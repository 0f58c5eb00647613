"""T5 as Flax modules (the encoder-decoder model, its stack and layers).

Loaded on first use through :mod:`.t5`; needs Flax. The serving path
(``t5_serving``) runs the same parameter tree without it.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

try:
    import flax.linen as nn
except ImportError as e:  # pragma: no cover - depends on the environment
    raise ImportError(
        "the T5 Flax modules need flax (pip install flax); T5 serving does not"
    ) from e

from ..config import get_config
from ..ops.flash import flash_attention
from ..ops.rel_bias import T5RelBias, materialize
from .attention import dispatch_attention
from .t5 import T5Config, _padding_mask, _relative_position_bucket


class T5LayerNorm(nn.Module):
    """RMS norm: no mean subtraction, no bias; variance in fp32."""

    epsilon: float = 1e-6
    dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        scale = self.param("scale", nn.initializers.ones, (x.shape[-1],), jnp.float32)
        xf = x.astype(jnp.float32)
        var = jnp.mean(xf * xf, axis=-1, keepdims=True)
        xf = xf * jax.lax.rsqrt(var + self.epsilon)
        return (xf * scale).astype(self.dtype)


class T5RelativeBias(nn.Module):
    """Learned bias (num_buckets, num_heads); dense (1, H, Sq, Skv) or the
    raw table for the in-kernel flash path (ops/rel_bias.py)."""

    config: T5Config
    bidirectional: bool

    @nn.compact
    def __call__(self, sq: int, skv: int, as_table: bool = False) -> jax.Array:
        cfg = self.config
        table = self.param(
            "rel_embedding",
            nn.initializers.normal(0.02),
            (cfg.relative_attention_num_buckets, cfg.num_heads),
            jnp.float32,
        )
        if as_table:
            return table
        ctx = jnp.arange(sq, dtype=jnp.int32)[:, None]
        mem = jnp.arange(skv, dtype=jnp.int32)[None, :]
        buckets = _relative_position_bucket(
            mem - ctx,
            self.bidirectional,
            cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance,
        )
        bias = table[buckets]  # (Sq, Skv, H)
        return bias.transpose(2, 0, 1)[None].astype(cfg.dtype)


class T5Attention(nn.Module):
    """T5 attention: no projection bias, unscaled scores, optional
    additive position bias, inner dim ``num_heads * d_kv``.

    ``kernel_bias=True`` means ``bias`` is the raw (num_buckets, H) table
    and the relative-position bias is rebuilt from iota INSIDE the Pallas
    flash kernel (ops/rel_bias.py) — no dense (H, Sq, Skv) tensor exists,
    which is what makes long-sequence T5 tractable (the reference's
    headline T5-Large seq-8192 claim would need a ~4 GB bias tensor on
    its dense path, reference README.md:663)."""

    config: T5Config
    causal: bool = False
    kernel_bias: bool = False

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        kv: Optional[jax.Array] = None,
        mask: Optional[jax.Array] = None,
        bias: Optional[jax.Array] = None,
    ) -> jax.Array:
        cfg = self.config
        kv = x if kv is None else kv
        b, sq, _ = x.shape
        skv = kv.shape[1]
        inner = cfg.num_heads * cfg.d_kv
        dense = lambda name: nn.Dense(  # noqa: E731
            inner, use_bias=False, dtype=cfg.dtype, name=name
        )
        q = dense("q")(x).reshape(b, sq, cfg.num_heads, cfg.d_kv)
        k = dense("k")(kv).reshape(b, skv, cfg.num_heads, cfg.d_kv)
        v = dense("v")(kv).reshape(b, skv, cfg.num_heads, cfg.d_kv)
        if self.kernel_bias and bias is not None:
            spec = T5RelBias(
                table=bias,
                bidirectional=not self.causal,
                max_distance=cfg.relative_attention_max_distance,
            )
            if mask is None and sq >= get_config().flash_threshold:
                out = flash_attention(
                    q, k, v, causal=self.causal, sm_scale=1.0, rel_bias=spec
                )
            else:
                dense_bias = materialize(spec, sq, skv).astype(cfg.dtype)
                out, _ = dispatch_attention(
                    q, k, v, mask, bias=dense_bias, causal=self.causal, sm_scale=1.0
                )
        else:
            out, _ = dispatch_attention(
                q, k, v, mask, bias=bias, causal=self.causal, sm_scale=1.0
            )
        out = out.reshape(b, sq, inner)
        return nn.Dense(cfg.d_model, use_bias=False, dtype=cfg.dtype, name="o")(out)


class T5FeedForward(nn.Module):
    config: T5Config

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        cfg = self.config
        dense = lambda feats, name: nn.Dense(  # noqa: E731
            feats, use_bias=False, dtype=cfg.dtype, name=name
        )
        if cfg.feed_forward_proj == "gated-gelu":
            h = nn.gelu(dense(cfg.d_ff, "wi_0")(x), approximate=False) * dense(
                cfg.d_ff, "wi_1"
            )(x)
        else:
            h = nn.relu(dense(cfg.d_ff, "wi")(x))
        return dense(cfg.d_model, "wo")(h)


class T5Block(nn.Module):
    """Pre-LN block: [self-attn, (cross-attn), ffn], each residual."""

    config: T5Config
    is_decoder: bool = False
    kernel_bias: bool = False

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        self_bias: Optional[jax.Array],
        self_mask: Optional[jax.Array],
        enc_out: Optional[jax.Array] = None,
        enc_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        cfg = self.config
        ln = lambda name: T5LayerNorm(  # noqa: E731
            epsilon=cfg.layer_norm_epsilon, dtype=cfg.dtype, name=name
        )
        x = x + T5Attention(
            cfg,
            causal=self.is_decoder,
            kernel_bias=self.kernel_bias,
            name="self_attn",
        )(ln("self_attn_ln")(x), mask=self_mask, bias=self_bias)
        if self.is_decoder:
            x = x + T5Attention(cfg, causal=False, name="cross_attn")(
                ln("cross_attn_ln")(x), kv=enc_out, mask=enc_mask
            )
        return x + T5FeedForward(cfg, name="ffn")(ln("ffn_ln")(x))


class _ScanBlock(nn.Module):
    config: T5Config
    is_decoder: bool = False
    kernel_bias: bool = False

    @nn.compact
    def __call__(self, x, self_bias, self_mask, enc_out, enc_mask):
        out = T5Block(
            self.config, self.is_decoder, kernel_bias=self.kernel_bias, name="block"
        )(x, self_bias, self_mask, enc_out, enc_mask)
        return out, None


class T5Stack(nn.Module):
    """Encoder or decoder stack with stack-level relative position bias."""

    config: T5Config
    is_decoder: bool = False
    scan_layers: bool = True

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        self_mask: Optional[jax.Array] = None,
        enc_out: Optional[jax.Array] = None,
        enc_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        cfg = self.config
        n_layers = cfg.num_decoder_layers if self.is_decoder else cfg.num_layers
        s = x.shape[1]
        # Unmasked stacks ship the raw bias TABLE into each layer and let
        # the flash kernel rebuild the bias from iota per tile; masked
        # stacks (padding) fall back to the dense-bias fused path.
        kernel_bias = self_mask is None
        bias = T5RelativeBias(
            cfg, bidirectional=not self.is_decoder, name="rel_bias"
        )(s, s, as_table=kernel_bias)
        if self.scan_layers:
            scanned = nn.scan(
                _ScanBlock,
                variable_axes={"params": 0},
                split_rngs={"params": True},
                in_axes=(nn.broadcast,) * 4,
                length=n_layers,
                metadata_params={nn.PARTITION_NAME: "layers"},
            )(cfg, self.is_decoder, kernel_bias, name="blocks")
            x, _ = scanned(x, bias, self_mask, enc_out, enc_mask)
        else:
            for i in range(n_layers):
                x = T5Block(
                    cfg, self.is_decoder, kernel_bias=kernel_bias, name=f"block_{i}"
                )(x, bias, self_mask, enc_out, enc_mask)
        return T5LayerNorm(
            epsilon=cfg.layer_norm_epsilon, dtype=cfg.dtype, name="final_ln"
        )(x)


class T5Model(nn.Module):
    """Encoder-decoder T5 (no LM head). Returns decoder hidden states."""

    config: T5Config
    scan_layers: bool = True

    def setup(self) -> None:
        cfg = self.config
        self.shared = self.param(
            "shared",
            nn.initializers.normal(1.0),
            (cfg.vocab_size, cfg.d_model),
            jnp.float32,
        )
        self.encoder = T5Stack(cfg, is_decoder=False, scan_layers=self.scan_layers)
        self.decoder = T5Stack(cfg, is_decoder=True, scan_layers=self.scan_layers)

    def encode(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        x = self.shared.astype(self.config.dtype)[input_ids]
        return self.encoder(x, self_mask=_padding_mask(attention_mask, x.shape[1]))

    def decode(
        self,
        decoder_input_ids: jax.Array,
        enc_out: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        decoder_attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        sq = decoder_input_ids.shape[1]
        x = self.shared.astype(self.config.dtype)[decoder_input_ids]
        enc_mask = None
        if attention_mask is not None:
            keep = attention_mask.astype(bool)[:, None, None, :]
            enc_mask = jnp.broadcast_to(
                keep, (attention_mask.shape[0], 1, sq, attention_mask.shape[1])
            )
        return self.decoder(
            x,
            self_mask=_padding_mask(decoder_attention_mask, sq),
            enc_out=enc_out,
            enc_mask=enc_mask,
        )

    def __call__(
        self,
        input_ids: jax.Array,
        decoder_input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        decoder_attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        enc = self.encode(input_ids, attention_mask)
        return self.decode(
            decoder_input_ids, enc, attention_mask, decoder_attention_mask
        )


class T5ForConditionalGeneration(nn.Module):
    """T5 with the tied LM head (logits scaled by d_model**-0.5 when tied,
    matching the HF/T5 v1.0 convention)."""

    config: T5Config
    scan_layers: bool = True

    def setup(self) -> None:
        self.model = T5Model(self.config, scan_layers=self.scan_layers)

    def __call__(
        self,
        input_ids: jax.Array,
        decoder_input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        decoder_attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        cfg = self.config
        h = self.model(
            input_ids, decoder_input_ids, attention_mask, decoder_attention_mask
        )
        if cfg.tie_word_embeddings:
            h = h * (cfg.d_model ** -0.5)
        return h @ self.model.shared.astype(cfg.dtype).T


# ---------------------------------------------------------------------------
# HF weight transfer
# ---------------------------------------------------------------------------
