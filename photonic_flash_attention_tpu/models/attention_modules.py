"""Drop-in attention layers as Flax modules.

``PhotonicFlashAttention`` (reference integration/pytorch/modules.py:12-232)
and ``PhotonicMultiHeadAttention`` (modules.py:235-336). They need Flax;
the models on the serving and training path do not use them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

try:
    import flax.linen as nn
except ImportError as e:  # pragma: no cover - depends on the environment
    raise ImportError(
        "the Flax attention modules need flax (pip install flax); the "
        "functional models and the serving engine do not"
    ) from e

from ..core.engine import get_engine
from .attention import _is_tracing, dispatch_attention, padding_mask_to_lens_bias


class PhotonicFlashAttention(nn.Module):
    """Drop-in attention layer (reference modules.py:12-232).

    Shapes: (batch, seq, embed_dim) in/out. Self-attention when only
    ``query`` is given; cross-attention with separate key/value
    (reference flash_attention_3.py:86-94's self/cross split).

    Attributes:
      embed_dim / num_heads / num_kv_heads: projection geometry (GQA when
        num_kv_heads < num_heads).
      causal: apply causal masking.
      dropout_rate: attention-output dropout (train mode only).
      attention_dropout: dropout on the attention probabilities inside
        the kernel path (reference flash_attention_3.py:43,174-175) —
        in-kernel positional mask on flash, identical-sample weight mask
        on the fused path. Train mode only; needs a 'dropout' RNG.
      use_bias: bias on projections.
      adaptive: eager calls route through the measured AttentionEngine;
        in-trace calls always use static dispatch.
    """

    embed_dim: int
    num_heads: int
    num_kv_heads: Optional[int] = None
    causal: bool = False
    dropout_rate: float = 0.0
    attention_dropout: float = 0.0
    use_bias: bool = True
    adaptive: bool = True
    dtype: jnp.dtype = jnp.bfloat16
    param_dtype: jnp.dtype = jnp.float32

    def setup(self) -> None:
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads {self.num_heads}"
            )
        kvh = self.num_kv_heads or self.num_heads
        head_dim = self.embed_dim // self.num_heads
        dense = lambda feats, name: nn.Dense(  # noqa: E731
            feats,
            use_bias=self.use_bias,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name=name,
        )
        self.q_proj = dense(self.num_heads * head_dim, "q_proj")
        self.k_proj = dense(kvh * head_dim, "k_proj")
        self.v_proj = dense(kvh * head_dim, "v_proj")
        self.out_proj = dense(self.embed_dim, "out_proj")
        self.dropout = nn.Dropout(self.dropout_rate)

    def __call__(
        self,
        query: jax.Array,
        key: Optional[jax.Array] = None,
        value: Optional[jax.Array] = None,
        mask: Optional[jax.Array] = None,
        *,
        need_weights: bool = False,
        deterministic: bool = True,
        kv_lens: Optional[jax.Array] = None,
        k_bias: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, Optional[jax.Array]]:
        key = query if key is None else key
        value = key if value is None else value

        b, sq, _ = query.shape
        skv = key.shape[1]
        kvh = self.num_kv_heads or self.num_heads
        head_dim = self.embed_dim // self.num_heads

        q = self.q_proj(query).reshape(b, sq, self.num_heads, head_dim)
        k = self.k_proj(key).reshape(b, skv, kvh, head_dim)
        v = self.v_proj(value).reshape(b, skv, kvh, head_dim)

        attn_rate = (
            self.attention_dropout
            if (not deterministic and self.attention_dropout > 0.0)
            else 0.0
        )
        attn_seed = None
        if attn_rate > 0.0:
            attn_seed = jax.random.randint(
                self.make_rng("dropout"), (1,), 0,
                jnp.iinfo(jnp.int32).max, dtype=jnp.int32,
            )

        if self.adaptive and attn_rate == 0.0 and not _is_tracing(q):
            out, weights = get_engine()(
                q, k, v, mask, causal=self.causal, need_weights=need_weights,
                kv_lens=kv_lens, k_bias=k_bias,
            )
        else:
            out, weights = dispatch_attention(
                q, k, v, mask, causal=self.causal, need_weights=need_weights,
                kv_lens=kv_lens, k_bias=k_bias,
                dropout_rate=attn_rate, dropout_seed=attn_seed,
            )

        out = out.reshape(b, sq, self.num_heads * head_dim)
        out = self.out_proj(out)
        out = self.dropout(out, deterministic=deterministic)
        return out, weights

    @staticmethod
    def get_performance_stats() -> dict:
        """Engine stats surface (reference modules.py:189-218)."""
        return get_engine().get_performance_stats()


class PhotonicMultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention``-compatible facade (modules.py:235-336).

    Accepts (B, S, E) with ``batch_first=True`` semantics (the JAX-native
    layout; the reference's transpose shims are torch-specific),
    ``key_padding_mask`` (True = ignore position), optional
    ``attn_mask``, and returns head-averaged weights when
    ``need_weights=True`` with ``average_attn_weights``.
    """

    embed_dim: int
    num_heads: int
    dropout_rate: float = 0.0
    attention_dropout: float = 0.0
    use_bias: bool = True
    causal: bool = False
    dtype: jnp.dtype = jnp.bfloat16
    param_dtype: jnp.dtype = jnp.float32

    def setup(self) -> None:
        self.inner = PhotonicFlashAttention(
            embed_dim=self.embed_dim,
            num_heads=self.num_heads,
            causal=self.causal,
            dropout_rate=self.dropout_rate,
            attention_dropout=self.attention_dropout,
            use_bias=self.use_bias,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="attention",
        )

    def __call__(
        self,
        query: jax.Array,
        key: Optional[jax.Array] = None,
        value: Optional[jax.Array] = None,
        key_padding_mask: Optional[jax.Array] = None,
        attn_mask: Optional[jax.Array] = None,
        *,
        need_weights: bool = True,
        average_attn_weights: bool = True,
        deterministic: bool = True,
    ) -> Tuple[jax.Array, Optional[jax.Array]]:
        key = query if key is None else key
        b, sq, _ = query.shape
        skv = key.shape[1]

        mask = None
        kv_lens = k_bias = None
        if attn_mask is not None:
            mask = attn_mask.astype(bool)
            if mask.ndim == 2:
                mask = mask[None, None]
            elif mask.ndim == 3:
                mask = mask[:, None]
        if key_padding_mask is not None:
            # True = padded (ignore), torch convention (modules.py:287-299).
            keep = jnp.logical_not(key_padding_mask)
            if mask is None:
                # Pure key padding stays on the flash fast path as
                # per-row lengths + per-key bias (in-kernel masking).
                kv_lens, k_bias = padding_mask_to_lens_bias(keep)
            else:
                keep4 = jnp.broadcast_to(keep[:, None, None, :], (b, 1, sq, skv))
                mask = jnp.logical_and(mask, keep4)

        out, weights = self.inner(
            query,
            key,
            value,
            mask,
            need_weights=need_weights,
            deterministic=deterministic,
            kv_lens=kv_lens,
            k_bias=k_bias,
        )
        if weights is not None and average_attn_weights:
            weights = jnp.mean(weights, axis=1)  # head-average (modules.py:318)
        return out, weights
