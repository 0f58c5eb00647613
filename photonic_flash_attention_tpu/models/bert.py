"""BERT model family on the attention engine (Flax; loaded on first use).

The reference's model-conversion surface names BERT as a first-class
family: ``AttentionLayerDetector`` extracts BERT attention geometry
(reference integration/pytorch/convert.py:174-185) and
``_transfer_weights`` special-cases the separate query/key/value
projections (convert.py:361-398). Here BERT is implemented natively in
Flax on ``PhotonicFlashAttention``, with exact HF weight transfer
(``load_hf_bert`` / ``transfer_hf_bert``) so converted checkpoints
produce identical encodings.

Idioms: the encoder stack runs under ``nn.scan`` (one block body in
HLO regardless of depth), compute in bfloat16 with fp32 params, padding
masks as boolean keep-masks merged at the attention call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

try:
    import flax.linen as nn
except ImportError as e:  # pragma: no cover - depends on the environment
    raise ImportError("the BERT model needs flax (pip install flax)") from e

from .attention import padding_mask_to_lens_bias
from .attention_modules import PhotonicFlashAttention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: Any = jnp.bfloat16

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def large(cls) -> "BertConfig":
        return cls(
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
        )

    @classmethod
    def tiny(cls) -> "BertConfig":
        """For tests/dryruns."""
        return cls(
            vocab_size=512,
            hidden_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=256,
            max_position_embeddings=128,
        )


class BertEmbeddings(nn.Module):
    config: BertConfig

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,
        token_type_ids: Optional[jax.Array] = None,
        positions: Optional[jax.Array] = None,
    ) -> jax.Array:
        cfg = self.config
        b, s = input_ids.shape
        word = self.param(
            "word_embeddings",
            nn.initializers.normal(0.02),
            (cfg.vocab_size, cfg.hidden_size),
            jnp.float32,
        )
        pos = self.param(
            "position_embeddings",
            nn.initializers.normal(0.02),
            (cfg.max_position_embeddings, cfg.hidden_size),
            jnp.float32,
        )
        tok_type = self.param(
            "token_type_embeddings",
            nn.initializers.normal(0.02),
            (cfg.type_vocab_size, cfg.hidden_size),
            jnp.float32,
        )
        if positions is None:
            positions = jnp.arange(s, dtype=jnp.int32)[None, :]
        if token_type_ids is None:
            token_type_ids = jnp.zeros_like(input_ids)
        x = word[input_ids] + pos[positions] + tok_type[token_type_ids]
        x = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, dtype=jnp.float32, name="LayerNorm"
        )(x)
        return x.astype(cfg.dtype)


class BertLayer(nn.Module):
    """Post-LN encoder block (attention -> add&norm -> FFN -> add&norm)."""

    config: BertConfig

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        kv_lens: Optional[jax.Array] = None,
        k_bias: Optional[jax.Array] = None,
    ) -> jax.Array:
        cfg = self.config
        attn_out, _ = PhotonicFlashAttention(
            embed_dim=cfg.hidden_size,
            num_heads=cfg.num_attention_heads,
            causal=False,
            dtype=cfg.dtype,
            adaptive=False,  # in-model calls are traced; static dispatch
            name="attention",
        )(x, kv_lens=kv_lens, k_bias=k_bias)
        x = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, dtype=cfg.dtype, name="attention_ln"
        )(x + attn_out)
        h = nn.Dense(cfg.intermediate_size, dtype=cfg.dtype, name="intermediate")(x)
        h = nn.gelu(h, approximate=False)  # BERT uses exact (erf) GELU
        h = nn.Dense(cfg.hidden_size, dtype=cfg.dtype, name="output")(h)
        return nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, dtype=cfg.dtype, name="output_ln"
        )(x + h)


class _ScanLayer(nn.Module):
    """Scan-compatible wrapper; the padding mask broadcasts across layers."""

    config: BertConfig

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        kv_lens: Optional[jax.Array],
        k_bias: Optional[jax.Array],
    ) -> Tuple[jax.Array, None]:
        return BertLayer(self.config, name="layer")(x, kv_lens, k_bias), None


class BertModel(nn.Module):
    """BERT encoder. Input: int32 (B, S) token ids.

    Returns ``(sequence_output (B, S, H), pooled_output (B, H))``; the
    pooler is the HF tanh head over the [CLS] position.
    """

    config: BertConfig
    scan_layers: bool = True
    add_pooler: bool = True

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        token_type_ids: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, Optional[jax.Array]]:
        cfg = self.config
        b, s = input_ids.shape
        x = BertEmbeddings(cfg, name="embeddings")(input_ids, token_type_ids)

        kv_lens = k_bias = None
        if attention_mask is not None:
            # HF convention: 1 = attend. Key padding rides the flash
            # kernel natively (per-row lengths + per-key bias) instead of
            # forcing the O(S^2) dense-mask path — the headline masked
            # case (padded BERT batches) stays on the fast kernel.
            kv_lens, k_bias = padding_mask_to_lens_bias(
                attention_mask.astype(bool)
            )

        if self.scan_layers:
            scanned = nn.scan(
                _ScanLayer,
                variable_axes={"params": 0},
                split_rngs={"params": True},
                in_axes=(nn.broadcast, nn.broadcast),
                length=cfg.num_hidden_layers,
                metadata_params={nn.PARTITION_NAME: "layers"},
            )(cfg, name="encoder")
            x, _ = scanned(x, kv_lens, k_bias)
        else:
            for i in range(cfg.num_hidden_layers):
                x = BertLayer(cfg, name=f"layer_{i}")(x, kv_lens, k_bias)

        pooled = None
        if self.add_pooler:
            cls = x[:, 0]
            pooled = nn.tanh(
                nn.Dense(cfg.hidden_size, dtype=cfg.dtype, name="pooler")(cls)
            )
        return x, pooled


def _transpose(w):
    import numpy as np

    return np.asarray(w).T


def transfer_hf_bert(hf_model: Any, dtype=jnp.bfloat16) -> Tuple[Any, Dict, Any]:
    """Weight transfer from a loaded HF (torch) BertModel.

    The separate q/k/v projection handling mirrors the reference's
    BERT branch of ``_transfer_weights`` (convert.py:361-398); torch
    ``nn.Linear`` stores (out, in) kernels, flax ``Dense`` stores
    (in, out), so every projection transposes.
    """
    import numpy as np

    hf = getattr(hf_model, "bert", hf_model)  # task heads wrap .bert
    sd = {k: np.asarray(v.detach()) for k, v in hf.state_dict().items()}
    hf_cfg = hf.config
    cfg = BertConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        type_vocab_size=hf_cfg.type_vocab_size,
        layer_norm_eps=hf_cfg.layer_norm_eps,
        dtype=dtype,
    )

    params: Dict[str, Any] = {
        "embeddings": {
            "word_embeddings": sd["embeddings.word_embeddings.weight"],
            "position_embeddings": sd["embeddings.position_embeddings.weight"],
            "token_type_embeddings": sd["embeddings.token_type_embeddings.weight"],
            "LayerNorm": {
                "scale": sd["embeddings.LayerNorm.weight"],
                "bias": sd["embeddings.LayerNorm.bias"],
            },
        }
    }
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        layers.append(
            {
                "attention": {
                    "q_proj": {
                        "kernel": _transpose(sd[p + "attention.self.query.weight"]),
                        "bias": sd[p + "attention.self.query.bias"],
                    },
                    "k_proj": {
                        "kernel": _transpose(sd[p + "attention.self.key.weight"]),
                        "bias": sd[p + "attention.self.key.bias"],
                    },
                    "v_proj": {
                        "kernel": _transpose(sd[p + "attention.self.value.weight"]),
                        "bias": sd[p + "attention.self.value.bias"],
                    },
                    "out_proj": {
                        "kernel": _transpose(sd[p + "attention.output.dense.weight"]),
                        "bias": sd[p + "attention.output.dense.bias"],
                    },
                },
                "attention_ln": {
                    "scale": sd[p + "attention.output.LayerNorm.weight"],
                    "bias": sd[p + "attention.output.LayerNorm.bias"],
                },
                "intermediate": {
                    "kernel": _transpose(sd[p + "intermediate.dense.weight"]),
                    "bias": sd[p + "intermediate.dense.bias"],
                },
                "output": {
                    "kernel": _transpose(sd[p + "output.dense.weight"]),
                    "bias": sd[p + "output.dense.bias"],
                },
                "output_ln": {
                    "scale": sd[p + "output.LayerNorm.weight"],
                    "bias": sd[p + "output.LayerNorm.bias"],
                },
            }
        )
    import numpy as np

    params["encoder"] = {
        "layer": jax.tree_util.tree_map(lambda *xs: np.stack(xs, 0), *layers)
    }
    has_pooler = "pooler.dense.weight" in sd
    if has_pooler:
        params["pooler"] = {
            "kernel": _transpose(sd["pooler.dense.weight"]),
            "bias": sd["pooler.dense.bias"],
        }
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), params)
    model = BertModel(cfg, add_pooler=has_pooler)
    return model, {"params": params}, cfg


def load_hf_bert(model_name: str = "bert-base-uncased", dtype=jnp.bfloat16):
    """Load HF BERT weights into this implementation."""
    from transformers import BertModel as HFBertModel

    return transfer_hf_bert(HFBertModel.from_pretrained(model_name), dtype)
