"""T5 model family (encoder-decoder) on the attention engine.

T5 is the third model family the reference's converter special-cases
(reference integration/pytorch/convert.py:174-202 config extraction;
:361-450 weight transfer). T5 attention differs from GPT-2/BERT in ways
that exercise this engine's full surface:

* unscaled attention scores (``sm_scale=1.0`` — T5 folds the scale into
  initialization),
* bias-free projections with an inner dim ``num_heads * d_kv`` that may
  differ from ``d_model``,
* a learned **relative position bias** added to the scores — routed
  through the engine's additive-bias path (``dispatch_attention(bias=...)``),
* RMS layer norm (no mean subtraction, no bias),
* an encoder stack + a causal decoder stack with cross-attention.

Idioms: both stacks run under ``nn.scan`` with the relative position
bias hoisted to stack level (it is shared across layers — HF computes it
in block 0 and threads it through; hoisting makes the scanned block
uniform), compute in bfloat16 with fp32 params.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp



@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" (v1.0) | "gated-gelu" (v1.1)
    tie_word_embeddings: bool = True
    dtype: Any = jnp.bfloat16

    @classmethod
    def small(cls) -> "T5Config":
        return cls()

    @classmethod
    def base(cls) -> "T5Config":
        return cls(d_model=768, d_ff=3072, num_layers=12, num_decoder_layers=12, num_heads=12)

    @classmethod
    def large(cls) -> "T5Config":
        return cls(d_model=1024, d_ff=4096, num_layers=24, num_decoder_layers=24, num_heads=16)

    @classmethod
    def tiny(cls) -> "T5Config":
        """For tests/dryruns."""
        return cls(
            vocab_size=512,
            d_model=64,
            d_kv=16,
            d_ff=128,
            num_layers=2,
            num_decoder_layers=2,
            num_heads=4,
        )


def _relative_position_bucket(
    relative_position: jax.Array,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> jax.Array:
    """T5's log-binned relative position bucketing (public algorithm from
    the T5 paper, section on relative position embeddings)."""
    ret = jnp.zeros_like(relative_position)
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).astype(jnp.int32) * num_buckets
        n = jnp.abs(n)
    else:
        n = -jnp.minimum(n, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        jnp.log(jnp.maximum(n, 1).astype(jnp.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(jnp.int32)
    val_large = jnp.minimum(val_large, num_buckets - 1)
    return ret + jnp.where(is_small, n, val_large)


def _padding_mask(attention_mask: Optional[jax.Array], sq: int) -> Optional[jax.Array]:
    if attention_mask is None:
        return None
    keep = attention_mask.astype(bool)[:, None, None, :]
    return jnp.broadcast_to(keep, (attention_mask.shape[0], 1, sq, attention_mask.shape[1]))


def _t(w):
    import numpy as np

    return np.asarray(w).T


def transfer_hf_t5(hf_model: Any, dtype=jnp.bfloat16) -> Tuple[Any, Dict, Any]:
    """Weight transfer from a loaded HF (torch) T5Model /
    T5ForConditionalGeneration.

    Mirrors the reference's T5 branch of ``_transfer_weights``
    (convert.py:361-450): separate q/k/v/o projections (transposed from
    torch's (out, in)), the layer-0 relative_attention_bias hoisted to
    stack level, RMS-norm weights mapped to ``scale``.
    """
    import numpy as np

    sd = {k: np.asarray(v.detach()) for k, v in hf_model.state_dict().items()}
    hf_cfg = hf_model.config
    ff_proj = getattr(hf_cfg, "feed_forward_proj", "relu")
    cfg = T5Config(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.d_model,
        d_kv=hf_cfg.d_kv,
        d_ff=hf_cfg.d_ff,
        num_layers=hf_cfg.num_layers,
        num_decoder_layers=getattr(hf_cfg, "num_decoder_layers", hf_cfg.num_layers),
        num_heads=hf_cfg.num_heads,
        relative_attention_num_buckets=hf_cfg.relative_attention_num_buckets,
        relative_attention_max_distance=getattr(
            hf_cfg, "relative_attention_max_distance", 128
        ),
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        feed_forward_proj="gated-gelu" if "gated" in ff_proj else "relu",
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", True),
        dtype=dtype,
    )

    def ffn_params(p: str) -> Dict[str, Any]:
        if cfg.feed_forward_proj == "gated-gelu":
            return {
                "wi_0": {"kernel": _t(sd[p + "DenseReluDense.wi_0.weight"])},
                "wi_1": {"kernel": _t(sd[p + "DenseReluDense.wi_1.weight"])},
                "wo": {"kernel": _t(sd[p + "DenseReluDense.wo.weight"])},
            }
        return {
            "wi": {"kernel": _t(sd[p + "DenseReluDense.wi.weight"])},
            "wo": {"kernel": _t(sd[p + "DenseReluDense.wo.weight"])},
        }

    def attn_params(p: str) -> Dict[str, Any]:
        return {
            "q": {"kernel": _t(sd[p + "q.weight"])},
            "k": {"kernel": _t(sd[p + "k.weight"])},
            "v": {"kernel": _t(sd[p + "v.weight"])},
            "o": {"kernel": _t(sd[p + "o.weight"])},
        }

    def stack_params(prefix: str, n_layers: int, is_decoder: bool) -> Dict[str, Any]:
        blocks = []
        for i in range(n_layers):
            p = f"{prefix}.block.{i}."
            blk: Dict[str, Any] = {
                "self_attn": attn_params(p + "layer.0.SelfAttention."),
                "self_attn_ln": {"scale": sd[p + "layer.0.layer_norm.weight"]},
            }
            if is_decoder:
                blk["cross_attn"] = attn_params(p + "layer.1.EncDecAttention.")
                blk["cross_attn_ln"] = {"scale": sd[p + "layer.1.layer_norm.weight"]}
                ffn_idx = 2
            else:
                ffn_idx = 1
            blk["ffn"] = ffn_params(p + f"layer.{ffn_idx}.")
            blk["ffn_ln"] = {"scale": sd[p + f"layer.{ffn_idx}.layer_norm.weight"]}
            blocks.append(blk)
        return {
            "rel_bias": {
                "rel_embedding": sd[
                    f"{prefix}.block.0.layer.0.SelfAttention."
                    "relative_attention_bias.weight"
                ]
            },
            "blocks": {
                "block": jax.tree_util.tree_map(
                    lambda *xs: np.stack(xs, 0), *blocks
                )
            },
            "final_ln": {"scale": sd[f"{prefix}.final_layer_norm.weight"]},
        }

    is_lm = any(k.startswith("lm_head") for k in sd) or cfg.tie_word_embeddings
    model_params = {
        "shared": sd["shared.weight"],
        "encoder": stack_params("encoder", cfg.num_layers, False),
        "decoder": stack_params("decoder", cfg.num_decoder_layers, True),
    }
    from .t5_modules import T5ForConditionalGeneration, T5Model

    has_lm_head = type(hf_model).__name__.endswith("ForConditionalGeneration")
    if has_lm_head:
        params = {"model": model_params}
        model = T5ForConditionalGeneration(cfg)
    else:
        params = model_params
        model = T5Model(cfg)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), params)
    del is_lm
    return model, {"params": params}, cfg


def load_hf_t5(model_name: str = "t5-small", dtype=jnp.bfloat16):
    """Load HF T5 weights into this implementation."""
    from transformers import T5ForConditionalGeneration as HFT5

    return transfer_hf_t5(HFT5.from_pretrained(model_name), dtype)


_FLAX_CLASSES = (
    "T5LayerNorm", "T5RelativeBias", "T5Attention", "T5FeedForward", "T5Block",
    "T5Stack", "T5Model", "T5ForConditionalGeneration",
)


def __getattr__(name):
    # The Flax modules load on first use: the serving path needs only
    # T5Config and the parameter tree, not Flax.
    if name in _FLAX_CLASSES:
        from . import t5_modules

        return getattr(t5_modules, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
