"""Llama model family on the attention engine, in plain JAX.

Llama is in the reference converter's family-detection list (reference
integration/pytorch/convert.py — ``_detect_family`` probes for
"llama") but has no weight-transfer branch there; this module completes
the surface with a functional implementation plus exact HF transfer.
Architecturally it exercises the engine features GPT-2/BERT/T5 do not:

* **grouped-query attention** — runs on the flash kernel's native GQA
  index maps (no repeated KV in HBM),
* **rotary position embeddings** (half-split rotate convention, matching
  HF ``apply_rotary_pos_emb``),
* RMSNorm pre-normalization and SwiGLU MLP, all bias-free.

As elsewhere: one ``lax.scan`` over stacked layer params, bf16 compute
over fp32 params, tensor-parallel PartitionSpec rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .attention import dispatch_attention
from .functional import FunctionalModel, dense_init, rms_norm


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    dtype: Any = jnp.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """For tests/dryruns (GQA: 8 q heads over 2 kv heads)."""
        return cls(
            vocab_size=512,
            hidden_size=128,
            intermediate_size=256,
            num_hidden_layers=2,
            num_attention_heads=8,
            num_key_value_heads=2,
            max_position_embeddings=256,
        )


def rope_cos_sin(
    positions: jax.Array, head_dim: int, theta: float
) -> Tuple[jax.Array, jax.Array]:
    """(B, S) int positions -> cos/sin (B, S, head_dim) fp32, HF layout
    (frequencies duplicated across the two halves)."""
    inv_freq = 1.0 / (
        theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim)
    )
    angles = positions.astype(jnp.float32)[..., None] * inv_freq  # (B, S, D/2)
    emb = jnp.concatenate([angles, angles], axis=-1)  # (B, S, D)
    return jnp.cos(emb), jnp.sin(emb)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Half-split rotation (HF ``rotate_half``): x is (B, S, H, D)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    cos = cos[:, :, None, :].astype(jnp.float32)
    sin = sin[:, :, None, :].astype(jnp.float32)
    out = x.astype(jnp.float32) * cos + rotated.astype(jnp.float32) * sin
    return out.astype(x.dtype)


def llama_init_params(cfg: LlamaConfig, rng: jax.Array) -> Dict[str, Any]:
    """Random parameters (fp32) in the layout of ``transfer_hf_llama``."""
    e, f, L, hd = (
        cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.head_dim
    )
    hq, hkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    keys = jax.random.split(rng, 9)
    params = {
        "embed_tokens": 0.02 * jax.random.normal(keys[0], (cfg.vocab_size, e)),
        "layers": {
            "layer": {
                "input_ln": {"scale": jnp.ones((L, e))},
                "post_attn_ln": {"scale": jnp.ones((L, e))},
                "attn": {
                    "q_proj": dense_init(keys[1], L, e, hq, bias=False),
                    "k_proj": dense_init(keys[2], L, e, hkv, bias=False),
                    "v_proj": dense_init(keys[3], L, e, hkv, bias=False),
                    "o_proj": dense_init(keys[4], L, hq, e, bias=False),
                },
                "mlp": {
                    "gate_proj": dense_init(keys[5], L, e, f, bias=False),
                    "up_proj": dense_init(keys[6], L, e, f, bias=False),
                    "down_proj": dense_init(keys[7], L, f, e, bias=False),
                },
            }
        },
        "norm": {"scale": jnp.ones((e,))},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = 0.02 * jax.random.normal(keys[8], (e, cfg.vocab_size))
    return params


def llama_forward(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    input_ids: jax.Array,
    *,
    positions: Optional[jax.Array] = None,
    attention_mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Logits (B, S, V) for int32 (B, S) ids; ``attention_mask`` (B, S)
    marks the keys to attend (1) or ignore (0)."""
    b, s = input_ids.shape
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    if positions is None:
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    mask = None
    if attention_mask is not None:
        keep = attention_mask.astype(bool)[:, None, None, :]
        mask = jnp.broadcast_to(keep, (b, 1, s, s))
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    x = params["embed_tokens"].astype(cfg.dtype)[input_ids]

    def dense(x, p):
        return jnp.dot(x, p["kernel"].astype(x.dtype))

    def layer(x, p):
        h = rms_norm(x, p["input_ln"]["scale"], eps)
        a = p["attn"]
        q = apply_rope(dense(h, a["q_proj"]).reshape(b, s, hq, hd), cos, sin)
        k = apply_rope(dense(h, a["k_proj"]).reshape(b, s, hkv, hd), cos, sin)
        v = dense(h, a["v_proj"]).reshape(b, s, hkv, hd)
        out, _ = dispatch_attention(q, k, v, mask, causal=True)
        x = x + dense(out.reshape(b, s, hq * hd), a["o_proj"])
        h = rms_norm(x, p["post_attn_ln"]["scale"], eps)
        m = p["mlp"]
        gate = jax.nn.silu(dense(h, m["gate_proj"]))
        return x + dense(gate * dense(h, m["up_proj"]), m["down_proj"]), None

    x, _ = jax.lax.scan(layer, x, params["layers"]["layer"])
    x = rms_norm(x, params["norm"]["scale"], eps)
    return lm_head(x, params, cfg)


def lm_head(x, params, cfg: LlamaConfig):
    """Float32 logits: bf16 operands, f32 accumulation."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        w = params["embed_tokens"].astype(cfg.dtype).T
    else:
        w = params["lm_head"].astype(cfg.dtype)
    return jnp.dot(x, w, preferred_element_type=jnp.float32)


class LlamaForCausalLM(FunctionalModel):
    """Llama with LM head. Input: int32 (B, S) token ids."""

    def init_params(self, rng, *_args):
        return llama_init_params(self.config, rng)

    def forward(self, params, input_ids, *, deterministic=True, dropout_rng=None,
                positions=None, attention_mask=None):
        del deterministic, dropout_rng  # no dropout in this family
        return llama_forward(
            params, self.config, input_ids, positions=positions,
            attention_mask=attention_mask,
        )


def llama_param_sharding_rules(params: Dict, mesh_axes=("data", "model")):
    """TP PartitionSpecs: q/k/v/gate/up column-sharded, o/down row-sharded,
    embeddings sharded on hidden."""
    _, model = mesh_axes

    def rule(names: Tuple[str, ...], leaf) -> P:
        name = "/".join(names)
        base = None
        if any(f"{p}/kernel" in name for p in ("q_proj", "k_proj", "v_proj")):
            base = (None, model)
        elif "o_proj/kernel" in name or "down_proj/kernel" in name:
            base = (model, None)
        elif "gate_proj/kernel" in name or "up_proj/kernel" in name:
            base = (None, model)
        elif name.endswith("embed_tokens") or name.endswith("lm_head"):
            base = (None, model)
        if base is None or leaf.ndim < 2:
            return P()
        return P(*((None,) * (leaf.ndim - 2) + base))

    flat = jax.tree_util.tree_flatten_with_path(params)[0]

    def path_names(kp):
        return tuple(
            getattr(e, "key", getattr(e, "idx", str(e))) for e in kp
        )

    specs = {path_names(kp): rule(tuple(map(str, path_names(kp))), leaf) for kp, leaf in flat}

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        return specs[prefix]

    return build(params)


def _t(w):
    import numpy as np

    return np.asarray(w).T


def transfer_hf_llama(hf_model: Any, dtype=jnp.bfloat16) -> Tuple[Any, Dict, Any]:
    """Weight transfer from a loaded HF (torch) LlamaForCausalLM/LlamaModel."""
    import numpy as np

    sd = {k: np.asarray(v.detach()) for k, v in hf_model.state_dict().items()}
    if not any(k.startswith("model.") for k in sd):
        sd = {f"model.{k}": v for k, v in sd.items()}
    hf_cfg = hf_model.config
    tie = bool(getattr(hf_cfg, "tie_word_embeddings", False))
    has_head = "lm_head.weight" in sd
    cfg = LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_key_value_heads=getattr(
            hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads
        ),
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        rms_norm_eps=hf_cfg.rms_norm_eps,
        tie_word_embeddings=tie or not has_head,
        dtype=dtype,
    )
    params: Dict[str, Any] = {"embed_tokens": sd["model.embed_tokens.weight"]}
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        layers.append(
            {
                "input_ln": {"scale": sd[p + "input_layernorm.weight"]},
                "post_attn_ln": {"scale": sd[p + "post_attention_layernorm.weight"]},
                "attn": {
                    "q_proj": {"kernel": _t(sd[p + "self_attn.q_proj.weight"])},
                    "k_proj": {"kernel": _t(sd[p + "self_attn.k_proj.weight"])},
                    "v_proj": {"kernel": _t(sd[p + "self_attn.v_proj.weight"])},
                    "o_proj": {"kernel": _t(sd[p + "self_attn.o_proj.weight"])},
                },
                "mlp": {
                    "gate_proj": {"kernel": _t(sd[p + "mlp.gate_proj.weight"])},
                    "up_proj": {"kernel": _t(sd[p + "mlp.up_proj.weight"])},
                    "down_proj": {"kernel": _t(sd[p + "mlp.down_proj.weight"])},
                },
            }
        )
    params["layers"] = {
        "layer": jax.tree_util.tree_map(lambda *xs: np.stack(xs, 0), *layers)
    }
    params["norm"] = {"scale": sd["model.norm.weight"]}
    if has_head and not cfg.tie_word_embeddings:
        params["lm_head"] = _t(sd["lm_head.weight"])
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), params)
    return LlamaForCausalLM(cfg), {"params": params}, cfg


def load_hf_llama(model_name: str, dtype=jnp.bfloat16):
    """Load HF Llama weights into this implementation."""
    from transformers import AutoModelForCausalLM

    return transfer_hf_llama(AutoModelForCausalLM.from_pretrained(model_name), dtype)
