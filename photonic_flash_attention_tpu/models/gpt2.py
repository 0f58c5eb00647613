"""GPT-2 model family (the flagship end-to-end model), in plain JAX.

The reference converts HF GPT-2 by swapping its attention layers
(reference integration/pytorch/convert.py:174-202 GPT-2 config extraction,
:399-430 fused-c_attn weight transfer); BASELINE.json names GPT-2-medium
as the E2E target. Here GPT-2 is a pure function over a parameter pytree
(``gpt2_forward``), with exact HF weight loading (``load_hf_gpt2``) so
converted checkpoints produce identical logits. ``GPT2LMHead`` wraps it in
the ``init``/``apply`` interface the trainer and tests call.

Parameter tree (layer params stacked on a leading (n_layer,) axis, so the
forward is one ``lax.scan`` over a single block body)::

    wte (V, E), wpe (P, E), ln_f {scale, bias},
    h/block/{ln_1, ln_2: {scale, bias},
             attn/{q_proj, k_proj, v_proj, out_proj}: {kernel, bias},
             mlp/{c_fc, c_proj}: {kernel, bias}}

Sharding: ``param_sharding_rules`` returns a PartitionSpec tree for
tensor-parallel (attention heads + MLP) × data-parallel execution over a
``Mesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .attention import dispatch_attention
from .functional import FunctionalModel, dense_init, layer_norm


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    #: dropout on attention probabilities (HF attn_pdrop) — train mode
    #: only; applied in-kernel on the flash path (ops/flash.py).
    attn_pdrop: float = 0.0
    dtype: Any = jnp.bfloat16

    @classmethod
    def small(cls) -> "GPT2Config":
        return cls()

    @classmethod
    def medium(cls) -> "GPT2Config":
        return cls(n_embd=1024, n_layer=24, n_head=16)

    @classmethod
    def large(cls) -> "GPT2Config":
        return cls(n_embd=1280, n_layer=36, n_head=20)

    @classmethod
    def tiny(cls) -> "GPT2Config":
        """For tests/dryruns."""
        return cls(vocab_size=1024, n_positions=256, n_embd=128, n_layer=2, n_head=4)


def gpt2_init_params(cfg: GPT2Config, rng: jax.Array) -> Dict[str, Any]:
    """Random parameters (fp32) in the layout of ``transfer_hf_gpt2``."""
    e, L = cfg.n_embd, cfg.n_layer
    keys = jax.random.split(rng, 8)
    ln = lambda: {"scale": jnp.ones((L, e)), "bias": jnp.zeros((L, e))}  # noqa: E731
    return {
        "wte": 0.02 * jax.random.normal(keys[0], (cfg.vocab_size, e)),
        "wpe": 0.01 * jax.random.normal(keys[1], (cfg.n_positions, e)),
        "ln_f": {"scale": jnp.ones((e,)), "bias": jnp.zeros((e,))},
        "h": {
            "block": {
                "ln_1": ln(),
                "ln_2": ln(),
                "attn": {
                    "q_proj": dense_init(keys[2], L, e, e),
                    "k_proj": dense_init(keys[3], L, e, e),
                    "v_proj": dense_init(keys[4], L, e, e),
                    "out_proj": dense_init(keys[5], L, e, e),
                },
                "mlp": {
                    "c_fc": dense_init(keys[6], L, e, 4 * e),
                    "c_proj": dense_init(keys[7], L, 4 * e, e),
                },
            }
        },
    }


def _dense(x, p):
    return jnp.dot(x, p["kernel"].astype(x.dtype)) + p["bias"].astype(x.dtype)


def gpt2_forward(
    params: Dict[str, Any],
    cfg: GPT2Config,
    input_ids: jax.Array,
    *,
    deterministic: bool = True,
    positions: Optional[jax.Array] = None,
    dropout_rng: Optional[jax.Array] = None,
    attention: Optional[Callable] = None,
) -> jax.Array:
    """Logits (B, S, V) of the tied-embedding GPT-2 LM for int32 (B, S) ids.

    Train mode (``deterministic=False`` with ``dropout_rng``) applies
    ``cfg.attn_pdrop`` to the attention probabilities inside the kernel;
    each layer draws its own seed. ``attention(q, k, v) -> out`` replaces
    the causal attention of every layer (a reference run).
    """
    b, s = input_ids.shape
    h = cfg.n_head
    d = cfg.n_embd // h
    eps = cfg.layer_norm_epsilon
    if positions is None:
        positions = jnp.arange(s, dtype=jnp.int32)[None, :]
    wte = params["wte"].astype(cfg.dtype)
    x = wte[input_ids] + params["wpe"].astype(cfg.dtype)[positions]
    rate = cfg.attn_pdrop if (not deterministic and dropout_rng is not None) else 0.0

    def block(x, xs):
        p, lyr = xs
        hin = layer_norm(x, p["ln_1"]["scale"], p["ln_1"]["bias"], eps)
        a = p["attn"]
        q = _dense(hin, a["q_proj"]).reshape(b, s, h, d)
        k = _dense(hin, a["k_proj"]).reshape(b, s, h, d)
        v = _dense(hin, a["v_proj"]).reshape(b, s, h, d)
        seed = None
        if rate > 0.0:
            seed = jax.random.randint(
                jax.random.fold_in(dropout_rng, lyr), (1,), 0,
                jnp.iinfo(jnp.int32).max, dtype=jnp.int32,
            )
        if attention is not None:
            out = attention(q, k, v)
        else:
            out, _ = dispatch_attention(
                q, k, v, causal=True, dropout_rate=rate, dropout_seed=seed
            )
        x = x + _dense(out.reshape(b, s, h * d), a["out_proj"])
        h2 = layer_norm(x, p["ln_2"]["scale"], p["ln_2"]["bias"], eps)
        m = jax.nn.gelu(_dense(h2, p["mlp"]["c_fc"]), approximate=True)
        return x + _dense(m, p["mlp"]["c_proj"]), None

    x, _ = jax.lax.scan(
        block, x, (params["h"]["block"], jnp.arange(cfg.n_layer, dtype=jnp.int32))
    )
    x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"], eps)
    # Tied head; float32 logits (bf16 operands, f32 accumulation).
    return jnp.dot(x, wte.T, preferred_element_type=jnp.float32)


class GPT2LMHead(FunctionalModel):
    """GPT-2 with tied-embedding LM head. Input: int32 (B, S) token ids."""

    def init_params(self, rng, *_args):
        return gpt2_init_params(self.config, rng)

    def forward(self, params, input_ids, *, deterministic=True, positions=None,
                dropout_rng=None):
        return gpt2_forward(
            params, self.config, input_ids, deterministic=deterministic,
            positions=positions, dropout_rng=dropout_rng,
        )


def param_sharding_rules(params: Dict, mesh_axes: Tuple[str, str] = ("data", "model")):
    """PartitionSpec tree for TP×DP over ('data','model') mesh axes.

    Tensor-parallel layout (the SNIPPETS.md §1 head-sharding pattern):
    q/k/v projections column-sharded (heads on 'model'), out/c_proj
    row-sharded, MLP c_fc column- and c_proj row-sharded, embeddings
    vocab-replicated with n_embd sharding on wte for memory.
    """
    _, model = mesh_axes

    def rule(path: Tuple[str, ...], leaf) -> P:
        name = "/".join(str(p) for p in path)
        # Base spec for the trailing (in, out) dims of a kernel; scanned
        # layer stacks carry a leading (n_layer,) axis padded with None.
        base = None
        if "q_proj/kernel" in name or "k_proj/kernel" in name or "v_proj/kernel" in name:
            base = (None, model)  # column parallel (heads)
        elif "out_proj/kernel" in name:
            base = (model, None)  # row parallel
        elif "c_fc/kernel" in name:
            base = (None, model)
        elif "c_proj/kernel" in name:
            base = (model, None)
        elif name.endswith("wte"):
            base = (None, model)
        if base is None or leaf.ndim < 2:
            return P()  # biases, layernorm params, wpe: replicated
        return P(*((None,) * (leaf.ndim - 2) + base))

    flat = jax.tree_util.tree_flatten_with_path(params)[0]

    def path_to_names(kp):
        out = []
        for entry in kp:
            if hasattr(entry, "key"):
                out.append(entry.key)
            elif hasattr(entry, "idx"):
                out.append(str(entry.idx))
            else:
                out.append(str(entry))
        return tuple(out)

    specs = {path_to_names(kp): rule(path_to_names(kp), leaf) for kp, leaf in flat}

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        return specs[prefix]

    return build(params)


def load_hf_gpt2(model_name: str = "gpt2", dtype=jnp.bfloat16):
    """Load HF GPT-2 weights into this implementation (downloads weights)."""
    from transformers import GPT2LMHeadModel

    return transfer_hf_gpt2(GPT2LMHeadModel.from_pretrained(model_name), dtype)


def transfer_hf_gpt2(hf, dtype=jnp.bfloat16):
    """Transfer weights from an already-constructed HF GPT-2 (no network).

    Handles the fused ``c_attn`` QKV split the reference handles in
    ``_transfer_weights`` (convert.py:399-430): HF GPT-2 uses Conv1D
    ((in, out) kernels, no transpose needed) with QKV
    concatenated on the output axis. Accepts ``GPT2LMHeadModel`` or bare
    ``GPT2Model`` (state-dict keys are normalized to the ``transformer.``
    prefix).
    """
    import numpy as np

    sd = {k: np.asarray(v.detach()) for k, v in hf.state_dict().items()}
    # LMHead checkpoints prefix with 'transformer.', bare GPT2Model doesn't.
    if not any(k.startswith("transformer.") for k in sd):
        sd = {f"transformer.{k}": v for k, v in sd.items()}
    hf_cfg = hf.config
    cfg = GPT2Config(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.n_positions,
        n_embd=hf_cfg.n_embd,
        n_layer=hf_cfg.n_layer,
        n_head=hf_cfg.n_head,
        dtype=dtype,
    )
    params: Dict[str, Any] = {
        "wte": sd["transformer.wte.weight"],
        "wpe": sd["transformer.wpe.weight"],
        "ln_f": {
            "scale": sd["transformer.ln_f.weight"],
            "bias": sd["transformer.ln_f.bias"],
        },
    }
    layers = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        c_attn_w = sd[p + "attn.c_attn.weight"]  # (E, 3E) Conv1D layout
        c_attn_b = sd[p + "attn.c_attn.bias"]
        qw, kw, vw = np.split(c_attn_w, 3, axis=1)
        qb, kb, vb = np.split(c_attn_b, 3, axis=0)
        layers.append(
            {
                "ln_1": {"scale": sd[p + "ln_1.weight"], "bias": sd[p + "ln_1.bias"]},
                "ln_2": {"scale": sd[p + "ln_2.weight"], "bias": sd[p + "ln_2.bias"]},
                "attn": {
                    "q_proj": {"kernel": qw, "bias": qb},
                    "k_proj": {"kernel": kw, "bias": kb},
                    "v_proj": {"kernel": vw, "bias": vb},
                    "out_proj": {
                        "kernel": sd[p + "attn.c_proj.weight"],
                        "bias": sd[p + "attn.c_proj.bias"],
                    },
                },
                "mlp": {
                    "c_fc": {
                        "kernel": sd[p + "mlp.c_fc.weight"],
                        "bias": sd[p + "mlp.c_fc.bias"],
                    },
                    "c_proj": {
                        "kernel": sd[p + "mlp.c_proj.weight"],
                        "bias": sd[p + "mlp.c_proj.bias"],
                    },
                },
            }
        )
    # Stack per-layer trees along the scan axis: h/block/... -> (L, ...).
    params["h"] = {
        "block": jax.tree_util.tree_map(lambda *xs: np.stack(xs, 0), *layers)
    }
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), params)
    return GPT2LMHead(cfg), {"params": params}, cfg
