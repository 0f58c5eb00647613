"""Functional Llama serving path: paged-KV prefill + decode steps.

The Llama counterpart of :mod:`.gpt2_serving` — same cache layout and
step structure, with the family's architectural differences:

* RMSNorm (no bias), bias-free projections, SwiGLU MLP,
* rotary position embeddings applied to q/k inside the step (positions
  come from the scheduler, so decode steps rotate by the token's true
  absolute position),
* **GQA-sized page pool**: cache arrays carry ``num_key_value_heads``
  (not ``num_attention_heads``) — the KV memory saving GQA exists for —
  and the paged-attention read broadcasts query-head groups natively.

Cache layout: k/v (L, Hkv, num_pages, page_size, D) — token-major, see
ops/paged.py — with optional per-token INT8 scales. Host-side page
tables live in the serving engine.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..ops.flash import flash_attention
from ..ops.paged import gather_history, paged_attention, write_tokens
from .llama import LlamaConfig, apply_rope, lm_head, rope_cos_sin


def _rms_norm(x, scale, eps):
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps) * scale).astype(x.dtype)


def _dense(x, kernel):
    return jnp.dot(x, kernel.astype(x.dtype))


def create_llama_pages(
    cfg: LlamaConfig, num_pages: int, page_size: int, dtype=jnp.bfloat16
) -> Dict[str, jax.Array]:
    """Page pool scan-tree for Llama (Hkv heads)."""
    shape = (
        cfg.num_hidden_layers,
        cfg.num_key_value_heads,
        num_pages,
        page_size,
        cfg.head_dim,
    )
    quant = dtype == jnp.int8
    sshape = (cfg.num_hidden_layers, cfg.num_key_value_heads, num_pages, page_size)
    dummy = jnp.zeros((cfg.num_hidden_layers, 1, 1, 1), jnp.float32)
    return {
        "k": jnp.zeros(shape, dtype),
        "v": jnp.zeros(shape, dtype),
        "ks": jnp.ones(sshape, jnp.float32) if quant else dummy,
        "vs": jnp.ones(sshape, jnp.float32) if quant else jnp.zeros_like(dummy),
    }


@functools.partial(
    jax.jit, static_argnames=("cfg", "quantized"), donate_argnames=("pages_tree",)
)
def llama_prefill_step(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    input_ids: jax.Array,  # (B, S) right-padded
    prompt_lengths: jax.Array,  # (B,)
    pages_tree: Dict[str, jax.Array],
    flat_slots: jax.Array,  # (B, S) int32 flat page slots
    quantized: bool,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Prompt forward + cache fill. Returns (last-token logits, pages)."""
    b, s = input_ids.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    cos, sin = rope_cos_sin(positions, d, cfg.rope_theta)
    x = params["embed_tokens"].astype(cfg.dtype)[input_ids]
    blk = params["layers"]["layer"]

    def layer(carry, xs):
        # Full pool as CARRY (see gpt2_serving.prefill_step rationale).
        x, pool = carry
        p_l, lyr = xs
        h_in = _rms_norm(x, p_l["input_ln"]["scale"], eps)
        a = p_l["attn"]
        q = _dense(h_in, a["q_proj"]["kernel"]).reshape(b, s, hq, d)
        k = _dense(h_in, a["k_proj"]["kernel"]).reshape(b, s, hkv, d)
        v = _dense(h_in, a["v_proj"]["kernel"]).reshape(b, s, hkv, d)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        pool = write_tokens(
            pool,
            k.reshape(b * s, hkv, d),
            v.reshape(b * s, hkv, d),
            flat_slots.reshape(b * s),
            lyr,
            quantized,
        )
        attn = flash_attention(q, k, v, causal=True)  # native GQA
        attn = _dense(attn.reshape(b, s, hq * d), a["o_proj"]["kernel"])
        x = x + attn
        h2 = _rms_norm(x, p_l["post_attn_ln"]["scale"], eps)
        m = p_l["mlp"]
        gate = jax.nn.silu(_dense(h2, m["gate_proj"]["kernel"]))
        up = _dense(h2, m["up_proj"]["kernel"])
        return (x + _dense(gate * up, m["down_proj"]["kernel"]), pool), None

    (x, new_cache), _ = jax.lax.scan(
        layer,
        (x, pages_tree),
        (blk, jnp.arange(cfg.num_hidden_layers, dtype=jnp.int32)),
    )
    x = _rms_norm(x, params["norm"]["scale"], eps)
    idx = jnp.clip(prompt_lengths - 1, 0, s - 1)
    x_last = jnp.take_along_axis(x, idx[:, None, None], axis=1)[:, 0]
    logits = lm_head(x_last, params, cfg)
    return logits.astype(jnp.float32), new_cache


@functools.partial(
    jax.jit, static_argnames=("cfg", "quantized"), donate_argnames=("pages_tree",)
)
def llama_decode_step(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    input_ids: jax.Array,  # (B,)
    positions: jax.Array,  # (B,)
    pages_tree: Dict[str, jax.Array],
    flat_slots: jax.Array,  # (B,)
    lengths: jax.Array,  # (B,)
    page_tables: jax.Array,  # (B, pages_per_seq)
    quantized: bool,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """One decode token per sequence. Returns (logits (B, V), new pages).

    Full-pool carry + scattered token write + layer-indexed paged
    attention — same structure and rationale as gpt2_serving.decode_step.
    """
    b = input_ids.shape[0]
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    cos, sin = rope_cos_sin(positions[:, None], d, cfg.rope_theta)  # (B,1,D)
    x = params["embed_tokens"].astype(cfg.dtype)[input_ids]  # (B, E)
    blk = params["layers"]["layer"]

    def layer(carry, xs):
        x, pool = carry
        p_l, lyr = xs
        h_in = _rms_norm(x, p_l["input_ln"]["scale"], eps)
        a = p_l["attn"]
        q = _dense(h_in, a["q_proj"]["kernel"]).reshape(b, 1, hq, d)
        k = _dense(h_in, a["k_proj"]["kernel"]).reshape(b, 1, hkv, d)
        v = _dense(h_in, a["v_proj"]["kernel"]).reshape(b, 1, hkv, d)
        q = apply_rope(q, cos, sin)[:, 0]  # (B, Hq, D)
        k = apply_rope(k, cos, sin)[:, 0]  # (B, Hkv, D)
        v = v[:, 0]
        pool = write_tokens(pool, k, v, flat_slots, lyr, quantized)
        attn = paged_attention(
            q,
            pool["k"],
            pool["v"],
            lengths,
            page_tables,
            pool["ks"] if quantized else None,
            pool["vs"] if quantized else None,
            layer=lyr,
        )  # (B, Hq, D)
        attn = _dense(attn.reshape(b, hq * d).astype(x.dtype), a["o_proj"]["kernel"])
        x = x + attn
        h2 = _rms_norm(x, p_l["post_attn_ln"]["scale"], eps)
        m = p_l["mlp"]
        gate = jax.nn.silu(_dense(h2, m["gate_proj"]["kernel"]))
        up = _dense(h2, m["up_proj"]["kernel"])
        return (x + _dense(gate * up, m["down_proj"]["kernel"]), pool), None

    (x, new_cache), _ = jax.lax.scan(
        layer,
        (x, pages_tree),
        (blk, jnp.arange(cfg.num_hidden_layers, dtype=jnp.int32)),
    )
    x = _rms_norm(x, params["norm"]["scale"], eps)
    logits = lm_head(x, params, cfg)
    return logits.astype(jnp.float32), new_cache


@functools.partial(
    jax.jit, static_argnames=("cfg", "quantized", "s_hist"), donate_argnames=("pages_tree",)
)
def llama_prefill_chunk_step(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    input_ids: jax.Array,  # (B, C) chunk tokens, right-padded
    chunk_start: jax.Array,  # (B,) global position of chunk token 0
    chunk_lens: jax.Array,  # (B,) valid tokens in this chunk
    pages_tree: Dict[str, jax.Array],
    flat_slots: jax.Array,  # (B, C)
    page_tables: jax.Array,  # (B, pages_per_seq)
    quantized: bool,
    s_hist: int,  # static history window (tokens; page multiple)
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """One chunk of an incremental (chunked) Llama prefill.

    Same structure as :func:`.gpt2_serving.prefill_chunk_step` (history
    gather from pages + one flash call over [history || chunk] with
    cross-length causal and a dead-tail k_bias), with the family's
    differences: RoPE rotates the chunk's q/k by their TRUE absolute
    positions, and the history K gathered from the pool is already
    rotated (K is stored post-RoPE), so no re-rotation is needed. GQA:
    the gathered history carries Hkv heads; the flash kernel broadcasts
    query-head groups natively.
    """
    from ..ops.reference import DEFAULT_MASK_VALUE

    b, c = input_ids.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    page = pages_tree["k"].shape[-2]
    n_hist_pages = s_hist // page
    positions = chunk_start[:, None] + jnp.arange(c, dtype=jnp.int32)[None]
    cos, sin = rope_cos_sin(positions, d, cfg.rope_theta)
    x = params["embed_tokens"].astype(cfg.dtype)[input_ids]
    blk = params["layers"]["layer"]

    hist_col = jnp.arange(s_hist, dtype=jnp.int32)[None]
    hist_dead = hist_col >= chunk_start[:, None]
    chunk_col = jnp.arange(c, dtype=jnp.int32)[None]
    chunk_dead = chunk_col >= chunk_lens[:, None]
    dead = jnp.concatenate([hist_dead, chunk_dead], axis=1)
    k_bias = jnp.where(dead, jnp.float32(DEFAULT_MASK_VALUE), 0.0)

    def layer(carry, xs):
        x, pool = carry
        p_l, lyr = xs
        h_in = _rms_norm(x, p_l["input_ln"]["scale"], eps)
        a = p_l["attn"]
        q = _dense(h_in, a["q_proj"]["kernel"]).reshape(b, c, hq, d)
        k = _dense(h_in, a["k_proj"]["kernel"]).reshape(b, c, hkv, d)
        v = _dense(h_in, a["v_proj"]["kernel"]).reshape(b, c, hkv, d)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if n_hist_pages > 0:
            k_hist, v_hist = gather_history(
                pool, page_tables, lyr, n_hist_pages, quantized
            )
            k_cat = jnp.concatenate([k_hist.astype(q.dtype), k], axis=1)
            v_cat = jnp.concatenate([v_hist.astype(q.dtype), v], axis=1)
        else:
            k_cat, v_cat = k, v
        pool = write_tokens(
            pool,
            k.reshape(b * c, hkv, d),
            v.reshape(b * c, hkv, d),
            flat_slots.reshape(b * c),
            lyr,
            quantized,
        )
        attn = flash_attention(q, k_cat, v_cat, causal=True, k_bias=k_bias)
        attn = _dense(attn.reshape(b, c, hq * d), a["o_proj"]["kernel"])
        x = x + attn
        h2 = _rms_norm(x, p_l["post_attn_ln"]["scale"], eps)
        m = p_l["mlp"]
        gate = jax.nn.silu(_dense(h2, m["gate_proj"]["kernel"]))
        up = _dense(h2, m["up_proj"]["kernel"])
        return (x + _dense(gate * up, m["down_proj"]["kernel"]), pool), None

    (x, new_cache), _ = jax.lax.scan(
        layer,
        (x, pages_tree),
        (blk, jnp.arange(cfg.num_hidden_layers, dtype=jnp.int32)),
    )
    x = _rms_norm(x, params["norm"]["scale"], eps)
    idx = jnp.clip(chunk_lens - 1, 0, c - 1)
    x_last = jnp.take_along_axis(x, idx[:, None, None], axis=1)[:, 0]
    logits = lm_head(x_last, params, cfg)
    return logits.astype(jnp.float32), new_cache
