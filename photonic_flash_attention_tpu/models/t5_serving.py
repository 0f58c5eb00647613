"""Functional T5 (encoder-decoder) serving path (VERDICT r3 #9).

T5 is a first-class family in the reference's converter
(reference integration/pytorch/convert.py:174-202) and its headline
benchmark (reference README.md:662-663); this module makes it
*servable* through the continuous-batching engine:

* **prefill** = one encoder forward over the prompt + per-decoder-layer
  cross-attention K/V projection into a PINNED per-slot buffer (encoder
  keys never change during decode — paging them would buy nothing and
  cost a gather per step) + the decoder's start-token step writing the
  first self-attention KV into the paged pool;
* **decode** = paged decoder self-attention through the same fused
  write+attend kernel the GPT-2/Llama families use, with the T5
  relative-position bias streamed IN-KERNEL per kv block
  (ops/paged.py ``token_bias``), plus dense cross-attention over the
  pinned encoder KV.

Operates directly on the flax param tree of
:class:`..models.t5.T5ForConditionalGeneration` (``variables["params"]``)
— layers are already stacked by ``nn.scan``, so the lax.scan layer loop
consumes them natively.

Cache layout: decoder self-attn pools (L, H, num_pages, page, D) —
token-major, see ops/paged.py; cross buffers
(L, max_batch, H, D, enc_max_len) — head-dim-major, so decode
cross-attention is a batched (H, D) x (H, D, S) contraction with no
transposes.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..ops.paged import paged_attention, write_tokens
from ..ops.reference import DEFAULT_MASK_VALUE
from ..ops.rel_bias import relative_position_bucket
from .t5 import T5Config

DECODER_START_TOKEN_ID = 0  # T5 convention: pad token starts decoding


def _rms(x, scale, eps):
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype) * scale.astype(
        x.dtype
    )


def _dense(x, kernel):
    return jnp.dot(x, kernel.astype(x.dtype))


def create_t5_pages(
    cfg: T5Config,
    num_pages: int,
    page_size: int,
    dtype=jnp.bfloat16,
    *,
    max_batch: int = 8,
    enc_max_len: int = 512,
) -> Dict[str, jax.Array]:
    """Decoder self-attn page pools + pinned per-slot cross-KV buffers."""
    L, H, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    shape = (L, H, num_pages, page_size, D)
    quant = dtype == jnp.int8
    sshape = (L, H, num_pages, page_size)
    dummy = jnp.zeros((L, 1, 1, 1), jnp.float32)
    return {
        "k": jnp.zeros(shape, dtype),
        "v": jnp.zeros(shape, dtype),
        "ks": jnp.ones(sshape, jnp.float32) if quant else dummy,
        "vs": jnp.ones(sshape, jnp.float32) if quant else jnp.zeros_like(dummy),
        "cross_k": jnp.zeros((L, max_batch, H, D, enc_max_len), cfg.dtype),
        "cross_v": jnp.zeros((L, max_batch, H, D, enc_max_len), cfg.dtype),
        "enc_len": jnp.zeros((max_batch,), jnp.int32),
    }


def _ffn(x, p_l, cfg: T5Config):
    h = _rms(x, p_l["ffn_ln"]["scale"], cfg.layer_norm_epsilon)
    m = p_l["ffn"]
    if cfg.feed_forward_proj == "gated-gelu":
        inner = jax.nn.gelu(
            _dense(h, m["wi_0"]["kernel"]), approximate=False
        ) * _dense(h, m["wi_1"]["kernel"])
    else:
        inner = jax.nn.relu(_dense(h, m["wi"]["kernel"]))
    return x + _dense(inner, m["wo"]["kernel"])


def _encoder_forward(params, cfg: T5Config, enc_ids, enc_len):
    """Bidirectional encoder with dense rel bias + padding mask."""
    p = params["model"]
    b, s = enc_ids.shape
    H, D = cfg.num_heads, cfg.d_kv
    x = p["shared"].astype(cfg.dtype)[enc_ids]
    table = p["encoder"]["rel_bias"]["rel_embedding"]  # (nb, H)
    pos = jnp.arange(s, dtype=jnp.int32)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None],
        bidirectional=True,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance,
    )
    bias = table[buckets].transpose(2, 0, 1)[None]  # (1, H, S, S) fp32
    keep = pos[None, :] < enc_len[:, None]  # (B, S)
    bias = bias + jnp.where(keep, 0.0, DEFAULT_MASK_VALUE)[:, None, None, :]

    def layer(x, p_l):
        h = _rms(x, p_l["self_attn_ln"]["scale"], cfg.layer_norm_epsilon)
        a = p_l["self_attn"]
        q = _dense(h, a["q"]["kernel"]).reshape(b, s, H, D)
        k = _dense(h, a["k"]["kernel"]).reshape(b, s, H, D)
        v = _dense(h, a["v"]["kernel"]).reshape(b, s, H, D)
        sc = jnp.einsum(
            "bqhd,bkhd->bhqk", q.astype(jnp.float32), k.astype(jnp.float32)
        ) + bias  # T5: unscaled scores
        w = jax.nn.softmax(sc, axis=-1)
        out = jnp.einsum("bhqk,bkhd->bqhd", w, v.astype(jnp.float32))
        out = out.astype(x.dtype).reshape(b, s, H * D)
        x = x + _dense(out, a["o"]["kernel"])
        return _ffn(x, p_l, cfg), None

    x, _ = jax.lax.scan(layer, x, p["encoder"]["blocks"]["block"])
    return _rms(x, p["encoder"]["final_ln"]["scale"], cfg.layer_norm_epsilon)


def _t5_decode_core(
    params,
    cfg: T5Config,
    input_ids,  # (B,)
    positions,  # (B,) decoder position of the consumed token
    pages_tree,
    flat_slots,  # (B,)
    lengths,  # (B,) decoder length INCLUDING the current token
    page_tables,  # (B, pages_per_seq)
    quantized: bool,
    cross_rows,  # (B,) int32 slot row per batch element
):
    p = params["model"]
    b = input_ids.shape[0]
    H, D = cfg.num_heads, cfg.d_kv
    eps = cfg.layer_norm_epsilon
    page_size = pages_tree["k"].shape[-2]
    s_cap = page_tables.shape[1] * page_size
    x = p["shared"].astype(cfg.dtype)[input_ids]  # (B, E)

    # Decoder self-attn relative bias for every potential key position —
    # (B, H, S_cap) fp32, streamed in-kernel per kv block (token_bias).
    table = p["decoder"]["rel_bias"]["rel_embedding"]  # (nb, H)
    k_pos = jnp.arange(s_cap, dtype=jnp.int32)
    buckets = relative_position_bucket(
        k_pos[None, :] - positions[:, None],
        bidirectional=False,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance,
    )  # (B, S_cap)
    self_bias = table[buckets].transpose(0, 2, 1).astype(jnp.float32)

    enc_len = pages_tree["enc_len"][cross_rows]  # (B,)
    s_enc = pages_tree["cross_k"].shape[-1]
    enc_keep = jnp.arange(s_enc, dtype=jnp.int32)[None] < enc_len[:, None]

    def layer(carry, xs):
        x, pool = carry
        p_l, lyr = xs
        # -- paged self-attention (scattered write, in-kernel bias) --
        h = _rms(x, p_l["self_attn_ln"]["scale"], eps)
        a = p_l["self_attn"]
        q = _dense(h, a["q"]["kernel"]).reshape(b, H, D)
        k = _dense(h, a["k"]["kernel"]).reshape(b, H, D)
        v = _dense(h, a["v"]["kernel"]).reshape(b, H, D)
        pool = write_tokens(pool, k, v, flat_slots, lyr, quantized)
        attn = paged_attention(
            q,
            pool["k"],
            pool["v"],
            lengths,
            page_tables,
            pool["ks"] if quantized else None,
            pool["vs"] if quantized else None,
            sm_scale=1.0,  # T5: unscaled scores
            layer=lyr,
            token_bias=self_bias,
        )
        x = x + _dense(attn.reshape(b, H * D).astype(x.dtype), a["o"]["kernel"])

        # -- cross-attention over the pinned encoder KV --
        h2 = _rms(x, p_l["cross_attn_ln"]["scale"], eps)
        c = p_l["cross_attn"]
        q2 = _dense(h2, c["q"]["kernel"]).reshape(b, H, D).astype(jnp.float32)
        ck = jax.lax.dynamic_index_in_dim(
            pool["cross_k"], lyr, 0, keepdims=False
        )[cross_rows]  # (B, H, D, S_enc)
        cv = jax.lax.dynamic_index_in_dim(
            pool["cross_v"], lyr, 0, keepdims=False
        )[cross_rows]
        s2 = jnp.einsum("bhd,bhds->bhs", q2, ck.astype(jnp.float32))
        s2 = jnp.where(enc_keep[:, None], s2, DEFAULT_MASK_VALUE)
        w2 = jax.nn.softmax(s2, axis=-1)
        out2 = jnp.einsum("bhs,bhds->bhd", w2, cv.astype(jnp.float32))
        x = x + _dense(
            out2.reshape(b, H * D).astype(x.dtype), c["o"]["kernel"]
        )
        return (_ffn(x, p_l, cfg), pool), None

    blocks = p["decoder"]["blocks"]["block"]
    (x, pool), _ = jax.lax.scan(
        layer,
        (x, pages_tree),
        (blocks, jnp.arange(cfg.num_decoder_layers, dtype=jnp.int32)),
    )
    x = _rms(x, p["decoder"]["final_ln"]["scale"], eps)
    if cfg.tie_word_embeddings:
        x = x * (cfg.d_model ** -0.5)
    logits = x @ p["shared"].astype(cfg.dtype).T
    return logits.astype(jnp.float32), pool


@functools.partial(
    jax.jit, static_argnames=("cfg", "quantized"), donate_argnames=("pages_tree",)
)
def t5_prefill_step(
    params: Dict[str, Any],
    cfg: T5Config,
    enc_ids: jax.Array,  # (1, S_pad) right-padded encoder prompt
    enc_len: jax.Array,  # (1,)
    pages_tree: Dict[str, jax.Array],
    dec0_slot: jax.Array,  # (1,) flat page slot of decoder token 0
    dec_tables: jax.Array,  # (1, pages_per_seq)
    quantized: bool,
    slot: jax.Array,  # () int32 serving slot row (cross buffers)
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Encoder forward + cross-KV pin + decoder start-token step.

    Returns the logits after consuming DECODER_START_TOKEN_ID (the
    distribution of the first generated token) and the updated pages.
    """
    p = params["model"]
    H, D = cfg.num_heads, cfg.d_kv
    enc_out = _encoder_forward(params, cfg, enc_ids, enc_len)  # (1, S, E)
    s = enc_out.shape[1]
    s_enc = pages_tree["cross_k"].shape[-1]

    def cross_proj(_, p_l):
        c = p_l["cross_attn"]
        ck = _dense(enc_out, c["k"]["kernel"]).reshape(1, s, H, D)
        cv = _dense(enc_out, c["v"]["kernel"]).reshape(1, s, H, D)
        # head-dim-major (H, D, S)
        return None, (ck[0].transpose(1, 2, 0), cv[0].transpose(1, 2, 0))

    _, (cks, cvs) = jax.lax.scan(
        cross_proj, None, p["decoder"]["blocks"]["block"]
    )  # (L, H, D, S)
    pad = s_enc - s
    if pad < 0:
        raise ValueError(
            f"encoder prompt ({s}) exceeds enc_max_len ({s_enc})"
        )
    cks = jnp.pad(cks, ((0, 0), (0, 0), (0, 0), (0, pad))).astype(cfg.dtype)
    cvs = jnp.pad(cvs, ((0, 0), (0, 0), (0, 0), (0, pad))).astype(cfg.dtype)
    pages_tree = dict(pages_tree)
    pages_tree["cross_k"] = jax.lax.dynamic_update_slice(
        pages_tree["cross_k"], cks[:, None], (0, slot, 0, 0, 0)
    )
    pages_tree["cross_v"] = jax.lax.dynamic_update_slice(
        pages_tree["cross_v"], cvs[:, None], (0, slot, 0, 0, 0)
    )
    pages_tree["enc_len"] = jax.lax.dynamic_update_slice(
        pages_tree["enc_len"], enc_len.astype(jnp.int32), (slot,)
    )

    logits, pages_tree = _t5_decode_core(
        params,
        cfg,
        jnp.full((1,), DECODER_START_TOKEN_ID, jnp.int32),
        jnp.zeros((1,), jnp.int32),  # decoder position 0
        pages_tree,
        dec0_slot.astype(jnp.int32),
        jnp.ones((1,), jnp.int32),  # decoder length 1
        dec_tables,
        quantized,
        jnp.reshape(slot, (1,)).astype(jnp.int32),
    )
    return logits, pages_tree


@functools.partial(
    jax.jit, static_argnames=("cfg", "quantized"), donate_argnames=("pages_tree",)
)
def t5_decode_step(
    params: Dict[str, Any],
    cfg: T5Config,
    input_ids: jax.Array,  # (B,)
    positions: jax.Array,  # (B,) decoder position of the consumed token
    pages_tree: Dict[str, jax.Array],
    flat_slots: jax.Array,  # (B,)
    lengths: jax.Array,  # (B,) decoder length INCLUDING current
    page_tables: jax.Array,  # (B, pages_per_seq)
    quantized: bool,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """One decode token per slot; batch row b reads cross buffers row b
    (the serving engine's decode batch is slot-ordered)."""
    b = input_ids.shape[0]
    return _t5_decode_core(
        params,
        cfg,
        input_ids,
        positions,
        pages_tree,
        flat_slots,
        lengths,
        page_tables,
        quantized,
        jnp.arange(b, dtype=jnp.int32),
    )
