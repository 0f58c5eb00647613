"""Paged-attention decode over the KV page pool.

One query token per sequence attends over its pages of a (possibly INT8)
KV pool. Decode is bound by memory: the kernel's job is to read each
cached byte once.

Page layout: **token-major** ``(Hkv, P, page_size, head_dim)``, with an
optional leading layer axis ``(L, Hkv, P, page_size, head_dim)`` for the
serving pools that hold every layer in one array. INT8 pools carry
per-token fp32 scales ``([L,] Hkv, P, page_size)``.

* ``paged_attention`` — Pallas kernel on the Triton route. One program
  per (sequence, KV head, split of the page list): it loads its own page
  ids, gathers ``block_tokens`` cached rows per step, dequantizes INT8 in
  registers, and keeps an online softmax for the query heads of its KV
  head (GQA). The splits let a small batch fill the card; their partial
  results merge by logsumexp in XLA. The layer index is an operand, so the
  kernel reads the multi-layer pool in place. ``token_bias`` adds a
  per-(head, key token) score bias (T5's relative bias at decode).
* ``paged_attention_xla`` — gather-based XLA version: the plain reference
  and the oracle of the tests.
* ``write_tokens`` — the K/V write of a step as one XLA scatter into the
  pool (in place when the pool is donated or carried through a scan).

Shapes:
  q:            (B, Hq, D)           one token per sequence
  lengths:      (B,) int32           tokens valid per sequence
  page_indices: (B, pages_per_seq) int32
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .pallas_utils import cdiv, next_pow2, resolve_interpret
from .reference import DEFAULT_MASK_VALUE

INT8_MAX = 127.0
LOG2E = math.log2(math.e)
#: SMs of the card the split count aims to fill twice over.
_TARGET_PROGRAMS = 264


def _layer_slice(x: Optional[jax.Array], layer) -> Optional[jax.Array]:
    if x is None:
        return None
    return lax.dynamic_index_in_dim(x, jnp.reshape(layer, ()), 0, keepdims=False)


def paged_attention_xla(
    q: jax.Array,
    k_pages: jax.Array,
    v_pages: jax.Array,
    lengths: jax.Array,
    page_indices: jax.Array,
    k_scales: Optional[jax.Array] = None,
    v_scales: Optional[jax.Array] = None,
    *,
    sm_scale: Optional[float] = None,
    layer: Optional[jax.Array] = None,
    token_bias: Optional[jax.Array] = None,
) -> jax.Array:
    """Gather-based paged attention (XLA). Returns (B, Hq, D)."""
    if k_pages.ndim == 5:
        k_pages, v_pages = _layer_slice(k_pages, layer), _layer_slice(v_pages, layer)
        k_scales, v_scales = _layer_slice(k_scales, layer), _layer_slice(v_scales, layer)
    b, hq, d = q.shape
    hkv, _, page, _ = k_pages.shape
    group = hq // hkv
    s_total = page_indices.shape[1] * page
    scale = sm_scale if sm_scale is not None else d ** -0.5

    def gather(pages, scales):
        g = pages[:, page_indices]  # (Hkv, B, pps, page, D)
        g = g.transpose(1, 0, 2, 3, 4).reshape(b, hkv, s_total, d)
        g = g.astype(jnp.float32)
        if scales is not None:
            sc = scales[:, page_indices].transpose(1, 0, 2, 3)
            g = g * sc.reshape(b, hkv, s_total, 1)
        return g

    k = gather(k_pages, k_scales)
    v = gather(v_pages, v_scales)
    qf = q.astype(jnp.float32).reshape(b, hkv, group, d) * scale
    s = jnp.einsum("bhgd,bhsd->bhgs", qf, k)
    if token_bias is not None:
        s = s + _fit_bias(token_bias, s_total).reshape(b, hkv, group, s_total)
    pos = jnp.arange(s_total, dtype=jnp.int32)
    valid = pos[None] < lengths[:, None]
    s = jnp.where(valid[:, None, None], s, DEFAULT_MASK_VALUE)
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhgs,bhsd->bhgd", p, v)
    return o.reshape(b, hq, d).astype(q.dtype)


def _fit_bias(token_bias: jax.Array, s_cap: int) -> jax.Array:
    tb = token_bias.astype(jnp.float32)
    if tb.shape[-1] < s_cap:
        return jnp.pad(tb, ((0, 0), (0, 0), (0, s_cap - tb.shape[-1])))
    return tb[..., :s_cap]


# ---------------------------------------------------------------------------
# Triton kernel
# ---------------------------------------------------------------------------


def _paged_kernel(
    layer_ref, len_ref, pt_ref, q_ref, k_ref, v_ref, ks_ref, vs_ref, tb_ref,
    o_ref, m_ref, l_ref, *, sm_scale: float, page: int, block_tokens: int,
    pages_per_split: int, num_kv_heads: int, num_pages: int,
):
    h, sp = pl.program_id(1), pl.program_id(2)
    length = len_ref[0]
    # Row of page 0 of this (layer, KV head) in the flattened pool.
    base = (layer_ref[0] * num_kv_heads + h) * num_pages
    first_tok = sp * pages_per_split * page
    stop_tok = jnp.minimum(length, first_tok + pages_per_split * page)
    n_blocks = lax.div(
        jnp.maximum(stop_tok - first_tok, 0) + block_tokens - 1, block_tokens
    )
    q = q_ref[...]
    g, d = q.shape
    scale2 = sm_scale * LOG2E
    lane = jnp.arange(block_tokens, dtype=jnp.int32)

    def body(j, carry):
        acc, m, l = carry
        tok = first_tok + j * block_tokens + lane
        # One row gather per tile: page id of each token, then its row.
        rows = (pt_ref[tok // page] + base) * page + tok % page
        k = k_ref[rows, :]
        v = v_ref[rows, :]
        s = pl.dot(q, k.astype(q.dtype), trans_b=True) * scale2
        if ks_ref is not None:
            s = s * ks_ref[rows][None, :]
        if tb_ref is not None:
            s = s + tb_ref[:, pl.ds(first_tok + j * block_tokens, block_tokens)] * LOG2E
        valid = (tok < stop_tok)[None, :]
        s = jnp.where(valid, s, DEFAULT_MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.where(valid, jnp.exp2(s - m_new[:, None]), 0.0)
        alpha = jnp.exp2(m - m_new)
        l = l * alpha + jnp.sum(p, axis=1)
        if vs_ref is not None:
            p = p * vs_ref[rows][None, :]
        acc = acc * alpha[:, None] + pl.dot(p.astype(q.dtype), v.astype(q.dtype))
        return acc, m_new, l

    acc, m, l = lax.fori_loop(
        0, n_blocks, body,
        (
            jnp.zeros((g, d), jnp.float32),
            jnp.full((g,), DEFAULT_MASK_VALUE, jnp.float32),
            jnp.zeros((g,), jnp.float32),
        ),
    )
    o_ref[...] = acc
    m_ref[...] = m
    l_ref[...] = l


def _splits(batch: int, num_kv_heads: int, num_blocks: int) -> int:
    """Splits of the page list so that the grid fills the card twice."""
    want = cdiv(_TARGET_PROGRAMS, max(1, batch * num_kv_heads))
    return max(1, min(next_pow2(want), num_blocks))


def paged_attention(
    q: jax.Array,
    k_pages: jax.Array,
    v_pages: jax.Array,
    lengths: jax.Array,
    page_indices: jax.Array,
    k_scales: Optional[jax.Array] = None,
    v_scales: Optional[jax.Array] = None,
    *,
    sm_scale: Optional[float] = None,
    layer: Optional[jax.Array] = None,
    token_bias: Optional[jax.Array] = None,
    block_tokens: Optional[int] = None,
    num_splits: Optional[int] = None,
    interpret: Optional[bool] = None,
) -> jax.Array:
    """Paged decode attention. Returns (B, Hq, D) in q.dtype.

    Products run in q's dtype on the tensor cores: bf16, or float32 at
    the default matmul precision (TF32 on the GPU, exact in the CPU
    interpreter); int8 pages are dequantized to it in registers.

    Pools are ``(Hkv, P, page, D)`` or, with ``layer``, ``(L, Hkv, P,
    page, D)``; scales drop the last axis. ``token_bias`` is (B, Hq, S)
    fp32 over token positions (zero-padded or cut to the page-table
    capacity; columns past ``lengths`` are masked anyway).
    """
    if k_pages.ndim == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
        if k_scales is not None:
            k_scales, v_scales = k_scales[None], v_scales[None]
        layer = jnp.zeros((1,), jnp.int32)
    if layer is None:
        raise ValueError("a layered pool (rank 5) needs its layer index")
    b, hq, d = q.shape
    n_layers, hkv, num_pages, page, _ = k_pages.shape
    if hq % hkv:
        raise ValueError(f"Hq {hq} not divisible by Hkv {hkv} (GQA)")
    if page < 1 or page & (page - 1):
        raise ValueError(f"page_size must be a power of two, got {page}")
    group = hq // hkv
    pps = page_indices.shape[1]
    bt = block_tokens or 128
    if bt & (bt - 1) or bt < 16:
        raise ValueError(f"block_tokens must be a power of two >= 16, got {bt}")
    ppb = max(1, bt // page)  # pages per tile (a tile may be part of a page)
    nblk = cdiv(pps, ppb)
    splits = num_splits or _splits(b, hkv, nblk)
    pages_per_split = cdiv(nblk, splits) * ppb
    pps_p = splits * pages_per_split
    scale = sm_scale if sm_scale is not None else d ** -0.5
    quantized = k_scales is not None

    gp = max(16, next_pow2(group))
    dp = max(16, next_pow2(d))
    qg = q.reshape(b, hkv, group, d)
    qg = jnp.pad(qg, ((0, 0), (0, 0), (0, gp - group), (0, dp - d)))
    pt = jnp.pad(page_indices.astype(jnp.int32), ((0, 0), (0, pps_p - pps)))
    # Flattened (rows, D) views of the pool: a free reshape, no copy.
    flat = (n_layers * hkv * num_pages * page, d)
    kf, vf = k_pages.reshape(flat), v_pages.reshape(flat)
    if dp != d:
        kf = jnp.pad(kf, ((0, 0), (0, dp - d)))
        vf = jnp.pad(vf, ((0, 0), (0, dp - d)))
    ksf = vsf = ks_spec = None
    full2 = pl.BlockSpec(kf.shape, lambda bi, h, sp: (0, 0))
    if quantized:
        ksf = k_scales.reshape(flat[:1]).astype(jnp.float32)
        vsf = v_scales.reshape(flat[:1]).astype(jnp.float32)
        ks_spec = pl.BlockSpec(ksf.shape, lambda bi, h, sp: (0,))
    tb = tb_spec = None
    if token_bias is not None:
        tb = _fit_bias(token_bias, pps_p * page).reshape(b, hkv, group, pps_p * page)
        tb = jnp.pad(tb, ((0, 0), (0, 0), (0, gp - group), (0, 0)))
        tb_spec = pl.BlockSpec(
            (None, None, gp, pps_p * page), lambda bi, h, sp: (bi, h, 0, 0)
        )
    part = lambda bi, h, sp: (sp, bi, h, 0)  # noqa: E731
    kernel = functools.partial(
        _paged_kernel, sm_scale=float(scale), page=page, block_tokens=bt,
        pages_per_split=pages_per_split, num_kv_heads=hkv, num_pages=num_pages,
    )
    o, m, l = pl.pallas_call(
        kernel,
        grid=(b, hkv, splits),
        in_specs=[
            pl.BlockSpec((1,), lambda bi, h, sp: (0,)),
            pl.BlockSpec((None, 1), lambda bi, h, sp: (bi, 0)),
            pl.BlockSpec((None, pps_p), lambda bi, h, sp: (bi, 0)),
            pl.BlockSpec((None, None, gp, dp), lambda bi, h, sp: (bi, h, 0, 0)),
            full2, full2, ks_spec, ks_spec, tb_spec,
        ],
        out_specs=[
            pl.BlockSpec((None, None, None, gp, dp), lambda bi, h, sp: (sp, bi, h, 0, 0)),
            pl.BlockSpec((None, None, None, gp), part),
            pl.BlockSpec((None, None, None, gp), part),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((splits, b, hkv, gp, dp), jnp.float32),
            jax.ShapeDtypeStruct((splits, b, hkv, gp), jnp.float32),
            jax.ShapeDtypeStruct((splits, b, hkv, gp), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=resolve_interpret(interpret),
        backend="triton",
        name="pfa_paged_decode",
    )(
        jnp.reshape(layer, (1,)).astype(jnp.int32),
        lengths.astype(jnp.int32).reshape(b, 1),
        pt, qg, kf, vf, ksf, vsf, tb,
    )
    # Merge the splits (base-2 running max, natural output).
    m_max = jnp.max(m, axis=0)
    w = jnp.exp2(m - m_max[None])
    l_tot = jnp.sum(l * w, axis=0)
    o = jnp.sum(o * w[..., None], axis=0) / jnp.where(l_tot == 0.0, 1.0, l_tot)[..., None]
    return o[:, :, :group, :d].reshape(b, hq, d).astype(q.dtype)


# ---------------------------------------------------------------------------
# Pool writes
# ---------------------------------------------------------------------------


def quantize_tokens(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-token symmetric int8. x: (..., D) -> (int8 payload, fp32 scales)."""
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
    scale = jnp.where(absmax == 0.0, 1.0, absmax / INT8_MAX)
    payload = jnp.clip(
        jnp.round(x.astype(jnp.float32) / scale[..., None]), -INT8_MAX, INT8_MAX
    ).astype(jnp.int8)
    return payload, scale


def write_tokens(
    pool: Dict[str, jax.Array],
    k_new: jax.Array,  # (N, Hkv, D)
    v_new: jax.Array,
    flat_slots: jax.Array,  # (N,) page * page_size + offset
    layer: jax.Array,  # scalar layer index
    quantized: bool,
) -> Dict[str, jax.Array]:
    """Scatter N tokens' K/V into the multi-layer pool dict.

    ``pool`` holds ``k``/``v`` (L, Hkv, P, page, D) and, when quantized,
    ``ks``/``vs`` (L, Hkv, P, page). Each array is viewed as rows of one
    token and head (a free reshape) and written by row index, the scatter
    form XLA updates in place: indexing the 5-D pool directly makes XLA
    transpose the whole pool around the scatter.
    """
    pool = dict(pool)
    n_layers, hkv, num_pages, page, d = pool["k"].shape
    heads = jnp.arange(hkv, dtype=jnp.int32)[None, :]
    pids = (flat_slots // page).astype(jnp.int32)[:, None]
    offs = (flat_slots % page).astype(jnp.int32)[:, None]
    rows = (((layer * hkv + heads) * num_pages + pids) * page + offs).reshape(-1)

    def put(name, val, row_shape):
        arr = pool[name]
        flat = arr.reshape((-1,) + row_shape)
        val = val.reshape((-1,) + row_shape).astype(arr.dtype)
        pool[name] = flat.at[rows].set(val).reshape(arr.shape)

    if quantized:
        k8, ks = quantize_tokens(k_new)
        v8, vs = quantize_tokens(v_new)
        put("k", k8, (d,))
        put("v", v8, (d,))
        put("ks", ks, ())
        put("vs", vs, ())
    else:
        put("k", k_new, (d,))
        put("v", v_new, (d,))
    return pool


def gather_history(
    pool: Dict[str, jax.Array],
    page_tables: jax.Array,  # (B, pages_per_seq)
    layer: jax.Array,
    n_pages: int,
    quantized: bool,
) -> Tuple[jax.Array, jax.Array]:
    """Dense (B, n_pages * page, Hkv, D) K/V of each row's first pages,
    dequantized to fp32 when the pool is int8."""
    pt = page_tables[:, :n_pages]

    def gather(name, sname):
        g = pool[name][layer][:, pt]  # (Hkv, B, n, page, D)
        hkv, b, n, pg, d = g.shape
        g = g.transpose(1, 2, 3, 0, 4).reshape(b, n * pg, hkv, d)
        if quantized:
            sc = pool[sname][layer][:, pt]  # (Hkv, B, n, page)
            sc = sc.transpose(1, 2, 3, 0).reshape(b, n * pg, hkv)
            return g.astype(jnp.float32) * sc[..., None]
        return g

    return gather("k", "ks"), gather("v", "vs")
