"""Flash attention on the GPU: cuDNN for the plain cases, a Pallas kernel
on the Triton route for everything else.

``flash_attention`` chooses by what it can observe. Plain or causal
self-attention in bf16/fp16 with a head dim cuDNN takes runs on cuDNN's
fused attention (a library kernel, through ``jax.nn.dot_product_attention``
with ``implementation="cudnn"``). The rest runs on this module's kernel:

* one program per (q block, batch, head); the loop over KV blocks runs
  inside the program, bounded by causality, the window and ``kv_lens``,
  so blocks that are masked out are never loaded;
* the online softmax runs in base 2 with the scale folded into one
  multiply; the per-row max ``m``, sum ``l`` and accumulator live in
  registers;
* GQA reads the KV head ``h // group`` through the block index map;
* per-key bias, dense bias tiles, ALiBi and T5 bias (rebuilt from iota
  inside the kernel), a relative-position window and positional-hash
  dropout are applied per tile;
* the row logsumexp is written when asked for: the backward pass and ring
  attention's merge read it.

The backward pass is two more kernels of the same shape: one program per
(KV block, batch, head) for dK/dV and one per (q block, batch, head) for
dQ, recomputing probabilities from the saved logsumexp. The gradient of a
T5/ALiBi bias table runs as a blockwise XLA scan instead (``_xla_bwd``).

API shape convention: (batch, seq, num_heads, head_dim).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import platform
from .pallas_utils import dropout_keep, next_pow2, resolve_interpret, round_up
from .reference import DEFAULT_MASK_VALUE
from .rel_bias import (
    RelBias,
    bias_from_table,
    bias_table,
    rel_statics,
    relative_position_bucket,
)

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
_NO_REL = ("none", False, 0, 0)
# Masked scores in the base-2 domain; finite so that a row whose every
# score is masked keeps a finite running max.
_MASK = DEFAULT_MASK_VALUE


class _Cfg(NamedTuple):
    """Static description of one kernel call (hashable for custom_vjp)."""

    causal: bool
    sm_scale: float
    window: Optional[Tuple[Optional[int], Optional[int]]]
    rel: Tuple[str, bool, int, int]
    dropout_rate: float
    block_q: int
    block_kv: int
    interpret: bool


# ---------------------------------------------------------------------------
# Tile helpers shared by the forward and backward kernels
# ---------------------------------------------------------------------------


def _floordiv(a, b: int):
    """Floor division of a traced int32 scalar by a positive constant."""
    return jnp.where(a >= 0, lax.div(a, b), -lax.div(-a + b - 1, b))


def _kv_range(cfg: _Cfg, q_lo, q_hi, kv_off, n_kv_blocks: int, len_b):
    """KV blocks [lo, hi) that any of rows [q_lo, q_hi] (q positions) can see."""
    bk = cfg.block_kv
    lo = jnp.int32(0)
    hi = jnp.int32(n_kv_blocks)
    if cfg.causal:
        hi = jnp.minimum(hi, _floordiv(q_hi + kv_off, bk) + 1)
    if cfg.window is not None:
        w_lo, w_hi = cfg.window
        if w_lo is not None:
            lo = jnp.maximum(lo, _floordiv(q_lo + kv_off + w_lo, bk))
        if w_hi is not None:
            hi = jnp.minimum(hi, _floordiv(q_hi + kv_off + w_hi, bk) + 1)
    if len_b is not None:
        hi = jnp.minimum(hi, lax.div(len_b + bk - 1, bk))
    return lo, jnp.maximum(hi, lo)


def _q_range(cfg: _Cfg, kv_lo, kv_hi, kv_off, n_q_blocks: int):
    """q blocks [lo, hi) that can see any of columns [kv_lo, kv_hi]."""
    bq = cfg.block_q
    lo = jnp.int32(0)
    hi = jnp.int32(n_q_blocks)
    if cfg.causal:
        lo = jnp.maximum(lo, _floordiv(kv_lo - kv_off, bq))
    if cfg.window is not None:
        w_lo, w_hi = cfg.window
        if w_hi is not None:  # col - row <= w_hi  ->  row >= col - w_hi
            lo = jnp.maximum(lo, _floordiv(kv_lo - w_hi - kv_off, bq))
        if w_lo is not None:  # col - row >= w_lo  ->  row <= col - w_lo
            hi = jnp.minimum(hi, _floordiv(kv_hi - w_lo - kv_off, bq) + 1)
    return lo, jnp.maximum(hi, lo)


def _valid(cfg: _Cfg, rows, cols, kv_len: int, padded_kv: bool, len_b):
    """Boolean (rows x cols) tile of attendable positions, or None.

    ``rows`` are q positions shifted by the end-alignment offset, i.e. in
    the KV coordinate frame.
    """
    valid = None

    def _and(a, b):
        return b if a is None else jnp.logical_and(a, b)

    if padded_kv:
        valid = _and(valid, cols < kv_len)
    if len_b is not None:
        valid = _and(valid, cols < len_b)
    if cfg.causal:
        valid = _and(valid, cols <= rows)
    if cfg.window is not None:
        w_lo, w_hi = cfg.window
        rel = cols - rows
        if w_lo is not None:
            valid = _and(valid, rel >= w_lo)
        if w_hi is not None:
            valid = _and(valid, rel <= w_hi)
    return valid


def _bias_tile(cfg: _Cfg, rows, cols, kb_ref, ab_ref, tab_ref, kv_start, block_kv):
    """Additive score bias of one tile in natural-log units, or None."""
    bias = None

    def _add(a, b):
        return b if a is None else a + b

    if kb_ref is not None:
        bias = _add(bias, kb_ref[pl.ds(kv_start, block_kv)][None, :])
    if ab_ref is not None:
        bias = _add(bias, ab_ref[:, pl.ds(kv_start, block_kv)])
    kind, bidir, nb, maxd = cfg.rel
    if kind == "alibi":
        bias = _add(bias, tab_ref[0] * (cols - rows).astype(jnp.float32))
    elif kind == "t5":
        bucket = relative_position_bucket(
            cols - rows, bidirectional=bidir, num_buckets=nb, max_distance=maxd
        )
        t5 = jnp.zeros(bucket.shape, jnp.float32)
        for j in range(nb):
            t5 = jnp.where(bucket == j, tab_ref[j], t5)
        bias = _add(bias, t5)
    return bias


def _dropout(cfg: _Cfg, seed_ref, q_rows, cols, kv_len: int, bh):
    return dropout_keep(seed_ref[0], q_rows, cols, kv_len, cfg.dropout_rate, bh=bh)


def _dot(a, b, trans_b=False, trans_a=False):
    prec = lax.Precision.HIGHEST if a.dtype == jnp.float32 else None
    return pl.dot(a, b, trans_a=trans_a, trans_b=trans_b, precision=prec)


# ---------------------------------------------------------------------------
# Forward kernel
# ---------------------------------------------------------------------------


def _fwd_kernel(
    q_ref, k_ref, v_ref, lens_ref, kb_ref, ab_ref, tab_ref, seed_ref,
    o_ref, *lse_refs, cfg: _Cfg, q_len: int, kv_len: int, padded_kv: bool,
    num_heads: int,
):
    qi, b, h = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    bq, bk = cfg.block_q, cfg.block_kv
    n_kv_blocks = k_ref.shape[0] // bk
    kv_off = kv_len - q_len
    q_start = qi * bq
    len_b = lens_ref[0] if lens_ref is not None else None
    q_pos = q_start + jnp.arange(bq, dtype=jnp.int32)
    rows = (q_pos + kv_off)[:, None]
    scale2 = cfg.sm_scale * LOG2E
    q = q_ref[...]
    d = q.shape[-1]

    def tile(j, carry, masked: bool):
        acc, m, l = carry
        kv_start = j * bk
        cols = (kv_start + jnp.arange(bk, dtype=jnp.int32))[None, :]
        k = k_ref[pl.ds(kv_start, bk), :]
        s = _dot(q, k, trans_b=True) * scale2
        bias = _bias_tile(cfg, rows, cols, kb_ref, ab_ref, tab_ref, kv_start, bk)
        if bias is not None:
            s = jnp.maximum(s + bias * LOG2E, _MASK)
        valid = (
            _valid(cfg, rows, cols, kv_len, padded_kv, len_b) if masked else None
        )
        if valid is not None:
            s = jnp.where(valid, s, _MASK)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.exp2(s - m_new[:, None])
        if valid is not None:
            p = jnp.where(valid, p, 0.0)
        alpha = jnp.exp2(m - m_new)
        l = l * alpha + jnp.sum(p, axis=1)
        if cfg.dropout_rate > 0.0:
            keep = _dropout(cfg, seed_ref, q_pos[:, None], cols, kv_len,
                            b * num_heads + h)
            p = jnp.where(keep, p, 0.0) * (1.0 / (1.0 - cfg.dropout_rate))
        v = v_ref[pl.ds(kv_start, bk), :]
        acc = acc * alpha[:, None] + _dot(p.astype(v.dtype), v)
        return acc, m_new, l

    lo, hi = _kv_range(cfg, q_start, q_start + bq - 1, kv_off, n_kv_blocks, len_b)
    carry = (
        jnp.zeros((bq, d), jnp.float32),
        jnp.full((bq,), _MASK, jnp.float32),
        jnp.zeros((bq,), jnp.float32),
    )
    only_causal = (
        cfg.causal and cfg.window is None and len_b is None and not padded_kv
    )
    if only_causal:
        # Blocks wholly below the diagonal need no mask: run them first,
        # then the few that straddle it with the mask.
        mid = jnp.clip(_floordiv(q_start + kv_off + 1, bk), lo, hi)
        carry = lax.fori_loop(lo, mid, functools.partial(tile, masked=False), carry)
        carry = lax.fori_loop(mid, hi, functools.partial(tile, masked=True), carry)
    else:
        carry = lax.fori_loop(lo, hi, functools.partial(tile, masked=True), carry)
    acc, m, l = carry
    empty = l == 0.0
    l_safe = jnp.where(empty, 1.0, l)
    o_ref[...] = (acc / l_safe[:, None]).astype(o_ref.dtype)
    if lse_refs:
        lse_refs[0][...] = jnp.where(
            empty, -jnp.inf, (m + jnp.log2(l_safe)) * LN2
        )


def _num_warps(d: int) -> int:
    return 4 if d <= 64 else 8


def _pad_to(x, axis: int, size: int):
    if x.shape[axis] == size:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, size - x.shape[axis])
    return jnp.pad(x, pads)


def _head_dim(d: int) -> int:
    return max(16, next_pow2(d))


def _fwd(cfg: _Cfg, q, k, v, lens, kbias, tab, seed, dense_bias=None,
         need_lse=True):
    """Run the forward kernel. Returns (o, lse or None); lse is (B, Hq, Sq)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    bq, bk = cfg.block_q, cfg.block_kv
    sq_p, skv_p, dp = round_up(sq, bq), round_up(skv, bk), _head_dim(d)
    qp = _pad_to(_pad_to(q, 1, sq_p), 3, dp)
    kp = _pad_to(_pad_to(k, 1, skv_p), 3, dp)
    vp = _pad_to(_pad_to(v, 1, skv_p), 3, dp)

    lens_in = lens_spec = None
    if lens is not None:
        lens_in = lens.astype(jnp.int32).reshape(b, 1)
        lens_spec = pl.BlockSpec((None, 1), lambda i, bb, h: (bb, 0))
    kb_in = kb_spec = None
    if kbias is not None:
        kb_in = _pad_to(kbias.astype(jnp.float32), 1, skv_p)
        kb_spec = pl.BlockSpec((None, skv_p), lambda i, bb, h: (bb, 0))
    ab_in = ab_spec = None
    if dense_bias is not None:
        ab_in = _pad_to(_pad_to(dense_bias.astype(jnp.float32), 2, sq_p), 3, skv_p)
        if ab_in.shape[1] == 1:
            ab_spec = pl.BlockSpec((None, None, bq, skv_p), lambda i, bb, h: (bb, 0, i, 0))
        else:
            ab_spec = pl.BlockSpec((None, None, bq, skv_p), lambda i, bb, h: (bb, h, i, 0))
    tab_in = tab_spec = None
    if tab is not None:
        tab_in = tab.astype(jnp.float32)
        tab_spec = pl.BlockSpec((None, tab_in.shape[1]), lambda i, bb, h: (h, 0))
    seed_in = seed_spec = None
    if seed is not None:
        seed_in = seed.astype(jnp.int32).reshape(1)
        seed_spec = pl.BlockSpec((1,), lambda i, bb, h: (0,))

    kv_map = lambda i, bb, h: (bb, 0, h // group, 0)  # noqa: E731
    in_specs = [
        pl.BlockSpec((None, bq, None, dp), lambda i, bb, h: (bb, i, h, 0)),
        pl.BlockSpec((None, skv_p, None, dp), kv_map),
        pl.BlockSpec((None, skv_p, None, dp), kv_map),
        lens_spec, kb_spec, ab_spec, tab_spec, seed_spec,
    ]
    out_shape = [jax.ShapeDtypeStruct((b, sq_p, hq, dp), q.dtype)]
    out_specs = [pl.BlockSpec((None, bq, None, dp), lambda i, bb, h: (bb, i, h, 0))]
    if need_lse:
        out_shape.append(jax.ShapeDtypeStruct((b, hq, sq_p), jnp.float32))
        out_specs.append(pl.BlockSpec((None, None, bq), lambda i, bb, h: (bb, h, i)))
    kernel = functools.partial(
        _fwd_kernel, cfg=cfg, q_len=sq, kv_len=skv, padded_kv=skv_p > skv,
        num_heads=hq,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(sq_p // bq, b, hq),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(dp), num_stages=2
        ),
        interpret=cfg.interpret,
        backend="triton",
        name="pfa_flash_fwd",
    )(qp, kp, vp, lens_in, kb_in, ab_in, tab_in, seed_in)
    o = outs[0][:, :sq, :, :d]
    lse = outs[1][:, :, :sq] if need_lse else None
    return o, lse


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------


def _probs(cfg, q, k, rows, cols, lse2, kb_ref, tab_ref, kv_start, bk, kv_len,
           padded_kv, len_b):
    """Recompute one tile of probabilities from the saved logsumexp."""
    s = _dot(q, k, trans_b=True) * (cfg.sm_scale * LOG2E)
    bias = _bias_tile(cfg, rows, cols, kb_ref, None, tab_ref, kv_start, bk)
    if bias is not None:
        s = jnp.maximum(s + bias * LOG2E, _MASK)
    p = jnp.exp2(s - lse2[:, None])
    valid = _valid(cfg, rows, cols, kv_len, padded_kv, len_b)
    if valid is not None:
        p = jnp.where(valid, p, 0.0)
    return p


def _dkv_kernel(
    q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, lens_ref, kb_ref,
    seed_ref, dk_ref, dv_ref, *dkb_refs, cfg: _Cfg, q_len: int, kv_len: int,
    padded_kv: bool, num_heads: int,
):
    j, b, h = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    bq, bk = cfg.block_q, cfg.block_kv
    n_q_blocks = q_ref.shape[0] // bq
    kv_off = kv_len - q_len
    kv_start = j * bk
    cols = (kv_start + jnp.arange(bk, dtype=jnp.int32))[None, :]
    len_b = lens_ref[0] if lens_ref is not None else None
    k = k_ref[...]
    v = v_ref[...]
    d = k.shape[-1]

    def body(i, carry):
        dk, dv, dkb = carry
        q_start = i * bq
        q_pos = q_start + jnp.arange(bq, dtype=jnp.int32)
        rows = (q_pos + kv_off)[:, None]
        q = q_ref[pl.ds(q_start, bq), :]
        do = do_ref[pl.ds(q_start, bq), :]
        lse2 = lse_ref[pl.ds(q_start, bq)]
        delta = delta_ref[pl.ds(q_start, bq)]
        p = _probs(cfg, q, k, rows, cols, lse2, kb_ref, None, kv_start, bk,
                   kv_len, padded_kv, len_b)
        dp = _dot(do, v, trans_b=True)
        if cfg.dropout_rate > 0.0:
            keep = _dropout(cfg, seed_ref, q_pos[:, None], cols, kv_len,
                            b * num_heads + h)
            inv = 1.0 / (1.0 - cfg.dropout_rate)
            pd = jnp.where(keep, p * inv, 0.0)
            dp = jnp.where(keep, dp * inv, 0.0)
        else:
            pd = p
        dv = dv + _dot(pd.astype(do.dtype), do, trans_a=True)
        ds = p * (dp - delta[:, None])
        dk = dk + _dot(ds.astype(q.dtype), q, trans_a=True)
        if dkb is not None:
            dkb = dkb + jnp.sum(ds, axis=0)
        return dk, dv, dkb

    lo, hi = _q_range(cfg, kv_start, kv_start + bk - 1, kv_off, n_q_blocks)
    if len_b is not None:
        hi = jnp.where(kv_start < len_b, hi, lo)
    carry = (
        jnp.zeros((bk, d), jnp.float32),
        jnp.zeros((bk, d), jnp.float32),
        jnp.zeros((bk,), jnp.float32) if dkb_refs else None,
    )
    dk, dv, dkb = lax.fori_loop(lo, hi, body, carry)
    dk_ref[...] = (dk * cfg.sm_scale).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)
    if dkb_refs:
        dkb_refs[0][...] = dkb


def _dq_kernel(
    q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, lens_ref, kb_ref,
    tab_ref, seed_ref, dq_ref, *, cfg: _Cfg, q_len: int, kv_len: int,
    padded_kv: bool, num_heads: int,
):
    qi, b, h = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    bq, bk = cfg.block_q, cfg.block_kv
    n_kv_blocks = k_ref.shape[0] // bk
    kv_off = kv_len - q_len
    q_start = qi * bq
    q_pos = q_start + jnp.arange(bq, dtype=jnp.int32)
    rows = (q_pos + kv_off)[:, None]
    len_b = lens_ref[0] if lens_ref is not None else None
    q = q_ref[...]
    do = do_ref[...]
    lse2 = lse_ref[...]
    delta = delta_ref[...]

    def body(j, dq):
        kv_start = j * bk
        cols = (kv_start + jnp.arange(bk, dtype=jnp.int32))[None, :]
        k = k_ref[pl.ds(kv_start, bk), :]
        v = v_ref[pl.ds(kv_start, bk), :]
        p = _probs(cfg, q, k, rows, cols, lse2, kb_ref, tab_ref, kv_start, bk,
                   kv_len, padded_kv, len_b)
        dp = _dot(do, v, trans_b=True)
        if cfg.dropout_rate > 0.0:
            keep = _dropout(cfg, seed_ref, q_pos[:, None], cols, kv_len,
                            b * num_heads + h)
            dp = jnp.where(keep, dp * (1.0 / (1.0 - cfg.dropout_rate)), 0.0)
        ds = p * (dp - delta[:, None])
        return dq + _dot(ds.astype(k.dtype), k)

    lo, hi = _kv_range(cfg, q_start, q_start + bq - 1, kv_off, n_kv_blocks, len_b)
    dq = lax.fori_loop(lo, hi, body, jnp.zeros(q.shape, jnp.float32))
    dq_ref[...] = (dq * cfg.sm_scale).astype(dq_ref.dtype)


def _bwd_kernels(cfg: _Cfg, q, k, v, lens, kbias, seed, o, lse, do):
    """dq, dk, dv (and the per-key bias gradient) through the two kernels."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    bq, bk = cfg.block_q, cfg.block_kv
    sq_p, skv_p, dp = round_up(sq, bq), round_up(skv, bk), _head_dim(d)
    delta = jnp.einsum(
        "bqhd,bqhd->bhq", o.astype(jnp.float32), do.astype(jnp.float32)
    )
    # Rows that saw no key have lse = -inf; +inf makes their p exactly 0.
    lse2 = jnp.where(jnp.isneginf(lse), jnp.inf, lse * LOG2E)
    qp = _pad_to(_pad_to(q, 1, sq_p), 3, dp)
    dop = _pad_to(_pad_to(do.astype(q.dtype), 1, sq_p), 3, dp)
    kp = _pad_to(_pad_to(k, 1, skv_p), 3, dp)
    vp = _pad_to(_pad_to(v, 1, skv_p), 3, dp)
    lse_p = _pad_to(lse2, 2, sq_p)
    delta_p = _pad_to(delta, 2, sq_p)

    lens_in = None if lens is None else lens.astype(jnp.int32).reshape(b, 1)
    kb_in = None if kbias is None else _pad_to(kbias.astype(jnp.float32), 1, skv_p)
    seed_in = None if seed is None else seed.astype(jnp.int32).reshape(1)
    statics = dict(cfg=cfg, q_len=sq, kv_len=skv, padded_kv=skv_p > skv,
                   num_heads=hq)
    params = plgpu.CompilerParams(num_warps=_num_warps(dp), num_stages=2)

    # dK / dV: one program per (KV block, batch, q head).
    full_q = lambda j, bb, h: (bb, 0, h, 0)  # noqa: E731
    kv_blk = lambda j, bb, h: (bb, j, h // group, 0)  # noqa: E731
    row_q = lambda j, bb, h: (bb, h, 0)  # noqa: E731
    dkv_specs = [
        pl.BlockSpec((None, sq_p, None, dp), full_q),
        pl.BlockSpec((None, bk, None, dp), kv_blk),
        pl.BlockSpec((None, bk, None, dp), kv_blk),
        pl.BlockSpec((None, sq_p, None, dp), full_q),
        pl.BlockSpec((None, None, sq_p), row_q),
        pl.BlockSpec((None, None, sq_p), row_q),
        None if lens is None else pl.BlockSpec((None, 1), lambda j, bb, h: (bb, 0)),
        None if kbias is None else pl.BlockSpec((None, skv_p), lambda j, bb, h: (bb, 0)),
        None if seed is None else pl.BlockSpec((1,), lambda j, bb, h: (0,)),
    ]
    dkv_dtype = jnp.float32 if group > 1 else k.dtype
    out_blk = lambda j, bb, h: (bb, j, h, 0)  # noqa: E731
    out_shape = [
        jax.ShapeDtypeStruct((b, skv_p, hq, dp), dkv_dtype),
        jax.ShapeDtypeStruct((b, skv_p, hq, dp), dkv_dtype),
    ]
    out_specs = [
        pl.BlockSpec((None, bk, None, dp), out_blk),
        pl.BlockSpec((None, bk, None, dp), out_blk),
    ]
    if kbias is not None:
        out_shape.append(jax.ShapeDtypeStruct((b, hq, skv_p), jnp.float32))
        out_specs.append(pl.BlockSpec((None, None, bk), lambda j, bb, h: (bb, h, j)))
    outs = pl.pallas_call(
        functools.partial(_dkv_kernel, **statics),
        grid=(skv_p // bk, b, hq),
        in_specs=dkv_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=params,
        interpret=cfg.interpret,
        backend="triton",
        name="pfa_flash_bwd_dkv",
    )(qp, kp, vp, dop, lse_p, delta_p, lens_in, kb_in, seed_in)
    dk, dv = outs[0][:, :skv, :, :d], outs[1][:, :skv, :, :d]
    if group > 1:
        dk = dk.reshape(b, skv, hkv, group, d).sum(3)
        dv = dv.reshape(b, skv, hkv, group, d).sum(3)
    dkb = outs[2].sum(1)[:, :skv] if kbias is not None else None

    # dQ: one program per (q block, batch, q head).
    q_blk = lambda i, bb, h: (bb, i, h, 0)  # noqa: E731
    full_kv = lambda i, bb, h: (bb, 0, h // group, 0)  # noqa: E731
    row_blk = lambda i, bb, h: (bb, h, i)  # noqa: E731
    dq_specs = [
        pl.BlockSpec((None, bq, None, dp), q_blk),
        pl.BlockSpec((None, skv_p, None, dp), full_kv),
        pl.BlockSpec((None, skv_p, None, dp), full_kv),
        pl.BlockSpec((None, bq, None, dp), q_blk),
        pl.BlockSpec((None, None, bq), row_blk),
        pl.BlockSpec((None, None, bq), row_blk),
        None if lens is None else pl.BlockSpec((None, 1), lambda i, bb, h: (bb, 0)),
        None if kbias is None else pl.BlockSpec((None, skv_p), lambda i, bb, h: (bb, 0)),
        None,
        None if seed is None else pl.BlockSpec((1,), lambda i, bb, h: (0,)),
    ]
    dq = pl.pallas_call(
        functools.partial(_dq_kernel, **statics),
        grid=(sq_p // bq, b, hq),
        in_specs=dq_specs,
        out_specs=pl.BlockSpec((None, bq, None, dp), q_blk),
        out_shape=jax.ShapeDtypeStruct((b, sq_p, hq, dp), q.dtype),
        compiler_params=params,
        interpret=cfg.interpret,
        backend="triton",
        name="pfa_flash_bwd_dq",
    )(qp, kp, vp, dop, lse_p, delta_p, lens_in, kb_in, None, seed_in)
    return dq[:, :sq, :, :d], dk.astype(k.dtype), dv.astype(v.dtype), dkb


def _xla_bwd(
    q: jax.Array,  # [B, H, Sq, D]
    k: jax.Array,  # [B, H, Skv_p, D], KV heads already repeated
    v: jax.Array,
    o: jax.Array,
    lse: jax.Array,  # [B, H, Sq]
    do: jax.Array,
    *,
    sm_scale: float,
    causal: bool,
    q_true_len: int,
    kv_true_len: int,
    block_kv: int,
    tab: Optional[jax.Array] = None,  # (H, W) fp32 rel-bias table
    rel: Tuple[str, bool, int, int] = _NO_REL,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    kv_lens: Optional[jax.Array] = None,
    k_bias: Optional[jax.Array] = None,  # (B, Skv_p)
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
):
    """Blockwise backward in plain XLA: a scan over KV blocks.

    Carries the gradient of a T5/ALiBi bias table (a per-bucket sum of
    score gradients, which a tile kernel would have to reduce across
    programs). Also the independent check on the backward kernels.
    Returns (dq, dk, dv, dtab or None, dkbias or None).
    """
    b, h, sq, d = q.shape
    skv = k.shape[2]
    num_blocks = skv // block_kv
    kv_off = kv_true_len - q_true_len
    rel_kind, rel_bidir, rel_nb, rel_maxd = rel

    qf = q.astype(jnp.float32)
    dof = do.astype(jnp.float32)
    of = o.astype(jnp.float32)
    di = jnp.sum(of * dof, axis=-1, keepdims=True)
    lse_e = lse[..., None]

    kb = k.astype(jnp.float32).reshape(b, h, num_blocks, block_kv, d)
    vb = v.astype(jnp.float32).reshape(b, h, num_blocks, block_kv, d)
    kb = kb.transpose(2, 0, 1, 3, 4)
    vb = vb.transpose(2, 0, 1, 3, 4)

    row = lax.broadcasted_iota(jnp.int32, (sq, block_kv), 0) + kv_off

    if k_bias is not None:
        kb_blocks = (
            k_bias.astype(jnp.float32)
            .reshape(b, num_blocks, block_kv)
            .transpose(1, 0, 2)
        )
    else:
        kb_blocks = jnp.zeros((num_blocks, 1, 1), jnp.float32)

    def body(carry, inputs):
        dq_acc, dtab_acc = carry
        blk_idx, k_blk, v_blk, kb_blk = inputs
        s = jnp.einsum("bhqd,bhkd->bhqk", qf, k_blk) * sm_scale
        col = lax.broadcasted_iota(jnp.int32, (sq, block_kv), 1) + blk_idx * block_kv
        rel_blk = col - row
        if rel_kind != "none":
            bias = bias_from_table(
                rel_kind, tab, rel_blk, bidirectional=rel_bidir,
                num_buckets=rel_nb, max_distance=rel_maxd,
            )
            s = s + bias[None]
        if k_bias is not None:
            s = s + kb_blk[:, None, None, :]
        valid = col < kv_true_len
        if causal:
            valid = jnp.logical_and(valid, col <= row)
        if window is not None:
            lo_, hi_ = window
            if lo_ is not None:
                valid = jnp.logical_and(valid, rel_blk >= lo_)
            if hi_ is not None:
                valid = jnp.logical_and(valid, rel_blk <= hi_)
        valid = valid[None, None]
        if kv_lens is not None:
            valid = jnp.logical_and(
                valid, col[None, None] < kv_lens[:, None, None, None]
            )
        p = jnp.where(valid, jnp.exp(s - lse_e), 0.0)
        if dropout_rate > 0.0:
            qrow = lax.broadcasted_iota(jnp.int32, (sq, block_kv), 0)
            bh_idx = (
                jnp.arange(b, dtype=jnp.int32)[:, None] * h
                + jnp.arange(h, dtype=jnp.int32)[None, :]
            )[:, :, None, None]
            keep = dropout_keep(
                dropout_seed.reshape(()), qrow[None, None], col[None, None],
                kv_true_len, dropout_rate, bh=bh_idx,
            )
            mscale = jnp.where(keep, 1.0 / (1.0 - dropout_rate), 0.0)
            dv_blk = jnp.einsum("bhqk,bhqd->bhkd", p * mscale, dof)
            dp = jnp.einsum("bhqd,bhkd->bhqk", dof, v_blk) * mscale
        else:
            dv_blk = jnp.einsum("bhqk,bhqd->bhkd", p, dof)
            dp = jnp.einsum("bhqd,bhkd->bhqk", dof, v_blk)
        dsb = p * (dp - di)
        if rel_kind == "alibi":
            dtab_acc = dtab_acc + jnp.sum(
                dsb * rel_blk[None, None].astype(jnp.float32), axis=(0, 2, 3)
            ).reshape(h, 1)
        elif rel_kind == "t5":
            bucket = relative_position_bucket(
                rel_blk, bidirectional=rel_bidir, num_buckets=rel_nb,
                max_distance=rel_maxd,
            )
            for b_ in range(rel_nb):
                dtab_acc = dtab_acc.at[:, b_].add(
                    jnp.sum(jnp.where(bucket[None, None] == b_, dsb, 0.0),
                            axis=(0, 2, 3))
                )
        ds = dsb * sm_scale
        dq_acc = dq_acc + jnp.einsum("bhqk,bhkd->bhqd", ds, k_blk)
        dk_blk = jnp.einsum("bhqk,bhqd->bhkd", ds, qf)
        dkb_blk = jnp.sum(dsb, axis=(1, 2))
        return (dq_acc, dtab_acc), (dk_blk, dv_blk, dkb_blk)

    blk_ids = jnp.arange(num_blocks, dtype=jnp.int32)
    dtab0 = jnp.zeros(tab.shape, jnp.float32) if tab is not None else jnp.zeros((h, 1))
    (dq, dtab), (dk_blocks, dv_blocks, dkb_blocks) = lax.scan(
        body, (jnp.zeros_like(qf), dtab0), (blk_ids, kb, vb, kb_blocks)
    )
    dk = dk_blocks.transpose(1, 2, 0, 3, 4).reshape(b, h, skv, d)
    dv = dv_blocks.transpose(1, 2, 0, 3, 4).reshape(b, h, skv, d)
    dkbias = (
        dkb_blocks.transpose(1, 0, 2).reshape(b, skv) if k_bias is not None else None
    )
    return (
        dq.astype(q.dtype),
        dk.astype(k.dtype),
        dv.astype(v.dtype),
        dtab if rel_kind != "none" else None,
        dkbias,
    )


def _rel_bwd(cfg: _Cfg, q, k, v, tab, o, lse, do):
    """Backward of the rel-bias variant through ``_xla_bwd`` (table grad)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    bk = min(512, round_up(skv, 16))
    skv_p = round_up(skv, bk)
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    kt = _pad_to(t(jnp.repeat(k, group, axis=2) if group > 1 else k), 2, skv_p)
    vt = _pad_to(t(jnp.repeat(v, group, axis=2) if group > 1 else v), 2, skv_p)
    dq, dk, dv, dtab, _ = _xla_bwd(
        t(q), kt, vt, t(o), lse, t(do), sm_scale=cfg.sm_scale,
        causal=cfg.causal, q_true_len=sq, kv_true_len=skv, block_kv=bk,
        tab=tab, rel=cfg.rel,
    )
    dk, dv = t(dk[:, :, :skv]), t(dv[:, :, :skv])
    if group > 1:
        dk = dk.reshape(b, skv, hkv, group, d).sum(3)
        dv = dv.reshape(b, skv, hkv, group, d).sum(3)
    return t(dq), dk.astype(k.dtype), dv.astype(v.dtype), dtab.astype(tab.dtype)


# ---------------------------------------------------------------------------
# custom_vjp core
# ---------------------------------------------------------------------------


def _int_ct(x):
    return None if x is None else jnp.zeros(x.shape, jax.dtypes.float0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _flash_core(cfg: _Cfg, q, k, v, lens, kbias, tab, seed):
    return _fwd(cfg, q, k, v, lens, kbias, tab, seed, need_lse=False)[0]


def _flash_core_fwd(cfg, q, k, v, lens, kbias, tab, seed):
    o, lse = _fwd(cfg, q, k, v, lens, kbias, tab, seed)
    return o, (q, k, v, lens, kbias, tab, seed, o, lse)


def _flash_core_bwd(cfg, res, do):
    q, k, v, lens, kbias, tab, seed, o, lse = res
    if cfg.rel[0] != "none":
        dq, dk, dv, dtab = _rel_bwd(cfg, q, k, v, tab, o, lse, do)
        return dq, dk, dv, None, None, dtab, None
    dq, dk, dv, dkb = _bwd_kernels(cfg, q, k, v, lens, kbias, seed, o, lse, do)
    if kbias is not None:
        dkb = dkb.astype(kbias.dtype)
    return dq, dk, dv, _int_ct(lens), dkb, None, _int_ct(seed)


_flash_core.defvjp(_flash_core_fwd, _flash_core_bwd)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _check_block(name: str, val: int) -> None:
    if val < 16 or val & (val - 1):
        raise ValueError(
            f"{name}={val} must be a power of two >= 16 (Triton tile shapes)"
        )


def _blocks(sq: int, skv: int, d: int, block_q, block_kv) -> Tuple[int, int]:
    """Tile sizes: caller's if given, else 64 rows x 64 keys, clamped to
    the sequence (a power of two at least 16)."""
    bq = block_q or min(64 if d <= 64 else 128, max(16, next_pow2(sq)))
    bk = block_kv or min(64, max(16, next_pow2(skv)))
    _check_block("block_q", bq)
    _check_block("block_kv", bk)
    return bq, bk


def cudnn_eligible(q, k, *, causal: bool, features: bool) -> bool:
    """Whether cuDNN's fused attention computes exactly this call.

    It does for plain (or causal self-) attention in bf16/fp16 with a head
    dim of at most 128 in multiples of 8. It is not asked for anything
    else: T5/ALiBi bias (dense only there), positional-hash dropout, the
    logsumexp in float32, per-key bias, windows and padded lengths
    (``features``), or causal attention between unequal lengths (cuDNN
    aligns the diagonal at the start, this module at the end). Tile
    sizes play no part: they only shape this module's kernel.
    """
    d = q.shape[-1]
    return (
        platform.on_gpu()
        and not features
        and q.dtype in (jnp.bfloat16, jnp.float16)
        and k.dtype == q.dtype
        and d <= 128
        and d % 8 == 0
        and (not causal or q.shape[1] == k.shape[1])
    )


def flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    interpret: Optional[bool] = None,
    rel_bias: Optional[RelBias] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    kv_lens: Optional[jax.Array] = None,
    k_bias: Optional[jax.Array] = None,
    attn_bias: Optional[jax.Array] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
    implementation: Optional[str] = None,
) -> jax.Array:
    """Flash attention (differentiable except with ``attn_bias``).

    Args:
      q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) with Hq % Hkv == 0 (GQA).
      causal: causal mask, aligned at the sequence end when Sq != Skv.
      sm_scale: score scale, default 1/sqrt(D).
      block_q / block_kv: kernel tile sizes (powers of two >= 16); chosen
        here otherwise. They apply only when the call runs on this
        module's kernel.
      interpret: run the kernel in the Pallas interpreter (the CPU's
        mode; refused on the GPU). Setting it asks for the kernel.
      kv_lens: optional (B,) int32 valid KV length per sequence. Blocks
        past it are never loaded.
      k_bias: optional (B, Skv) fp32 additive per-key bias (0 = attend,
        DEFAULT_MASK_VALUE = ignore), differentiable. May combine with
        kv_lens.
      attn_bias: optional dense (B, 1|Hq, Sq, Skv) fp32 additive bias,
        streamed in tiles. Forward only; combines with ``causal`` only.
      rel_bias: ``T5RelBias`` or ``ALiBi`` (ops/rel_bias.py), rebuilt from
        iota inside the kernel; differentiable in its table.
      window: (lo, hi) bounds on rel = col - row, inclusive, None =
        unbounded: ``window=(-w + 1, 0)`` with ``causal=True`` is a
        sliding window of w keys. Blocks outside are never loaded.
      dropout_rate / dropout_seed: attention-probability dropout with the
        positional hash of ``pallas_utils.dropout_keep``.
      implementation: None chooses by what the call computes: cuDNN
        where ``cudnn_eligible`` holds, this module's kernel otherwise.
        "pallas" always runs the kernel (benchmarks, tile tuning).

    Returns:
      (B, Sq, Hq, D) in q.dtype.
    """
    if implementation not in (None, "pallas"):
        raise ValueError(
            f"implementation must be None or 'pallas', got {implementation!r}"
        )
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq {hq} not divisible by Hkv {hkv} (GQA)")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    if dropout_rate > 0.0:
        if not 0.0 < dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in (0, 1), got {dropout_rate}")
        if kv_lens is not None or k_bias is not None or rel_bias is not None or window is not None:
            raise ValueError(
                "dropout_rate cannot be combined with kv_lens/k_bias/"
                "rel_bias/window"
            )
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
    if attn_bias is not None:
        if (
            kv_lens is not None or k_bias is not None or rel_bias is not None
            or window is not None or dropout_rate > 0.0
        ):
            raise ValueError(
                "attn_bias cannot be combined with kv_lens/k_bias/"
                "rel_bias/window/dropout"
            )
        if attn_bias.ndim != 4 or attn_bias.shape[0] != b or attn_bias.shape[
            1
        ] not in (1, hq) or attn_bias.shape[2:] != (sq, skv):
            raise ValueError(
                f"attn_bias must be (B, 1|Hq, Sq, Skv) = ({b}, 1|{hq}, "
                f"{sq}, {skv}), got {attn_bias.shape}"
            )
    if (kv_lens is not None or k_bias is not None) and (
        rel_bias is not None or window is not None
    ):
        raise ValueError("kv_lens/k_bias cannot be combined with rel_bias or window")
    if window is not None and rel_bias is not None:
        raise ValueError("window cannot be combined with rel_bias")
    if kv_lens is not None and kv_lens.shape != (b,):
        raise ValueError(f"kv_lens must be shape ({b},), got {kv_lens.shape}")
    if k_bias is not None and k_bias.shape != (b, skv):
        raise ValueError(f"k_bias must be shape ({b}, {skv}), got {k_bias.shape}")
    if rel_bias is not None and rel_bias.num_heads != hq:
        raise ValueError(f"rel_bias heads {rel_bias.num_heads} != q heads {hq}")

    features = any(
        x is not None for x in (rel_bias, window, kv_lens, k_bias, attn_bias)
    ) or dropout_rate > 0.0
    if (
        implementation is None
        and interpret is None
        and cudnn_eligible(q, k, causal=causal, features=features)
    ):
        return jax.nn.dot_product_attention(
            q, k, v, scale=scale, is_causal=causal, implementation="cudnn"
        )

    bq, bk = _blocks(sq, skv, d, block_q, block_kv)
    tab, rel = None, _NO_REL
    if rel_bias is not None:
        _, tab = bias_table(rel_bias)
        rel = rel_statics(rel_bias)
    cfg = _Cfg(
        causal=bool(causal), sm_scale=float(scale),
        window=None if window is None else (window[0], window[1]),
        rel=rel, dropout_rate=float(dropout_rate), block_q=bq, block_kv=bk,
        interpret=resolve_interpret(interpret),
    )
    if attn_bias is not None:
        return _fwd(cfg, q, k, v, None, None, None, None, dense_bias=attn_bias,
                    need_lse=False)[0]
    seed = (
        jnp.asarray(dropout_seed, jnp.int32).reshape(1)
        if dropout_rate > 0.0 else None
    )
    kbias = None if k_bias is None else k_bias.astype(jnp.float32)
    return _flash_core(cfg, q, k, v, kv_lens, kbias, tab, seed)


def flash_attention_with_lse(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    interpret: Optional[bool] = None,
    kv_lens: Optional[jax.Array] = None,
    k_bias: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Flash attention also returning the per-row logsumexp.

    Returns (output (B, Sq, Hq, D), lse (B, Hq, Sq) fp32). The lse makes
    partial results mergeable across KV shards (ring attention): a row
    that saw no valid key has lse = -inf and a zero output row, so it
    drops out of the merge. Forward only.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq {hq} not divisible by Hkv {hkv} (GQA)")
    if kv_lens is not None and kv_lens.shape != (b,):
        raise ValueError(f"kv_lens must be shape ({b},), got {kv_lens.shape}")
    if k_bias is not None and k_bias.shape != (b, skv):
        raise ValueError(f"k_bias must be shape ({b}, {skv}), got {k_bias.shape}")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    bq, bk = _blocks(sq, skv, d, block_q, block_kv)
    cfg = _Cfg(
        causal=bool(causal), sm_scale=float(scale), window=None, rel=_NO_REL,
        dropout_rate=0.0, block_q=bq, block_kv=bk,
        interpret=resolve_interpret(interpret),
    )
    kbias = None if k_bias is None else k_bias.astype(jnp.float32)
    return _fwd(cfg, q, k, v, kv_lens, kbias, None, None)


def merge_partial_attention(o1, lse1, o2, lse2):
    """Merge two normalized partial-attention results by logsumexp.

    Each part is (output (..., D) normalized within its own key set,
    lse (...)) with lse = -inf and a zero output row where the part saw no
    valid keys. The same recurrence merges ring-attention shards.
    """
    o1f = o1.astype(jnp.float32)
    o2f = o2.astype(jnp.float32)
    m = jnp.maximum(lse1, lse2)
    m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
    w1 = jnp.where(jnp.isneginf(lse1), 0.0, jnp.exp(lse1 - m_safe))
    w2 = jnp.where(jnp.isneginf(lse2), 0.0, jnp.exp(lse2 - m_safe))
    denom = w1 + w2
    safe = jnp.where(denom == 0.0, 1.0, denom)
    o = (o1f * w1[..., None] + o2f * w2[..., None]) / safe[..., None]
    lse = jnp.where(denom == 0.0, -jnp.inf, m_safe + jnp.log(safe))
    return o, lse
