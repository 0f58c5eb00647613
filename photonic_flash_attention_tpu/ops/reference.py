"""Reference attention implementations (the numerics oracle).

Pure-``jnp`` analogues of the reference's two forward paths
(reference core/flash_attention_3.py:152-180 ``_standard_attention`` and
:182-262 ``_tiled_attention`` online-softmax). These are the correctness
anchors for every kernel in this package: kernels must match
``attention_reference`` to tight tolerances, and ``attention_blockwise``
demonstrates the tiling recurrence in plain JAX.

Shape convention: (batch, seq, num_heads, head_dim) at the API boundary —
the natural layout for JAX transformer stacks.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

DEFAULT_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def _scale(head_dim: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else head_dim ** -0.5


def attention_reference(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mask: Optional[jax.Array] = None,
    *,
    bias: Optional[jax.Array] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    need_weights: bool = False,
    weights_only: bool = False,
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Standard O(S^2)-memory attention (the oracle).

    Args:
      q: (B, Sq, Hq, D)
      k: (B, Skv, Hkv, D); Hq % Hkv == 0 (GQA broadcast).
      v: (B, Skv, Hkv, D)
      mask: optional boolean mask broadcastable to (B, Hq, Sq, Skv);
        True = attend.
      bias: optional additive score bias broadcastable to (B, Hq, Sq, Skv)
        (e.g. T5 relative position bias, ALiBi slopes).
      causal: apply causal masking.
      sm_scale: score scale; default 1/sqrt(D).
      need_weights: also return softmax weights (B, Hq, Sq, Skv).
      weights_only: skip the P.V recombine and return (None, weights) —
        for callers that post-process the weights (e.g. attention-prob
        dropout) and recombine themselves; saves the output einsum in
        eager mode where XLA DCE can't elide it.

    Returns:
      (output (B, Sq, Hq, D) or None, weights or None)
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    group = hq // hkv
    if group > 1:
        k = jnp.repeat(k, group, axis=2)
        v = jnp.repeat(v, group, axis=2)

    qf = q.astype(jnp.float32) * _scale(d, sm_scale)
    scores = jnp.einsum("bqhd,bkhd->bhqk", qf, k.astype(jnp.float32))

    if bias is not None:
        scores = scores + bias.astype(jnp.float32)
    if causal:
        row = jax.lax.broadcasted_iota(jnp.int32, (sq, skv), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (sq, skv), 1)
        causal_mask = (col <= row + (skv - sq))[None, None]
        scores = jnp.where(causal_mask, scores, DEFAULT_MASK_VALUE)
    if mask is not None:
        scores = jnp.where(mask, scores, DEFAULT_MASK_VALUE)

    weights = jax.nn.softmax(scores, axis=-1)
    if weights_only:
        return None, weights
    out = jnp.einsum("bhqk,bkhd->bqhd", weights, v.astype(jnp.float32))
    out = out.astype(q.dtype)
    return (out, weights) if need_weights else (out, None)


@functools.partial(jax.jit, static_argnames=("causal", "sm_scale", "block_kv"))
def attention_blockwise(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_kv: int = 512,
) -> jax.Array:
    """Online-softmax blockwise attention in plain JAX (O(S) memory).

    The same recurrence the Pallas flash kernel implements (running max m,
    running sum l, rescaled accumulator — cf. reference
    core/flash_attention_3.py:207-260), expressed as a ``lax.scan`` over KV
    blocks so XLA fuses it. Used as the portable fallback and as a second,
    independently-derived check on the kernel math.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    group = hq // hkv
    if group > 1:
        k = jnp.repeat(k, group, axis=2)
        v = jnp.repeat(v, group, axis=2)

    scale = _scale(d, sm_scale)
    qf = (q.astype(jnp.float32) * scale).transpose(0, 2, 1, 3)  # B H Sq D
    kf = k.astype(jnp.float32).transpose(0, 2, 1, 3)  # B H Skv D
    vf = v.astype(jnp.float32).transpose(0, 2, 1, 3)

    pad = (-skv) % block_kv
    if pad:
        kf = jnp.pad(kf, ((0, 0), (0, 0), (0, pad), (0, 0)))
        vf = jnp.pad(vf, ((0, 0), (0, 0), (0, pad), (0, 0)))
    skv_padded = skv + pad
    num_blocks = skv_padded // block_kv

    kb = kf.reshape(b, hq, num_blocks, block_kv, d).transpose(2, 0, 1, 3, 4)
    vb = vf.reshape(b, hq, num_blocks, block_kv, d).transpose(2, 0, 1, 3, 4)

    row_ids = jax.lax.broadcasted_iota(jnp.int32, (sq, block_kv), 0) + (skv - sq)

    def body(carry, inputs):
        m_prev, l_prev, acc = carry
        blk_idx, k_blk, v_blk = inputs
        s = jnp.einsum("bhqd,bhkd->bhqk", qf, k_blk)  # B H Sq block
        col_ids = (
            jax.lax.broadcasted_iota(jnp.int32, (sq, block_kv), 1) + blk_idx * block_kv
        )
        valid = col_ids < skv
        if causal:
            valid = jnp.logical_and(valid, col_ids <= row_ids)
        s = jnp.where(valid[None, None], s, DEFAULT_MASK_VALUE)

        m_curr = jnp.max(s, axis=-1, keepdims=True)
        m_next = jnp.maximum(m_prev, m_curr)
        alpha = jnp.exp(m_prev - m_next)
        p = jnp.exp(s - m_next)
        l_next = alpha * l_prev + jnp.sum(p, axis=-1, keepdims=True)
        acc = alpha * acc + jnp.einsum("bhqk,bhkd->bhqd", p, v_blk)
        return (m_next, l_next, acc), None

    m0 = jnp.full((b, hq, sq, 1), -jnp.inf, jnp.float32)
    l0 = jnp.zeros((b, hq, sq, 1), jnp.float32)
    acc0 = jnp.zeros((b, hq, sq, d), jnp.float32)
    blk_ids = jnp.arange(num_blocks, dtype=jnp.int32)
    (m_fin, l_fin, acc), _ = jax.lax.scan(body, (m0, l0, acc0), (blk_ids, kb, vb))

    l_safe = jnp.where(l_fin == 0.0, 1.0, l_fin)
    out = (acc / l_safe).transpose(0, 2, 1, 3)
    return out.astype(q.dtype)
