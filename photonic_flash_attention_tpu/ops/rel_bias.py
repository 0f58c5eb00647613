"""Structured relative-position biases computed *inside* the flash kernel.

The reference supports T5 by swapping its attention layers while keeping
the model's relative-position bias as a materialized (1, H, Sq, Skv)
additive tensor (reference integration/pytorch/convert.py:174-202 extracts
the T5 config; its README claims T5-Large seq-8192 as the headline
speedup, README.md:663). Materializing that bias at S=8192 costs
H * S^2 * 4 bytes ≈ 4 GB — it cannot ride along into a tiled kernel as an
HBM tensor.

The answer here: T5's bias is a *function of (col - row)* through a
32-entry learned table, and ALiBi is linear in (col - row). Both are
recomputable from iota inside each score tile for free in memory terms:
the kernel carries only one head's row of the table and rebuilds the
per-tile bias in registers. This file holds the bias *specs*
(small dataclasses the kernels and models share) and the pure-jnp bucket
math used by both the Pallas kernel and the XLA oracle/backward paths.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp


def relative_position_bucket(
    relative_position: jax.Array,
    *,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> jax.Array:
    """T5's log-binned relative-position bucketing (public algorithm from
    the T5 paper; matches HF ``_relative_position_bucket`` exactly).

    Pure jnp on int32 arrays — safe both in XLA and inside Pallas kernels
    (elementwise compare/log/select on a 2D tile).
    """
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


def static_bucket(
    relative_position: int,
    *,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> int:
    """Python-int twin of ``relative_position_bucket`` for trace-time
    constants (e.g. the saturated far-region bucket indices)."""
    ret = 0
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        if n > 0:
            ret += num_buckets
        n = abs(n)
    else:
        n = -min(n, 0)
    max_exact = num_buckets // 2
    if n < max_exact:
        return ret + n
    val_large = max_exact + int(
        math.log(max(n, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    )
    return ret + min(val_large, num_buckets - 1)


@dataclasses.dataclass(frozen=True)
class T5RelBias:
    """T5 relative-position bias: ``score += table[bucket(col - row)]``.

    Attributes:
      table: (num_buckets, num_heads) learned embedding (HF
        ``relative_attention_bias.weight`` layout).
      bidirectional: True for encoder self-attention, False for decoder.
      max_distance: log-bucket saturation distance (HF default 128).
    """

    table: jax.Array
    bidirectional: bool
    max_distance: int = 128

    @property
    def num_buckets(self) -> int:
        return self.table.shape[0]

    @property
    def num_heads(self) -> int:
        return self.table.shape[1]


@dataclasses.dataclass(frozen=True)
class ALiBi:
    """ALiBi bias: ``score += slopes[h] * (col - row)`` (non-positive in
    the causal region; the positive side is causal-masked).

    Attributes:
      slopes: (num_heads,) per-head slopes, conventionally the geometric
        sequence from ``alibi_slopes``.
    """

    slopes: jax.Array

    @property
    def num_heads(self) -> int:
        return self.slopes.shape[0]


RelBias = Union[T5RelBias, ALiBi]


def alibi_slopes(num_heads: int) -> jax.Array:
    """The standard ALiBi geometric slope schedule (public recipe from the
    ALiBi paper): slopes = 2^(-8i/n) for i in 1..n, extended for non-power
    -of-two head counts by interleaving the next power of two."""

    def pow2_slopes(n: int):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        vals = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        vals = pow2_slopes(closest)
        extra = pow2_slopes(2 * closest)[0::2]
        vals = vals + extra[: num_heads - closest]
    return jnp.asarray(vals, jnp.float32)


def bias_table(spec: RelBias) -> Tuple[str, jax.Array]:
    """Normalize a spec to (kind, (H, W) fp32 table) for the kernel.

    T5: W = num_buckets (table transposed to head-major so each grid step
    grabs one head's row). ALiBi: W = 1 (the slope).
    """
    if isinstance(spec, T5RelBias):
        return "t5", spec.table.astype(jnp.float32).T
    if isinstance(spec, ALiBi):
        return "alibi", spec.slopes.astype(jnp.float32)[:, None]
    raise TypeError(f"unknown rel-bias spec: {type(spec)!r}")


def rel_statics(spec: RelBias) -> Tuple[str, bool, int, int]:
    """Hashable static parameters (kind, bidirectional, buckets, maxdist)
    for custom_vjp nondiff plumbing."""
    if isinstance(spec, T5RelBias):
        return ("t5", spec.bidirectional, spec.num_buckets, spec.max_distance)
    return ("alibi", False, 1, 0)


def bias_from_table(
    kind: str,
    tab_hw: jax.Array,  # (H, W) fp32 as produced by bias_table
    rel: jax.Array,  # int32, any shape
    *,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> jax.Array:
    """XLA-side bias materialization from the normalized table: returns
    (H, *rel.shape) fp32. Used by the backward pass and the oracle."""
    if kind == "alibi":
        return tab_hw[:, 0][(...,) + (None,) * rel.ndim] * rel.astype(jnp.float32)
    buckets = relative_position_bucket(
        rel,
        bidirectional=bidirectional,
        num_buckets=num_buckets,
        max_distance=max_distance,
    )
    return jnp.moveaxis(tab_hw[:, buckets], 0, 0)  # (H, *rel.shape)


def materialize(
    spec: RelBias,
    sq: int,
    skv: int,
    *,
    kv_offset: Optional[int] = None,
) -> jax.Array:
    """Dense (1, H, Sq, Skv) bias for the fused/oracle path.

    ``kv_offset`` defaults to ``skv - sq`` (sequence-end alignment, the
    decode convention shared with the flash kernel's causal masking).
    """
    off = skv - sq if kv_offset is None else kv_offset
    ctx = jnp.arange(sq, dtype=jnp.int32)[:, None] + off
    mem = jnp.arange(skv, dtype=jnp.int32)[None, :]
    rel = mem - ctx
    kind, tab = bias_table(spec)
    _, bidir, nb, maxd = rel_statics(spec)
    bias = bias_from_table(
        kind, tab, rel, bidirectional=bidir, num_buckets=nb, max_distance=maxd
    )
    return bias[None]  # (1, H, Sq, Skv)
