"""Ulysses sequence parallelism — all-to-all head x sequence re-sharding.

The alternative context-parallel scheme to ring attention (SURVEY.md
§2.5: "Ulysses all-to-all on heads when heads >= chips"). Where ring
attention keeps Q sequence-sharded and rotates KV around the ring,
Ulysses re-shards: an ``all_to_all`` swaps the sharded dimension from
sequence to heads, every device then runs ordinary (single-device,
Pallas flash) attention over the FULL sequence for its head subset, and
a second ``all_to_all`` swaps back.

Trade-off vs ring: two bulk all-to-alls (suits all-to-all NVLink, one shot each
way) instead of n-1 ppermute steps, full-sequence flash locality, but it
requires ``num_heads % axis_size == 0`` and peak memory holds the whole
sequence per device. The router-level guidance from the scaling
literature: Ulysses when heads >= chips and sequence fits, ring when the
sequence must stay sharded.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.flash import flash_attention
from ..utils.exceptions import DistributionError


def ulysses_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    interpret: Optional[bool] = None,
    kv_lens: Optional[jax.Array] = None,
    k_bias: Optional[jax.Array] = None,
) -> jax.Array:
    """Ulysses body — call inside ``shard_map``.

    Args:
      q/k/v: LOCAL shards (B, S_local, H, D); the global sequence is the
        concatenation over ``axis_name``. Requires H % axis_size == 0.
      kv_lens: optional (B,) int32 GLOBAL valid key lengths (replicated
        over the seq axis): after the all_to_all the full sequence is
        device-resident, so they feed the local flash call unchanged.
      k_bias: optional (B, S_local) LOCAL shard of a global (B, S)
        additive per-key bias; all-gathered to the full sequence
        (B*S*4 bytes — negligible next to the q/k/v re-shards).

    Returns the local output shard (B, S_local, H, D).
    """
    n = jax.lax.psum(1, axis_name)

    # seq-sharded -> head-sharded: split heads, gather sequence.
    def scatter_heads(x):
        return jax.lax.all_to_all(
            x, axis_name, split_axis=2, concat_axis=1, tiled=True
        )

    # head-sharded -> seq-sharded: split sequence, gather heads.
    def gather_heads(x):
        return jax.lax.all_to_all(
            x, axis_name, split_axis=1, concat_axis=2, tiled=True
        )

    qh = scatter_heads(q)  # (B, S, H/n, D)
    kh = scatter_heads(k)
    vh = scatter_heads(v)
    bias_full = (
        jax.lax.all_gather(k_bias, axis_name, axis=1, tiled=True)
        if k_bias is not None
        else None
    )
    oh = flash_attention(
        qh,
        kh,
        vh,
        causal=causal,
        sm_scale=sm_scale,
        block_q=block_q,
        block_kv=block_kv,
        interpret=interpret,
        kv_lens=kv_lens.astype(jnp.int32) if kv_lens is not None else None,
        k_bias=bias_full,
    )
    del n
    return gather_heads(oh)


def make_ulysses_attention(
    mesh: Mesh,
    *,
    seq_axis: str = "seq",
    data_axis: Optional[str] = "data",
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
):
    """Build a jitted sharded Ulysses-attention callable for ``mesh``.

    Input/output layout (B, S, H, D) with batch on ``data_axis`` and
    sequence on ``seq_axis``; heads stay unsharded at the boundary (they
    shard transiently inside the all_to_all sandwich).
    """
    axes = dict(mesh.shape)
    if seq_axis not in axes:
        raise DistributionError(f"mesh has no axis {seq_axis!r}")
    dspec = data_axis if data_axis in axes else None
    spec = P(dspec, seq_axis, None, None)

    fn = functools.partial(
        ulysses_attention,
        axis_name=seq_axis,
        causal=causal,
        sm_scale=sm_scale,
        block_q=block_q,
        block_kv=block_kv,
    )
    _jitted: dict = {}

    def _get(has_lens: bool, has_bias: bool):
        key = (has_lens, has_bias)
        j = _jitted.get(key)
        if j is not None:
            return j
        in_specs = [spec, spec, spec]
        if has_lens:
            in_specs.append(P(dspec))  # (B,) replicated over seq
        if has_bias:
            in_specs.append(P(dspec, seq_axis))  # (B, S) seq-sharded

        def body(q, k, v, *rest):
            i = 0
            kw = {}
            if has_lens:
                kw["kv_lens"] = rest[i]
                i += 1
            if has_bias:
                kw["k_bias"] = rest[i]
            return fn(q, k, v, **kw)

        mapped = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=spec,
            check_vma=False,
        )
        return _jitted.setdefault(key, jax.jit(mapped))

    n_seq = mesh.shape[seq_axis]

    def with_checks_and_telemetry(q, k, v, kv_lens=None, k_bias=None):
        h = q.shape[2]
        if h % n_seq:
            raise DistributionError(
                f"ulysses requires num_heads ({h}) % seq axis size "
                f"({n_seq}) == 0; use ring attention instead"
            )
        hkv = k.shape[2]
        if hkv % n_seq:
            # GQA: the all_to_all splits the KV head axis too — an
            # indivisible Hkv would fail deep inside the collective.
            raise DistributionError(
                f"ulysses requires num_kv_heads ({hkv}) % seq axis size "
                f"({n_seq}) == 0 (GQA); use ring attention instead"
            )
        args = [q, k, v]
        if kv_lens is not None:
            args.append(kv_lens)
        if k_bias is not None:
            args.append(k_bias)
        out = _get(kv_lens is not None, k_bias is not None)(*args)
        try:
            from .telemetry import get_telemetry

            tel = get_telemetry()
            # Each all_to_all moves (n-1)/n of each device's local shard;
            # 3 inbound re-shards (q, k, v) + 1 outbound (o).
            local_bytes = q.size // max(n_seq, 1) * jnp.dtype(q.dtype).itemsize
            moved = local_bytes * (n_seq - 1) // max(n_seq, 1)
            for _ in range(4):
                tel.record(seq_axis, "all_to_all", moved, n_seq)
        except Exception:  # noqa: BLE001 - telemetry must never break compute
            pass
        return out

    return with_checks_and_telemetry
