"""Pipeline parallelism — GPipe microbatch schedule over a stage mesh axis.

The reference imports ``torch.distributed.pipeline.sync.Pipe`` and never
uses it (reference scaling/distributed_computing.py:14; SURVEY.md §2.5
"PP: imported, unused"). This is the real thing: layer groups
shard onto a ``stage`` mesh axis, activations flow stage-to-stage with
``jax.lax.ppermute`` inside a ``fori_loop`` running the classic GPipe
schedule (M microbatches over S stages in M + S - 1 ticks, with the
usual (S-1)/(M+S-1) bubble).

Usage::

    mesh = create_mesh((4,), ("stage",))
    fn = lambda stage_params, x: x @ stage_params  # one stage's compute
    pipe = make_pipeline(mesh, fn, num_microbatches=8)
    y = pipe(stage_params_stacked, x)   # params: (S, ...); x: (B, ...)

The wrapper splits the batch into microbatches, runs the schedule, and
returns outputs replicated on every device.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.exceptions import DistributionError


def _pipeline_body(
    stage_params,
    x_micro: jax.Array,  # (M, Bm, ...) all microbatch inputs (replicated)
    *,
    fn: Callable,
    axis_name: str,
    num_stages: int,
    num_microbatches: int,
):
    """shard_map body: run the GPipe schedule on this stage."""
    idx = jax.lax.axis_index(axis_name)
    m = num_microbatches
    s = num_stages
    ticks = m + s - 1
    perm = [(i, i + 1) for i in range(s - 1)]  # stage i -> i+1

    feat_shape = x_micro.shape[1:]
    out_buf = jnp.zeros((m,) + feat_shape, x_micro.dtype)
    cur = jnp.zeros(feat_shape, x_micro.dtype)  # activation arriving this tick

    def tick(t, carry):
        cur, out_buf = carry
        # Stage 0 injects microbatch t; later stages consume `cur`.
        mb = jax.lax.dynamic_index_in_dim(
            x_micro, jnp.clip(t, 0, m - 1), axis=0, keepdims=False
        )
        inp = jnp.where(idx == 0, mb, cur)
        y = fn(stage_params, inp)
        # This stage's work at tick t belongs to microbatch t - idx;
        # valid only while 0 <= t - idx < m.
        my_mb = t - idx
        valid = jnp.logical_and(my_mb >= 0, my_mb < m)
        # Last stage banks its result.
        bank = jnp.logical_and(valid, idx == s - 1)
        out_buf = jax.lax.cond(
            bank,
            lambda buf: jax.lax.dynamic_update_index_in_dim(
                buf, y, jnp.clip(my_mb, 0, m - 1), axis=0
            ),
            lambda buf: buf,
            out_buf,
        )
        # Everyone forwards to the next stage (stage s-1 sends nothing).
        nxt = jax.lax.ppermute(y, axis_name, perm)
        return nxt, out_buf

    _, out_buf = jax.lax.fori_loop(0, ticks, tick, (cur, out_buf))
    # Result lives on the last stage; psum broadcasts it (zeros elsewhere).
    out_buf = jnp.where(idx == s - 1, out_buf, jnp.zeros_like(out_buf))
    return jax.lax.psum(out_buf, axis_name)


def make_pipeline(
    mesh: Mesh,
    fn: Callable,
    num_microbatches: int,
    *,
    stage_axis: str = "stage",
):
    """Build a jitted pipeline callable for ``mesh``.

    Args:
      fn: ``(stage_params, x) -> y`` — one stage's forward. ``y`` must
        have ``x``'s shape/dtype (inter-stage activations are
        homogeneous, as in any pipeline).
      num_microbatches: GPipe M; batch must divide evenly.

    Returns ``pipe(stage_params_stacked, x)`` where ``stage_params_stacked``
    has a leading (num_stages,) axis (sharded onto the stage axis) and
    ``x`` is the full batch (replicated). Output is replicated.
    """
    if stage_axis not in mesh.shape:
        raise DistributionError(f"mesh has no axis {stage_axis!r}")
    s = mesh.shape[stage_axis]

    body = functools.partial(
        _pipeline_body,
        fn=fn,
        axis_name=stage_axis,
        num_stages=s,
        num_microbatches=num_microbatches,
    )
    # Stage params sharded on their leading axis; shard_map hands each
    # stage a (1, ...) slice — squeeze it before fn.
    param_spec = P(stage_axis)
    mapped = jax.shard_map(
        lambda p, x: body(jax.tree_util.tree_map(lambda a: a[0], p), x),
        mesh=mesh,
        in_specs=(param_spec, P()),
        out_specs=P(),
        check_vma=False,
    )
    jitted = jax.jit(mapped)

    def pipe(stage_params, x):
        leading = jax.tree_util.tree_leaves(stage_params)[0].shape[0]
        if leading != s:
            raise DistributionError(
                f"stage_params leading axis {leading} != {s} stages"
            )
        b = x.shape[0]
        if b % num_microbatches:
            raise DistributionError(
                f"batch {b} not divisible by {num_microbatches} microbatches"
            )
        xm = x.reshape((num_microbatches, b // num_microbatches) + x.shape[1:])
        out = jitted(stage_params, xm)
        return out.reshape((b,) + x.shape[1:])

    return pipe
