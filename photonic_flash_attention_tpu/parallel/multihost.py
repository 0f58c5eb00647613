"""Multi-host initialization and pod-slice meshes.

The reference *names* a distributed backend and never initializes it
(reference scaling/distributed_computing.py:98-99: 'nccl'/'gloo'/
'tensorpipe' strings; ``init_process_group`` never called — SURVEY.md
§0.3). This module is the real thing for multi-host GPU clusters:

* ``initialize_multihost`` — ``jax.distributed.initialize`` with
  environment autodetection (no-op on single-process / already-initialized
  runtimes),
* ``pod_mesh`` — a device mesh spanning all hosts, DCN-major ordering so
  axes that cross hosts ride the data-center network and the rest stay
  inside a host (uses ``mesh_utils.create_hybrid_device_mesh`` when
  several processes exist).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh

from ..utils.exceptions import DistributionError
from ..utils.logging import get_logger

logger = get_logger("multihost")

_initialized = False


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Initialize cross-host JAX runtime; safe to call on one host.

    Reads the coordinator from the standard env (JAX_COORDINATOR_ADDRESS)
    when args are omitted; returns a summary dict.
    """
    global _initialized
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if not _initialized and coordinator_address:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
            _initialized = True
        except (RuntimeError, ValueError) as e:
            # already initialized (e.g. by a launcher) is fine
            if "already" not in str(e).lower():
                raise DistributionError(f"multihost init failed: {e}") from e
            _initialized = True
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }


def pod_mesh(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str],
    *,
    dcn_axis: Optional[str] = None,
) -> Mesh:
    """Mesh over every device in the pod slice.

    ``dcn_axis`` names the axis that crosses hosts (data-parallel is the
    usual choice — gradients cross hosts once per step; everything else
    stays on the in-host links). With one process this reduces to a
    normal device mesh.
    """
    n = jax.device_count()
    shapes = list(axis_shapes)
    if -1 in shapes:
        known = int(np.prod([s for s in shapes if s != -1]))
        shapes[shapes.index(-1)] = n // known
    if int(np.prod(shapes)) != n:
        raise DistributionError(
            f"axis shapes {tuple(shapes)} do not cover {n} devices"
        )
    if jax.process_count() > 1 and dcn_axis is not None:
        idx = list(axis_names).index(dcn_axis)
        dcn = [1] * len(shapes)
        ici = list(shapes)
        # cross-host replicas on the dcn axis; the rest stays in-host
        per_host = shapes[idx] // jax.process_count()
        if per_host * jax.process_count() != shapes[idx]:
            raise DistributionError(
                f"dcn axis {dcn_axis} extent {shapes[idx]} not divisible by "
                f"{jax.process_count()} processes"
            )
        dcn[idx] = jax.process_count()
        ici[idx] = per_host
        try:
            devices = mesh_utils.create_hybrid_device_mesh(
                ici, dcn, devices=jax.devices()
            )
        except ValueError:
            # CPU multi-process runtimes have no slice_index (everything
            # reports slice 0), which create_hybrid_device_mesh requires.
            # Arrange manually: process-major device order with the dcn
            # axis's cross-process component outermost, so the dcn axis
            # still strides processes (the property that matters — the
            # 2-process DCN test exercises exactly this path).
            devs = np.array(
                sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
            )
            nproc = jax.process_count()
            rest = [s for i, s in enumerate(shapes) if i != idx]
            tmp = devs.reshape([nproc, per_host] + rest)
            perm, rest_axis = [], 2
            for i in range(len(shapes)):
                if i == idx:
                    perm += [0, 1]
                else:
                    perm.append(rest_axis)
                    rest_axis += 1
            devices = tmp.transpose(perm).reshape(shapes)
    else:
        devices = mesh_utils.create_device_mesh(shapes, devices=jax.devices())
    return Mesh(devices, tuple(axis_names))


def process_summary() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": [str(d) for d in jax.local_devices()],
    }
