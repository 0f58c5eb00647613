"""Collective telemetry — per-axis communication accounting.

The rebirth of the photonic NoC simulator's *observable* surface
(reference photonic/optical_kernels/interconnect.py:475-515: per-link
utilization stats, congestion detection at >= 0.8 utilization, delivery
stats) for real XLA collectives: every instrumented collective call site
records bytes moved per (mesh axis, op), utilization is estimated against
the card-to-card link bandwidth (``platform.device_peaks``), and the
congestion threshold drives
the same adapt/alert behavior the reference's ``adapt_routing`` had.

Byte accounting is host-side and analytic (collectives execute inside
jit; XLA exposes no per-op counters) — which is exactly what the
reference's simulator provided, except the transfers here are real and
the bandwidth model matches the hardware.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import jax
import numpy as np

from .. import platform
from ..utils.logging import get_logger

logger = get_logger("telemetry")

CONGESTION_THRESHOLD = 0.8  # reference interconnect.py:486-502


def collective_bytes(op: str, shard_bytes: int, axis_size: int) -> int:
    """Bytes a device moves for one collective over an axis (ring algos)."""
    if axis_size <= 1:
        return 0
    if op == "ppermute":
        return shard_bytes
    if op == "all_gather":
        return shard_bytes * (axis_size - 1)
    if op == "psum":  # ring all-reduce = reduce-scatter + all-gather
        return 2 * shard_bytes * (axis_size - 1) // axis_size * 1
    if op == "reduce_scatter":
        return shard_bytes * (axis_size - 1) // axis_size
    if op == "all_to_all":
        return shard_bytes * (axis_size - 1) // axis_size
    return shard_bytes


@dataclasses.dataclass
class AxisStats:
    bytes_total: int = 0
    ops: int = 0
    by_op: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    window_start: float = dataclasses.field(default_factory=time.time)
    window_bytes: int = 0
    # Analytic minimum seconds of link busy time for the window's traffic
    # (bytes / full link bandwidth). The honest denominator-free quantity:
    # wall-clock of the *recording* loop says nothing about transfer
    # duration (records happen host-side, often at trace time).
    window_busy_s: float = 0.0


class CollectiveTelemetry:
    """Per-axis byte/utilization accounting (the NoC stats surface)."""

    WINDOW_S = 10.0

    def __init__(self, link_gbps: Optional[float] = None) -> None:
        if link_gbps is None:
            link_gbps = platform.device_peaks().link_bytes_per_s / 1e9
        self.link_gbps = max(link_gbps, 1e-3)
        self._axes: Dict[str, AxisStats] = defaultdict(AxisStats)
        self._lock = threading.RLock()
        self._congestion_events = 0
        self._last_congestion_log: Dict[str, float] = {}

    def record(self, axis: str, op: str, shard_bytes: int, axis_size: int) -> None:
        moved = collective_bytes(op, shard_bytes, axis_size)
        now = time.time()
        with self._lock:
            st = self._axes[axis]
            st.bytes_total += moved
            st.ops += 1
            st.by_op[op] += moved
            if now - st.window_start > self.WINDOW_S:
                st.window_start = now
                st.window_bytes = 0
                st.window_busy_s = 0.0
            st.window_bytes += moved
            st.window_busy_s += moved / (self.link_gbps * 1e9)
            if self.utilization(axis) >= CONGESTION_THRESHOLD:
                self._congestion_events += 1
                # Rate-limit to one log line per window per axis — a hot
                # collective loop would otherwise emit one warning per call
                # (observed flooding the multichip dryrun log in round 1).
                if now - self._last_congestion_log.get(axis, 0.0) > self.WINDOW_S:
                    self._last_congestion_log[axis] = now
                    # On a virtual CPU mesh the link model is meaningless
                    # (there is no link): info there, warning on cards.
                    level = logger.warning if platform.on_gpu() else logger.info
                    level(
                        "axis %s congested (analytic estimate: recorded "
                        "traffic needs %.0f%% of link time this window)",
                        axis,
                        100 * self.utilization(axis),
                    )

    def utilization(self, axis: str) -> float:
        """Analytic link busy fraction over the current window, in [0, 1].

        ``window_busy_s`` is the minimum time the window's recorded bytes
        would occupy the link at full bandwidth; the denominator is
        the window wall-clock, floored by the busy time itself (a link
        cannot be busy for longer than the elapsed time it was busy).
        This is an *analytic estimate* — XLA exposes no per-collective
        timing — so it is a lower bound on pressure, never >100%.
        (Replaces the round-2 formula that divided burst bytes by the
        recording loop's wall-clock and reported 131x "utilization".)
        """
        st = self._axes.get(axis)
        if st is None:
            return 0.0
        elapsed = max(time.time() - st.window_start, 1e-3)
        return st.window_busy_s / max(elapsed, st.window_busy_s)

    def record_array(self, axis: str, op: str, x, axis_size: int) -> None:
        nbytes = int(np.prod(x.shape)) * jax.numpy.dtype(x.dtype).itemsize
        self.record(axis, op, nbytes, axis_size)

    def get_stats(self) -> Dict:
        with self._lock:
            return {
                "link_gbps": self.link_gbps,
                "congestion_events": self._congestion_events,
                "utilization_note": (
                    "analytic lower-bound busy fraction (bytes / link "
                    "bandwidth vs window wall-clock), capped at 1.0"
                ),
                "axes": {
                    name: {
                        "bytes_total": st.bytes_total,
                        "ops": st.ops,
                        "by_op": dict(st.by_op),
                        "utilization": self.utilization(name),
                    }
                    for name, st in self._axes.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._axes.clear()
            self._congestion_events = 0


_telemetry: Optional[CollectiveTelemetry] = None
_tel_lock = threading.Lock()


def get_telemetry() -> CollectiveTelemetry:
    global _telemetry
    if _telemetry is None:
        with _tel_lock:
            if _telemetry is None:
                _telemetry = CollectiveTelemetry()
    return _telemetry
