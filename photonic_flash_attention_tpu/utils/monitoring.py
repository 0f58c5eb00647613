"""Lightweight metric rings + device telemetry.

Rebirth of reference utils/monitoring.py:9-90 (metric rings) and the
thermal/health monitors' *measurement surface* (reference
monitoring/thermal_monitor.py, health_monitor.py) mapped to real device
signals: HBM usage from ``jax.Device.memory_stats()`` and step latencies
from the engine. The state machine lives in ``core.health``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

import jax


class MetricRing:
    """Fixed-capacity rolling metric window (reference monitoring.py:9-50)."""

    def __init__(self, capacity: int = 256) -> None:
        self._values: Deque[Tuple[float, float]] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, value: float, timestamp: Optional[float] = None) -> None:
        with self._lock:
            self._values.append((timestamp or time.time(), float(value)))

    def __len__(self) -> int:
        return len(self._values)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            vals = [v for _, v in self._values]
        if not vals:
            return {"count": 0}
        vals_sorted = sorted(vals)
        n = len(vals)
        return {
            "count": n,
            "mean": sum(vals) / n,
            "min": vals_sorted[0],
            "max": vals_sorted[-1],
            "p50": vals_sorted[n // 2],
            "p95": vals_sorted[min(n - 1, int(n * 0.95))],
            "last": vals[-1],
        }


class MetricRegistry:
    """Named metric rings with a single snapshot call."""

    def __init__(self) -> None:
        self._rings: Dict[str, MetricRing] = {}
        self._lock = threading.Lock()

    def ring(self, name: str) -> MetricRing:
        with self._lock:
            if name not in self._rings:
                self._rings[name] = MetricRing()
            return self._rings[name]

    def record(self, name: str, value: float) -> None:
        self.ring(name).record(value)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = list(self._rings.items())
        return {name: ring.summary() for name, ring in items}


_registry: Optional[MetricRegistry] = None
_registry_lock = threading.Lock()


def get_metrics() -> MetricRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricRegistry()
    return _registry


def device_memory_stats(device: Optional[jax.Device] = None) -> Dict[str, Any]:
    """HBM usage for one device; replaces the reference's CUDA memory probes."""
    device = device or jax.devices()[0]
    try:
        stats = device.memory_stats() or {}
    except (RuntimeError, AttributeError, NotImplementedError):
        stats = {}
    out: Dict[str, Any] = {
        "platform": device.platform,
        "device": str(device),
    }
    if stats:
        limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
        in_use = stats.get("bytes_in_use")
        out.update(
            {
                "bytes_in_use": in_use,
                "bytes_limit": limit,
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "utilization": (in_use / limit) if (in_use and limit) else None,
            }
        )
    return out
