"""Fault tolerance: degradation ladder + resilient attention wrapper.

The rebirth of reference resilience/fault_tolerance.py:27-1113:

* ``GracefulDegradationManager`` (reference :201-328) — trigger ->
  config-rewrite table. The reference rewrote optical knobs
  (photonic-failure->gpu_only, thermal->reduce optical power); this
  ladder rewrites real engine knobs: quantization accuracy failure ->
  raise precision (int8 -> bf16), memory pressure -> shrink batch /
  evict KV pages, latency SLO breach -> drop to the cheaper kernel,
  kernel failure -> pin the fused XLA path.
* ``ResilientAttentionWrapper`` (reference :939-1113) — composes circuit
  breaker + recovery policies + the degradation ladder around any
  attention callable, with a last-resort uniform-attention fallback
  (mean over values — finite, shape-correct, clearly flagged).

The reference's ``AutoRecoverySystem``'s named strategies (:331-608) are
covered by :mod:`..core.error_recovery`'s policy table.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import get_config, set_global_config
from ..core.error_recovery import CircuitBreaker, get_recovery_manager
from ..utils.logging import get_logger

logger = get_logger("resilience")


class DegradationLevel(int, enum.Enum):
    NORMAL = 0
    REDUCED = 1  # precision raised / cheaper kernels preferred
    MINIMAL = 2  # fused XLA path only
    EMERGENCY = 3  # last-resort fallback answers


class DegradationTrigger(str, enum.Enum):
    QUANT_ACCURACY = "quant_accuracy"  # quantized output failed numeric gates
    MEMORY_PRESSURE = "memory_pressure"
    LATENCY_SLO = "latency_slo"
    KERNEL_FAILURE = "kernel_failure"


@dataclasses.dataclass
class DegradationAction:
    """One rung of the ladder: what config to rewrite and how to undo."""

    trigger: DegradationTrigger
    level: DegradationLevel
    description: str
    apply: Callable[[], None]
    revert: Callable[[], None]


class GracefulDegradationManager:
    """Trigger -> config-rewrite ladder (reference :201-328)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._active: Dict[DegradationTrigger, DegradationAction] = {}
        self._history: List[Dict] = []
        self._saved: Dict[str, Any] = {}

    def _save(self, key: str) -> None:
        if key not in self._saved:
            self._saved[key] = getattr(get_config(), key)

    def _actions(self, trigger: DegradationTrigger) -> DegradationAction:
        cfg = get_config()
        if trigger == DegradationTrigger.QUANT_ACCURACY:
            self._save("quant_mode")
            self._save("kv_cache_dtype")
            return DegradationAction(
                trigger,
                DegradationLevel.REDUCED,
                "raise precision: quant_mode/kv_cache_dtype -> bf16",
                apply=lambda: set_global_config(quant_mode="bf16", kv_cache_dtype="bf16"),
                revert=lambda: set_global_config(
                    quant_mode=self._saved["quant_mode"],
                    kv_cache_dtype=self._saved["kv_cache_dtype"],
                ),
            )
        if trigger == DegradationTrigger.MEMORY_PRESSURE:
            self._save("max_batch_size")
            new_batch = max(1, cfg.max_batch_size // 2)
            return DegradationAction(
                trigger,
                DegradationLevel.REDUCED,
                f"halve max_batch_size -> {new_batch}",
                apply=lambda: set_global_config(max_batch_size=new_batch),
                revert=lambda: set_global_config(
                    max_batch_size=self._saved["max_batch_size"]
                ),
            )
        if trigger == DegradationTrigger.LATENCY_SLO:
            self._save("auto_kernel_selection")
            return DegradationAction(
                trigger,
                DegradationLevel.REDUCED,
                "freeze router exploration (static threshold dispatch)",
                apply=lambda: set_global_config(auto_kernel_selection=False),
                revert=lambda: set_global_config(
                    auto_kernel_selection=self._saved["auto_kernel_selection"]
                ),
            )
        # KERNEL_FAILURE
        self._save("flash_threshold")
        return DegradationAction(
            trigger,
            DegradationLevel.MINIMAL,
            "pin fused XLA path (flash_threshold -> inf)",
            apply=lambda: set_global_config(flash_threshold=1 << 30),
            revert=lambda: set_global_config(
                flash_threshold=self._saved["flash_threshold"]
            ),
        )

    def degrade(self, trigger: DegradationTrigger, reason: str = "") -> DegradationAction:
        with self._lock:
            if trigger in self._active:
                return self._active[trigger]
            action = self._actions(trigger)
            action.apply()
            self._active[trigger] = action
            self._history.append(
                {"time": time.time(), "event": "degrade", "trigger": trigger.value,
                 "action": action.description, "reason": reason}
            )
            logger.warning("degraded (%s): %s", trigger.value, action.description)
            return action

    def recover(self, trigger: DegradationTrigger) -> bool:
        with self._lock:
            action = self._active.pop(trigger, None)
            if action is None:
                return False
            action.revert()
            self._history.append(
                {"time": time.time(), "event": "recover", "trigger": trigger.value}
            )
            logger.info("recovered from %s", trigger.value)
            return True

    def recover_all(self) -> None:
        with self._lock:
            for trigger in list(self._active):
                self.recover(trigger)

    @property
    def level(self) -> DegradationLevel:
        with self._lock:
            if not self._active:
                return DegradationLevel.NORMAL
            return max(a.level for a in self._active.values())

    def get_status(self) -> Dict:
        with self._lock:
            return {
                "level": self.level.name,
                "active_triggers": [t.value for t in self._active],
                "history_len": len(self._history),
                "recent": self._history[-5:],
            }


class ResilientAttentionWrapper:
    """Compose breaker + recovery + degradation around an attention callable
    (reference fault_tolerance.py:939-1113).

    ``attention_fn(q, k, v, mask=None, **kw) -> (out, weights)``;
    the wrapper preserves that contract under failure.
    """

    def __init__(
        self,
        attention_fn: Callable,
        fallback_fn: Optional[Callable] = None,
        degradation: Optional[GracefulDegradationManager] = None,
        breaker: Optional[CircuitBreaker] = None,
        max_failures_before_degrade: int = 3,
    ) -> None:
        self.attention_fn = attention_fn
        self.fallback_fn = fallback_fn
        self.degradation = degradation or GracefulDegradationManager()
        self.breaker = breaker or CircuitBreaker("resilient_attention", 10, 15.0)
        self.max_failures_before_degrade = max_failures_before_degrade
        self._failures = 0
        self._successes = 0
        self._last_resort_uses = 0
        self._lock = threading.RLock()

    def __call__(self, q, k, v, mask=None, **kwargs) -> Tuple[Any, Any]:
        recovery = get_recovery_manager()
        try:
            with self.breaker:
                out = self.attention_fn(q, k, v, mask, **kwargs)
            with self._lock:
                self._successes += 1
                self._failures = 0
            return out
        except Exception as primary:  # noqa: BLE001
            with self._lock:
                self._failures += 1
                if self._failures >= self.max_failures_before_degrade:
                    self.degradation.degrade(
                        DegradationTrigger.KERNEL_FAILURE, str(primary)[:120]
                    )
            try:
                return recovery.handle_error(
                    primary,
                    operation=lambda: self.attention_fn(q, k, v, mask, **kwargs),
                    fallback=(
                        (lambda: self.fallback_fn(q, k, v, mask, **kwargs))
                        if self.fallback_fn
                        else None
                    ),
                )
            except Exception as secondary:  # noqa: BLE001
                logger.error(
                    "attention failed through all recovery paths: %s", secondary
                )
                return self._last_resort(q, k, v), None

    def _last_resort(self, q, k, v):
        """Finite, shape-correct emergency output: uniform attention
        (mean over values) — the reference's identity-ish fallback
        (fault_tolerance.py:1060-1113)."""
        with self._lock:
            self._last_resort_uses += 1
        hq = q.shape[2]
        hkv = v.shape[2]
        vv = jnp.repeat(v, hq // hkv, axis=2) if hq != hkv else v
        out = jnp.broadcast_to(
            jnp.mean(vv.astype(jnp.float32), axis=1, keepdims=True), q.shape
        )
        return out.astype(q.dtype)

    def get_status(self) -> Dict:
        with self._lock:
            return {
                "successes": self._successes,
                "consecutive_failures": self._failures,
                "last_resort_uses": self._last_resort_uses,
                "breaker_state": self.breaker.state.value,
                "degradation": self.degradation.get_status(),
            }
