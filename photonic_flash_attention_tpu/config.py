"""Global configuration for the attention engine.

The rebirth of the reference's ``GlobalConfig`` singleton
(cf. reference src/photonic_flash_attention/config.py:8-101): one typed
dataclass singleton, environment-variable overrides, and validated
``update(**kwargs)``.  The photonic knobs (wavelengths, optical power,
modulator resolution) become their analogues here: quantization mode,
kernel block sizes, router thresholds, and mesh axis names.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Optional, Tuple


@dataclasses.dataclass
class GlobalConfig:
    """Process-wide configuration singleton.

    Attributes mirror the *capabilities* of the reference config
    (device priority, routing threshold, memory fraction, thermal/logging
    flags) re-expressed for a GPU inference engine.
    """

    # --- kernel routing (reference: photonic_threshold=512, config.py:14) ---
    #: sequence length at/above which the tiled flash kernel is preferred
    #: over the fused short-sequence path.
    flash_threshold: int = 512
    #: minimum total tokens (batch * seq) for the flash kernel: below it
    #: the fused XLA path serves the call. Not measured on the GPU yet;
    #: the reference's heuristic similarly gated on total ops
    #: (hybrid_router.py:160-173 total-ops > 1e6 -> photonic).
    flash_min_tokens: int = 2048
    #: sequence length at/above which ring (sequence-parallel) attention is
    #: preferred when a `seq` mesh axis is available.
    ring_threshold: int = 16384
    #: enable the adaptive (measured-latency) router; when False the static
    #: threshold dispatch above is used.
    auto_kernel_selection: bool = True
    #: self-driving block tuning: the first adaptive-routing encounter of
    #: a flash workload bucket measures up to 3 block-size candidates
    #: (scan-chained fits, core/timing.py) and persists the winner —
    #: production traffic no longer needs an explicit engine.autotune()
    #: call (the in-band version of the reference's background
    #: re-optimizer, autonomous_optimizer.py:167-191).
    auto_block_tuning: bool = True
    #: energy-aware kernel arbitration weight in [0, 1] (VERDICT r4 #10;
    #: the reference's latency-vs-energy framing, hybrid_router.py:599-611,
    #: with measured numbers). 0 = rank kernels purely by measured
    #: latency (default); w > 0 ranks by
    #: ``(1-w)*latency_ms + w*energy_mj/board_watts`` — the energy term
    #: expressed as the time an equal-energy kernel would take at board
    #: power, so int8-QK's lower HBM traffic can break near-latency ties
    #: (a lower-traffic kernel can win a near-latency tie).
    energy_weight: float = 0.0

    # --- quantization (reference: 6-bit modulator, matrix_mult.py:36) ---
    #: quantization mode: "bf16" | "int8" (int8 quantizes the KV cache;
    #: attention activations stay bf16).
    quant_mode: str = "bf16"
    #: dtype used for the KV cache payload: "bf16" | "int8".
    kv_cache_dtype: str = "bf16"
    #: block size (tokens) for per-block quantization scales.
    quant_block_size: int = 128

    #: paged KV-cache page size in tokens (a power of two).
    page_size: int = 64

    # --- memory (reference: max_memory_fraction=0.8, config.py) ---
    max_memory_fraction: float = 0.8
    #: HBM bytes reserved for the paged KV cache (0 = auto-size).
    kv_cache_bytes: int = 0

    # --- distribution ---
    mesh_data_axis: str = "data"
    mesh_model_axis: str = "model"
    mesh_seq_axis: str = "seq"

    # --- observability (reference: enable_profiling, log flags) ---
    enable_profiling: bool = False
    log_level: str = "INFO"

    # --- safety rails (reference: seq caps 8192/16384, validation.py:193) ---
    max_sequence_length: int = 1 << 20
    max_batch_size: int = 4096

    def update(self, **kwargs: Any) -> None:
        """Update config attributes, rejecting unknown keys.

        Mirrors reference ``GlobalConfig.update`` (config.py:51-59).
        """
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"Unknown config key: {key!r}")
            setattr(self, key, value)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# Environment override table (reference: config.py:61-83).
_ENV_OVERRIDES: Tuple[Tuple[str, str, Any], ...] = (
    ("PFA_FLASH_THRESHOLD", "flash_threshold", int),
    ("PFA_FLASH_MIN_TOKENS", "flash_min_tokens", int),
    ("PFA_RING_THRESHOLD", "ring_threshold", int),
    ("PFA_QUANT_MODE", "quant_mode", str),
    ("PFA_KV_CACHE_DTYPE", "kv_cache_dtype", str),
    ("PFA_PAGE_SIZE", "page_size", int),
    ("PFA_LOG_LEVEL", "log_level", str),
    ("PFA_ENABLE_PROFILING", "enable_profiling", lambda v: v.lower() in ("1", "true", "yes")),
    ("PFA_AUTO_KERNEL_SELECTION", "auto_kernel_selection", lambda v: v.lower() in ("1", "true", "yes")),
    ("PFA_AUTO_BLOCK_TUNING", "auto_block_tuning", lambda v: v.lower() in ("1", "true", "yes")),
    ("PFA_ENERGY_WEIGHT", "energy_weight", float),
)

_config_lock = threading.Lock()
_config: Optional[GlobalConfig] = None


def _from_env() -> GlobalConfig:
    cfg = GlobalConfig()
    for env_name, attr, conv in _ENV_OVERRIDES:
        raw = os.environ.get(env_name)
        if raw is not None:
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                pass  # ignore malformed env values, keep defaults
    return cfg


def get_config() -> GlobalConfig:
    """Return the process-wide config singleton (reference config.py:99-101)."""
    global _config
    if _config is None:
        with _config_lock:
            if _config is None:
                _config = _from_env()
    return _config


def set_global_config(**kwargs: Any) -> GlobalConfig:
    """Update the global config (reference __init__.py:69-72)."""
    cfg = get_config()
    cfg.update(**kwargs)
    return cfg


def reset_config() -> None:
    """Reset to env-derived defaults (used by tests)."""
    global _config
    with _config_lock:
        _config = None
