"""Analytic roofline cost model for attention kernels.

The rebirth of the reference's device-physics sandbox (reference
photonic/simulation/circuit.py:25-665 simulated S-matrices and frequency
responses of a hardware it didn't have) as the model an attention engine
actually needs: given a workload and a device's published peaks
(:mod:`photonic_flash_attention_tpu.platform`), predict FLOPs, bytes
moved, compute-bound vs memory-bound, and the speed-of-light latency.
Three consumers:

* the router — analytic priors before measurements exist,
* the autotuner — sanity bounds on measured numbers,
* bench/CI — "% of roofline" reporting (the north-star metric).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .. import platform
from ..platform import DevicePeaks

_DTYPE_BYTES = {"bf16": 2, "fp16": 2, "f32": 4, "fp8": 1, "int8": 1}


@dataclasses.dataclass
class KernelCost:
    flops: float
    hbm_bytes: float
    t_compute_us: float
    t_memory_us: float

    @property
    def t_roofline_us(self) -> float:
        return max(self.t_compute_us, self.t_memory_us)

    @property
    def bound(self) -> str:
        return "compute" if self.t_compute_us >= self.t_memory_us else "memory"

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "t_compute_us": self.t_compute_us,
            "t_memory_us": self.t_memory_us,
            "t_roofline_us": self.t_roofline_us,
            "bound": self.bound,
            "arithmetic_intensity": self.arithmetic_intensity,
        }


def _caps(caps: Optional[DevicePeaks]) -> DevicePeaks:
    return caps if caps is not None else platform.device_peaks()


def _peak_flops(c: DevicePeaks, dtype: str) -> float:
    if dtype in ("int8", "fp8"):
        return c.int8_ops
    if dtype == "f32":
        return c.tf32_flops
    return c.bf16_flops


def attention_prefill_cost(
    batch: int,
    q_len: int,
    kv_len: int,
    num_heads: int,
    head_dim: int,
    *,
    causal: bool = False,
    dtype: str = "bf16",
    caps: Optional[DevicePeaks] = None,
) -> KernelCost:
    """Flash-attention forward cost (QK^T + PV, streaming KV from HBM)."""
    c = _caps(caps)
    frac = 0.5 if causal and q_len == kv_len else 1.0
    flops = 4.0 * batch * num_heads * q_len * kv_len * head_dim * frac
    b = _DTYPE_BYTES[dtype]
    # q read + o write once; k, v read once (flash streams tiles).
    hbm = batch * num_heads * head_dim * b * (2 * q_len + 2 * kv_len)
    t_comp = flops / _peak_flops(c, dtype) * 1e6
    t_mem = hbm / c.hbm_bytes_per_s * 1e6
    return KernelCost(flops, hbm, t_comp, t_mem)


def attention_decode_cost(
    batch: int,
    kv_len: int,
    num_q_heads: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    kv_dtype: str = "bf16",
    caps: Optional[DevicePeaks] = None,
) -> KernelCost:
    """Paged decode cost: one query token vs the whole KV cache.

    Decode is HBM-bound: the cache read dominates. INT8 KV halves bytes
    — the source of its ~2x decode speedup.
    """
    c = _caps(caps)
    flops = 4.0 * batch * num_q_heads * kv_len * head_dim
    b = _DTYPE_BYTES[kv_dtype]
    hbm = 2.0 * batch * num_kv_heads * kv_len * head_dim * b  # K + V read
    if kv_dtype == "int8":
        hbm += 2.0 * batch * num_kv_heads * kv_len * 4  # per-token scales
    t_comp = flops / c.bf16_flops * 1e6
    t_mem = hbm / c.hbm_bytes_per_s * 1e6
    return KernelCost(flops, hbm, t_comp, t_mem)


def matmul_cost(
    m: int,
    n: int,
    k: int,
    *,
    dtype: str = "bf16",
    caps: Optional[DevicePeaks] = None,
) -> KernelCost:
    c = _caps(caps)
    flops = 2.0 * m * n * k
    b = _DTYPE_BYTES[dtype]
    hbm = (m * k + k * n + m * n) * b
    return KernelCost(
        flops, hbm, flops / _peak_flops(c, dtype) * 1e6, hbm / c.hbm_bytes_per_s * 1e6
    )


def ring_attention_step_cost(
    batch: int,
    local_seq: int,
    num_heads: int,
    head_dim: int,
    n_devices: int,
    *,
    dtype: str = "bf16",
    caps: Optional[DevicePeaks] = None,
) -> Dict:
    """Per-step compute vs the KV shard's transfer to the next card.

    Ring attention hides communication when t_compute >= t_link (each
    step sends one K/V shard one way over the card-to-card link);
    returns both plus the predicted overlap ratio.
    """
    c = _caps(caps)
    comp = attention_prefill_cost(
        batch, local_seq, local_seq, num_heads, head_dim, dtype=dtype, caps=c
    )
    b = _DTYPE_BYTES[dtype]
    kv_bytes = 2.0 * batch * num_heads * local_seq * head_dim * b
    t_link_us = kv_bytes / max(c.link_bytes_per_s, 1.0) * 1e6
    overlap = min(1.0, comp.t_roofline_us / max(t_link_us, 1e-9))
    return {
        "t_compute_us": comp.t_roofline_us,
        "t_link_us": t_link_us,
        "overlap_efficiency": overlap,
        "comm_hidden": comp.t_roofline_us >= t_link_us,
        "steps": n_devices,
    }


def roofline_fraction(measured_us: float, cost: KernelCost) -> float:
    """Fraction of speed-of-light achieved (north-star metric)."""
    return cost.t_roofline_us / max(measured_us, 1e-9)


# -- energy model ---------------------------------------------------------

# Analytic per-operation energy constants (documented ESTIMATES, not
# measurements: no per-kernel power counter is read here). Magnitudes
# follow the public accelerator-architecture literature (Horowitz ISSCC'14
# scaled to ~5nm; HBM3 access energy ~3-5 pJ/bit): a tensor-core bf16
# FLOP costs O(0.1) pJ, roughly doubled for chip overheads; an HBM byte
# costs ~100x a FLOP — which is why a bytes-aware model ranks kernels that
# a latency x watts model cannot (int8 KV's halved traffic).
PJ_PER_FLOP = {
    "bf16": 0.30,
    "fp16": 0.30,
    "f32": 0.60,
    "int8": 0.12,
    "fp8": 0.12,
}
PJ_PER_HBM_BYTE = 40.0
#: Share of the card's board power drawn regardless of work (clocks,
#: links, DRAM refresh): an estimate, applied to ``DevicePeaks.power_w``.
STATIC_POWER_FRACTION = 0.12


def kernel_energy_mj(
    cost: KernelCost,
    latency_ms: float,
    *,
    dtype: str = "bf16",
    caps: Optional[DevicePeaks] = None,
) -> float:
    """Roofline-derived energy estimate for one kernel execution.

    ``E = flops * e_flop(dtype) + hbm_bytes * e_byte + P_static * t``.
    The dynamic terms scale with the WORK, the static term with measured
    wall time at a fixed share of the card's board power.
    """
    e_flop = PJ_PER_FLOP.get(dtype, PJ_PER_FLOP["bf16"])
    dynamic_pj = cost.flops * e_flop + cost.hbm_bytes * PJ_PER_HBM_BYTE
    static_w = STATIC_POWER_FRACTION * _caps(caps).power_w
    return dynamic_pj * 1e-9 + static_w * latency_ms  # W * ms = mJ
