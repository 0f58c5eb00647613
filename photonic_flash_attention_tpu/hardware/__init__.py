"""Hardware: device detection and the roofline cost model."""

from .detection import (
    Device,
    detect_devices,
    get_best_device,
    get_device_info,
)
from .roofline import (
    KernelCost,
    attention_decode_cost,
    attention_prefill_cost,
    kernel_energy_mj,
    matmul_cost,
    ring_attention_step_cost,
    roofline_fraction,
)

__all__ = [
    "Device",
    "KernelCost",
    "attention_decode_cost",
    "attention_prefill_cost",
    "detect_devices",
    "get_best_device",
    "get_device_info",
    "kernel_energy_mj",
    "matmul_cost",
    "ring_attention_step_cost",
    "roofline_fraction",
]
