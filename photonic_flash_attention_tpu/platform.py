"""The one place that decides what the program runs on.

Every branch on the machine goes through this module: which backend JAX
found, whether Pallas kernels run compiled or in the interpreter, and the
published peak rates of the device that numbers are divided by.

Only two platforms are known. ``gpu`` is the accelerator the kernels are
written for (NVIDIA Hopper through Pallas' Triton route and cuDNN).
``cpu`` exists for the test suite: kernels run in the Pallas interpreter
there, and its peak row is a placeholder that no measurement may cite.
Anything else raises, and so does a GPU whose ``device_kind`` has no row
in :data:`PEAKS`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import jax

KNOWN_PLATFORMS = ("gpu", "cpu")


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one device (dense, no sparsity)."""

    name: str
    bf16_flops: float
    fp8_flops: float
    int8_ops: float
    tf32_flops: float
    fp32_flops: float
    hbm_bytes_per_s: float
    hbm_bytes: float
    #: one direction of the all-to-all card interconnect
    link_bytes_per_s: float
    #: board power the rates assume
    power_w: float
    source: str
    is_placeholder: bool = False

    @property
    def ridge_flops_per_byte(self) -> float:
        """Operations per byte read at which bf16 compute becomes the bound."""
        return self.bf16_flops / self.hbm_bytes_per_s


_H100_SXM = DevicePeaks(
    name="NVIDIA H100 SXM",
    bf16_flops=989e12,
    fp8_flops=1979e12,
    int8_ops=1979e12,
    tf32_flops=495e12,
    fp32_flops=67e12,
    hbm_bytes_per_s=3.35e12,
    hbm_bytes=80e9,
    link_bytes_per_s=450e9,
    power_w=700.0,
    source="NVIDIA H100 data sheet, SXM part, dense rates",
)

#: Test-suite row: the interpreter has no meaningful peak. Marked as a
#: placeholder so nothing reports a share against it as a device metric.
_CPU = DevicePeaks(
    name="cpu (tests only)",
    bf16_flops=1e12,
    fp8_flops=1e12,
    int8_ops=1e12,
    tf32_flops=1e12,
    fp32_flops=1e12,
    hbm_bytes_per_s=50e9,
    hbm_bytes=16e9,
    link_bytes_per_s=10e9,
    power_w=100.0,
    source="placeholder for CPU test runs; not a device measurement",
    is_placeholder=True,
)

#: Peak table keyed by ``jax.Device.device_kind``.
PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
    "cpu": _CPU,
}


class UnknownDeviceError(RuntimeError):
    """The program met a platform or device kind it has no data for."""


@functools.lru_cache(maxsize=1)
def backend() -> str:
    """``"gpu"`` or ``"cpu"``; any other JAX backend raises."""
    name = jax.default_backend()
    if name == "cuda":
        name = "gpu"
    if name not in KNOWN_PLATFORMS:
        raise UnknownDeviceError(
            f"unsupported JAX backend {name!r}; this program runs on an "
            f"NVIDIA GPU (or the CPU for tests)"
        )
    return name


def on_gpu() -> bool:
    return backend() == "gpu"


def interpret_kernels() -> bool:
    """Pallas kernels run in the interpreter on the CPU and only there."""
    return backend() == "cpu"


def device_kind(device: Optional[jax.Device] = None) -> str:
    dev = device if device is not None else jax.devices()[0]
    return "cpu" if dev.platform == "cpu" else dev.device_kind


def device_peaks(device: Optional[jax.Device] = None) -> DevicePeaks:
    """The peak row of ``device`` (default: the first device).

    A device kind missing from :data:`PEAKS` is an error, never a default.
    """
    kind = device_kind(device)
    try:
        return PEAKS[kind]
    except KeyError:
        raise UnknownDeviceError(
            f"no peak rates for device kind {kind!r}; add a row to "
            f"photonic_flash_attention_tpu.platform.PEAKS with its source"
        ) from None


def describe() -> Dict[str, object]:
    """Platform, device kind and count as JAX reports them."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
