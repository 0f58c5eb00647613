"""Device detection.

The rebirth of reference photonic/hardware/detection.py:10-258: probe the
platform, enumerate devices with their capabilities, keep a module
singleton with ``detect_*``/``get_best_*``/``get_device_info`` surface.
The reference probed lspci/device files for photonic accelerators and
always fell back to a simulator; here the probe is ``jax.devices()`` and
each device's peak rates come from the one table in
:mod:`photonic_flash_attention_tpu.platform` (an unknown accelerator
raises there). The CPU row exists only for the test suite.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import jax

from .. import platform
from ..platform import DevicePeaks
from ..utils.logging import get_logger

logger = get_logger("hardware")


@dataclasses.dataclass
class Device:
    """Detected device (reference PhotonicDevice dataclass :10-21)."""

    device_id: int
    kind: str
    platform: str
    peaks: DevicePeaks
    process_index: int = 0

    @property
    def is_simulated(self) -> bool:
        """True for the CPU test backend (interpreted kernels)."""
        return self.platform == "cpu"


class HardwareDetector:
    """Singleton detector (reference PhotonicHardwareDetector)."""

    def __init__(self) -> None:
        self._devices: Optional[List[Device]] = None
        self._lock = threading.Lock()

    def detect(self, refresh: bool = False) -> List[Device]:
        with self._lock:
            if self._devices is not None and not refresh:
                return self._devices
            self._devices = [
                Device(
                    device_id=d.id,
                    kind=platform.device_kind(d),
                    platform=d.platform,
                    peaks=platform.device_peaks(d),
                    process_index=d.process_index,
                )
                for d in jax.devices()
            ]
            return self._devices

    def best(self) -> Optional[Device]:
        devices = self.detect()
        if not devices:
            return None
        return max(devices, key=lambda d: d.peaks.bf16_flops)

    def info(self) -> Dict:
        devices = self.detect()
        return {
            "device_count": len(devices),
            "simulated": all(d.is_simulated for d in devices),
            "devices": [
                {
                    "id": d.device_id,
                    "kind": d.kind,
                    "platform": d.platform,
                    "name": d.peaks.name,
                    "bf16_tflops": d.peaks.bf16_flops / 1e12,
                    "hbm_gb": d.peaks.hbm_bytes / 1e9,
                    "peaks_source": d.peaks.source,
                }
                for d in devices
            ],
        }


_detector: Optional[HardwareDetector] = None
_det_lock = threading.Lock()


def _get_detector() -> HardwareDetector:
    global _detector
    if _detector is None:
        with _det_lock:
            if _detector is None:
                _detector = HardwareDetector()
    return _detector


def detect_devices(refresh: bool = False) -> List[Device]:
    """Reference detect_photonic_hardware :212."""
    return _get_detector().detect(refresh)


def get_best_device() -> Optional[Device]:
    """Reference get_best_photonic_device :229."""
    return _get_detector().best()


def get_device_info() -> Dict:
    """Reference get_device_info :258."""
    return _get_detector().info()
