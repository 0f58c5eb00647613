"""The platform module: one decision on the machine, one peak table."""

import dataclasses

import jax
import pytest

from photonic_flash_attention_tpu import platform
from photonic_flash_attention_tpu.ops import pallas_utils


class TestBackend:
    def test_tests_run_on_the_cpu(self):
        assert platform.backend() == "cpu"
        assert not platform.on_gpu()

    def test_interpreter_only_on_cpu(self):
        assert platform.interpret_kernels()

    def test_unknown_backend_raises(self, monkeypatch):
        platform.backend.cache_clear()
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
        try:
            with pytest.raises(platform.UnknownDeviceError):
                platform.backend()
        finally:
            platform.backend.cache_clear()

    def test_cuda_backend_name_is_gpu(self, monkeypatch):
        platform.backend.cache_clear()
        monkeypatch.setattr(jax, "default_backend", lambda: "cuda")
        try:
            assert platform.backend() == "gpu"
        finally:
            platform.backend.cache_clear()

    def test_describe(self):
        d = platform.describe()
        assert d["platform"] == "cpu" and d["count"] == len(jax.devices())


class TestResolveInterpret:
    def test_default_follows_platform(self):
        assert pallas_utils.resolve_interpret(None) is True

    def test_explicit_values_on_cpu(self):
        assert pallas_utils.resolve_interpret(True) is True
        assert pallas_utils.resolve_interpret(False) is False

    def test_gpu_refuses_the_interpreter(self, monkeypatch):
        monkeypatch.setattr(platform, "interpret_kernels", lambda: False)
        assert pallas_utils.resolve_interpret(None) is False
        with pytest.raises(ValueError, match="refused on the GPU"):
            pallas_utils.resolve_interpret(True)


class TestPeaks:
    def test_h100_row_matches_the_data_sheet(self):
        h = platform.PEAKS["NVIDIA H100 80GB HBM3"]
        assert h.bf16_flops == 989e12
        assert h.fp8_flops == 1979e12 and h.int8_ops == 1979e12
        assert h.tf32_flops == 495e12 and h.fp32_flops == 67e12
        assert h.hbm_bytes_per_s == 3.35e12 and h.hbm_bytes == 80e9
        assert h.link_bytes_per_s == 450e9 and h.power_w == 700.0
        assert "data sheet" in h.source and not h.is_placeholder

    def test_ridge_point(self):
        h = platform.PEAKS["NVIDIA H100 80GB HBM3"]
        assert 290 < h.ridge_flops_per_byte < 300

    def test_cpu_row_is_a_placeholder(self):
        p = platform.device_peaks()
        assert p.is_placeholder and "not a device measurement" in p.source

    def test_unknown_device_kind_raises(self, monkeypatch):
        monkeypatch.setattr(platform, "device_kind", lambda device=None: "Some GPU 9000")
        with pytest.raises(platform.UnknownDeviceError, match="no peak rates"):
            platform.device_peaks()

    def test_peaks_are_immutable(self):
        with pytest.raises(dataclasses.FrozenInstanceError):
            platform.PEAKS["cpu"].power_w = 1.0
