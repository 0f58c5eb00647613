"""Device detection + roofline model sanity (peaks from the platform table)."""

import pytest

from photonic_flash_attention_tpu.hardware.detection import (
    detect_devices,
    get_best_device,
    get_device_info,
)
from photonic_flash_attention_tpu.hardware.roofline import (
    attention_decode_cost,
    attention_prefill_cost,
    kernel_energy_mj,
    matmul_cost,
    ring_attention_step_cost,
    roofline_fraction,
)
from photonic_flash_attention_tpu.platform import PEAKS

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


class TestDetection:
    def test_detects_devices(self):
        devs = detect_devices(refresh=True)
        assert len(devs) >= 1
        assert devs[0].platform == "cpu"
        assert devs[0].is_simulated

    def test_best_device(self):
        assert get_best_device() is not None

    def test_info_surface(self):
        info = get_device_info()
        assert info["device_count"] >= 1
        assert "name" in info["devices"][0]
        assert "placeholder" in info["devices"][0]["peaks_source"]


class TestRoofline:
    def test_prefill_compute_bound_long_seq(self):
        c = attention_prefill_cost(4, 4096, 4096, 12, 128, dtype="bf16", caps=H100)
        assert c.bound == "compute"
        assert c.flops == 4 * 4 * 12 * 4096 * 4096 * 128

    def test_decode_memory_bound(self):
        c = attention_decode_cost(8, 8192, 12, 12, 128, kv_dtype="bf16", caps=H100)
        assert c.bound == "memory"

    def test_int8_kv_halves_decode_bytes(self):
        bf16 = attention_decode_cost(8, 8192, 12, 12, 128, kv_dtype="bf16", caps=H100)
        int8 = attention_decode_cost(8, 8192, 12, 12, 128, kv_dtype="int8", caps=H100)
        # int8 payload is half; scales add a little back
        assert int8.hbm_bytes < 0.6 * bf16.hbm_bytes
        assert int8.t_roofline_us < bf16.t_roofline_us

    def test_causal_halves_flops(self):
        full = attention_prefill_cost(1, 2048, 2048, 8, 64, caps=H100)
        causal = attention_prefill_cost(1, 2048, 2048, 8, 64, causal=True, caps=H100)
        assert causal.flops == pytest.approx(full.flops / 2)

    def test_compute_time_at_published_peak(self):
        c = attention_prefill_cost(1, 2048, 2048, 8, 128, caps=H100)
        assert c.t_compute_us == pytest.approx(c.flops / 989e12 * 1e6)

    def test_ring_overlap_large_shards_hidden(self):
        r = ring_attention_step_cost(1, 8192, 16, 128, 4, caps=H100)
        assert r["comm_hidden"]
        assert r["overlap_efficiency"] == 1.0
        assert r["t_link_us"] == pytest.approx(2 * 16 * 8192 * 128 * 2 / 450e9 * 1e6)

    def test_roofline_fraction(self):
        c = matmul_cost(4096, 4096, 4096, caps=H100)
        assert 0.49 < roofline_fraction(c.t_roofline_us * 2, c) < 0.51

    def test_default_caps_come_from_the_platform(self):
        c = matmul_cost(256, 256, 256)
        assert c.t_compute_us > 0  # CPU test row; never a device metric


class TestEnergyModel:
    """Roofline-derived energy: bytes+flops aware, not latency x watts."""

    def test_energy_positive_and_scales_with_work(self):
        small = attention_prefill_cost(1, 512, 512, 8, 64, caps=H100)
        big = attention_prefill_cost(4, 4096, 4096, 8, 64, caps=H100)
        assert 0 < kernel_energy_mj(small, 0.1, caps=H100) < kernel_energy_mj(big, 0.1, caps=H100)

    def test_int8_decode_cheaper_than_bf16_at_equal_latency(self):
        """int8 KV moves half the bytes, so at IDENTICAL latency it costs
        less energy."""
        bf16 = attention_decode_cost(8, 8192, 12, 12, 128, kv_dtype="bf16", caps=H100)
        int8 = attention_decode_cost(8, 8192, 12, 12, 128, kv_dtype="int8", caps=H100)
        assert kernel_energy_mj(int8, 0.2, caps=H100) < kernel_energy_mj(bf16, 0.2, caps=H100)

    def test_static_term_scales_with_board_power(self):
        c = attention_decode_cost(1, 128, 1, 1, 64, caps=H100)
        e1 = kernel_energy_mj(c, 1.0, caps=H100)
        e2 = kernel_energy_mj(c, 2.0, caps=H100)
        from photonic_flash_attention_tpu.hardware.roofline import STATIC_POWER_FRACTION

        assert e2 - e1 == pytest.approx(STATIC_POWER_FRACTION * H100.power_w)

    def test_engine_reports_workload_aware_energy(self):
        import jax.numpy as jnp
        import numpy as np

        from photonic_flash_attention_tpu.core.engine import AttentionEngine
        from photonic_flash_attention_tpu.core.router import AdaptiveRouter

        rng = np.random.default_rng(0)
        eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))
        q = jnp.asarray(rng.standard_normal((1, 256, 2, 64)), jnp.float32)
        eng(q, q, q)
        stats = eng.get_performance_stats()
        assert stats["last_energy_mj"] > 0
