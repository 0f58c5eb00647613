"""Collective telemetry + multihost helpers + mesh construction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photonic_flash_attention_tpu.parallel.mesh import create_mesh
from photonic_flash_attention_tpu.parallel.multihost import (
    initialize_multihost,
    pod_mesh,
    process_summary,
)
from photonic_flash_attention_tpu.parallel.telemetry import (
    CONGESTION_THRESHOLD,
    CollectiveTelemetry,
    collective_bytes,
)
from photonic_flash_attention_tpu.utils.exceptions import DistributionError


class TestCollectiveBytes:
    def test_ppermute(self):
        assert collective_bytes("ppermute", 100, 4) == 100

    def test_all_gather(self):
        assert collective_bytes("all_gather", 100, 4) == 300

    def test_single_device_free(self):
        assert collective_bytes("psum", 100, 1) == 0

    def test_reduce_scatter(self):
        assert collective_bytes("reduce_scatter", 100, 4) == 75


class TestTelemetry:
    def test_records_and_reports(self):
        t = CollectiveTelemetry(link_gbps=100.0)
        t.record("seq", "ppermute", 1 << 20, 4)
        t.record("seq", "ppermute", 1 << 20, 4)
        t.record("model", "psum", 1 << 20, 2)
        s = t.get_stats()
        assert s["axes"]["seq"]["ops"] == 2
        assert s["axes"]["seq"]["bytes_total"] == 2 << 20
        assert "psum" in s["axes"]["model"]["by_op"]

    def test_congestion_detection(self):
        t = CollectiveTelemetry(link_gbps=1e-6)  # tiny capacity
        t.record("seq", "all_gather", 10 << 20, 8)
        t.record("seq", "all_gather", 10 << 20, 8)
        assert t.get_stats()["congestion_events"] >= 1
        assert t.utilization("seq") >= CONGESTION_THRESHOLD

    def test_utilization_capped_at_one(self):
        """Analytic busy fraction never exceeds 100% (round-2 bug: 131x)."""
        t = CollectiveTelemetry(link_gbps=1e-6)
        for _ in range(50):
            t.record("seq", "all_gather", 100 << 20, 8)
        assert 0.0 <= t.utilization("seq") <= 1.0
        assert t.get_stats()["axes"]["seq"]["utilization"] <= 1.0

    def test_ring_attention_records(self, rng):
        from photonic_flash_attention_tpu.parallel.ring import make_ring_attention
        from photonic_flash_attention_tpu.parallel.telemetry import get_telemetry

        get_telemetry().reset()
        mesh = create_mesh((4,), ("seq",), jax.devices()[:4])
        fn = make_ring_attention(mesh, data_axis=None, model_axis=None)
        q = jnp.asarray(rng.standard_normal((1, 256, 2, 64)), jnp.float32)
        fn(q, q, q)
        stats = get_telemetry().get_stats()
        assert stats["axes"]["seq"]["ops"] == 3  # n-1 ring steps
        assert stats["axes"]["seq"]["bytes_total"] > 0


class TestMultihost:
    def test_initialize_single_process_noop(self):
        info = initialize_multihost()
        assert info["process_count"] == 1
        assert info["global_devices"] >= 1

    def test_pod_mesh_shapes(self):
        mesh = pod_mesh((2, 4), ("data", "model"))
        assert mesh.shape == {"data": 2, "model": 4}

    def test_pod_mesh_infers_minus_one(self):
        mesh = pod_mesh((-1, 2), ("data", "model"))
        assert mesh.shape["data"] * 2 == jax.device_count()

    def test_pod_mesh_bad_shape(self):
        with pytest.raises(DistributionError):
            pod_mesh((3, 3), ("a", "b"))

    def test_process_summary(self):
        s = process_summary()
        assert s["process_count"] == 1


class TestCreateMesh:
    def test_default_one_axis(self):
        mesh = create_mesh(axis_names=("data",))
        assert mesh.shape["data"] == jax.device_count()

    def test_minus_one_inference(self):
        mesh = create_mesh((2, -1), ("data", "model"))
        assert mesh.shape["model"] == jax.device_count() // 2

    def test_mismatch_raises(self):
        with pytest.raises(DistributionError):
            create_mesh((3,), ("data",), jax.devices()[:4])
