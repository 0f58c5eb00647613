"""Test configuration.

All tests run on the CPU with 8 virtual devices, so multi-device sharding
paths are exercised without a GPU — the analogue of the reference's
``PHOTONIC_SIMULATION=1`` conftest switch (reference tests/conftest.py:11).
Pallas kernels run in the interpreter there (``platform.interpret_kernels``).

Tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here; ``python3 chip_smoke.py``
runs the same checks on the GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest

# The reference's fixture shape grid (reference tests/conftest.py:31-38):
# (batch, seq, embed_dim, num_heads)
SHAPE_GRID = [
    (2, 128, 512, 8),
    (4, 256, 768, 12),
    (1, 512, 1024, 16),
]


@pytest.fixture(params=SHAPE_GRID, ids=lambda s: f"b{s[0]}s{s[1]}d{s[2]}h{s[3]}")
def attention_shape(request):
    return request.param


@pytest.fixture(params=[jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def dtype(request):
    return request.param


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def qkv(attention_shape, dtype, rng):
    """Seeded (B, S, H, D) q/k/v triplet."""
    b, s, d_model, h = attention_shape
    d = d_model // h
    shape = (b, s, h, d)
    q = jnp.asarray(rng.standard_normal(shape), dtype)
    k = jnp.asarray(rng.standard_normal(shape), dtype)
    v = jnp.asarray(rng.standard_normal(shape), dtype)
    return q, k, v


@pytest.fixture
def gpu_device():
    """The first device when it is a GPU; skips the test otherwise.

    Decided at run time, inside the fixture, so every test worker
    collects the same tests.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; python3 chip_smoke.py runs this on the card")
    return dev


@pytest.fixture(autouse=True)
def _reset_config():
    from photonic_flash_attention_tpu.config import reset_config

    reset_config()
    yield
    reset_config()


def assert_close(a, b, rtol=None, atol=None, err_msg=""):
    """Tolerance ladder: tight for fp32, looser for bf16 compute."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if rtol is None:
        rtol = 2e-2 if (a.dtype != np.float32 or b.dtype != np.float32) else 2e-2
    if atol is None:
        atol = 2e-2
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=err_msg)


def max_rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    denom = np.maximum(np.abs(b), 1e-3)
    return float(np.max(np.abs(a - b) / denom))


def rel_err_norm(a, b):
    """Norm-relative error — the reference's <0.1 accuracy gate metric
    (reference tests/performance/test_benchmarks.py:280)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))
