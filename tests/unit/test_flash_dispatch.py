"""flash_attention's choice of path, tile defaults, padding, and the
forward kernel's lowering through Triton for CUDA (no GPU needed)."""

import jax
import jax.numpy as jnp
import pytest

from photonic_flash_attention_tpu import platform
from photonic_flash_attention_tpu.ops import flash as F
from photonic_flash_attention_tpu.ops.reference import attention_reference
from photonic_flash_attention_tpu.ops.rel_bias import ALiBi, T5RelBias, alibi_slopes

from ..conftest import rel_err_norm


def _sds(b, s, h, d, dtype=jnp.bfloat16):
    return jax.ShapeDtypeStruct((b, s, h, d), dtype)


class TestCudnnEligibility:
    @pytest.fixture
    def on_gpu(self, monkeypatch):
        monkeypatch.setattr(platform, "on_gpu", lambda: True)

    @pytest.mark.parametrize(
        "sq,skv,d,dtype,causal,features,expect",
        [
            (1024, 1024, 64, jnp.bfloat16, True, False, True),
            (1024, 1024, 128, jnp.float16, False, False, True),
            (512, 1024, 64, jnp.bfloat16, False, False, True),
            (512, 1024, 64, jnp.bfloat16, True, False, False),  # end-aligned causal
            (1024, 1024, 64, jnp.float32, True, False, False),  # fp32 stays exact
            (1024, 1024, 256, jnp.bfloat16, True, False, False),  # head dim
            (1024, 1024, 60, jnp.bfloat16, True, False, False),  # not a multiple of 8
            (1024, 1024, 64, jnp.bfloat16, True, True, False),  # kernel-only feature
        ],
    )
    def test_routes(self, on_gpu, sq, skv, d, dtype, causal, features, expect):
        q = _sds(2, sq, 4, d, dtype)
        k = _sds(2, skv, 4, d, dtype)
        got = F.cudnn_eligible(q, k, causal=causal, features=features)
        assert got is expect

    def test_never_on_cpu(self):
        q = _sds(2, 1024, 4, 64)
        assert not F.cudnn_eligible(q, q, causal=True, features=False)

    def test_cudnn_route_is_taken_on_gpu(self, on_gpu, monkeypatch):
        called = {}

        def fake(q, k, v, **kw):
            called.update(kw)
            return q

        monkeypatch.setattr(jax.nn, "dot_product_attention", fake)
        q = jnp.zeros((1, 64, 2, 64), jnp.bfloat16)
        F.flash_attention(q, q, q, causal=True)
        assert called["implementation"] == "cudnn" and called["is_causal"]

    @pytest.fixture
    def spy_cudnn(self, monkeypatch):
        calls = []

        def fake(q, k, v, **kw):
            calls.append(kw["implementation"])
            return q

        monkeypatch.setattr(jax.nn, "dot_product_attention", fake)
        return calls

    def test_caller_tiles_do_not_leave_cudnn(self, on_gpu, spy_cudnn):
        """Tile sizes shape the kernel only; they never choose it."""
        q = jnp.zeros((1, 64, 2, 64), jnp.bfloat16)
        F.flash_attention(q, q, q, causal=True, block_q=32, block_kv=32)
        assert spy_cudnn == ["cudnn"]

    def test_pallas_implementation_keeps_the_kernel(self, on_gpu, spy_cudnn, monkeypatch):
        monkeypatch.setattr(F, "resolve_interpret", lambda i: True)
        q = jnp.zeros((1, 64, 2, 64), jnp.bfloat16)
        F.flash_attention(q, q, q, causal=True, implementation="pallas")
        assert spy_cudnn == []

    def test_unknown_implementation_raises(self):
        q = jnp.zeros((1, 16, 2, 64), jnp.bfloat16)
        with pytest.raises(ValueError, match="implementation"):
            F.flash_attention(q, q, q, implementation="cudnn")

    def test_recorded_tile_profile_keeps_dispatch_on_cudnn(self, on_gpu, spy_cudnn, monkeypatch):
        """A tile profile recorded by the engine or ``calibrate`` for this
        shape must not move a model's plain causal bf16 call off cuDNN."""
        from photonic_flash_attention_tpu.core import autotuner as A
        from photonic_flash_attention_tpu.models.attention import dispatch_attention

        tuner = A.Autotuner()
        monkeypatch.setattr(A, "get_autotuner", lambda: tuner)
        b, s, h, d = 2, 1024, 2, 64
        tuner.record(A.Autotuner.profile_key(s, s, d, b, h), A.TuneResult(32, 32, 0.1))
        q = jnp.zeros((b, s, h, d), jnp.bfloat16)
        dispatch_attention(q, q, q, causal=True)
        assert spy_cudnn == ["cudnn"]

    @pytest.mark.parametrize("kw", [
        {"window": (-8, 0)},
        {"kv_lens": jnp.asarray([64], jnp.int32)},
        {"rel_bias": ALiBi(alibi_slopes(2))},
    ])
    def test_features_keep_the_kernel_on_gpu(self, on_gpu, monkeypatch, kw):
        monkeypatch.setattr(jax.nn, "dot_product_attention",
                            lambda *a, **k: pytest.fail("cuDNN called"))
        monkeypatch.setattr(F, "resolve_interpret", lambda i: True)
        q = jnp.zeros((1, 64, 2, 64), jnp.bfloat16)
        F.flash_attention(q, q, q, causal=True, **kw)


class TestBlocks:
    @pytest.mark.parametrize(
        "sq,skv,d,want",
        [(1024, 1024, 64, (64, 64)), (4096, 4096, 128, (128, 64)),
         (5, 9, 64, (16, 16)), (40, 1000, 32, (64, 64))],
    )
    def test_defaults(self, sq, skv, d, want):
        assert F._blocks(sq, skv, d, None, None) == want

    def test_caller_tiles_kept(self):
        assert F._blocks(1024, 1024, 64, 32, 128) == (32, 128)


class TestKernelPaths:
    @pytest.mark.parametrize(
        "sq,skv,causal", [(50, 50, True), (33, 70, True), (100, 37, False)]
    )
    def test_unaligned_lengths_pad_and_slice(self, rng, sq, skv, causal):
        q = jnp.asarray(rng.standard_normal((2, sq, 2, 32)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((2, skv, 2, 32)), jnp.float32)
        out = F.flash_attention(q, k, k, causal=causal, block_q=32, block_kv=32)
        ref, _ = attention_reference(q, k, k, causal=causal)
        assert out.shape == q.shape
        assert rel_err_norm(out, ref) < 1e-5

    def test_odd_head_dim_pads_to_power_of_two(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 64, 2, 40)), jnp.float32)
        out = F.flash_attention(q, q, q, block_q=32, block_kv=32)
        ref, _ = attention_reference(q, q, q)
        assert rel_err_norm(out, ref) < 1e-5

    def test_rows_without_keys_have_zero_output_and_neg_inf_lse(self, rng):
        q = jnp.asarray(rng.standard_normal((2, 32, 2, 32)), jnp.float32)
        lens = jnp.asarray([0, 20], jnp.int32)
        o, lse = F.flash_attention_with_lse(q, q, q, kv_lens=lens, block_q=16, block_kv=16)
        assert float(jnp.abs(o[0]).max()) == 0.0
        assert bool(jnp.all(jnp.isneginf(lse[0])))
        assert bool(jnp.all(jnp.isfinite(lse[1])))

    def test_merge_partial_attention_equals_full(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 32, 2, 32)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 64, 2, 32)), jnp.float32)
        o1, l1 = F.flash_attention_with_lse(q, k[:, :32], k[:, :32], block_q=16, block_kv=16)
        o2, l2 = F.flash_attention_with_lse(q, k[:, 32:], k[:, 32:], block_q=16, block_kv=16)
        o, _ = F.merge_partial_attention(o1, l1.transpose(0, 2, 1), o2, l2.transpose(0, 2, 1))
        ref, _ = attention_reference(q, k, k)
        assert rel_err_norm(o, ref) < 1e-5


@pytest.mark.parametrize("case", ["alibi", "t5", "dense_bias", "lse", "kv_lens", "window", "gqa_d128"])
def test_forward_lowers_for_cuda(case):
    """Each forward variant lowers through Triton for CUDA."""
    b, s, h, d = 2, 256, 4, 128 if case == "gqa_d128" else 64
    q = _sds(b, s, h, d)
    k = _sds(b, s, 2 if case == "gqa_d128" else h, d)
    kw = dict(block_q=64, block_kv=64, interpret=False)
    args = (q, k, k)
    if case == "alibi":
        fn = lambda q, k, v: F.flash_attention(q, k, v, causal=True, rel_bias=ALiBi(alibi_slopes(h)), **kw)  # noqa: E731
    elif case == "t5":
        fn = lambda q, k, v: F.flash_attention(q, k, v, rel_bias=T5RelBias(jnp.zeros((32, h)), True), **kw)  # noqa: E731
    elif case == "dense_bias":
        fn = lambda q, k, v, ab: F.flash_attention(q, k, v, attn_bias=ab, **kw)  # noqa: E731
        args += (jax.ShapeDtypeStruct((b, 1, s, s), jnp.float32),)
    elif case == "lse":
        fn = lambda q, k, v: F.flash_attention_with_lse(q, k, v, causal=True, **kw)  # noqa: E731
    elif case == "kv_lens":
        fn = lambda q, k, v, n: F.flash_attention(q, k, v, kv_lens=n, **kw)  # noqa: E731
        args += (jax.ShapeDtypeStruct((b,), jnp.int32),)
    elif case == "window":
        fn = lambda q, k, v: F.flash_attention(q, k, v, causal=True, window=(-100, 0), **kw)  # noqa: E731
    else:
        fn = lambda q, k, v: F.flash_attention(q, k, v, causal=True, **kw)  # noqa: E731
    text = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "pfa_flash_fwd" in text
