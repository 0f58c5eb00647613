"""Flash kernel vs oracle — the core numerics gates.

Port of the reference's unit strategy (reference
tests/unit/test_flash_attention_3.py): shape assertions, forward parity,
causal/cross attention, gradient checks, numerical stability at extreme
inputs. Tolerances follow BASELINE.md's ladder (weights-sum atol 1e-3;
quantized rel-err < 0.1 comes later in quant tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photonic_flash_attention_tpu.ops.flash import flash_attention
from photonic_flash_attention_tpu.ops.reference import (
    attention_blockwise,
    attention_reference,
)

from ..conftest import assert_close, max_rel_err, rel_err_norm


class TestOracleSelfConsistency:
    def test_blockwise_matches_standard(self, qkv):
        q, k, v = qkv
        ref, _ = attention_reference(q, k, v)
        blk = attention_blockwise(q, k, v, block_kv=128)
        assert_close(blk, ref)

    def test_blockwise_causal(self, qkv):
        q, k, v = qkv
        ref, _ = attention_reference(q, k, v, causal=True)
        blk = attention_blockwise(q, k, v, causal=True, block_kv=128)
        assert_close(blk, ref)

    def test_weights_sum_to_one(self, qkv):
        q, k, v = qkv
        _, w = attention_reference(q, k, v, need_weights=True)
        sums = jnp.sum(w, axis=-1)
        np.testing.assert_allclose(np.asarray(sums), 1.0, atol=1e-3)


class TestFlashKernel:
    def test_output_shape_dtype(self, qkv):
        q, k, v = qkv
        out = flash_attention(q, k, v)
        assert out.shape == q.shape
        assert out.dtype == q.dtype

    def test_matches_oracle(self, qkv):
        q, k, v = qkv
        ref, _ = attention_reference(q, k, v)
        out = flash_attention(q, k, v, block_q=128, block_kv=128)
        assert_close(out, ref)

    def test_matches_oracle_causal(self, qkv):
        q, k, v = qkv
        ref, _ = attention_reference(q, k, v, causal=True)
        out = flash_attention(q, k, v, causal=True, block_q=128, block_kv=128)
        assert_close(out, ref)

    def test_unaligned_seq_padding(self, rng):
        """Sequence lengths not divisible by the block size."""
        q = jnp.asarray(rng.standard_normal((1, 200, 4, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 333, 4, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 333, 4, 64)), jnp.float32)
        ref, _ = attention_reference(q, k, v)
        out = flash_attention(q, k, v, block_q=128, block_kv=128)
        assert_close(out, ref)

    def test_cross_attention_causal_alignment(self, rng):
        """Sq < Skv causal (decode-style, end-aligned diagonal)."""
        q = jnp.asarray(rng.standard_normal((2, 128, 4, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((2, 384, 4, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((2, 384, 4, 64)), jnp.float32)
        ref, _ = attention_reference(q, k, v, causal=True)
        out = flash_attention(q, k, v, causal=True, block_q=128, block_kv=128)
        assert_close(out, ref)

    def test_gqa_head_broadcast(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 256, 8, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 256, 2, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 256, 2, 64)), jnp.float32)
        ref, _ = attention_reference(q, k, v)
        out = flash_attention(q, k, v, block_q=128, block_kv=128)
        assert_close(out, ref)

    def test_numerical_stability_extreme_inputs(self, rng):
        """±10σ inputs (reference test_flash_attention_3.py:249-262)."""
        q = jnp.asarray(rng.standard_normal((1, 128, 2, 64)) * 10, jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 128, 2, 64)) * 10, jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 128, 2, 64)), jnp.float32)
        out = flash_attention(q, k, v, block_q=128, block_kv=128)
        assert bool(jnp.all(jnp.isfinite(out)))
        ref, _ = attention_reference(q, k, v)
        assert_close(out, ref, atol=1e-2, rtol=1e-2)

    def test_bf16_rel_error_gate(self, rng):
        """bf16 kernel vs fp32 oracle within the 10% reference gate."""
        q32 = rng.standard_normal((2, 256, 4, 64)).astype(np.float32)
        k32 = rng.standard_normal((2, 256, 4, 64)).astype(np.float32)
        v32 = rng.standard_normal((2, 256, 4, 64)).astype(np.float32)
        ref, _ = attention_reference(
            jnp.asarray(q32), jnp.asarray(k32), jnp.asarray(v32)
        )
        out = flash_attention(
            jnp.asarray(q32, jnp.bfloat16),
            jnp.asarray(k32, jnp.bfloat16),
            jnp.asarray(v32, jnp.bfloat16),
            block_q=128,
            block_kv=128,
        )
        assert rel_err_norm(out, ref) < 0.1

    def test_rejects_unaligned_block_sizes(self, rng):
        """block_q/block_kv must be powers of two >= 16 (Triton tile
        shapes) — a clear error, not an obscure lowering failure."""
        q = jnp.asarray(rng.standard_normal((1, 256, 2, 64)), jnp.float32)
        with pytest.raises(ValueError, match="power of two"):
            flash_attention(q, q, q, block_q=128, block_kv=192)
        with pytest.raises(ValueError, match="power of two"):
            flash_attention(q, q, q, block_q=96, block_kv=128)
        with pytest.raises(ValueError, match="power of two"):
            flash_attention(q, q, q, block_q=8, block_kv=64)


class TestFlashMasked:
    """In-kernel key-padding masks (reference applies attention_mask in
    its tile loop, flash_attention_3.py:150,165-175 — here per-row
    lengths + per-key bias keep masked calls on the flash kernel)."""

    def _setup(self, rng, b=3, s=384, h=4, d=64):
        q = jnp.asarray(rng.standard_normal((b, s, h, d)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((b, s, h, d)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((b, s, h, d)), jnp.float32)
        return q, k, v

    def test_kv_lens_matches_masked_oracle(self, rng):
        q, k, v = self._setup(rng)
        lens = jnp.asarray([384, 200, 77], jnp.int32)
        keep = (jnp.arange(384)[None] < lens[:, None])[:, None, None, :]
        ref, _ = attention_reference(q, k, v, keep)
        out = flash_attention(q, k, v, kv_lens=lens, block_q=128, block_kv=128)
        assert_close(out, ref)

    def test_kv_lens_causal(self, rng):
        q, k, v = self._setup(rng)
        lens = jnp.asarray([300, 384, 129], jnp.int32)
        keep = (jnp.arange(384)[None] < lens[:, None])[:, None, None, :]
        ref, _ = attention_reference(q, k, v, keep, causal=True)
        out = flash_attention(
            q, k, v, kv_lens=lens, causal=True, block_q=128, block_kv=128
        )
        assert_close(out, ref)

    def test_k_bias_arbitrary_pattern(self, rng):
        """Non-contiguous key masks are exact via the additive bias."""
        from photonic_flash_attention_tpu.ops.reference import (
            DEFAULT_MASK_VALUE,
        )

        q, k, v = self._setup(rng)
        km = rng.random((3, 384)) > 0.3
        km[:, 0] = True  # no fully-masked rows (softmax degenerate)
        kb = jnp.where(jnp.asarray(km), 0.0, DEFAULT_MASK_VALUE).astype(
            jnp.float32
        )
        ref, _ = attention_reference(
            q, k, v, jnp.asarray(km)[:, None, None, :]
        )
        out = flash_attention(q, k, v, k_bias=kb, block_q=128, block_kv=128)
        assert_close(out, ref)

    def test_masked_gradients_match_oracle(self, rng):
        q, k, v = self._setup(rng, s=256)
        lens = jnp.asarray([256, 100, 31], jnp.int32)
        keep = (jnp.arange(256)[None] < lens[:, None])[:, None, None, :]

        def loss_flash(q, k, v):
            o = flash_attention(
                q, k, v, kv_lens=lens, block_q=128, block_kv=128
            )
            return jnp.sum(o.astype(jnp.float32) ** 2)

        def loss_ref(q, k, v):
            o, _ = attention_reference(q, k, v, keep)
            return jnp.sum(o.astype(jnp.float32) ** 2)

        g1 = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
        g2 = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(g1, g2):
            assert_close(a, b, atol=2e-5, rtol=2e-5)

    def test_k_bias_differentiable(self, rng):
        """Real (non-mask) per-key biases get an exact bias gradient."""
        q, k, v = self._setup(rng, s=256)
        kb = jnp.asarray(rng.standard_normal((3, 256)), jnp.float32)

        def loss_flash(kb):
            o = flash_attention(q, k, v, k_bias=kb, block_q=128, block_kv=128)
            return jnp.sum(o.astype(jnp.float32) ** 2)

        def loss_ref(kb):
            o, _ = attention_reference(
                q, k, v, bias=kb[:, None, None, :]
            )
            return jnp.sum(o.astype(jnp.float32) ** 2)

        assert_close(
            jax.grad(loss_flash)(kb), jax.grad(loss_ref)(kb),
            atol=2e-4, rtol=2e-4,
        )


class TestFlashGradients:
    def test_grads_match_oracle(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 128, 2, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 128, 2, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 128, 2, 64)), jnp.float32)

        def loss_flash(q, k, v):
            return jnp.sum(
                flash_attention(q, k, v, block_q=128, block_kv=128) ** 2
            )

        def loss_ref(q, k, v):
            return jnp.sum(attention_reference(q, k, v)[0] ** 2)

        g_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for gf, gr, name in zip(g_flash, g_ref, "qkv"):
            assert_close(gf, gr, err_msg=f"d{name} mismatch")

    def test_grads_causal(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 256, 2, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 256, 2, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 256, 2, 64)), jnp.float32)

        def loss_flash(q, k, v):
            return jnp.sum(
                flash_attention(q, k, v, causal=True, block_q=128, block_kv=128) ** 2
            )

        def loss_ref(q, k, v):
            return jnp.sum(attention_reference(q, k, v, causal=True)[0] ** 2)

        g_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for gf, gr, name in zip(g_flash, g_ref, "qkv"):
            assert_close(gf, gr, err_msg=f"d{name} mismatch")

    def test_grads_unaligned(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 200, 2, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 200, 2, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 200, 2, 64)), jnp.float32)

        def loss_flash(q, k, v):
            return jnp.sum(flash_attention(q, k, v, block_q=128, block_kv=128) ** 2)

        def loss_ref(q, k, v):
            return jnp.sum(attention_reference(q, k, v)[0] ** 2)

        g_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for gf, gr, name in zip(g_flash, g_ref, "qkv"):
            assert_close(gf, gr, err_msg=f"d{name} mismatch")


class TestGQAGradients:
    def test_gqa_grads_match_reference(self, rng):
        """Native-GQA primal + group-reduced dK/dV must match autodiff
        through the repeated-head oracle."""
        import jax

        from photonic_flash_attention_tpu.ops.reference import attention_reference

        q = jnp.asarray(rng.standard_normal((1, 256, 8, 32)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 256, 2, 32)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 256, 2, 32)), jnp.float32)

        def loss_flash(q, k, v):
            return jnp.sum(
                flash_attention(
                    q, k, v, causal=True, block_q=128, block_kv=128
                ) ** 2
            )

        def loss_ref(q, k, v):
            return jnp.sum(attention_reference(q, k, v, causal=True)[0] ** 2)

        gf = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
        gr = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for a, b, name in zip(gf, gr, ("dq", "dk", "dv")):
            assert a.shape == b.shape, name
            assert_close(a, b, err_msg=name)


class TestDenseAttnBias:
    """Dense (Sq, Skv) additive bias streamed as in-kernel tiles
    (VERDICT r3 #5 — the last C1 parity gap: reference applies any-shape
    attention_mask inside its tile loop, flash_attention_3.py:150,165-175)."""

    def test_random_dense_mask_matches_fused_oracle(self, rng):
        from photonic_flash_attention_tpu.ops.reference import (
            DEFAULT_MASK_VALUE,
        )

        q = jnp.asarray(rng.standard_normal((2, 256, 4, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((2, 256, 4, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((2, 256, 4, 64)), jnp.float32)
        keep = rng.random((2, 1, 256, 256)) > 0.3
        keep[:, :, :, 0] = True  # no fully-masked rows
        mask = jnp.asarray(keep)
        ref, _ = attention_reference(q, k, v, mask)
        bias = jnp.where(mask, 0.0, DEFAULT_MASK_VALUE).astype(jnp.float32)
        out = flash_attention(
            q, k, v, attn_bias=bias, block_q=128, block_kv=128
        )
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=2e-5, atol=2e-5
        )

    def test_per_head_real_bias_causal(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 256, 4, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 256, 4, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 256, 4, 64)), jnp.float32)
        bias = jnp.asarray(
            rng.standard_normal((1, 4, 256, 256)), jnp.float32
        )
        ref, _ = attention_reference(q, k, v, bias=bias, causal=True)
        out = flash_attention(
            q, k, v, causal=True, attn_bias=bias, block_q=128, block_kv=128
        )
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=2e-5, atol=2e-5
        )

    def test_unaligned_lengths(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 200, 2, 64)), jnp.float32)
        k = jnp.asarray(rng.standard_normal((1, 333, 2, 64)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((1, 333, 2, 64)), jnp.float32)
        bias = jnp.asarray(rng.standard_normal((1, 1, 200, 333)), jnp.float32)
        ref, _ = attention_reference(q, k, v, bias=bias)
        out = flash_attention(
            q, k, v, attn_bias=bias, block_q=128, block_kv=128
        )
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=2e-5, atol=2e-5
        )

    def test_rejects_combinations(self, rng):
        q = jnp.asarray(rng.standard_normal((1, 128, 2, 64)), jnp.float32)
        bias = jnp.zeros((1, 1, 128, 128), jnp.float32)
        with pytest.raises(ValueError, match="attn_bias"):
            flash_attention(
                q, q, q, attn_bias=bias,
                kv_lens=jnp.asarray([128], jnp.int32),
            )
        with pytest.raises(ValueError, match="attn_bias"):
            flash_attention(q, q, q, attn_bias=jnp.zeros((1, 1, 64, 128)))
