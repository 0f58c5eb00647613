"""In-kernel relative-position bias (T5 buckets, ALiBi) vs the dense oracle.

The reference supports T5 by materializing its (1, H, Sq, Skv) bias and
adding it to scores (reference integration/pytorch/convert.py:174-202 per
-family configs; core attention adds additive masks). These tests gate
the in-kernel version — bias rebuilt from iota inside the Pallas tile —
against the same math done densely in XLA, including gradients w.r.t.
the learned table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photonic_flash_attention_tpu.ops.flash import flash_attention
from photonic_flash_attention_tpu.ops.reference import attention_reference
from photonic_flash_attention_tpu.ops.rel_bias import (
    ALiBi,
    T5RelBias,
    alibi_slopes,
    materialize,
    relative_position_bucket,
)

from ..conftest import assert_close


def _mk(b=2, s=256, h=4, d=64, skv=None, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    skv = skv or s
    q = jnp.asarray(rng.standard_normal((b, s, h, d)), dtype)
    k = jnp.asarray(rng.standard_normal((b, skv, h, d)), dtype)
    v = jnp.asarray(rng.standard_normal((b, skv, h, d)), dtype)
    return q, k, v


def _t5_spec(h=4, bidirectional=True, nb=32, maxd=128, seed=1):
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.standard_normal((nb, h)) * 0.5, jnp.float32)
    return T5RelBias(table=table, bidirectional=bidirectional, max_distance=maxd)


class TestBucketFunction:
    def test_matches_hf_semantics_bidirectional(self):
        # Hand-checked values of the public T5 bucketing algorithm.
        rel = jnp.asarray([[-200, -128, -17, -15, -1, 0, 1, 15, 17, 128, 200]])
        b = relative_position_bucket(
            rel, bidirectional=True, num_buckets=32, max_distance=128
        )
        b = np.asarray(b)[0]
        assert b[5] == 0  # rel 0
        assert b[4] == 1  # rel -1 -> n=1 exact
        assert b[6] == 17  # rel +1 -> 16 + 1
        assert b[0] == 15 and b[1] == 15  # left saturation
        assert b[9] == 31 and b[10] == 31  # right saturation

    def test_causal_saturation(self):
        rel = jnp.asarray([[-1000, -128, -64, -15, 0, 5]])
        b = relative_position_bucket(
            rel, bidirectional=False, num_buckets=32, max_distance=128
        )
        b = np.asarray(b)[0]
        assert b[0] == 31 and b[1] == 31  # beyond max_distance
        assert b[3] == 15 and b[4] == 0
        assert b[5] == 0  # future positions clamp to bucket 0 (causal-masked anyway)


class TestT5BiasParity:
    @pytest.mark.parametrize("bidirectional", [True, False])
    def test_matches_dense_oracle(self, bidirectional):
        q, k, v = _mk()
        spec = _t5_spec(bidirectional=bidirectional)
        causal = not bidirectional
        dense = materialize(spec, q.shape[1], k.shape[1])
        ref, _ = attention_reference(q, k, v, bias=dense, causal=causal, sm_scale=1.0)
        out = flash_attention(
            q, k, v, causal=causal, sm_scale=1.0, rel_bias=spec,
            block_q=128, block_kv=128,
        )
        assert_close(out, ref, atol=2e-5, rtol=2e-5)

    def test_far_tile_predication_exact(self):
        # Long enough that interior tiles are fully saturated: the
        # constant-bias fast path must be bit-consistent with the dense
        # bias (this is the path that makes T5@long-S cheap).
        q, k, v = _mk(b=1, s=1024, h=2)
        spec = _t5_spec(h=2, bidirectional=False)
        dense = materialize(spec, 1024, 1024)
        ref, _ = attention_reference(q, k, v, bias=dense, causal=True, sm_scale=1.0)
        out = flash_attention(
            q, k, v, causal=True, sm_scale=1.0, rel_bias=spec,
            block_q=128, block_kv=128,
        )
        assert_close(out, ref, atol=2e-5, rtol=2e-5)

    def test_cross_attention_offset(self):
        # Sq != Skv: rel positions follow the sequence-end (decode)
        # alignment used by causal masking.
        q, k, v = _mk(s=128, skv=384)
        spec = _t5_spec(bidirectional=False)
        dense = materialize(spec, 128, 384)
        ref, _ = attention_reference(q, k, v, bias=dense, causal=True, sm_scale=1.0)
        out = flash_attention(
            q, k, v, causal=True, sm_scale=1.0, rel_bias=spec,
            block_q=128, block_kv=128,
        )
        assert_close(out, ref, atol=2e-5, rtol=2e-5)

    def test_grads_match_dense(self):
        q, k, v = _mk(b=1, s=256, h=2)
        spec = _t5_spec(h=2, bidirectional=False)

        def loss_flash(q, k, v, table):
            s = T5RelBias(table=table, bidirectional=False, max_distance=128)
            out = flash_attention(
                q, k, v, causal=True, sm_scale=1.0, rel_bias=s,
                block_q=128, block_kv=128,
            )
            return jnp.sum(out.astype(jnp.float32) ** 2)

        def loss_dense(q, k, v, table):
            s = T5RelBias(table=table, bidirectional=False, max_distance=128)
            dense = materialize(s, q.shape[1], k.shape[1])
            out, _ = attention_reference(q, k, v, bias=dense, causal=True, sm_scale=1.0)
            return jnp.sum(out.astype(jnp.float32) ** 2)

        gf = jax.grad(loss_flash, argnums=(0, 1, 2, 3))(q, k, v, spec.table)
        gd = jax.grad(loss_dense, argnums=(0, 1, 2, 3))(q, k, v, spec.table)
        for a, b in zip(gf, gd):
            assert_close(a, b, atol=5e-4, rtol=5e-4)


class TestALiBi:
    def test_slopes_schedule(self):
        s8 = np.asarray(alibi_slopes(8))
        np.testing.assert_allclose(s8[0], 2 ** -1.0, rtol=1e-6)
        np.testing.assert_allclose(s8[-1], 2 ** -8.0, rtol=1e-6)
        s12 = np.asarray(alibi_slopes(12))
        assert s12.shape == (12,) and (s12 > 0).all()

    def test_matches_dense_oracle(self):
        q, k, v = _mk(h=8)
        spec = ALiBi(slopes=alibi_slopes(8))
        dense = materialize(spec, q.shape[1], k.shape[1])
        ref, _ = attention_reference(q, k, v, bias=dense, causal=True)
        out = flash_attention(
            q, k, v, causal=True, rel_bias=spec, block_q=128, block_kv=128
        )
        assert_close(out, ref, atol=2e-5, rtol=2e-5)

    def test_slope_grads(self):
        q, k, v = _mk(b=1, s=128, h=4)
        slopes = alibi_slopes(4)

        def loss(fn_kind, slopes):
            spec = ALiBi(slopes=slopes)
            if fn_kind == "flash":
                out = flash_attention(
                    q, k, v, causal=True, rel_bias=spec, block_q=128, block_kv=128
                )
            else:
                dense = materialize(spec, 128, 128)
                out, _ = attention_reference(q, k, v, bias=dense, causal=True)
            return jnp.sum(out.astype(jnp.float32) ** 2)

        gf = jax.grad(lambda s: loss("flash", s))(slopes)
        gd = jax.grad(lambda s: loss("dense", s))(slopes)
        assert_close(gf, gd, atol=5e-4, rtol=5e-4)


class TestValidation:
    def test_head_mismatch_raises(self):
        q, k, v = _mk(h=4)
        spec = _t5_spec(h=8)
        with pytest.raises(ValueError, match="heads"):
            flash_attention(q, k, v, rel_bias=spec)


class TestT5ModelKernelBiasPath:
    def test_encoder_kernel_path_matches_dense(self):
        """Model-level gate: the unmasked T5 stack (in-kernel bias via the
        raw table) must match the dense-bias fused path bit-for-tolerance.
        """
        import dataclasses

        import numpy as np
        from photonic_flash_attention_tpu.config import get_config
        from photonic_flash_attention_tpu.models.t5 import T5Config, T5Stack

        # fp32 so the gate is numerics-tight (in bf16 the two paths
        # differ only by cast noise; verified max-abs-diff 3e-6 in fp32).
        cfg = dataclasses.replace(T5Config.tiny(), dtype=jnp.float32)
        stack = T5Stack(cfg, is_decoder=False, scan_layers=True)
        rng = jax.random.PRNGKey(0)
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal((2, 640, cfg.d_model)),
            jnp.float32,
        )
        params = stack.init(rng, x)

        conf = get_config()
        old = conf.flash_threshold
        try:
            conf.update(flash_threshold=512)  # 640 >= 512 -> kernel path
            out_kernel = stack.apply(params, x)
            conf.update(flash_threshold=10 ** 9)  # force dense fused path
            out_dense = stack.apply(params, x)
        finally:
            conf.update(flash_threshold=old)
        assert_close(out_kernel, out_dense, atol=5e-5, rtol=5e-5)
