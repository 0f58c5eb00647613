"""Paged decode kernel (Pallas, Triton route) vs dense oracle, f32/int8 pages."""

import jax.numpy as jnp
import numpy as np
import pytest

from photonic_flash_attention_tpu.core.kv_cache import PagedKVCache
from photonic_flash_attention_tpu.ops import paged as P
from photonic_flash_attention_tpu.ops.paged import paged_attention, paged_attention_xla
from photonic_flash_attention_tpu.ops.reference import attention_reference

from ..conftest import rel_err_norm

HKV, D, PAGE = 2, 64, 16


def build_cache_and_oracle(rng, lengths, dtype=jnp.float32, hq=4):
    """Fill a cache with random KV per sequence; return kernel inputs and
    the dense-oracle output."""
    cache = PagedKVCache(
        num_pages=128, page_size=PAGE, num_kv_heads=HKV, head_dim=D,
        dtype=dtype, max_pages_per_seq=8,
    )
    b = len(lengths)
    q = jnp.asarray(rng.standard_normal((b, hq, D)), jnp.float32)
    sids, refs = [], []
    for i, L in enumerate(lengths):
        sid = cache.allocate_sequence()
        k = jnp.asarray(rng.standard_normal((L, HKV, D)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((L, HKV, D)), jnp.float32)
        cache.append(sid, k, v)
        sids.append(sid)
        # Oracle on the *stored* (possibly quantized) KV so we measure the
        # kernel, not the storage quantization.
        kg, vg = cache.gather_kv(sid)
        ref, _ = attention_reference(
            q[i : i + 1, None], kg[None], vg[None]
        )
        refs.append(ref[0, 0])  # (hq, D)
    lengths_arr, tables = cache.page_table(sids)
    return cache, q, lengths_arr, tables, jnp.stack(refs)


def stack_layers(cache, n_layers=3):
    """Rank-5 (L, ...) pools holding the same pages at every layer."""
    k5 = jnp.stack([cache.k_pages] * n_layers)
    v5 = jnp.stack([cache.v_pages] * n_layers)
    ks5 = jnp.stack([cache.k_scales] * n_layers) if cache.k_scales is not None else None
    vs5 = jnp.stack([cache.v_scales] * n_layers) if cache.v_scales is not None else None
    return k5, v5, ks5, vs5


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8], ids=["f32", "int8"])
class TestPagedXLA:
    def test_matches_oracle(self, rng, dtype):
        cache, q, lengths, tables, ref = build_cache_and_oracle(
            rng, [40, 17, 128], dtype=dtype
        )
        out = paged_attention_xla(
            q, cache.k_pages, cache.v_pages, lengths, tables,
            cache.k_scales, cache.v_scales,
        )
        assert out.shape == q.shape
        assert rel_err_norm(out, ref) < 2e-2


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8], ids=["f32", "int8"])
class TestPagedPallas:
    def test_matches_oracle(self, rng, dtype):
        cache, q, lengths, tables, ref = build_cache_and_oracle(
            rng, [40, 17, 128], dtype=dtype
        )
        out = paged_attention(
            q, cache.k_pages, cache.v_pages, lengths, tables,
            cache.k_scales, cache.v_scales, block_tokens=32,
        )
        assert out.shape == q.shape
        assert rel_err_norm(out, ref) < 2e-2

    def test_single_sequence_single_page(self, rng, dtype):
        cache, q, lengths, tables, ref = build_cache_and_oracle(
            rng, [7], dtype=dtype
        )
        out = paged_attention(
            q, cache.k_pages, cache.v_pages, lengths, tables,
            cache.k_scales, cache.v_scales, block_tokens=32,
        )
        assert rel_err_norm(out, ref) < 2e-2

    def test_gqa_group(self, rng, dtype):
        cache, q, lengths, tables, ref = build_cache_and_oracle(
            rng, [64, 32], dtype=dtype, hq=8
        )
        out = paged_attention(
            q, cache.k_pages, cache.v_pages, lengths, tables,
            cache.k_scales, cache.v_scales, block_tokens=32,
        )
        assert rel_err_norm(out, ref) < 2e-2

    def test_token_bias_matches_xla(self, rng, dtype):
        """Per-(head, key token) bias: T5's relative bias at decode."""
        cache, q, lengths, tables, _ = build_cache_and_oracle(
            rng, [40, 17, 100], dtype=dtype
        )
        tb = jnp.asarray(rng.standard_normal((3, 4, 90)), jnp.float32)
        args = (q, cache.k_pages, cache.v_pages, lengths, tables,
                cache.k_scales, cache.v_scales)
        out = paged_attention(*args, token_bias=tb, block_tokens=32)
        ref = paged_attention_xla(*args, token_bias=tb)
        assert rel_err_norm(out, ref) < 2e-3

    @pytest.mark.parametrize(
        "block_tokens,splits", [(16, 1), (32, 2), (64, 4), (128, None)]
    )
    def test_tiles_and_splits_do_not_change_the_result(
        self, rng, dtype, block_tokens, splits
    ):
        cache, q, lengths, tables, ref = build_cache_and_oracle(
            rng, [128, 97, 33], dtype=dtype
        )
        out = paged_attention(
            q, cache.k_pages, cache.v_pages, lengths, tables,
            cache.k_scales, cache.v_scales, block_tokens=block_tokens,
            num_splits=splits,
        )
        assert rel_err_norm(out, ref) < 2e-2

    def test_empty_slot_is_finite_and_isolated(self, rng, dtype):
        """A serving slot of length 0 gives a finite row and does not
        touch the others."""
        cache, q, lengths, tables, ref = build_cache_and_oracle(
            rng, [40, 17], dtype=dtype
        )
        lengths = jnp.concatenate([lengths, jnp.zeros((1,), jnp.int32)])
        tables = jnp.concatenate([tables, jnp.zeros_like(tables[:1])])
        q = jnp.concatenate([q, q[:1]])
        out = paged_attention(
            q, cache.k_pages, cache.v_pages, lengths, tables,
            cache.k_scales, cache.v_scales, block_tokens=32,
        )
        assert rel_err_norm(out[:2], ref) < 2e-2
        assert bool(jnp.all(jnp.isfinite(out)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
class TestLayerIndexedPools:
    """Rank-5 (L, ...) pools read in place at a traced layer index."""

    def test_layer_indexed_matches_rank4(self, rng, dtype):
        cache, q, lengths, tables, ref = build_cache_and_oracle(
            rng, [40, 17, 128], dtype=dtype
        )
        k5, v5, ks5, vs5 = stack_layers(cache)
        out = paged_attention(
            q, k5, v5, lengths, tables, ks5, vs5, block_tokens=32,
            layer=jnp.int32(1),
        )
        assert rel_err_norm(out, ref) < 2e-2

    def test_fused_decode_write_and_attend(self, rng, dtype):
        """One decode step: scatter the token into the layered pool, then
        attend. Equals the oracle over the written pages, leaves the other
        layers bit-identical."""
        cache, q, lengths, tables, _ = build_cache_and_oracle(
            rng, [40, 17], dtype=dtype
        )
        k5, v5, _, _ = stack_layers(cache, 2)
        b, _, d = q.shape
        hkv, page = cache.k_pages.shape[0], cache.k_pages.shape[2]
        k_new = jnp.asarray(rng.standard_normal((b, hkv, d)), jnp.float32)
        v_new = jnp.asarray(rng.standard_normal((b, hkv, d)), jnp.float32)
        pids = tables[jnp.arange(b), lengths // page]
        flat = pids * page + lengths % page
        pool = P.write_tokens({"k": k5, "v": v5}, k_new, v_new, flat, jnp.int32(1), False)
        out = paged_attention(
            q, pool["k"], pool["v"], lengths + 1, tables, layer=jnp.int32(1),
            block_tokens=32,
        )
        kp = np.asarray(cache.k_pages.astype(jnp.float32)).copy()
        vp = np.asarray(cache.v_pages.astype(jnp.float32)).copy()
        for r in range(b):
            kp[:, int(pids[r]), int(lengths[r] % page)] = np.asarray(k_new[r].astype(dtype), np.float32)
            vp[:, int(pids[r]), int(lengths[r] % page)] = np.asarray(v_new[r].astype(dtype), np.float32)
        ref = paged_attention_xla(q, jnp.asarray(kp), jnp.asarray(vp), lengths + 1, tables)
        assert rel_err_norm(out, ref) < 2e-2
        np.testing.assert_array_equal(np.asarray(pool["k"][0]), np.asarray(k5[0]))


class TestPoolWrites:
    def test_int8_write_roundtrip(self, rng):
        x = jnp.asarray(rng.standard_normal((6, 2, 64)), jnp.float32)
        q8, sc = P.quantize_tokens(x)
        assert q8.dtype == jnp.int8 and sc.shape == (6, 2)
        assert rel_err_norm(q8.astype(jnp.float32) * sc[..., None], x) < 1e-2

    def test_write_tokens_int8_places_scales(self, rng):
        shape = (2, HKV, 8, PAGE, D)
        pool = {"k": jnp.zeros(shape, jnp.int8), "v": jnp.zeros(shape, jnp.int8),
                "ks": jnp.ones(shape[:-1]), "vs": jnp.ones(shape[:-1])}
        k = jnp.asarray(rng.standard_normal((3, HKV, D)), jnp.float32)
        slots = jnp.asarray([PAGE + 1, 3 * PAGE, 5 * PAGE + 7], jnp.int32)
        out = P.write_tokens(pool, k, k, slots, jnp.int32(1), True)
        deq = out["k"][1, :, 1, 1].astype(jnp.float32) * out["ks"][1, :, 1, 1][:, None]
        assert rel_err_norm(deq, k[0]) < 1e-2
        assert int(jnp.sum(out["k"][0] != 0)) == 0  # other layer untouched

    def test_gather_history_matches_cache(self, rng):
        cache, _, _, tables, _ = build_cache_and_oracle(rng, [40, 17])
        pool = {"k": cache.k_pages[None], "v": cache.v_pages[None]}
        kh, vh = P.gather_history(pool, tables, 0, 3, False)
        kg, _ = cache.gather_kv(0)
        np.testing.assert_allclose(np.asarray(kh[0, :40]), np.asarray(kg), rtol=1e-6)

    def test_page_size_must_be_power_of_two(self, rng):
        k = jnp.zeros((HKV, 4, 12, D))
        with pytest.raises(ValueError, match="power of two"):
            paged_attention(jnp.zeros((1, 4, D)), k, k, jnp.ones((1,), jnp.int32),
                            jnp.zeros((1, 2), jnp.int32))


@pytest.mark.parametrize("case", ["bf16", "int8", "int8_bias"])
def test_kernel_lowers_for_cuda(case):
    """The Triton lowering of the kernel runs without a GPU: lowering the
    call for the CUDA platform catches unsupported primitives here."""
    import jax

    b, hkv, hq, d, page, n_pages = 4, 2, 8, 64, 16, 33
    dt = jnp.int8 if case.startswith("int8") else jnp.bfloat16
    kp = jax.ShapeDtypeStruct((2, hkv, n_pages, page, d), dt)
    sc = jax.ShapeDtypeStruct((2, hkv, n_pages, page), jnp.float32) if dt == jnp.int8 else None
    tb = jax.ShapeDtypeStruct((b, hq, 64), jnp.float32) if case.endswith("bias") else None
    q = jax.ShapeDtypeStruct((b, hq, d), jnp.bfloat16)

    def f(q, kp, vp, lens, pt, ks, vs, tb):
        return paged_attention(q, kp, vp, lens, pt, ks, vs, layer=jnp.int32(1),
                               token_bias=tb, interpret=False)

    lowered = jax.jit(f).trace(
        q, kp, kp, jax.ShapeDtypeStruct((b,), jnp.int32),
        jax.ShapeDtypeStruct((b, 4), jnp.int32), sc, sc, tb,
    ).lower(lowering_platforms=("cuda",))
    assert "pfa_paged_decode" in lowered.as_text()
