"""Backward kernels (dK/dV and dQ programs) vs the blockwise XLA backward.

``_bwd_kernels`` runs the two Pallas kernels (interpreted here);
``_xla_bwd`` is the independent blockwise scan that also carries the
rel-bias table gradient. Both recompute probabilities from the forward's
logsumexp, so they must agree to float32 rounding.
"""

import jax
import jax.numpy as jnp
import pytest

from photonic_flash_attention_tpu.ops import flash as F
from photonic_flash_attention_tpu.ops.pallas_utils import round_up

from ..conftest import rel_err_norm


def _cfg(causal=False, window=None, dropout=0.0, bq=32, bk=32):
    return F._Cfg(causal=causal, sm_scale=0.125, window=window, rel=F._NO_REL,
                  dropout_rate=dropout, block_q=bq, block_kv=bk, interpret=True)


def _setup(rng, b, sq, skv, h, hkv, d):
    q = jnp.asarray(rng.standard_normal((b, sq, h, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, skv, hkv, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, skv, hkv, d)), jnp.float32)
    do = jnp.asarray(rng.standard_normal((b, sq, h, d)), jnp.float32)
    return q, k, v, do


def _both(cfg, q, k, v, do, lens=None, kbias=None, seed=None):
    o, lse = F._fwd(cfg, q, k, v, lens, kbias, None, seed)
    got = F._bwd_kernels(cfg, q, k, v, lens, kbias, seed, o, lse, do)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    skv_p = round_up(skv, 32)
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    pad = lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, skv_p - skv), (0, 0)))  # noqa: E731
    kt = pad(t(jnp.repeat(k, g, axis=2)))
    vt = pad(t(jnp.repeat(v, g, axis=2)))
    kb = None if kbias is None else jnp.pad(kbias, ((0, 0), (0, skv_p - skv)))
    dq, dk, dv, _, dkb = F._xla_bwd(
        t(q), kt, vt, t(o), lse, t(do), sm_scale=cfg.sm_scale, causal=cfg.causal,
        q_true_len=sq, kv_true_len=skv, block_kv=32, window=cfg.window,
        kv_lens=lens, k_bias=kb, dropout_rate=cfg.dropout_rate, dropout_seed=seed,
    )
    dk = t(dk)[:, :skv].reshape(b, skv, hkv, g, d).sum(3)
    dv = t(dv)[:, :skv].reshape(b, skv, hkv, g, d).sum(3)
    want = (t(dq), dk, dv, None if dkb is None else dkb[:, :skv])
    return got, want


@pytest.mark.parametrize(
    "b,sq,skv,h,d,causal",
    [
        (1, 200, 200, 2, 64, True),  # padding to the tile
        (1, 256, 384, 2, 64, True),  # cross-length, end-aligned causal
        (2, 128, 128, 2, 32, False),
        (2, 256, 256, 4, 64, False),
        (2, 256, 256, 4, 64, True),
    ],
)
def test_pallas_bwd_matches_xla_bwd(rng, b, sq, skv, h, d, causal):
    q, k, v, do = _setup(rng, b, sq, skv, h, h, d)
    got, want = _both(_cfg(causal=causal, bq=64, bk=64), q, k, v, do)
    for name, a, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert rel_err_norm(a, w) < 1e-4, name


@pytest.mark.parametrize(
    "b,sq,skv,h,hkv,d,causal",
    [
        (2, 96, 96, 4, 2, 32, True),  # GQA + padding to the tile
        (1, 32, 96, 2, 1, 64, True),  # cross-length MQA
        (1, 80, 48, 2, 2, 16, False),
        (1, 128, 128, 4, 1, 64, True),  # MQA
    ],
)
def test_pallas_bwd_gqa_matches_xla_bwd(rng, b, sq, skv, h, hkv, d, causal):
    q, k, v, do = _setup(rng, b, sq, skv, h, hkv, d)
    got, want = _both(_cfg(causal=causal), q, k, v, do)
    for name, a, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert rel_err_norm(a, w) < 1e-4, name


def test_pallas_bwd_window(rng):
    q, k, v, do = _setup(rng, 1, 128, 128, 2, 2, 32)
    got, want = _both(_cfg(causal=True, window=(-40, 0)), q, k, v, do)
    for a, w in zip(got[:3], want[:3]):
        assert rel_err_norm(a, w) < 1e-4


def test_pallas_bwd_two_sided_window(rng):
    q, k, v, do = _setup(rng, 1, 96, 96, 2, 2, 32)
    got, want = _both(_cfg(window=(-20, 33)), q, k, v, do)
    for a, w in zip(got[:3], want[:3]):
        assert rel_err_norm(a, w) < 1e-4


def test_fully_masked_rows_produce_finite_grads(rng):
    """A sequence with zero valid keys has lse = -inf rows: its gradients
    are exactly zero, never NaN."""
    q, k, v, do = _setup(rng, 2, 64, 64, 2, 2, 32)
    lens = jnp.asarray([0, 40], jnp.int32)
    got, want = _both(_cfg(), q, k, v, do, lens=lens)
    for a in got[:3]:
        assert bool(jnp.all(jnp.isfinite(a)))
    assert float(jnp.abs(got[0][0]).max()) == 0.0
    for a, w in zip(got[:3], want[:3]):
        assert rel_err_norm(a, w) < 1e-4


def test_kv_lens_and_k_bias_grads_match_xla_bwd(rng):
    q, k, v, do = _setup(rng, 2, 64, 80, 4, 2, 32)
    lens = jnp.asarray([80, 51], jnp.int32)
    kb = jnp.asarray(rng.standard_normal((2, 80)), jnp.float32)
    got, want = _both(_cfg(causal=True), q, k, v, do, lens=lens, kbias=kb)
    for name, a, w in zip(("dq", "dk", "dv", "dkbias"), got, want):
        assert rel_err_norm(a, w) < 1e-4, name


@pytest.mark.parametrize("bq", [128, 256])
def test_pallas_bwd_dropout_matches_xla_bwd(rng, bq):
    q, k, v, do = _setup(rng, 2, 256, 256, 2, 2, 32)
    seed = jnp.asarray([17], jnp.int32)
    got, want = _both(_cfg(causal=True, dropout=0.2, bq=bq), q, k, v, do, seed=seed)
    for a, w in zip(got[:3], want[:3]):
        assert rel_err_norm(a, w) < 1e-4


def test_rel_bias_table_gradient(rng):
    """T5/ALiBi tables take the blockwise XLA backward: their gradient
    matches autodiff through the dense reference."""
    from photonic_flash_attention_tpu.ops.reference import attention_reference
    from photonic_flash_attention_tpu.ops.rel_bias import ALiBi, alibi_slopes, materialize

    q, k, v, _ = _setup(rng, 1, 64, 64, 4, 4, 32)

    def f(slopes):
        return jnp.sum(F.flash_attention(q, k, v, causal=True, rel_bias=ALiBi(slopes)) ** 2)

    def r(slopes):
        out, _ = attention_reference(q, k, v, bias=materialize(ALiBi(slopes), 64, 64), causal=True)
        return jnp.sum(out ** 2)

    s = alibi_slopes(4)
    assert rel_err_norm(jax.grad(f)(s), jax.grad(r)(s)) < 1e-4


@pytest.mark.parametrize(
    "case", ["plain", "causal", "gqa", "window", "lens_bias", "dropout", "f32"]
)
def test_backward_lowers_for_cuda(case):
    """Forward and both backward kernels lower through Triton for CUDA."""
    b, s, h, hkv, d = 2, 128, 4, 2 if case == "gqa" else 4, 64
    dt = jnp.float32 if case == "f32" else jnp.bfloat16
    q = jax.ShapeDtypeStruct((b, s, h, d), dt)
    k = jax.ShapeDtypeStruct((b, s, hkv, d), dt)
    kw = dict(block_q=64, block_kv=64, interpret=False, causal=case != "plain")
    extra = ()
    if case == "window":
        kw["window"] = (-50, 0)
    if case == "dropout":
        kw.update(dropout_rate=0.1, dropout_seed=jnp.asarray([3], jnp.int32))

    if case == "lens_bias":
        def loss(q, k, v, lens, kb):
            return F.flash_attention(q, k, v, kv_lens=lens, k_bias=kb, **kw).astype(jnp.float32).sum()

        extra = (jax.ShapeDtypeStruct((b,), jnp.int32), jax.ShapeDtypeStruct((b, s), jnp.float32))
    else:
        def loss(q, k, v):
            return F.flash_attention(q, k, v, **kw).astype(jnp.float32).sum()

    text = jax.jit(jax.grad(loss, argnums=(0, 1, 2))).trace(q, k, k, *extra).lower(
        lowering_platforms=("cuda",)).as_text()
    for name in ("pfa_flash_fwd", "pfa_flash_bwd_dkv", "pfa_flash_bwd_dq"):
        assert name in text
