#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU (or four, with an option).

    python3 chip_smoke.py               # one card: kernels, serving, training
    python3 chip_smoke.py --four-cards  # four cards: sharded serving, ring,
                                        # Ulysses and DP x TP training only

Phases, each printing one line per check:

1. device: platform, device kind and count, ``nvidia-smi`` name and power
   limit. Anything but a GPU fails: there is no CPU fallback.
2. kernel parity at real widths: every attention kernel of the path
   against the float32 reference (``ops/reference.py``) under
   ``jax.default_matmul_precision("highest")``.
3. serving: GPT-2 medium through ``ServingEngine`` with int8 and with
   bf16 KV pages. The engine's own prefill, chunked-prefill and decode
   logits, tapped inside its compiled steps, are compared with a float32
   forward of the sequences it served (teacher forcing).
4. training: three AdamW steps of GPT-2 medium at B=8, S=1024; step-1
   gradients against the same step with reference attention.

Any failure raises and the script exits non-zero. The last line of
standard output is one JSON object naming the device. Weights and data
come from fixed seeds; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Iterator, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths of every phase. ``FULL`` is what runs on the card."""

    gpt2: str = "medium"  # GPT2Config classmethod
    flash_cases: Tuple[Tuple[str, int, int, int, int, int], ...] = (
        ("gpt2-medium", 8, 1024, 16, 16, 64),
        ("llama-gqa", 2, 4096, 32, 8, 128),
    )
    cross: Tuple[int, int] = (256, 956)  # chunk queries over history + chunk
    t5_seq: int = 8192
    t5_heads: int = 8
    paged: Tuple[int, int, int, int, int, int] = (16, 4096, 8, 32, 128, 64)
    serve_lengths: Tuple[int, ...] = (17, 113, 209, 305, 401, 497, 593, 700)
    serve_new: int = 32
    page: int = 64
    chunk: int = 256
    train_batch: int = 8
    train_seq: int = 1024
    train_steps: int = 3
    ring: Tuple[int, int, int, int] = (1, 32768, 16, 64)


FULL = Sizes()

FWD_TOL, GRAD_TOL, INT8_TOL = 1e-2, 2e-2, 3e-2
SERVE_TOL, SERVE_INT8_TOL, LOSS_TOL = 2e-2, 3e-2, 1e-2


class CheckFailed(AssertionError):
    pass


def rel(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    print(f"  {name}: rel={err:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {err:.3e} > {tol:.0e}")


def tree_rel(a, b) -> float:
    import jax
    import numpy as np

    fa = np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree_util.tree_leaves(a)])
    fb = np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree_util.tree_leaves(b)])
    return rel(fa, fb)


# ---------------------------------------------------------------------------
# Phase 2: kernels
# ---------------------------------------------------------------------------


def _qkv(key, b, s, hq, hkv, d):
    import jax
    import jax.numpy as jnp

    kq, kk, kv, kg = jax.random.split(key, 4)
    q = jax.random.normal(kq, (b, s, hq, d), jnp.bfloat16)
    k = jax.random.normal(kk, (b, s, hkv, d), jnp.bfloat16)
    v = jax.random.normal(kv, (b, s, hkv, d), jnp.bfloat16)
    g = jax.random.normal(kg, (b, s, hq, d), jnp.float32)
    return q, k, v, g


def _parity(name, fn, ref_fn, args, cot, *, grads=True, fwd_tol=FWD_TOL,
            argnums=(0, 1, 2)):
    """Forward and (optionally) VJP of ``fn`` vs ``ref_fn`` on ``args``.

    Every array travels as a jit argument: a closure would bake it into
    the program as a constant.
    """
    import jax
    import jax.numpy as jnp

    f32 = [a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a for a in args]
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(ref_fn)(*f32)
    out = jax.jit(fn)(*args)
    check(f"{name} fwd", rel(out, ref), fwd_tol)
    if not grads:
        return

    def vjp(f, xs):
        def loss(*a):
            *a, c = a
            return jnp.sum(f(*a).astype(jnp.float32) * c)

        return jax.jit(jax.grad(loss, argnums=argnums))(*xs, cot)

    got = vjp(fn, args)
    with jax.default_matmul_precision("highest"):
        want = vjp(ref_fn, f32)
    for i, (a, b) in zip(argnums, zip(got, want)):
        check(f"{name} grad[{i}]", rel(a, b), GRAD_TOL)


def phase_kernels(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from photonic_flash_attention_tpu.ops import paged as P
    from photonic_flash_attention_tpu.ops.flash import (
        flash_attention,
        flash_attention_with_lse,
    )
    from photonic_flash_attention_tpu.ops.pallas_utils import dropout_keep
    from photonic_flash_attention_tpu.ops.reference import (
        DEFAULT_MASK_VALUE,
        attention_reference,
    )
    from photonic_flash_attention_tpu.ops.rel_bias import T5RelBias, materialize

    key = jax.random.PRNGKey(0)
    ref_causal = lambda q, k, v: attention_reference(q, k, v, causal=True)[0]  # noqa: E731
    for name, b, s, hq, hkv, d in sz.flash_cases:
        q, k, v, g = _qkv(key, b, s, hq, hkv, d)
        _parity(f"flash_attention {name} B{b} S{s} Hq{hq} Hkv{hkv} D{d} causal",
                lambda q, k, v: flash_attention(q, k, v, causal=True),
                ref_causal, (q, k, v), g)
        _parity(f"flash kernel {name} causal",
                lambda q, k, v: flash_attention(q, k, v, causal=True, implementation="pallas"),
                ref_causal, (q, k, v), g)
        del q, k, v, g

    name, b, s, hq, hkv, d = sz.flash_cases[0]
    q, k, v, g = _qkv(jax.random.PRNGKey(1), b, s, hq, hkv, d)
    lens = jnp.asarray(np.random.default_rng(0).integers(s // 2, s + 1, b), jnp.int32)
    keep = (jnp.arange(s)[None, :] < lens[:, None])[:, None, None, :]
    _parity("flash kv_lens", lambda q, k, v: flash_attention(q, k, v, causal=True, kv_lens=lens),
            lambda q, k, v: attention_reference(q, k, v, keep, causal=True)[0], (q, k, v), g)
    kb = jax.random.normal(jax.random.PRNGKey(2), (b, s), jnp.float32)
    _parity("flash k_bias", lambda q, k, v, kb: flash_attention(q, k, v, k_bias=kb),
            lambda q, k, v, kb: attention_reference(q, k, v, bias=kb[:, None, None, :])[0],
            (q, k, v, kb), g, argnums=(0, 1, 2, 3))
    rr, cc = jnp.arange(s)[:, None], jnp.arange(s)[None, :]
    win = ((cc - rr) >= -255)[None, None]
    _parity("flash window(-255,0)", lambda q, k, v: flash_attention(q, k, v, causal=True, window=(-255, 0)),
            lambda q, k, v: attention_reference(q, k, v, win, causal=True)[0], (q, k, v), g)
    sq, skv = sz.cross
    kc = jax.random.split(jax.random.PRNGKey(10), 4)
    qc = jax.random.normal(kc[0], (b, sq, hq, d), jnp.bfloat16)
    kx = jax.random.normal(kc[1], (b, skv, hkv, d), jnp.bfloat16)
    vx = jax.random.normal(kc[2], (b, skv, hkv, d), jnp.bfloat16)
    gc = jax.random.normal(kc[3], (b, sq, hq, d), jnp.float32)
    # The chunked-prefill mask: history columns at or past the row's
    # start are dead, chunk columns past the chunk's length are dead.
    hist, col = skv - sq, np.arange(skv)[None]
    crng = np.random.default_rng(10)
    start, clen = crng.integers(1, hist + 1, (b, 1)), crng.integers(1, sq + 1, (b, 1))
    dead = np.where(col < hist, col >= start, col - hist >= clen)
    kbc = jnp.asarray(np.where(dead, DEFAULT_MASK_VALUE, 0.0), jnp.float32)
    _parity(f"flash cross-length causal + k_bias B{b} Sq{sq} Skv{skv} H{hq} D{d}",
            lambda q, k, v, kb: flash_attention(q, k, v, causal=True, k_bias=kb),
            lambda q, k, v, kb: attention_reference(q, k, v, bias=kb[:, None, None, :], causal=True)[0],
            (qc, kx, vx, kbc), gc)
    del qc, kx, vx, gc
    ab = jnp.where(jax.random.bernoulli(jax.random.PRNGKey(3), 0.9, (b, 1, s, s)), 0.0, DEFAULT_MASK_VALUE)
    _parity("flash attn_bias", lambda q, k, v, ab: flash_attention(q, k, v, causal=True, attn_bias=ab),
            lambda q, k, v, ab: attention_reference(q, k, v, bias=ab, causal=True)[0], (q, k, v, ab), g,
            grads=False)

    rate, seed = 0.1, jnp.array([1234], jnp.int32)

    def dropout_ref(q, k, v):
        _, w = attention_reference(q, k, v, causal=True, need_weights=True, weights_only=True)
        bh = (jnp.arange(b)[:, None] * hq + jnp.arange(hq)[None, :])[:, :, None, None]
        kp = dropout_keep(seed[0], rr[None, None], cc[None, None], s, rate, bh=bh)
        wd = jnp.where(kp, w, 0.0) / (1.0 - rate)
        return jnp.einsum("bhqk,bkhd->bqhd", wd, v.astype(jnp.float32))

    _parity("flash dropout", lambda q, k, v: flash_attention(q, k, v, causal=True, dropout_rate=rate, dropout_seed=seed),
            dropout_ref, (q, k, v), g)

    def lse_ref(q, k, v):
        sc = jnp.einsum("bqhd,bkhd->bhqk", q * d ** -0.5, k)
        sc = jnp.where(cc <= rr, sc, -jnp.inf)
        return jax.nn.logsumexp(sc, axis=-1)

    out = jax.jit(lambda q, k, v: flash_attention_with_lse(q, k, v, causal=True))(q, k, v)
    with jax.default_matmul_precision("highest"):
        q32, k32, v32 = (x.astype(jnp.float32) for x in (q, k, v))
        check("flash_attention_with_lse out", rel(out[0], ref_causal(q32, k32, v32)), FWD_TOL)
        check("flash_attention_with_lse lse", rel(out[1], jax.jit(lse_ref)(q32, k32, v32)), FWD_TOL)
    del q, k, v, g, ab, out

    st, th = sz.t5_seq, sz.t5_heads
    q, k, v, g = _qkv(jax.random.PRNGKey(4), 1, st, th, th, 64)
    table = 0.5 * jax.random.normal(jax.random.PRNGKey(5), (32, th), jnp.float32)
    _parity(f"flash T5 rel-bias S{st}",
            lambda q, tab, k, v: flash_attention(q, k, v, rel_bias=T5RelBias(tab, True)),
            lambda q, tab, k, v: attention_reference(
                q, k, v, bias=materialize(T5RelBias(tab, True), st, st))[0],
            (q, table, k, v), g, argnums=(0, 1))
    del q, k, v, g

    bsz, toks, hkv, hq, d, page = sz.paged
    n_pages = bsz * toks // page + 1
    rng = np.random.default_rng(6)
    pt = jnp.asarray(1 + rng.permutation(n_pages - 1).reshape(bsz, toks // page), jnp.int32)
    lens = jnp.asarray(rng.integers(toks // 2, toks + 1, bsz), jnp.int32)
    qd = jax.random.normal(jax.random.PRNGKey(7), (bsz, hq, d), jnp.bfloat16)
    kn = jax.random.normal(jax.random.PRNGKey(8), (n_pages * page, hkv, d), jnp.float32)
    vn = jax.random.normal(jax.random.PRNGKey(9), (n_pages * page, hkv, d), jnp.float32)
    slots = jnp.arange(n_pages * page, dtype=jnp.int32)
    as_pool = lambda x: x.reshape(n_pages, page, hkv, d).transpose(2, 0, 1, 3)[None]  # noqa: E731
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda q, kn, vn: P.paged_attention_xla(
            q.astype(jnp.float32), as_pool(kn), as_pool(vn), lens, pt, layer=jnp.int32(0)))(qd, kn, vn)
    for dt, tol in ((jnp.int8, INT8_TOL), (jnp.bfloat16, FWD_TOL)):
        quant = dt == jnp.int8
        pool = {"k": jnp.zeros((1, hkv, n_pages, page, d), dt), "v": jnp.zeros((1, hkv, n_pages, page, d), dt)}
        if quant:
            pool["ks"] = jnp.ones((1, hkv, n_pages, page))
            pool["vs"] = jnp.ones((1, hkv, n_pages, page))
        pool = jax.jit(P.write_tokens, static_argnums=(5,))(pool, kn, vn, slots, jnp.int32(0), quant)
        out = jax.jit(lambda q, pool: P.paged_attention(
            q, pool["k"], pool["v"], lens, pt, pool.get("ks"), pool.get("vs"),
            layer=jnp.int32(0)))(qd, pool)
        check(f"paged decode {jnp.dtype(dt).name} B{bsz} T{toks} Hkv{hkv} Hq{hq} D{d}", rel(out, ref), tol)
        del pool


# ---------------------------------------------------------------------------
# Phase 3: serving
# ---------------------------------------------------------------------------


def _gpt2(sz: Sizes):
    import jax

    from photonic_flash_attention_tpu.models.gpt2 import GPT2Config, gpt2_init_params

    cfg = getattr(GPT2Config, sz.gpt2)()
    params = jax.jit(lambda r: gpt2_init_params(cfg, r))(jax.random.PRNGKey(0))
    return cfg, params


def _ref_attention(q, k, v):
    """Causal float32 reference attention at full matmul precision."""
    import jax
    import jax.numpy as jnp

    from photonic_flash_attention_tpu.ops.reference import attention_reference

    with jax.default_matmul_precision("highest"):
        out, _ = attention_reference(
            q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32), causal=True
        )
    return out.astype(q.dtype)


@functools.lru_cache(maxsize=None)
def _ref_forward_fn(cfg):
    import jax
    import jax.numpy as jnp

    from photonic_flash_attention_tpu.models.gpt2 import gpt2_forward

    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    return jax.jit(lambda p, x: gpt2_forward(p, cfg32, x, attention=_ref_attention))


def _ref_logits(cfg, params, seqs: Sequence[Sequence[int]]):
    """Float32 forward of every sequence at full matmul precision: device
    logits (N, S, V), right-padded (causal, so padding changes nothing)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    s = -(-max(map(len, seqs)) // 64) * 64
    ids = np.zeros((len(seqs), s), np.int32)
    for r, x in enumerate(seqs):
        ids[r, : len(x)] = x
    with jax.default_matmul_precision("highest"):
        return _ref_forward_fn(cfg)(params, jnp.asarray(ids))


@contextlib.contextmanager
def _decode_tap(record: Callable) -> Iterator[None]:
    """Engines built inside report every decode step's logits to
    ``record(ids, positions, lengths, logits)``, from inside their
    compiled decode window (one host callback per step)."""
    import jax

    from photonic_flash_attention_tpu.core import serving

    real = serving.decode_step

    def tapped(*args, **kw):
        logits, pages = real(*args, **kw)
        jax.debug.callback(record, args[2], args[3], args[6], logits)
        return logits, pages

    serving.decode_step = tapped
    try:
        yield
    finally:
        serving.decode_step = real


def _serve(cfg, params, sz: Sizes, kv_dtype, *, mesh=None, tap=False):
    """Serve the requests once through ``ServingEngine``.

    Returns (prompts, outputs, timing, taps). With ``tap`` the engine's
    logits are recorded: ``taps["prefill"]`` holds (prompt index, position,
    logits) for every prefill call and chunk, ``taps["decode"]`` maps
    (slot, position) to (consumed token, logits), ``taps["slot"]`` maps
    prompt index to decode slot.
    """
    import jax.numpy as jnp
    import numpy as np

    from photonic_flash_attention_tpu.core.serving import ServingEngine

    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, L))) for L in sz.serve_lengths]
    taps: Dict = {"prefill": [], "decode": {}, "slot": {}}

    def on_decode(ids, pos, lens, logits):
        for r in range(len(ids)):
            if lens[r] > 0:
                taps["decode"][(r, int(pos[r]))] = (int(ids[r]), np.array(logits[r], np.float32))

    pps = -(-(max(sz.serve_lengths) + sz.serve_new) // sz.page)
    with _decode_tap(on_decode) if tap else contextlib.nullcontext():
        eng = ServingEngine(
            cfg, params, kv_dtype=kv_dtype, max_batch=8, page_size=sz.page,
            num_pages=1 + len(prompts) * pps, max_pages_per_seq=pps,
            prefill_chunk=sz.chunk, mesh=mesh,
        )
    if tap:
        prefill, chunk, admit = eng._prefill_step, eng._chunk_step, eng._try_admit
        by_text = {tuple(p): i for i, p in enumerate(prompts)}

        def note(ids, start, n, logits):
            text = tuple(int(x) for x in np.asarray(ids)[0, :n])
            i = next(j for j, p in enumerate(prompts) if tuple(p[start:start + n]) == text)
            taps["prefill"].append((i, start + n - 1, np.asarray(logits[0], np.float32)))

        def tap_prefill(params, cfg_, ids, lens, *rest):
            out = prefill(params, cfg_, ids, lens, *rest)
            note(ids, 0, int(lens[0]), out[0])
            return out

        def tap_chunk(params, cfg_, ids, start, lens, *rest):
            out = chunk(params, cfg_, ids, start, lens, *rest)
            note(ids, int(start[0]), int(lens[0]), out[0])
            return out

        def tap_admit():
            admit()
            for sq in eng._sequences.values():
                if sq.slot is not None:
                    taps["slot"].setdefault(by_text[tuple(sq.tokens[: sq.prompt_len])], sq.slot)

        eng._prefill_step, eng._chunk_step, eng._try_admit = tap_prefill, tap_chunk, tap_admit

    t0 = time.perf_counter()
    sids = [eng.submit(p, sz.serve_new) for p in prompts]
    first: Dict[int, float] = {}
    while not all(eng._sequences[s].done for s in sids):
        eng.step()
        now = time.perf_counter() - t0
        for s in sids:
            if s not in first and eng._sequences[s].new_tokens > 0:
                first[s] = now
    wall = time.perf_counter() - t0
    out = [eng._sequences[s].tokens[eng._sequences[s].prompt_len:] for s in sids]
    del eng
    timing = {"wall_s": wall, "tokens": sum(map(len, out)), "ttft_s": sorted(first.values())}
    return prompts, out, timing, taps


def _engine_logits_parity(label: str, cfg, params, sz: Sizes, kv_dtype, *, mesh=None) -> None:
    """The engine's own logits against a float32 forward of what it served.

    The served sequences (prompt + greedy tokens) go through the float32
    forward once; every prefill call, prefill chunk and decode step the
    engine ran is compared at its position. Teacher forcing keeps the
    comparison on the engine's own context, so a near-tie can not make
    the two diverge.
    """
    import jax.numpy as jnp
    import numpy as np

    prompts, outs, _, taps = _serve(cfg, params, sz, kv_dtype, mesh=mesh, tap=True)
    seqs = [p + o for p, o in zip(prompts, outs)]
    if sorted(taps["slot"]) != list(range(len(prompts))) or len(set(taps["slot"].values())) != len(prompts):
        raise CheckFailed(f"{label}: every request needs its own decode slot, got {taps['slot']}")
    groups: Dict[str, List[Tuple[int, int, object]]] = {"single-shot prefill": [], "chunked prefill": []}
    for i, pos, lg in taps["prefill"]:
        chunked = len(prompts[i]) > sz.chunk
        groups["chunked prefill" if chunked else "single-shot prefill"].append((i, pos, lg))
    groups["decode"] = []
    for i, seq in enumerate(seqs):
        for pos in range(len(prompts[i]), len(seq) - 1):
            hit = taps["decode"].get((taps["slot"][i], pos))
            if hit is None or hit[0] != seq[pos]:
                raise CheckFailed(f"{label}: no decode step of request {i} consumed token {pos}")
            groups["decode"].append((i, pos, hit[1]))
    ref = _ref_logits(cfg, params, seqs)
    tol = SERVE_INT8_TOL if kv_dtype == jnp.int8 else SERVE_TOL
    name = jnp.dtype(kv_dtype).name
    for what, rows in groups.items():
        if not rows:
            raise CheckFailed(f"{label} {name}-KV: the engine ran no {what}")
        want = np.asarray(ref[jnp.asarray([r[0] for r in rows]), jnp.asarray([r[1] for r in rows])])
        got = np.stack([r[2] for r in rows])
        check(f"{label} {name}-KV engine {what} logits ({len(rows)} rows) vs float32 forward",
              rel(got, want), tol)


def phase_serving(sz: Sizes) -> None:
    import jax.numpy as jnp

    cfg, params = _gpt2(sz)
    for kv in (jnp.int8, jnp.bfloat16):
        name = jnp.dtype(kv).name
        _engine_logits_parity("serving", cfg, params, sz, kv)
        _serve(cfg, params, sz, kv)  # compiles the untapped decode windows
        _, toks, t, _ = _serve(cfg, params, sz, kv)
        bad = [len(x) for x in toks if len(x) != sz.serve_new or not all(0 <= y < cfg.vocab_size for y in x)]
        if bad:
            raise CheckFailed(f"serving {name}: malformed outputs {bad}")
        tt = t["ttft_s"]
        print(f"  serving {name}-KV: {len(toks)} requests x {sz.serve_new} tokens, "
              f"{t['tokens'] / t['wall_s']:.1f} tokens/s, ttft p50 {tt[len(tt) // 2] * 1e3:.1f} ms "
              f"max {tt[-1] * 1e3:.1f} ms (informational)", flush=True)


# ---------------------------------------------------------------------------
# Phase 4: training
# ---------------------------------------------------------------------------


def _train_batch(cfg, sz: Sizes, seed: int = 3):
    import jax.numpy as jnp
    import numpy as np

    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (sz.train_batch, sz.train_seq))
    return {"input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(np.roll(ids, -1, 1), jnp.int32)}


def phase_training(sz: Sizes) -> None:
    import jax
    import numpy as np
    import optax

    from photonic_flash_attention_tpu.models.gpt2 import GPT2LMHead, gpt2_forward
    from photonic_flash_attention_tpu.training.trainer import TrainState, lm_loss, make_train_step

    cfg, params = _gpt2(sz)
    model = GPT2LMHead(cfg)
    batch = _train_batch(cfg, sz)
    ref_apply = lambda v, ids, **_: gpt2_forward(v["params"], cfg, ids, attention=_ref_attention)  # noqa: E731
    g = jax.jit(jax.grad(lambda p: lm_loss(model.apply, p, batch)))(params)
    g_ref = jax.jit(jax.grad(lambda p: lm_loss(ref_apply, p, batch)))(params)
    check("train step-1 grads vs reference attention", tree_rel(g, g_ref), GRAD_TOL)
    del g, g_ref

    tx = optax.adamw(1e-4)
    state = TrainState(step=jax.numpy.int32(0), params=params, opt_state=jax.jit(tx.init)(params))
    step = jax.jit(make_train_step(model.apply, tx), donate_argnums=(0,))
    compiled = step.lower(state, batch).compile()
    print(f"  train step memory_analysis: {compiled.memory_analysis()}", flush=True)
    losses = []
    for i in range(sz.train_steps):
        t0 = time.perf_counter()
        state, metrics = compiled(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        print(f"  train step {i + 1}: loss={loss:.4f} grad_norm={float(metrics['grad_norm']):.3f} "
              f"{dt * 1e3:.1f} ms", flush=True)
        if not np.isfinite(loss):
            raise CheckFailed(f"non-finite loss at step {i + 1}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}", flush=True)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def phase_four_cards(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from photonic_flash_attention_tpu.models.gpt2 import GPT2LMHead, param_sharding_rules
    from photonic_flash_attention_tpu.ops.flash import flash_attention
    from photonic_flash_attention_tpu.parallel.mesh import create_mesh
    from photonic_flash_attention_tpu.parallel.ring import make_ring_attention
    from photonic_flash_attention_tpu.parallel.ulysses import make_ulysses_attention
    from photonic_flash_attention_tpu.training.trainer import TrainState, make_train_step

    devs = jax.devices()[:4]
    if len(devs) < 4:
        raise CheckFailed(f"--four-cards needs 4 devices, found {len(devs)}")
    cfg, params = _gpt2(sz)

    # Greedy tokens compare exactly only when the arithmetic does: in bf16
    # a sharded psum rounds differently from one GEMM, which can break a
    # near-tie either way. So the token check runs both engines in
    # float32 at full matmul precision; the bf16 and int8 KV paths are
    # held to the float32 forward by their logits below.
    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    mesh = create_mesh((1, 4), ("data", "model"), devs)
    with jax.default_matmul_precision("highest"):
        _, one, _, _ = _serve(cfg32, params, sz, jnp.float32)
        _, four, t, _ = _serve(cfg32, params, sz, jnp.float32, mesh=mesh)
    same = sum(a == b for a, b in zip(one, four))
    print(f"  sharded serving (1, 4) data x model, float32: {same}/{len(one)} requests "
          f"token-identical to one card ({t['tokens'] / t['wall_s']:.1f} tokens/s incl. compile)",
          flush=True)
    if same != len(one):
        raise CheckFailed("sharded serving tokens differ from the one-card engine")
    # The sharded int8 and bf16 KV paths users serve, each against the
    # float32 forward of the tokens it served.
    for kv in (jnp.int8, jnp.bfloat16):
        _engine_logits_parity("sharded (1, 4)", cfg, params, sz, kv, mesh=mesh)

    b, s, h, d = sz.ring
    q, k, v, _ = _qkv(jax.random.PRNGKey(11), b, s, h, h, d)
    ref = jax.jit(lambda q, k, v: flash_attention(q, k, v, causal=True))(q, k, v)
    seq_mesh = create_mesh((4,), ("seq",), devs)
    ring = make_ring_attention(seq_mesh, data_axis=None, model_axis=None, causal=True)
    check(f"ring attention B{b} S{s} H{h} D{d} causal, 4-way seq vs one card", rel(ring(q, k, v), ref), GRAD_TOL)
    uly = make_ulysses_attention(seq_mesh, data_axis=None, causal=True)
    check(f"ulysses attention B{b} S{s} H{h} D{d} causal, 4-way seq vs one card", rel(uly(q, k, v), ref), GRAD_TOL)
    del q, k, v, ref

    model = GPT2LMHead(cfg)
    batch = _train_batch(cfg, sz)
    tx = optax.adamw(1e-4)
    step = make_train_step(model.apply, tx)
    state = TrainState(step=jnp.int32(0), params=params, opt_state=jax.jit(tx.init)(params))
    _, m_one = jax.jit(step)(state, batch)
    loss_one = float(m_one["loss"])
    dp_tp = create_mesh((2, 2), ("data", "model"), devs)
    specs = param_sharding_rules(params, ("data", "model"))
    sp = jax.device_put(params, jax.tree_util.tree_map(lambda s_: NamedSharding(dp_tp, s_), specs))
    sb = jax.device_put(batch, NamedSharding(dp_tp, P("data", None)))
    st = TrainState(step=jnp.int32(0), params=sp, opt_state=jax.jit(tx.init)(sp))
    with dp_tp:
        _, m_four = jax.jit(step)(st, sb)
    loss_four = float(m_four["loss"])
    check(f"DPxTP (2, 2) train step loss {loss_four:.5f} vs one card {loss_one:.5f}",
          abs(loss_four - loss_one) / abs(loss_one), LOSS_TOL)


# ---------------------------------------------------------------------------


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run(phases: Sequence[Tuple[str, Callable[[Sizes], None]]], sz: Sizes) -> None:
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"phase {name}:", flush=True)
        fn(sz)
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv: Sequence[str] = ()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths and what they are compared with")
    args = ap.parse_args(argv)
    try:
        import jax

        from photonic_flash_attention_tpu import platform
        from photonic_flash_attention_tpu.optimization.caching import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}", file=sys.stderr)
        return 2
    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: JAX found no device: {e}", file=sys.stderr)
        return 1
    dev = platform.describe()
    print(f"phase device: platform={dev['platform']} kind={dev['kind']} count={dev['count']}", flush=True)
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}", file=sys.stderr)
        return 1
    platform.device_peaks()  # an unknown card is an error
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    smi = _nvidia_smi()
    if args.four_cards:
        run([("four-cards", phase_four_cards)], FULL)
    else:
        run([("kernels", phase_kernels), ("serving", phase_serving),
             ("training", phase_training)], FULL)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": dev["platform"], "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
