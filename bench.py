#!/usr/bin/env python
"""Kernel and end-to-end benchmark on one NVIDIA GPU; prints ONE JSON line.

Headline metric: flash-attention causal prefill throughput (tokens/s) at
the reference's benchmark geometry (d=768, h=12, S=2048 — reference
cli.py:24-35 grid), through ``flash_attention`` as a caller gets it.
``vs_baseline`` is the speedup over XLA's plain attention on the same
card.

Rows: each hand-written kernel beside what XLA (and cuDNN, where it
covers the case) makes of the same call, at the shapes the smoke test
checks — flash forward and forward+backward at GPT-2 medium and at a
Llama GQA geometry, paged decode in int8 and bf16 — plus a GPT-2 medium
continuous-batching serving row. Each row carries its roofline share
against the card's published peaks (``platform.PEAKS``) with the card's
name and power limit.

Timing: the call runs N times inside one jitted loop with its output
chained into the next input (nothing is dead-code eliminated), the loop
ends in a scalar fetch, and per-call time is the slope of a linear fit
over two iteration counts, which cancels dispatch and fetch. Every large
array is a jit argument.

Runs only on a GPU: elsewhere it exits non-zero without a result.
"""

import functools
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ITERS = (5, 25)


def _time_ms(fn, *args, iters=ITERS):
    """Per-call ms of ``fn(*args)``; its first output is fed back as arg 0."""

    @jax.jit
    def many(args, n):
        def body(_, a):
            out = fn(*a)
            out = out[0] if isinstance(out, (tuple, list)) else out
            return (out.astype(a[0].dtype).reshape(a[0].shape),) + tuple(a[1:])

        a = jax.lax.fori_loop(0, n, body, tuple(args))
        return jnp.sum(a[0].astype(jnp.float32))

    float(many(args, iters[0]))

    def timed(n):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(many(args, n))
            best = min(best, time.perf_counter() - t0)
        return best

    lo, hi = iters
    return max((timed(hi) - timed(lo)) / (hi - lo) * 1e3, 1e-6)


def _all_grads(f, q, k, v):
    """dq, with dk and dv folded in so that no gradient is dead code."""
    dq, dk, dv = jax.grad(
        lambda q, k, v: f(q, k, v).astype(jnp.float32).sum(), argnums=(0, 1, 2)
    )(q, k, v)
    return dq + ((jnp.sum(dk) + jnp.sum(dv)) * 1e-30).astype(dq.dtype)


def _blockwise_bwd(q, k, v, bq):
    """The kernel's forward with the blockwise XLA backward (the path the
    T5/ALiBi table gradient takes), folded like ``_all_grads``."""
    from photonic_flash_attention_tpu.ops import flash as F

    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    cfg = F._Cfg(causal=True, sm_scale=d ** -0.5, window=None, rel=F._NO_REL,
                 dropout_rate=0.0, block_q=bq, block_kv=64, interpret=False)
    o, lse = F._fwd(cfg, q, k, v, None, None, None, None)
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    rep = lambda x: t(jnp.repeat(x, g, axis=2))  # noqa: E731
    dq, dk, dv, _, _ = F._xla_bwd(
        t(q), rep(k), rep(v), t(o), lse, t(jnp.ones_like(o)), sm_scale=cfg.sm_scale,
        causal=True, q_true_len=s, kv_true_len=s, block_kv=512,
    )
    return t(dq) + ((jnp.sum(dk) + jnp.sum(dv)) * 1e-30).astype(dq.dtype)


def _attn_flops(b, s, hq, d, causal, bwd=False):
    f = 4.0 * b * hq * s * s * d * (0.5 if causal else 1.0)
    return f * (3.5 if bwd else 1.0)  # backward ~2.5x forward


def _qkv(b, s, hq, hkv, d, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (
        jax.random.normal(ks[0], (b, s, hq, d), jnp.bfloat16),
        jax.random.normal(ks[1], (b, s, hkv, d), jnp.bfloat16),
        jax.random.normal(ks[2], (b, s, hkv, d), jnp.bfloat16),
    )


def _flash_rows(peaks):
    from photonic_flash_attention_tpu.ops.flash import flash_attention

    rows = []
    for name, (b, s, hq, hkv, d) in {
        "gpt2_medium_b8_s1024": (8, 1024, 16, 16, 64),
        "llama_gqa_b2_s4096_d128": (2, 4096, 32, 8, 128),
    }.items():
        q, k, v = _qkv(b, s, hq, hkv, d)
        bq = 64 if d <= 64 else 128
        impls = {
            "pallas_triton": lambda q, k, v: flash_attention(q, k, v, causal=True, block_q=bq, block_kv=64, implementation="pallas"),
            "cudnn": lambda q, k, v: jax.nn.dot_product_attention(q, k, v, is_causal=True, implementation="cudnn"),
            "xla": lambda q, k, v: jax.nn.dot_product_attention(q, k, v, is_causal=True, implementation="xla"),
        }
        for mode in ("fwd", "fwd_bwd"):
            row = {"name": f"flash_{mode}_{name}", "shape": [b, s, hq, hkv, d], "causal": True}
            runs = dict(impls)
            if mode == "fwd_bwd":
                runs["pallas_fwd_xla_blockwise_bwd"] = functools.partial(_blockwise_bwd, bq=bq)
            for impl, f in runs.items():
                if mode == "fwd":
                    g = f
                elif impl == "pallas_fwd_xla_blockwise_bwd":
                    g = f
                else:
                    g = functools.partial(_all_grads, f)
                try:
                    ms = _time_ms(g, q, k, v)
                    fl = _attn_flops(b, s, hq, d, True, bwd=mode != "fwd")
                    row[impl] = {"ms": round(ms, 4), "tflops": round(fl / ms / 1e9, 1),
                                 "roofline_share": round(fl / (ms * 1e-3) / peaks.bf16_flops, 3)}
                except Exception as e:  # noqa: BLE001 - a missing library path is a row entry
                    row[impl] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
            rows.append(row)
    return rows


def _decode_rows(peaks):
    from photonic_flash_attention_tpu.ops import paged as P

    b, toks, hkv, hq, d, page = 16, 4096, 8, 32, 128, 64
    n_pages = b * toks // page + 1
    rng = np.random.default_rng(0)
    pt = jnp.asarray(1 + rng.permutation(n_pages - 1).reshape(b, toks // page), jnp.int32)
    lens = jnp.full((b,), toks, jnp.int32)
    q = jax.random.normal(jax.random.PRNGKey(1), (b, hq, d), jnp.bfloat16)
    kn = jax.random.normal(jax.random.PRNGKey(2), (n_pages * page, hkv, d), jnp.float32)
    vn = jax.random.normal(jax.random.PRNGKey(3), (n_pages * page, hkv, d), jnp.float32)
    slots = jnp.arange(n_pages * page, dtype=jnp.int32)
    rows = []
    for dt in (jnp.int8, jnp.bfloat16):
        quant = dt == jnp.int8
        shape = (1, hkv, n_pages, page, d)
        pool = {"k": jnp.zeros(shape, dt), "v": jnp.zeros(shape, dt)}
        if quant:
            pool["ks"], pool["vs"] = jnp.ones(shape[:-1]), jnp.ones(shape[:-1])
        pool = jax.jit(P.write_tokens, static_argnums=(5,))(pool, kn, vn, slots, jnp.int32(0), quant)
        read = b * toks * hkv * d * 2 * jnp.dtype(dt).itemsize + (b * toks * hkv * 8 if quant else 0)
        row = {"name": f"paged_decode_{jnp.dtype(dt).name}_b{b}_t{toks}_hkv{hkv}_hq{hq}_d{d}",
               "cache_bytes_read": int(read)}
        for impl, f in {
            "pallas_triton": lambda q, pool: P.paged_attention(
                q, pool["k"], pool["v"], lens, pt, pool.get("ks"), pool.get("vs"), layer=jnp.int32(0)),
            "xla": lambda q, pool: P.paged_attention_xla(
                q, pool["k"], pool["v"], lens, pt, pool.get("ks"), pool.get("vs"), layer=jnp.int32(0)),
        }.items():
            ms = _time_ms(f, q, pool)
            row[impl] = {"ms": round(ms, 4), "gb_per_s": round(read / ms / 1e6, 1),
                         "roofline_share": round(read / (ms * 1e-3) / peaks.hbm_bytes_per_s, 3)}
        rows.append(row)
        del pool
    return rows


def _serving_row():
    """GPT-2 medium, int8 KV, 8 sequences: steady state after a warm pass."""
    from photonic_flash_attention_tpu.core.serving import ServingEngine
    from photonic_flash_attention_tpu.models.gpt2 import GPT2Config, gpt2_init_params

    cfg = GPT2Config.medium()
    params = jax.jit(lambda r: gpt2_init_params(cfg, r))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    n_prompt, n_new, batch = 128, 128, 8
    eng = ServingEngine(cfg, params, num_pages=1 + batch * 4, page_size=64,
                        max_pages_per_seq=4, max_batch=batch, kv_dtype=jnp.int8,
                        decode_window=64)

    def one_pass():
        prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n_prompt))) for _ in range(batch)]
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=n_new)
        return time.perf_counter() - t0

    cold = one_pass()
    eng.reset_performance_stats()
    wall = one_pass()
    stats = eng.get_performance_stats()
    return {
        "name": "serving_gpt2_medium_int8kv_b8_steady",
        "tokens_per_s": round(batch * (n_prompt + n_new) / wall, 1),
        "decode_tokens_per_s": round(stats["decode_tokens_per_s"], 1),
        "decode_ms_per_step": round(1e3 * stats["decode_time"] / max(stats["decode_steps"], 1), 3),
        "wall_s": round(wall, 3),
        "cold_wall_s": round(cold, 2),
    }


def main() -> int:
    from photonic_flash_attention_tpu import platform
    from photonic_flash_attention_tpu.ops.flash import flash_attention
    from photonic_flash_attention_tpu.optimization.caching import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print("bench.py runs on a GPU only", file=sys.stderr)
        return 1
    enable_compile_cache()
    peaks = platform.device_peaks()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()

    b, s, h, d = 4, 2048, 12, 64
    q, k, v = _qkv(b, s, h, h, d, seed=7)
    t_flash = _time_ms(lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, v)
    t_naive = _time_ms(
        lambda q, k, v: jax.nn.dot_product_attention(q, k, v, is_causal=True, implementation="xla"),
        q, k, v,
    )
    rows = []
    for label, fn in (("flash", _flash_rows), ("decode", _decode_rows)):
        try:
            rows += fn(peaks)
        except Exception as e:  # noqa: BLE001 - report the failed row group
            rows.append({"name": label, "error": f"{type(e).__name__}: {str(e)[:300]}"})
        print(f"{label} rows done", file=sys.stderr, flush=True)
    try:
        rows.append(_serving_row())
    except Exception as e:  # noqa: BLE001
        rows.append({"name": "serving", "error": f"{type(e).__name__}: {str(e)[:300]}"})
    fl = _attn_flops(b, s, h, d, True)
    print(json.dumps({
        "metric": "flash_attention_prefill_tokens_per_sec_per_chip",
        "value": round(b * s / (t_flash * 1e-3), 1),
        "unit": "tokens/s",
        "vs_baseline": round(t_naive / t_flash, 3),
        "detail": {
            "device": platform.describe(),
            "card": card,
            "peaks": {"name": peaks.name, "bf16_tflops": peaks.bf16_flops / 1e12,
                      "hbm_tb_per_s": peaks.hbm_bytes_per_s / 1e12, "source": peaks.source},
            "shape": {"batch": b, "seq": s, "heads": h, "head_dim": d, "causal": True},
            "flash_ms": round(t_flash, 4),
            "xla_ms": round(t_naive, 4),
            "flash_roofline_share": round(fl / (t_flash * 1e-3) / peaks.bf16_flops, 3),
            "rows": rows,
            "timing": "chained jit loop, linear fit over iteration counts",
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
