#!/usr/bin/env python
"""Model-level benchmark grid — the reference's headline table, measured.

The reference publishes model speedups only as README claims with no
benchmark artifacts (reference README.md:658-663: BERT-Base seq 512/2048,
GPT-2 seq 1024/4096, T5-Large seq 512/8192; see BASELINE.md). This script
measures the same grid for real on one GPU: full-model forward
latency with the flash kernel path vs the XLA-fused dense-attention path
in the *same* model code (toggled via ``flash_threshold``, the rebirth of
the reference's photonic-vs-GPU router threshold, reference config.py:14).

Timing methodology matches bench.py: the iteration loop runs inside one
jitted ``lax.scan`` with a data dependency between iterations (next ids
derived from the previous logits), and per-iteration time is the slope
across two iteration counts, cancelling host dispatch overhead.

Writes benchmarks/results.json and prints a markdown table.

Usage: python benchmarks/model_benchmark.py [--quick]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))  # runnable from any cwd

from photonic_flash_attention_tpu.config import get_config  # noqa: E402


def zeros_variables(model, sample_args):
    """Zero params from eval_shape: the timing needs shapes, not values."""
    shapes = jax.eval_shape(lambda r: model.init(r, *sample_args), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def fit_time(run_iters, lo=3, hi=13):
    """Per-iteration seconds via linear fit across two iteration counts."""
    run_iters(lo)  # compile + warm
    run_iters(hi)
    best_lo = best_hi = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        run_iters(lo)
        best_lo = min(best_lo, time.perf_counter() - t0)
        t0 = time.perf_counter()
        run_iters(hi)
        best_hi = min(best_hi, time.perf_counter() - t0)
    return (best_hi - best_lo) / (hi - lo)


def _chain_ids(logits, vocab):
    """Derive the next iteration's int32 ids from logits — a real data
    dependency so nothing is dead-code-eliminated inside the scan."""
    if logits.ndim == 3:
        return jnp.argmax(logits[..., : min(vocab, 256)], axis=-1).astype(jnp.int32)
    return jnp.clip(jnp.abs(logits).astype(jnp.int32), 0, vocab - 1)


def bench_model(apply_fn, variables, ids0, vocab, iters=(3, 13)):
    @functools.partial(jax.jit, static_argnums=2)
    def many(variables, ids, n):
        def body(c, _):
            logits = apply_fn(variables, c)
            return _chain_ids(logits, vocab), None

        out, _ = jax.lax.scan(body, ids, None, length=n)
        return jnp.sum(out)

    def run(n):
        return int(many(variables, ids0, n))

    return fit_time(run, *iters)


def build_bert(seq):
    from photonic_flash_attention_tpu.models.bert import BertConfig, BertModel

    cfg = dataclasses.replace(BertConfig.base(), max_position_embeddings=max(512, seq))
    model = BertModel(cfg, add_pooler=False)
    ids = jnp.zeros((1, seq), jnp.int32)
    variables = zeros_variables(model, (ids,))

    def apply_fn(variables, ids):
        seq_out, _ = model.apply(variables, ids)
        return seq_out

    return apply_fn, variables, ids, cfg.vocab_size


def build_gpt2(seq):
    from photonic_flash_attention_tpu.models.gpt2 import GPT2Config, GPT2LMHead

    cfg = dataclasses.replace(GPT2Config.small(), n_positions=max(1024, seq))
    model = GPT2LMHead(cfg)
    ids = jnp.zeros((1, seq), jnp.int32)
    variables = zeros_variables(model, (ids,))
    return (lambda v, i: model.apply(v, i)), variables, ids, cfg.vocab_size


def build_t5(seq):
    from photonic_flash_attention_tpu.models.t5 import T5Config, T5Model

    cfg = T5Config.large()
    model = T5Model(cfg)
    enc = jnp.zeros((1, seq), jnp.int32)
    dec = jnp.zeros((1, seq), jnp.int32)
    shapes = jax.eval_shape(
        lambda r: model.init(r, enc[:, :8], dec[:, :8]), jax.random.PRNGKey(0)
    )
    variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    def apply_fn(variables, ids):
        return model.apply(variables, ids, ids)

    return apply_fn, variables, enc, cfg.vocab_size


# (name, builder, seqs, reference claimed [gpu_ms, photonic_ms] per seq)
GRID = [
    ("BERT-Base", build_bert, {512: (12.3, 13.1), 2048: (89.7, 18.2)}),
    ("GPT-2", build_gpt2, {1024: (45.6, 22.8), 4096: (412.3, 41.5)}),
    ("T5-Large", build_t5, {512: (34.2, 38.9), 8192: (1823.4, 93.2)}),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="skip the largest configs")
    args = ap.parse_args()

    try:
        from photonic_flash_attention_tpu.optimization.caching import (
            CompileCacheManager,
        )

        CompileCacheManager().enable()
    except Exception:
        pass

    conf = get_config()
    results = []
    for name, builder, claims in GRID:
        for seq, (ref_gpu_ms, ref_photonic_ms) in claims.items():
            if args.quick and seq > 2048:
                continue
            print(f"== {name} seq={seq}", file=sys.stderr, flush=True)
            apply_fn, variables, ids, vocab = builder(seq)
            row = {
                "model": name,
                "seq": seq,
                "batch": 1,
                "ref_claim_gpu_ms": ref_gpu_ms,
                "ref_claim_photonic_ms": ref_photonic_ms,
            }
            for variant, threshold, min_tokens in (
                # router defaults (seq + token crossovers)
                ("auto", conf.flash_threshold, conf.flash_min_tokens),
                ("flash", 256, 0),  # force the flash kernel
                ("xla_dense", 10 ** 9, 10 ** 12),  # force the fused path
            ):
                old = (conf.flash_threshold, conf.flash_min_tokens)
                conf.update(flash_threshold=threshold, flash_min_tokens=min_tokens)
                try:
                    dt = bench_model(apply_fn, variables, ids, vocab)
                    row[f"{variant}_ms"] = round(dt * 1e3, 2)
                    print(
                        f"   {variant}: {dt*1e3:.2f} ms", file=sys.stderr, flush=True
                    )
                except Exception as e:  # OOM on dense long-seq is a result
                    row[f"{variant}_ms"] = None
                    row[f"{variant}_error"] = type(e).__name__
                    print(f"   {variant}: FAILED {type(e).__name__}",
                          file=sys.stderr, flush=True)
                finally:
                    conf.update(flash_threshold=old[0], flash_min_tokens=old[1])
            if row.get("flash_ms") and row.get("xla_dense_ms"):
                row["speedup"] = round(row["xla_dense_ms"] / row["flash_ms"], 2)
            results.append(row)
            del variables

    out = {
        "device": str(jax.devices()[0].device_kind),
        "dtype": "bfloat16",
        "timing": "lax.scan-chained linear fit (dispatch-overhead-free)",
        "results": results,
    }
    (HERE / "results.json").write_text(json.dumps(out, indent=2))

    print("\n| Model | Seq | auto (ms) | flash (ms) | XLA dense (ms) | speedup | ref claim GPU→photonic (ms) |")
    print("|---|---|---|---|---|---|---|")
    for r in results:
        print(
            f"| {r['model']} | {r['seq']} | {r.get('auto_ms')} | {r.get('flash_ms')} | "
            f"{r.get('xla_dense_ms') or r.get('xla_dense_error')} | "
            f"{r.get('speedup', '—')} | {r['ref_claim_gpu_ms']} → {r['ref_claim_photonic_ms']} |"
        )


if __name__ == "__main__":
    main()
