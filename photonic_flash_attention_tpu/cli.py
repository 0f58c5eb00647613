"""Command-line interface: benchmark / calibrate / device-info.

The rebirth of the reference CLI (reference cli.py:20-419) with the same
subcommand surface and default grids, real meaning attached:

* ``benchmark`` — sweep batch x seq over the hybrid engine with warmup,
  per-config latency stats + tokens/s + kernel used, optional JSON dump
  (reference cli.py:20-145; same default grid seq {128..4096} x batch
  {1,2,4,8}, d=768, h=12, 10 iters, cli.py:24-35).
* ``calibrate`` — random patterns through the quantized kernels, error vs
  the fp32 oracle, accuracy = 1 - mean relative error, save/load JSON
  (reference cli.py:148-303 — its "optical calibration" measured exactly
  this for the simulated modulator; here the numbers are real FP8/INT8
  error budgets).
* ``device-info`` — device/memory report, human or JSON
  (reference cli.py:306-363).

Console scripts: ``pfa-benchmark``, ``pfa-calibrate`` (pyproject).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import get_config
from .utils.logging import get_logger, setup_logging

logger = get_logger("cli")


def _timed_calls(fn, args, iters: int) -> List[float]:
    """Per-call latencies with a host fetch forcing completion."""
    out = fn(*args)
    float(jnp.sum(out))  # warmup compile + fetch path
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        float(jnp.sum(out))
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def benchmark(args: argparse.Namespace) -> int:
    """Sweep the engine over the benchmark grid (reference cli.py:20-145)."""
    from .core.engine import AttentionEngine
    from .core.router import AdaptiveRouter

    seqs = args.seq_lengths or [128, 256, 512, 1024, 2048, 4096]
    batches = args.batch_sizes or [1, 2, 4, 8]
    d_model, heads = args.embed_dim, args.num_heads
    head_dim = d_model // heads
    rng = np.random.default_rng(0)
    eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))

    results: List[Dict[str, Any]] = []
    for seq in seqs:
        for batch in batches:
            shape = (batch, seq, heads, head_dim)
            q = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
            k = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
            v = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
            # Warmup: let the engine measure every eligible kernel
            # (reference does 3 warmup calls, cli.py:67-68).
            for _ in range(args.warmup):
                eng(q, k, v, causal=args.causal)
            lat = []
            for _ in range(args.iterations):
                t0 = time.perf_counter()
                eng(q, k, v, causal=args.causal)
                lat.append((time.perf_counter() - t0) * 1e3)
            mean = statistics.mean(lat)
            row = {
                "batch_size": batch,
                "seq_length": seq,
                "latency_ms": {
                    "mean": round(mean, 3),
                    "std": round(statistics.pstdev(lat), 3),
                    "min": round(min(lat), 3),
                    "max": round(max(lat), 3),
                },
                "tokens_per_second": round(batch * seq / (mean / 1e3), 1),
                "kernel_used": eng.last_kernel_used,
                "energy_mj": round(eng.last_energy_mj, 3),
            }
            results.append(row)
            print(
                f"b={batch:<3d} s={seq:<5d} {mean:8.3f} ms  "
                f"{row['tokens_per_second']:>12,.0f} tok/s  [{eng.last_kernel_used}]"
            )

    payload = {
        "benchmark": "attention_engine",
        "config": {
            "embed_dim": d_model,
            "num_heads": heads,
            "causal": args.causal,
            "iterations": args.iterations,
            "backend": jax.default_backend(),
        },
        "engine_stats": eng.get_performance_stats(),
        "results": results,
    }
    if args.output:
        with open(args.output, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.output}")
    return 0


def calibrate(args: argparse.Namespace) -> int:
    """Quantization error sweep (reference cli.py:148-303).

    Covers what the program quantizes: fp8/int8 tensor quantization and
    the int8 KV cache read through the paged decode kernel, against the
    fp32 oracle."""
    from .ops.paged import paged_attention, paged_attention_xla, write_tokens
    from .ops.quantization import quantization_error, quantize

    rng = np.random.default_rng(args.seed)
    report: Dict[str, Any] = {"modes": {}, "patterns": args.patterns}
    b, hkv, hq, d, page, n_pages = 2, 2, 4, 64, 16, 33
    lens = jnp.asarray([n_pages // 2 * page, (n_pages - 1) // 2 * page], jnp.int32)
    pt = jnp.arange(1, n_pages, dtype=jnp.int32).reshape(b, -1)
    slots = jnp.arange(n_pages * page, dtype=jnp.int32)
    for mode, qdtype in (("fp8", jnp.float8_e4m3fn), ("int8", jnp.int8)):
        tensor_errs, attn_errs = [], []
        for _ in range(args.patterns):
            scale = 10.0 ** rng.uniform(-1, 1)
            x = jnp.asarray(rng.standard_normal((4, 256, 64)) * scale, jnp.float32)
            qt = quantize(x, qdtype, axis=1, block_size=128)
            tensor_errs.append(quantization_error(x, qt)["mean_rel_err"])
            if mode != "int8":
                continue
            q = jnp.asarray(rng.standard_normal((b, hq, d)), jnp.float32)
            kn = jnp.asarray(rng.standard_normal((n_pages * page, hkv, d)), jnp.float32)
            vn = jnp.asarray(rng.standard_normal((n_pages * page, hkv, d)) * scale, jnp.float32)
            shape = (1, hkv, n_pages, page, d)
            f32 = write_tokens({"k": jnp.zeros(shape), "v": jnp.zeros(shape)},
                               kn, vn, slots, 0, False)
            i8 = write_tokens(
                {"k": jnp.zeros(shape, jnp.int8), "v": jnp.zeros(shape, jnp.int8),
                 "ks": jnp.ones(shape[:-1]), "vs": jnp.ones(shape[:-1])},
                kn, vn, slots, 0, True,
            )
            ref = paged_attention_xla(q, f32["k"], f32["v"], lens, pt, layer=0)
            out = paged_attention(q, i8["k"], i8["v"], lens, pt, i8["ks"], i8["vs"], layer=0)
            num = float(jnp.linalg.norm((out - ref).astype(jnp.float32)))
            den = float(jnp.linalg.norm(ref.astype(jnp.float32)))
            attn_errs.append(num / max(den, 1e-9))
        m = {
            "tensor_mean_rel_err": float(np.mean(tensor_errs)),
            "tensor_accuracy": float(1.0 - np.mean(tensor_errs)),
            "passes_reference_gate": True,
        }
        line = f"{mode}: tensor acc {m['tensor_accuracy']:.4f}"
        if attn_errs:
            m["kv_decode_rel_err_mean"] = float(np.mean(attn_errs))
            m["kv_decode_rel_err_max"] = float(np.max(attn_errs))
            m["passes_reference_gate"] = bool(np.max(attn_errs) < 0.1)
            line += (
                f"  int8-KV decode rel-err mean {m['kv_decode_rel_err_mean']:.4f} "
                f"max {m['kv_decode_rel_err_max']:.4f}  "
                f"gate(<0.1): {'PASS' if m['passes_reference_gate'] else 'FAIL'}"
            )
        report["modes"][mode] = m
        print(line)

    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.output}")
    return 0 if all(m["passes_reference_gate"] for m in report["modes"].values()) else 1


def serve_bench(args: argparse.Namespace) -> int:
    """Continuous-batching decode benchmark: GPT-2 + paged KV cache.

    The BASELINE "INT8 paged KV-cache decode with continuous batching"
    config: measures prefill admission and steady-state decode
    throughput on one chip, bf16 vs int8 KV.
    """
    from .core.serving import ServingEngine
    from .models.gpt2 import GPT2Config, GPT2LMHead

    cfg = {
        "tiny": GPT2Config.tiny,
        "small": GPT2Config.small,
        "medium": GPT2Config.medium,
    }[args.model]()
    model = GPT2LMHead(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda r: model.init(r, ids), jax.random.PRNGKey(0))
    # Zero params: decode cost is weight-content independent.
    variables = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes
    )

    rng = np.random.default_rng(0)
    report: Dict[str, Any] = {"model": args.model, "config": vars(args), "modes": {}}
    for mode, kv_dtype in (("bf16", jnp.bfloat16), ("int8", jnp.int8)):
        if args.kv_dtype not in ("both", mode):
            continue
        pages_per_seq = max(
            4, -(-(args.prompt_len + args.new_tokens) // args.page_size)
        )
        num_pages = args.num_pages or args.batch * pages_per_seq + 8
        prompts = [
            [int(t) for t in rng.integers(0, cfg.vocab_size, args.prompt_len)]
            for _ in range(args.batch)
        ]

        def one_pass():
            """Full generate pass; returns (prefill_s, decode_s, steps)."""
            eng = ServingEngine(
                cfg,
                variables["params"],
                kv_dtype=kv_dtype,
                max_batch=args.batch,
                num_pages=num_pages,
                page_size=args.page_size,
                max_pages_per_seq=pages_per_seq,
                decode_window=args.decode_window,
                prefill_chunk=args.prefill_chunk,
                temperature=args.temperature,
                top_k=args.top_k,
                seed=args.sample_seed,
            )
            for p in prompts:
                eng.submit(p, args.new_tokens)
            t0 = time.perf_counter()
            eng.step()  # admission + all prefills (+ first decode window)
            t_prefill = time.perf_counter() - t0
            t0 = time.perf_counter()
            while eng.step() > 0:
                pass
            t_decode = time.perf_counter() - t0
            st = eng.get_performance_stats()
            return t_prefill, t_decode, st

        # Pass 1 pays XLA compiles (prefill buckets, decode windows);
        # pass 2 reuses the in-process jit cache — report steady state.
        one_pass()
        t_prefill, t_decode, st = one_pass()
        # Engine-internal timers cover every decode window, including the
        # one inside the first step() (which also prefills).
        dec_s = max(st["decode_steps"], 1)
        row = {
            "prefill_s": round(t_prefill, 4),
            "decode_wall_s": round(t_decode, 4),
            "decode_ms_per_step": round(
                st["decode_tokens"]
                / max(st["decode_tokens_per_s"], 1e-9)
                / dec_s
                * 1e3,
                3,
            ),
            **st,
        }
        report["modes"][mode] = row
        print(
            f"{mode}: prefill {t_prefill*1e3:8.1f} ms   decode "
            f"{row['decode_ms_per_step']:7.2f} ms/step   "
            f"{row['decode_tokens_per_s']:>10,.0f} tok/s"
        )
    if (
        args.kv_dtype == "both"
        and "bf16" in report["modes"]
        and "int8" in report["modes"]
    ):
        sp = (
            report["modes"]["bf16"]["decode_ms_per_step"]
            / max(report["modes"]["int8"]["decode_ms_per_step"], 1e-9)
        )
        report["int8_decode_speedup"] = round(sp, 3)
        print(f"int8 KV decode speedup: {sp:.2f}x")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"wrote {args.output}")
    return 0


def device_info(args: argparse.Namespace) -> int:
    """Device report (reference cli.py:306-363)."""
    from .utils.monitoring import device_memory_stats

    cfg = get_config()
    devices = []
    for dev in jax.devices():
        info = {
            "id": dev.id,
            "platform": dev.platform,
            "device_kind": getattr(dev, "device_kind", "unknown"),
            "process_index": dev.process_index,
            **{
                k: v
                for k, v in device_memory_stats(dev).items()
                if k not in ("platform", "device")
            },
        }
        devices.append(info)
    payload = {
        "backend": jax.default_backend(),
        "device_count": jax.device_count(),
        "process_count": jax.process_count(),
        "devices": devices,
        "config": cfg.to_dict(),
    }
    if args.json:
        print(json.dumps(payload, indent=1, default=str))
    else:
        print(f"backend: {payload['backend']}  devices: {payload['device_count']}")
        for d in devices:
            mem = ""
            if d.get("bytes_limit"):
                mem = f"  hbm {d.get('bytes_in_use', 0)/1e9:.2f}/{d['bytes_limit']/1e9:.1f} GB"
            print(f"  [{d['id']}] {d['device_kind']}{mem}")
        print(f"router: flash_threshold={cfg.flash_threshold} quant={cfg.quant_mode}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="pfa", description="attention engine CLI"
    )
    parser.add_argument("--log-level", default=None)
    sub = parser.add_subparsers(dest="command", required=True)

    b = sub.add_parser("benchmark", help="latency/throughput sweep")
    b.add_argument("--seq-lengths", type=int, nargs="+", default=None)
    b.add_argument("--batch-sizes", type=int, nargs="+", default=None)
    b.add_argument("--embed-dim", type=int, default=768)
    b.add_argument("--num-heads", type=int, default=12)
    b.add_argument("--iterations", type=int, default=10)
    b.add_argument("--warmup", type=int, default=3)
    b.add_argument("--causal", action="store_true")
    b.add_argument("--output", "-o", default=None)
    b.set_defaults(fn=benchmark)

    c = sub.add_parser("calibrate", help="quantization error sweep")
    c.add_argument("--patterns", type=int, default=8)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--output", "-o", default=None)
    c.set_defaults(fn=calibrate)

    s = sub.add_parser("serve-bench", help="paged-KV decode benchmark")
    s.add_argument("--model", choices=("tiny", "small", "medium"), default="small")
    s.add_argument("--batch", type=int, default=8)
    s.add_argument("--prompt-len", type=int, default=128)
    s.add_argument("--new-tokens", type=int, default=64)
    # None = auto-size: batch * pages-per-seq + slack.
    s.add_argument("--num-pages", type=int, default=None)
    # A power of two (the paged kernel's tiles cover whole pages).
    s.add_argument("--page-size", type=int, default=64)
    s.add_argument("--kv-dtype", choices=("bf16", "int8", "both"), default="both")
    # Device-resident decode window (steps per host round-trip).
    s.add_argument("--decode-window", type=int, default=16)
    # Chunked prefill: page-aligned chunk size (None = single-shot).
    s.add_argument("--prefill-chunk", type=int, default=None)
    # Sampling: temperature 0 = greedy; top-k 0 = no truncation.
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--sample-seed", type=int, default=0)
    s.add_argument("--output", "-o", default=None)
    s.set_defaults(fn=serve_bench)

    d = sub.add_parser("device-info", help="device / memory report")
    d.add_argument("--json", action="store_true")
    d.set_defaults(fn=device_info)

    args = parser.parse_args(argv)
    setup_logging(level=args.log_level)
    # Persistent XLA compile cache: repeated CLI runs skip recompiles.
    from .optimization.caching import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
