"""T5 encoder-decoder serving throughput on the GPU.

Measures the round-4 enc-dec serving path (encoder prefill + pinned
cross-KV + paged decoder self-attention with in-kernel relative bias)
at T5-base scale — the model family behind the reference's biggest
headline claim (T5-Large seq 8192: 19.56x, reference README.md:662-663,
which its dense path cannot actually run). Tokens/s here include host
scheduling.

Run: python benchmarks/t5_serving_bench.py
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from photonic_flash_attention_tpu.core.serving import ServingEngine  # noqa: E402
from photonic_flash_attention_tpu.models.t5 import (  # noqa: E402
    T5Config,
    T5ForConditionalGeneration,
)


def main() -> None:
    cfg = T5Config.base()
    model = T5ForConditionalGeneration(cfg)
    rng = np.random.default_rng(5)
    enc = jnp.zeros((1, 8), jnp.int32)
    dec = jnp.zeros((1, 4), jnp.int32)
    print("init params...", flush=True)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), enc, dec)

    b, enc_len, n_new = 8, 256, 64
    eng = ServingEngine(
        cfg,
        variables["params"],
        num_pages=256,
        page_size=128,
        max_batch=b,
        kv_dtype=jnp.int8,
        decode_window=16,
        enc_max_len=enc_len,
    )
    prompts = [list(rng.integers(2, cfg.vocab_size, enc_len)) for _ in range(b)]
    print("warmup (compiles)...", flush=True)
    eng.generate(prompts[:1], max_new_tokens=4)
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=n_new)
    wall = time.perf_counter() - t0
    total = b * (enc_len + n_new)
    print(
        f"t5_base_serving_int8kv_b{b}: wall {wall:.2f}s, "
        f"{total / wall:.1f} tokens/s ({b * n_new / wall:.1f} decode tok/s), "
        f"{b}x({enc_len} enc + {n_new} new), incl. host",
        flush=True,
    )


if __name__ == "__main__":
    main()
