#!/usr/bin/env python
"""GPT-2 train-step throughput on one GPU.

Measures tokens/s/chip for the full compiled train step (fwd + Pallas
flash bwd + optax update) with the scan-chained linear-fit methodology
(state threads through iterations, so nothing is DCE'd and dispatch
cancels).
"""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax


def main():
    from photonic_flash_attention_tpu.models.gpt2 import GPT2Config, GPT2LMHead
    from photonic_flash_attention_tpu.optimization.caching import (
        CompileCacheManager,
    )
    from photonic_flash_attention_tpu.training.trainer import (
        TrainState,
        make_train_step,
    )

    try:
        CompileCacheManager().enable()
    except Exception:
        pass
    print("backend:", jax.default_backend(), flush=True)

    name = sys.argv[1] if len(sys.argv) > 1 else "small"
    B, S = (8, 1024) if name == "small" else (8, 512)
    cfg = getattr(GPT2Config, name)()
    model = GPT2LMHead(cfg)
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)), jnp.int32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), ids[:1, :8])
    tx = optax.adamw(1e-4)
    params = variables["params"]
    opt_state = jax.jit(tx.init)(params)
    state = TrainState(step=jnp.int32(0), params=params, opt_state=opt_state)
    step_fn = jax.jit(make_train_step(model.apply, tx))
    labels = jnp.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
    batch = {"input_ids": ids, "labels": labels}

    @functools.partial(jax.jit, static_argnums=2)
    def many(state, batch, n):
        def body(s, _):
            s2, m = step_fn(s, batch)
            return s2, m["loss"]

        state, losses = jax.lax.scan(body, state, None, length=n)
        return losses

    def run(n):
        ls = many(state, batch, n)
        float(jnp.sum(ls))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(jnp.sum(many(state, batch, n)))
            best = min(best, time.perf_counter() - t0)
        return best

    t = (run(20) - run(5)) / 15
    toks = B * S / t
    print(
        f"gpt2-{name} train step B{B} S{S}: {t*1e3:.1f} ms/step, "
        f"{toks:,.0f} tokens/s/chip",
        flush=True,
    )


if __name__ == "__main__":
    main()
