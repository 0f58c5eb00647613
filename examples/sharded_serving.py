"""Model-axis sharded serving with chunked prefill and sampling.

Shards the KV page pools (on the KV-head axis) and the layer weights
(Megatron-style) over a ('data', 'model') mesh; a long prompt prefills
in page-aligned chunks so decode never stalls, and tokens sample on
device with temperature/top-k.

Run on any host (uses virtual CPU devices when fewer than 8 chips):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/sharded_serving.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from photonic_flash_attention_tpu.core.serving import ServingEngine
from photonic_flash_attention_tpu.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu.parallel.mesh import create_mesh


def main() -> None:
    cfg = GPT2Config.tiny()
    model = GPT2LMHead(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))

    n = jax.device_count()
    model_size = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    mesh = create_mesh((n // model_size, model_size), ("data", "model"))
    print(f"mesh: {mesh}")

    page_size = 16
    eng = ServingEngine(
        cfg,
        variables["params"],
        num_pages=64,
        page_size=page_size,
        max_batch=4,
        mesh=mesh,                      # sharded pools + weights
        prefill_chunk=page_size * 2,    # chunked prefill
        temperature=0.8,                # on-device sampling
        top_k=40,
        seed=0,
    )

    rng = np.random.default_rng(0)
    prompts = [
        list(map(int, rng.integers(1, cfg.vocab_size, n_)))
        for n_ in (12, 5 * page_size)  # one short, one long (chunked)
    ]
    outs = eng.generate(prompts, max_new_tokens=12)
    for p, o in zip(prompts, outs):
        print(f"prompt[{len(p)} toks] -> {o}")
    print(eng.get_performance_stats())


if __name__ == "__main__":
    main()
