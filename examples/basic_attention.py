"""Basic usage: the adaptive engine and the drop-in Flax module.

Mirrors the reference's examples/ quickstarts on the attention engine.
Run: python examples/basic_attention.py
"""

import jax
import jax.numpy as jnp
import numpy as np

from photonic_flash_attention_tpu.core.engine import get_engine
from photonic_flash_attention_tpu.models.attention import PhotonicFlashAttention


def main() -> None:
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 1024, 12, 64

    # 1) Raw engine call: adaptive measured-latency routing.
    q = jnp.asarray(rng.standard_normal((B, S, H, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, S, H, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, S, H, D)), jnp.bfloat16)
    engine = get_engine()
    out, _ = engine(q, k, v, causal=True)
    print(f"engine: out {out.shape}, kernel={engine.last_kernel_used}, "
          f"latency={engine.last_latency_ms:.2f} ms")

    # 2) Drop-in module with its own projections.
    x = jnp.asarray(rng.standard_normal((B, S, H * D)), jnp.bfloat16)
    layer = PhotonicFlashAttention(embed_dim=H * D, num_heads=H, causal=True)
    params = layer.init(jax.random.PRNGKey(0), x)
    y = jax.jit(lambda p, x: layer.apply(p, x)[0])(params, x)
    print(f"module: out {y.shape}")

    # 3) Aggregate stats (the reference's pervasive stats surface).
    print(engine.get_performance_stats())


if __name__ == "__main__":
    main()
