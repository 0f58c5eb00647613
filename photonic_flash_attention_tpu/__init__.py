"""photonic_flash_attention_tpu — an attention engine for NVIDIA GPUs in JAX.

A JAX/XLA/Pallas framework with the capabilities of the reference
``danieleschmidt/Photonic-Flash-Attention``: an attention engine (fused
short-seq / flash-tiled / paged-decode / ring) with a measured-latency
router, a paged KV cache, drop-in module APIs with HF-model conversion,
and multi-device distribution over a ``jax.sharding.Mesh``.

What the reference *simulates* (analog low-precision compute, crossover
dispatch), this package runs as GPU kernels with a measured cost model;
what the reference *fakes* (distribution), this package implements with
XLA collectives.
"""

from .config import GlobalConfig, get_config, reset_config, set_global_config

__version__ = "0.1.0"

__all__ = [
    "GlobalConfig",
    "get_config",
    "reset_config",
    "set_global_config",
    "__version__",
]


def __getattr__(name):
    # Lazy re-exports keep `import photonic_flash_attention_tpu` light.
    if name in (
        "flash_attention",
        "fused_attention",
    ):
        from . import ops

        return getattr(ops, name)
    if name in ("PhotonicFlashAttention", "PhotonicMultiHeadAttention"):
        from . import models

        return getattr(models, name)
    if name == "convert_to_photonic":
        from .models import convert_to_photonic

        return convert_to_photonic
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
