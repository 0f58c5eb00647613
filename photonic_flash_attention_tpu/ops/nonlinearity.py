"""Softmax, LayerNorm, RMSNorm and activations in plain ``jnp``.

The reference's optical nonlinearity layer (reference
photonic/optical_kernels/nonlinearity.py:24-457) approximated these
because its simulated analog device could not exponentiate. Here they are
the exact functions with float32 statistics. XLA fuses each into one pass
over the rows on the GPU, so no hand-written kernel stands behind them.
The dispatcher keeps the reference's API surface.
"""

from __future__ import annotations

import enum
from typing import Optional

import jax
import jax.numpy as jnp


class NonlinearityType(enum.Enum):
    """Mirror of the reference's NonlinearityType (nonlinearity.py:24-32)."""

    SOFTMAX = "softmax"
    RELU = "relu"
    GELU = "gelu"
    LAYER_NORM = "layer_norm"
    RMS_NORM = "rms_norm"


def fused_softmax(x: jax.Array, axis: int = -1) -> jax.Array:
    """Numerically stable softmax with float32 statistics."""
    return jax.nn.softmax(x.astype(jnp.float32), axis=axis).astype(x.dtype)


def fused_layer_norm(
    x: jax.Array,
    gamma: jax.Array,
    beta: Optional[jax.Array] = None,
    eps: float = 1e-5,
) -> jax.Array:
    """LayerNorm with float32 statistics regardless of activation dtype."""
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mu), axis=-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps) * gamma.astype(jnp.float32)
    if beta is not None:
        y = y + beta.astype(jnp.float32)
    return y.astype(x.dtype)


def fused_rms_norm(x: jax.Array, gamma: jax.Array, eps: float = 1e-6) -> jax.Array:
    """RMSNorm (the Llama-family norm) with float32 statistics."""
    xf = x.astype(jnp.float32)
    ms = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(ms + eps) * gamma.astype(jnp.float32)).astype(
        x.dtype
    )


relu = jax.nn.relu
gelu = jax.nn.gelu


def apply_nonlinearity(
    kind: NonlinearityType | str,
    x: jax.Array,
    *,
    gamma: Optional[jax.Array] = None,
    beta: Optional[jax.Array] = None,
    eps: float = 1e-5,
    axis: int = -1,
) -> jax.Array:
    """Dispatcher mirroring ``OpticalNonlinearityKernel.apply_nonlinearity``
    (reference nonlinearity.py:385-423)."""
    kind = NonlinearityType(kind) if isinstance(kind, str) else kind
    if kind is NonlinearityType.SOFTMAX:
        return fused_softmax(x, axis=axis)
    if kind is NonlinearityType.RELU:
        return relu(x)
    if kind is NonlinearityType.GELU:
        return gelu(x)
    if kind is NonlinearityType.LAYER_NORM:
        if gamma is None:
            gamma = jnp.ones((x.shape[-1],), x.dtype)
        return fused_layer_norm(x, gamma, beta, eps=eps)
    if kind is NonlinearityType.RMS_NORM:
        if gamma is None:
            gamma = jnp.ones((x.shape[-1],), x.dtype)
        return fused_rms_norm(x, gamma, eps=eps)
    raise ValueError(f"unknown nonlinearity: {kind}")
