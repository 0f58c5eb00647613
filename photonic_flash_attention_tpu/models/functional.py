"""Shared pieces of the models written as pure functions over a pytree.

The served and trained families (GPT-2, Llama) are plain functions of
their parameter tree. :class:`FunctionalModel` gives them the
``init(rng, sample) -> {"params": tree}`` / ``apply(variables, ...)``
interface that the trainer, the serving engine and the tests call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class FunctionalModel:
    """``init``/``apply`` over ``init_params``/``forward`` of a subclass."""

    config: Any

    def init_params(self, rng: jax.Array, *args) -> Dict[str, Any]:
        raise NotImplementedError

    def forward(self, params, *args, deterministic: bool = True,
                dropout_rng: Optional[jax.Array] = None, **kwargs):
        raise NotImplementedError

    def init(self, rng, *args, **_kwargs) -> Dict[str, Any]:
        if isinstance(rng, dict):
            rng = rng["params"]
        return {"params": self.init_params(rng, *args)}

    def apply(self, variables, *args, deterministic: bool = True,
              rngs: Optional[Dict[str, jax.Array]] = None, **kwargs):
        dropout_rng = None if rngs is None else rngs.get("dropout")
        return self.forward(
            variables["params"], *args, deterministic=deterministic,
            dropout_rng=dropout_rng, **kwargs,
        )


def dense_init(key, layers: int, fan_in: int, fan_out: int, bias: bool = True):
    """Stacked (layers, fan_in, fan_out) LeCun-normal kernel (+ zero bias)."""
    p = {
        "kernel": jax.random.normal(key, (layers, fan_in, fan_out), jnp.float32)
        * fan_in ** -0.5
    }
    if bias:
        p["bias"] = jnp.zeros((layers, fan_out), jnp.float32)
    return p


def layer_norm(x, scale, bias, eps):
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, -1, keepdims=True)
    var = jnp.var(xf, -1, keepdims=True)
    return ((xf - mean) * jax.lax.rsqrt(var + eps) * scale + bias).astype(x.dtype)


def rms_norm(x, scale, eps):
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps) * scale).astype(x.dtype)
