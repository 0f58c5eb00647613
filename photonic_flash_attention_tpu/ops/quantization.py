"""Block quantization for attention activations and the KV cache.

The rebirth of the reference's simulated analog quantization — the
6-bit modulator encode/decode in ``encode_to_optical``/``decode_from_optical``
(reference photonic/optical_kernels/matrix_mult.py:161-276) — as *real*
low-precision formats the tensor cores execute natively:

* FP8 (e4m3) per-block scaled tensors for QKV score matmuls,
* INT8 per-block scaled tensors for the KV cache payload,
* symmetric per-block absmax scaling (the analogue of the reference's
  per-call normalization `encode_to_optical` :170-172).

A ``QuantizedTensor`` carries (payload, scales); dequantization fuses into
the consuming matmul. The calibration error metric (`accuracy = 1 - mean
relative error`, reference cli.py:239-303) is reproduced by
``quantization_error`` for the `calibrate` CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

FP8_MAX = 448.0  # float8_e4m3fn max normal
INT8_MAX = 127.0


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QuantizedTensor:
    """Payload + per-block scales.

    ``values``: low-precision payload, same shape as the source.
    ``scales``: fp32, shape = source shape with the quantized axis reduced
    by ``block_size`` (ceil).
    ``axis``/``block_size``: which axis is block-quantized and how.
    """

    values: jax.Array
    scales: jax.Array
    axis: int
    block_size: int

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    def tree_flatten(self):
        return (self.values, self.scales), (self.axis, self.block_size)

    @classmethod
    def tree_unflatten(cls, aux, children):
        values, scales = children
        axis, block_size = aux
        return cls(values, scales, axis, block_size)

    def dequantize(self, dtype=jnp.float32) -> jax.Array:
        return dequantize(self, dtype)


def _block_absmax(x: jax.Array, axis: int, block_size: int) -> jax.Array:
    """Per-block absmax along ``axis``; returns shape with axis -> n_blocks."""
    size = x.shape[axis]
    n_blocks = -(-size // block_size)
    pad = n_blocks * block_size - size
    if pad:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        x = jnp.pad(x, widths)
    new_shape = (
        x.shape[:axis] + (n_blocks, block_size) + x.shape[axis + 1 :]
    )
    xb = x.reshape(new_shape)
    return jnp.max(jnp.abs(xb.astype(jnp.float32)), axis=axis + 1)


def _expand_scales(scales: jax.Array, axis: int, block_size: int, size: int) -> jax.Array:
    """Broadcast per-block scales back to the full axis length."""
    expanded = jnp.repeat(scales, block_size, axis=axis)
    idx = [slice(None)] * expanded.ndim
    idx[axis] = slice(0, size)
    return expanded[tuple(idx)]


def quantize(
    x: jax.Array,
    dtype: jnp.dtype,
    *,
    axis: int = -1,
    block_size: int = 128,
) -> QuantizedTensor:
    """Symmetric per-block quantization to fp8-e4m3 or int8."""
    axis = axis % x.ndim
    qmax = FP8_MAX if dtype == jnp.float8_e4m3fn else INT8_MAX
    absmax = _block_absmax(x, axis, block_size)
    scales = jnp.where(absmax == 0.0, 1.0, absmax / qmax)
    scale_full = _expand_scales(scales, axis, block_size, x.shape[axis])
    scaled = x.astype(jnp.float32) / scale_full
    if dtype == jnp.int8:
        values = jnp.clip(jnp.round(scaled), -INT8_MAX, INT8_MAX).astype(jnp.int8)
    else:
        values = jnp.clip(scaled, -qmax, qmax).astype(dtype)
    return QuantizedTensor(values, scales, axis, block_size)


def dequantize(qt: QuantizedTensor, dtype=jnp.float32) -> jax.Array:
    scale_full = _expand_scales(qt.scales, qt.axis, qt.block_size, qt.values.shape[qt.axis])
    return (qt.values.astype(jnp.float32) * scale_full).astype(dtype)


def quantize_kv(
    k: jax.Array,
    v: jax.Array,
    dtype: jnp.dtype = jnp.int8,
    *,
    seq_axis: int = 1,
    block_size: int = 128,
) -> Tuple[QuantizedTensor, QuantizedTensor]:
    """Quantize a KV pair along the sequence axis (per-token-block scales)."""
    return (
        quantize(k, dtype, axis=seq_axis, block_size=block_size),
        quantize(v, dtype, axis=seq_axis, block_size=block_size),
    )


def quantization_error(x: jax.Array, qt: QuantizedTensor) -> dict:
    """Calibration metrics (reference cli.py:239-303's accuracy measure)."""
    xr = qt.dequantize(jnp.float32)
    xf = x.astype(jnp.float32)
    abs_err = jnp.abs(xr - xf)
    denom = jnp.maximum(jnp.abs(xf), 1e-6)
    rel = abs_err / denom
    return {
        "max_abs_err": float(jnp.max(abs_err)),
        "mean_abs_err": float(jnp.mean(abs_err)),
        "max_rel_err": float(jnp.max(rel)),
        "mean_rel_err": float(jnp.mean(rel)),
        "accuracy": float(1.0 - jnp.mean(rel)),
    }
