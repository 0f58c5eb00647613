"""Shared helpers for the Pallas kernels (Triton route)."""

from __future__ import annotations

from typing import Optional

from .. import platform


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def resolve_interpret(interpret: Optional[bool]) -> bool:
    """Kernels run compiled on the GPU and in the interpreter on the CPU.

    ``None`` asks the platform module. An explicit ``True`` is accepted
    only where the interpreter is the platform's mode: the interpreter
    must never stand in for the compiled kernel on the GPU.
    """
    interp = platform.interpret_kernels()
    if interpret is None:
        return interp
    if interpret and not interp:
        raise ValueError(
            "interpret=True is refused on the GPU: kernels run compiled there"
        )
    return bool(interpret)


def dropout_keep(seed, rows, cols, kv_stride: int, rate: float, bh=None):
    """Deterministic positional dropout mask, independent of layout and tiles.

    A murmur3-style 32-bit finalizer over the global (batch*heads + head,
    q_row, kv_col) position and a seed. Because the mask depends only on
    position, the forward kernel, the backward kernels (other tile
    sizes) and the XLA paths all regenerate identical masks, and no
    (Sq, Skv) mask tensor ever exists in device memory.

    ``bh`` (the flattened batch-head index) makes masks independent per
    (batch, head), like a dropout layer's draw; omitting it would drop
    the same positions for every batch element and head.

    Args:
      seed: traced int32/uint32 scalar.
      rows/cols: int32 arrays (broadcastable) of global q/kv indices.
      kv_stride: static int, the true KV length (position linearizer).
      rate: static drop probability in [0, 1).
      bh: int32 scalar or array (broadcastable against rows/cols) with
        the flattened batch*num_heads + head index; None = 0.

    Returns a bool array: True = keep.
    """
    import jax.numpy as jnp

    x = (
        rows.astype(jnp.uint32) * jnp.uint32(kv_stride & 0xFFFFFFFF)
        + cols.astype(jnp.uint32)
    ) ^ seed.astype(jnp.uint32)
    if bh is not None:
        # Golden-ratio odd-constant spread keeps adjacent (b, h) streams
        # decorrelated before the finalizer mixes.
        x = x ^ (
            jnp.asarray(bh).astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
        )
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    thresh = jnp.uint32(min(int(rate * 4294967296.0), 4294967295))
    return x >= thresh
