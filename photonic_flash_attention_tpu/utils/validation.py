"""Input validation for attention calls and engine configs.

The rebirth of reference utils/validation.py:21-685 — shape/dtype/range
checks on attention inputs, sequence/batch caps, finiteness gates, and
kernel-config sanity checks (block-size alignment replaces the reference's
optical power-budget/wavelength checks).

Validation runs on *abstract* values wherever possible so it is free under
``jax.jit`` (static shape/dtype checks trace to nothing); data-dependent
checks (NaN/Inf) are offered as explicit opt-in helpers since they force a
device sync.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import get_config
from .exceptions import ValidationError

_ALLOWED_DTYPES = (
    jnp.float32,
    jnp.bfloat16,
    jnp.float16,
)



def validate_attention_inputs(
    query: jax.Array,
    key: jax.Array,
    value: jax.Array,
    mask: Optional[jax.Array] = None,
) -> None:
    """Validate (B, S, H, D)-shaped attention inputs.

    Static-only: safe to call inside jit. Mirrors reference
    ``validate_attention_inputs`` + seq/batch caps (validation.py:193-228).
    """
    for name, t in (("query", query), ("key", key), ("value", value)):
        if t.ndim != 4:
            raise ValidationError(
                f"{name} must be rank-4 (batch, seq, heads, head_dim), got shape {t.shape}"
            )
        if t.dtype not in _ALLOWED_DTYPES:
            raise ValidationError(f"{name} has unsupported dtype {t.dtype}")

    bq, sq, hq, dq = query.shape
    bk, sk, hk, dk = key.shape
    bv, sv, hv, dv = value.shape

    if (bk, sk) != (bv, sv):
        raise ValidationError(f"key/value seq mismatch: {key.shape} vs {value.shape}")
    if bq != bk:
        raise ValidationError(f"batch mismatch: query {bq} vs key {bk}")
    if dq != dk:
        raise ValidationError(f"head_dim mismatch: query {dq} vs key {dk}")
    if hk != hv:
        raise ValidationError(f"kv head mismatch: key {hk} vs value {hv}")
    if hq % hk != 0:
        raise ValidationError(
            f"num query heads ({hq}) must be a multiple of kv heads ({hk}) for GQA"
        )

    cfg = get_config()
    if sq > cfg.max_sequence_length or sk > cfg.max_sequence_length:
        raise ValidationError(
            f"sequence length {max(sq, sk)} exceeds cap {cfg.max_sequence_length}"
        )
    if bq > cfg.max_batch_size:
        raise ValidationError(f"batch size {bq} exceeds cap {cfg.max_batch_size}")

    if mask is not None:
        if mask.ndim not in (2, 3, 4):
            raise ValidationError(f"mask must be rank 2-4, got shape {mask.shape}")


def validate_block_config(block_q: int, block_kv: int, head_dim: int) -> None:
    """Kernel tiling sanity (replaces optical power/wavelength checks):
    Triton tiles are powers of two of at least 16."""
    for name, v in (("block_q", block_q), ("block_kv", block_kv)):
        if v < 16 or v & (v - 1):
            raise ValidationError(f"{name}={v} must be a power of two >= 16")
    if head_dim <= 0:
        raise ValidationError(f"head_dim={head_dim} must be positive")


def validate_quant_mode(mode: str) -> str:
    if mode not in ("bf16", "int8"):
        raise ValidationError(f"quant_mode must be bf16|int8, got {mode!r}")
    return mode


def check_finite(x: jax.Array, name: str = "tensor") -> jax.Array:
    """Data-dependent finiteness gate (reference validation.py:302-346).

    Returns ``x`` unchanged; uses ``jax.debug`` under jit or raises eagerly.
    """
    if isinstance(x, jax.core.Tracer):
        # Inside jit: attach a checkify-style debug assertion without sync.
        bad = jnp.logical_not(jnp.all(jnp.isfinite(x.astype(jnp.float32))))
        jax.debug.callback(_warn_if_bad, bad, name)
        return x
    if not bool(jnp.all(jnp.isfinite(x.astype(jnp.float32)))):
        raise ValidationError(f"{name} contains NaN/Inf")
    return x


def _warn_if_bad(bad: Any, name: str) -> None:
    if bool(bad):
        from .logging import get_logger

        get_logger("validation").warning("%s contains NaN/Inf", name)


def pad_to_multiple(x: jax.Array, multiple: int, axis: int) -> Tuple[jax.Array, int]:
    """Pad ``axis`` of ``x`` to a multiple; returns (padded, original_size)."""
    size = x.shape[axis]
    rem = size % multiple
    if rem == 0:
        return x, size
    pad = multiple - rem
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths), size


def normalize_mask(
    mask: Optional[jax.Array],
    batch: int,
    num_heads: int,
    q_len: int,
    kv_len: int,
) -> Optional[jax.Array]:
    """Broadcast a rank-2/3/4 boolean mask to (B, H, Sq, Skv)."""
    if mask is None:
        return None
    m = mask
    if m.ndim == 2:  # (Sq, Skv)
        m = m[None, None]
    elif m.ndim == 3:  # (B, Sq, Skv)
        m = m[:, None]
    return jnp.broadcast_to(m, (batch, num_heads, q_len, kv_len))
