"""Device-resident paged KV cache with host-side page tables.

The rebirth of the reference's ``UnifiedMemoryManager`` (reference
core/memory_manager.py:17-495): its per-(device, shape) free-list tensor
pool becomes a page pool over two big device arrays (K pages, V pages), its
``allocate``/``deallocate``/``get_memory_stats``/``temporary_allocation``
surface is preserved as ``allocate_sequence``/``free_sequence``/
``get_memory_stats``/``temporary_sequence``, and its OOM ladder
(limit check → GC → emergency cleanup, memory_manager.py:81-161) becomes
free-page accounting with an explicit eviction hook.

Page layout: **token-major** ``(num_kv_heads, num_pages, page_size,
head_dim)`` — one token's head vector is contiguous, the row the paged
decode kernel gathers (see ops/paged.py). Optional INT8 payload with
per-token fp32 scales ``(num_kv_heads, num_pages, page_size)``.

Device arrays are functionally updated; the cache object re-binds them
(donate-friendly under jit in the serving loop).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.exceptions import KVCacheError
from ..utils.logging import get_logger

logger = get_logger("kv_cache")

INT8_MAX = 127.0


@dataclasses.dataclass
class SequenceInfo:
    seq_id: int
    page_ids: List[int]
    length: int  # tokens currently stored


class PagedKVCache:
    """Paged KV storage for one attention layer (or shared trunk).

    Args:
      num_pages: total physical pages in the pool.
      page_size: tokens per page.
      num_kv_heads / head_dim: KV geometry.
      dtype: payload dtype — ``jnp.bfloat16`` or ``jnp.int8`` (per-token
        scales maintained automatically).
      max_pages_per_seq: page-table width (static shape for the kernel).
    """

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype=jnp.bfloat16,
        max_pages_per_seq: int = 128,
    ) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.quantized = dtype == jnp.int8
        self.max_pages_per_seq = max_pages_per_seq

        shape = (num_kv_heads, num_pages, page_size, head_dim)
        self.k_pages = jnp.zeros(shape, dtype)
        self.v_pages = jnp.zeros(shape, dtype)
        if self.quantized:
            sshape = (num_kv_heads, num_pages, page_size)
            self.k_scales = jnp.ones(sshape, jnp.float32)
            self.v_scales = jnp.ones(sshape, jnp.float32)
        else:
            self.k_scales = None
            self.v_scales = None

        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._sequences: Dict[int, SequenceInfo] = {}
        self._lock = threading.RLock()
        self._next_seq_id = 0
        # stats (reference get_memory_stats :377-423)
        self._alloc_count = 0
        self._free_count = 0
        self._oom_events = 0
        self._peak_pages_used = 0

    # -- allocation -------------------------------------------------------

    def allocate_sequence(self, num_tokens: int = 0, seq_id: Optional[int] = None) -> int:
        """Create a sequence, reserving pages for ``num_tokens``."""
        with self._lock:
            if seq_id is None:
                seq_id = self._next_seq_id
                self._next_seq_id += 1
            if seq_id in self._sequences:
                raise KVCacheError(f"sequence {seq_id} already allocated")
            info = SequenceInfo(seq_id, [], 0)
            self._sequences[seq_id] = info
            if num_tokens:
                self._reserve(info, num_tokens)
            return seq_id

    def _reserve(self, info: SequenceInfo, total_tokens: int) -> None:
        pages_needed = -(-total_tokens // self.page_size) - len(info.page_ids)
        if pages_needed <= 0:
            return
        if len(info.page_ids) + pages_needed > self.max_pages_per_seq:
            raise KVCacheError(
                f"sequence needs {len(info.page_ids) + pages_needed} pages "
                f"> max_pages_per_seq {self.max_pages_per_seq}"
            )
        if pages_needed > len(self._free):
            self._oom_events += 1
            raise KVCacheError(
                "KV cache out of pages",
                requested_bytes=pages_needed * self.page_bytes,
                available_bytes=len(self._free) * self.page_bytes,
            )
        for _ in range(pages_needed):
            info.page_ids.append(self._free.pop())
        self._alloc_count += pages_needed
        used = self.num_pages - len(self._free)
        self._peak_pages_used = max(self._peak_pages_used, used)

    def free_sequence(self, seq_id: int) -> None:
        """Release a sequence's pages (zeroing deferred — pages are
        logically invalid; the reference zeroes on free for security,
        memory_manager.py:163-213, which here would cost an HBM pass).
        """
        with self._lock:
            info = self._sequences.pop(seq_id, None)
            if info is None:
                raise KVCacheError(f"unknown sequence {seq_id}")
            self._free.extend(info.page_ids)
            self._free_count += len(info.page_ids)

    def temporary_sequence(self, num_tokens: int = 0):
        """Context manager (reference temporary_allocation :368-375)."""
        cache = self

        class _Tmp:
            def __enter__(self) -> int:
                self.seq_id = cache.allocate_sequence(num_tokens)
                return self.seq_id

            def __exit__(self, *exc) -> None:
                cache.free_sequence(self.seq_id)

        return _Tmp()

    # -- writes -----------------------------------------------------------

    def append(
        self, seq_id: int, k: jax.Array, v: jax.Array
    ) -> None:
        """Append ``(S_new, num_kv_heads, head_dim)`` K/V tokens."""
        with self._lock:
            info = self._sequences.get(seq_id)
            if info is None:
                raise KVCacheError(f"unknown sequence {seq_id}")
            s_new = k.shape[0]
            self._reserve(info, info.length + s_new)
            start = info.length
            info.length += s_new

        kq, ks = self._maybe_quantize(k)
        vq, vs = self._maybe_quantize(v)
        # Scatter token runs into their pages (token-major: tokens on the
        # second-to-last axis, head_dim last).
        pos = 0
        while pos < s_new:
            tok = start + pos
            page_idx = info.page_ids[tok // self.page_size]
            off = tok % self.page_size
            run = min(self.page_size - off, s_new - pos)
            ksl = kq[pos : pos + run].transpose(1, 0, 2)  # (H, run, D)
            vsl = vq[pos : pos + run].transpose(1, 0, 2)
            self.k_pages = self.k_pages.at[:, page_idx, off : off + run].set(ksl)
            self.v_pages = self.v_pages.at[:, page_idx, off : off + run].set(vsl)
            if self.quantized:
                self.k_scales = self.k_scales.at[:, page_idx, off : off + run].set(
                    ks[pos : pos + run].T
                )
                self.v_scales = self.v_scales.at[:, page_idx, off : off + run].set(
                    vs[pos : pos + run].T
                )
            pos += run

    def _maybe_quantize(self, x: jax.Array):
        """Per-token symmetric INT8 quantization (S, H, D) -> payload+scales."""
        if not self.quantized:
            return x.astype(self.dtype), None
        absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)  # (S, H)
        scale = jnp.where(absmax == 0.0, 1.0, absmax / INT8_MAX)
        payload = jnp.clip(
            jnp.round(x.astype(jnp.float32) / scale[..., None]), -INT8_MAX, INT8_MAX
        ).astype(jnp.int8)
        return payload, scale

    # -- reads ------------------------------------------------------------

    def sequence_length(self, seq_id: int) -> int:
        info = self._sequences.get(seq_id)
        if info is None:
            raise KVCacheError(f"unknown sequence {seq_id}")
        return info.length

    def page_table(
        self, seq_ids: List[int]
    ) -> Tuple[jax.Array, jax.Array]:
        """(lengths (B,), page_indices (B, max_pages_per_seq)) for a batch."""
        lengths = []
        tables = []
        with self._lock:
            for sid in seq_ids:
                info = self._sequences.get(sid)
                if info is None:
                    raise KVCacheError(f"unknown sequence {sid}")
                lengths.append(info.length)
                row = info.page_ids + [0] * (self.max_pages_per_seq - len(info.page_ids))
                tables.append(row)
        return (
            jnp.asarray(lengths, jnp.int32),
            jnp.asarray(tables, jnp.int32),
        )

    def gather_kv(self, seq_id: int):
        """Densify one sequence's K/V to (S, H, D) fp32 (debug/oracle path)."""
        info = self._sequences[seq_id]
        ks, vs = [], []
        for i, page_idx in enumerate(info.page_ids):
            n = min(self.page_size, info.length - i * self.page_size)
            if n <= 0:
                break
            kp = self.k_pages[:, page_idx, :n].astype(jnp.float32)  # (H, n, D)
            vp = self.v_pages[:, page_idx, :n].astype(jnp.float32)
            if self.quantized:
                kp = kp * self.k_scales[:, page_idx, :n, None]
                vp = vp * self.v_scales[:, page_idx, :n, None]
            ks.append(kp.transpose(1, 0, 2))
            vs.append(vp.transpose(1, 0, 2))
        return jnp.concatenate(ks, 0), jnp.concatenate(vs, 0)

    # -- stats ------------------------------------------------------------

    @property
    def page_bytes(self) -> int:
        itemsize = jnp.dtype(self.dtype).itemsize
        b = 2 * self.num_kv_heads * self.page_size * self.head_dim * itemsize
        if self.quantized:
            b += 2 * self.num_kv_heads * self.page_size * 4
        return b

    def get_memory_stats(self) -> Dict:
        """Pool stats (reference memory_manager.py:377-423)."""
        with self._lock:
            used = self.num_pages - len(self._free)
            return {
                "num_pages": self.num_pages,
                "pages_used": used,
                "pages_free": len(self._free),
                "utilization": used / self.num_pages,
                "peak_pages_used": self._peak_pages_used,
                "sequences": len(self._sequences),
                "alloc_count": self._alloc_count,
                "free_count": self._free_count,
                "oom_events": self._oom_events,
                "page_bytes": self.page_bytes,
                "pool_bytes": self.num_pages * self.page_bytes,
                "dtype": str(jnp.dtype(self.dtype)),
            }


_cache_singleton: Optional[PagedKVCache] = None
_cache_lock = threading.Lock()


def get_kv_cache(**kwargs) -> PagedKVCache:
    """Module-level singleton (reference get_memory_manager :476-495)."""
    global _cache_singleton
    if _cache_singleton is None:
        with _cache_lock:
            if _cache_singleton is None:
                kwargs.setdefault("num_pages", 1024)
                kwargs.setdefault("page_size", 128)
                kwargs.setdefault("num_kv_heads", 12)
                kwargs.setdefault("head_dim", 64)
                _cache_singleton = PagedKVCache(**kwargs)
    return _cache_singleton


def reset_kv_cache() -> None:
    global _cache_singleton
    with _cache_lock:
        _cache_singleton = None
