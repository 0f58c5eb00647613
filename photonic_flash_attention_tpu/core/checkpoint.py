"""Checkpoint / resume — params, KV cache, and engine state.

The reference's only persistence is the autonomous optimizer's pickled
learned state (reference core/autonomous_optimizer.py:94-99, 537-576) and
CLI calibration JSONs (cli.py:195-230); it has **no model checkpointing**
(SURVEY.md §5.4). A production serving stack needs real checkpoint/
resume, so this module provides the full surface:

* **model params** — orbax-backed, sharding-aware (arrays restore onto
  the live mesh layout when a target structure is given), step-numbered
  with retention;
* **paged KV cache** — device page arrays + host page tables, so a
  preempted serving process resumes mid-generation without recompute;
* **engine state** — router measurements + autotuner profiles as JSON
  (the honest analogue of ``autonomous_optimizer_state.pkl``).

All writes are atomic (tmp + rename for JSON; orbax's own atomicity for
trees).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp

from ..utils.exceptions import CheckpointError
from ..utils.logging import get_logger

logger = get_logger("checkpoint")

_STEP_RE = re.compile(r"^step_(\d+)$")


def _atomic_write_json(path: str, payload: Dict) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


class CheckpointManager:
    """Step-numbered checkpoints under one directory.

    Layout::

        <root>/step_<N>/params/        orbax pytree
        <root>/step_<N>/engine.json    router + autotuner state
        <root>/step_<N>/meta.json      step, timestamp, user metadata
    """

    def __init__(self, root: str, max_to_keep: int = 3) -> None:
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    # -- step bookkeeping ---------------------------------------------------

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            # only completed checkpoints (meta.json is written last)
            if m and os.path.exists(os.path.join(self.root, name, "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def _enforce_retention(self) -> None:
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(self._step_dir(victim), ignore_errors=True)
            logger.info("retention: removed checkpoint step_%d", victim)

    # -- params -------------------------------------------------------------

    def save(
        self,
        step: int,
        params: Any,
        engine_state: Optional[Dict] = None,
        metadata: Optional[Dict] = None,
    ) -> str:
        """Save a checkpoint; returns its directory."""
        import orbax.checkpoint as ocp

        d = self._step_dir(step)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d)
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.abspath(os.path.join(d, "params")), params)
        ckptr.wait_until_finished()
        if engine_state is not None:
            _atomic_write_json(os.path.join(d, "engine.json"), engine_state)
        # meta.json last: its presence marks the checkpoint complete.
        _atomic_write_json(
            os.path.join(d, "meta.json"),
            {"step": step, "saved_at": time.time(), **(metadata or {})},
        )
        self._enforce_retention()
        logger.info("saved checkpoint step_%d -> %s", step, d)
        return d

    def restore(
        self, step: Optional[int] = None, target: Optional[Any] = None
    ) -> Dict[str, Any]:
        """Restore ``{"params", "engine_state", "meta"}``.

        ``target``: optional abstract pytree (e.g. ``jax.eval_shape`` output
        with ``sharding`` set) — arrays restore directly onto that layout,
        the idiomatic multi-host resume path.
        """
        import orbax.checkpoint as ocp

        if step is None:
            step = self.latest_step()
        if step is None:
            raise CheckpointError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, "meta.json")):
            raise CheckpointError(f"checkpoint step_{step} is incomplete")
        ckptr = ocp.StandardCheckpointer()
        params = ckptr.restore(
            os.path.abspath(os.path.join(d, "params")), target
        )
        engine_state = None
        epath = os.path.join(d, "engine.json")
        if os.path.exists(epath):
            with open(epath) as f:
                engine_state = json.load(f)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return {"params": params, "engine_state": engine_state, "meta": meta}


# ---------------------------------------------------------------------------
# Engine (router + autotuner) state
# ---------------------------------------------------------------------------


def engine_state_dict(engine: Any) -> Dict:
    """Serializable router latency tables + autotuner profiles."""
    router = engine.router
    with router._lock:
        latency = {
            kernel.value: [
                {"bucket": list(bucket), "value": ema.value, "count": ema.count}
                for bucket, ema in table.items()
            ]
            for kernel, table in router._latency.items()
        }
    tuner = engine.autotuner
    with tuner._lock:
        profiles = {k: dataclasses.asdict(v) for k, v in tuner._profiles.items()}
    return {
        "version": 1,
        "router_latency": latency,
        "autotuner_profiles": profiles,
    }


def restore_engine_state(engine: Any, state: Dict) -> None:
    """Load state saved by :func:`engine_state_dict` into a live engine."""
    from .autotuner import TuneResult
    from .router import KernelKind, _EMA

    router = engine.router
    with router._lock:
        for kernel_name, entries in state.get("router_latency", {}).items():
            try:
                kernel = KernelKind(kernel_name)
            except ValueError:
                continue
            for e in entries:
                ema = _EMA()
                ema.value = float(e["value"])
                ema.count = int(e["count"])
                router._latency[kernel][tuple(e["bucket"])] = ema
    tuner = engine.autotuner
    with tuner._lock:
        for k, v in state.get("autotuner_profiles", {}).items():
            tuner._profiles[k] = TuneResult(**v)


# ---------------------------------------------------------------------------
# KV-cache save / restore (preemption-resilient serving)
# ---------------------------------------------------------------------------


def save_kv_cache(cache: Any, path: str) -> None:
    """Persist a :class:`~..core.kv_cache.PagedKVCache`: device page arrays
    (numpy .npz) + host page tables (JSON)."""
    import numpy as np

    os.makedirs(path, exist_ok=True)

    def to_np(x):
        a = np.asarray(x)
        # npz cannot represent ml_dtypes (bfloat16 etc.); store the raw
        # bit pattern and re-view on restore.
        if a.dtype == jnp.bfloat16:
            a = a.view(np.uint16)
        return a

    arrays = {
        "k_pages": to_np(cache.k_pages),
        "v_pages": to_np(cache.v_pages),
    }
    if cache.quantized:
        arrays["k_scales"] = np.asarray(cache.k_scales)
        arrays["v_scales"] = np.asarray(cache.v_scales)
    tmp = os.path.join(path, "pages.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, "pages.npz"))
    with cache._lock:
        host = {
            "version": 1,
            "num_pages": cache.num_pages,
            "page_size": cache.page_size,
            "num_kv_heads": cache.num_kv_heads,
            "head_dim": cache.head_dim,
            "dtype": str(jnp.dtype(cache.dtype)),
            "max_pages_per_seq": cache.max_pages_per_seq,
            "free": list(cache._free),
            "next_seq_id": cache._next_seq_id,
            "sequences": {
                str(sid): {"page_ids": info.page_ids, "length": info.length}
                for sid, info in cache._sequences.items()
            },
        }
    _atomic_write_json(os.path.join(path, "tables.json"), host)
    logger.info(
        "saved KV cache (%d seqs, %d pages) -> %s",
        len(host["sequences"]),
        cache.num_pages,
        path,
    )


def restore_kv_cache(path: str) -> Any:
    """Rebuild a PagedKVCache exactly as saved."""
    import numpy as np

    from .kv_cache import PagedKVCache, SequenceInfo

    with open(os.path.join(path, "tables.json")) as f:
        host = json.load(f)
    data = np.load(os.path.join(path, "pages.npz"))
    cache = PagedKVCache(
        num_pages=host["num_pages"],
        page_size=host["page_size"],
        num_kv_heads=host["num_kv_heads"],
        head_dim=host["head_dim"],
        dtype=jnp.dtype(host["dtype"]),
        max_pages_per_seq=host["max_pages_per_seq"],
    )
    def from_np(a):
        if jnp.dtype(cache.dtype) == jnp.bfloat16:
            a = a.view(jnp.bfloat16)
        return jnp.asarray(a, cache.dtype)

    cache.k_pages = from_np(data["k_pages"])
    cache.v_pages = from_np(data["v_pages"])
    if cache.quantized:
        cache.k_scales = jnp.asarray(data["k_scales"], jnp.float32)
        cache.v_scales = jnp.asarray(data["v_scales"], jnp.float32)
    with cache._lock:
        cache._free = list(host["free"])
        cache._next_seq_id = host["next_seq_id"]
        cache._sequences = {
            int(sid): SequenceInfo(int(sid), rec["page_ids"], rec["length"])
            for sid, rec in host["sequences"].items()
        }
    return cache
