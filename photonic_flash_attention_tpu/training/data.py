"""Host-side data pipeline: background prefetch + device placement.

Input handling: batches are prepared on the host by a
worker thread (tokenize/pack/shuffle are host work), staged into a small
bounded queue, and transferred to device asynchronously so step N+1's
input is already on-chip when step N finishes. This is the honest
counterpart of the reference's thread-pool "distributed" batch splitting
(reference core/hybrid_router.py:471-541) applied where threads actually
belong: the input pipeline.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np


def synthetic_lm_batches(
    *,
    batch: int,
    seq: int,
    vocab: int,
    accum_steps: int = 1,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless synthetic LM batches (benchmark / smoke-test input)."""
    rng = np.random.default_rng(seed)
    lead = (accum_steps,) if accum_steps > 1 else ()
    while True:
        ids = rng.integers(0, vocab, lead + (batch, seq), dtype=np.int32)
        labels = np.roll(ids, -1, axis=-1)
        yield {"input_ids": ids, "labels": labels}


class DataPipeline:
    """Bounded background prefetcher over any batch iterable.

    Args:
      source: iterable of dict[str, np.ndarray] batches.
      prefetch: queue depth (2 is enough to hide host latency).
      to_device: optional placement fn (e.g. sharded device_put); default
        ``jnp.asarray`` per leaf.
    """

    _DONE = object()

    def __init__(
        self,
        source: Iterable[Dict[str, np.ndarray]],
        *,
        prefetch: int = 2,
        to_device: Optional[Callable] = None,
    ) -> None:
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._to_device = to_device or (
            lambda b: {k: jnp.asarray(v) for k, v in b.items()}
        )
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                # device_put from the worker overlaps H2D with compute.
                self._q.put(self._to_device(batch))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self) -> None:
        self._stop.set()
        # Drain so the worker's blocked put() can finish.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "DataPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
