"""Host-side data pipeline: a batch iterator with background prefetch that
puts each rank's slice of a batch on its device — port of
``repro.data.pipeline``.

``shard_batches`` is the torch counterpart of JAX's ``NamedSharding`` on the
batch's leading axis: under ``torch.distributed`` every rank runs the
program and keeps its own contiguous slice (rank ``r`` of ``world`` holds
rows ``[r·B/world, (r+1)·B/world)``, the rows JAX gives device ``r``).
A background thread keeps ``prefetch`` batches ready, so host data work
and the host-to-device copies (from pinned memory, ``non_blocking``)
overlap device compute. ``launch.mesh``'s meshes carry a rank and a
world size to pass in.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class PrefetchIterator:
    """Wrap a host iterator with a daemon prefetch thread: items come out
    in order, and an error the iterator raises is raised by ``next()``
    after the items before it."""

    def __init__(self, it: Iterator, prefetch: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def _put(v, device: torch.device, rank: int, world: int) -> torch.Tensor:
    v = np.asarray(v)
    if v.ndim >= 1:
        if v.shape[0] % world:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split "
                             f"over {world} ranks")
        per = v.shape[0] // world
        v = v[rank * per:(rank + 1) * per]
    t = torch.from_numpy(np.array(v))       # a copy, as device_put makes
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def shard_batches(it: Iterator[dict], device, rank: int = 0, world: int = 1,
                  prefetch: int = 2) -> Iterator[dict]:
    """Put each host batch (a dict of arrays) on ``device``, this rank's
    contiguous slice of every array's leading axis (0-d arrays whole);
    prefetches in the background."""
    device = torch.device(device)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a world of {world}")

    def put(batch):
        return {k: _put(v, device, rank, world) for k, v in batch.items()}

    return PrefetchIterator((put(b) for b in it), prefetch=prefetch)
