"""Host-side data pipeline: each rank's batch rows, and background prefetch.

The port's counterpart of ``repro/data/pipeline.py``.  Every rank builds
(or reads) the same global host batch and keeps its own rows under the
batch spec ("pod", "data") -- replicated where the batch does not divide
-- on its own device.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.runtime.distributed import local_block

__all__ = ["shard_batch", "Prefetcher", "batch_sharding"]


def batch_sharding(rules, ndim_map: dict) -> dict:
    """Logical axes of each batch entry: its batch dim over ``"batch"``."""
    return {name: ("batch",) + (None,) * (ndim - 1) for name, ndim in ndim_map.items()}


def shard_batch(batch: dict, rules, *, rank: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """This rank's rows of every entry, as tensors on ``device``.  On a live
    mesh ``rank`` and ``device`` default to this process's; a mesh
    description needs ``rank``."""
    rank = getattr(rules.mesh, "rank", None) if rank is None else rank
    if rank is None:
        raise ValueError("shard_batch on a mesh description needs rank=")
    device = getattr(rules.mesh, "device", None) if device is None else device
    out = {}
    for name, arr in batch.items():
        arr = torch.as_tensor(np.asarray(arr)) if not isinstance(arr, torch.Tensor) else arr
        spec = rules.spec(("batch",) + (None,) * (arr.dim() - 1), tuple(arr.shape))
        out[name] = local_block(arr, spec, rules.mesh, rank).contiguous().to(device)
    return out


class Prefetcher:
    """Background-thread prefetch of host batches onto this rank's device
    (through :func:`shard_batch` under ``rules``, else whole)."""

    def __init__(self, it, rules=None, depth: int = 2, *, device: Optional[Union[str, torch.device]] = None,
                 rank: Optional[int] = None):
        self.it, self.rules, self.device, self.rank = it, rules, device, rank
        self.q: queue.Queue = queue.Queue(maxsize=depth)  # thread-safe itself: no lock
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for b in self.it:
                if self._stop.is_set():
                    return
                if self.rules is not None:
                    b = shard_batch(b, self.rules, rank=self.rank, device=self.device)
                else:
                    b = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in b.items()}
                self.q.put(b)
        except Exception as e:  # surfaced to the consumer
            self.q.put(e)
        self.q.put(StopIteration())

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, (StopIteration, Exception)):
            raise item
        return item

    def close(self):
        self._stop.set()
