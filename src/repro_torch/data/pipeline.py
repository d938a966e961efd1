"""Host input pipeline: background prefetch, then the batch onto the
device (counterpart of ``repro/data/pipeline.py``).

HugeCTR overlaps its data reader with compute via CUDA streams; here a
daemon thread fills a bounded queue while the device works, and
:func:`put_batch`, which the trainer uses, moves a host batch onto the
device. On a mesh every rank reads the same global batch (the readers are
seekable, ``batch(step)``) and keeps its data-parallel block
(:func:`batch_shardings`), the reference's ``NamedSharding`` over the DP
axes: split over ``"data"``, replicated over ``"model"``. ``Prefetcher``
is a copy; the trainer does not use it, as the reference's does not.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.launch import mesh as meshlib


class Prefetcher:

    def __init__(self, source: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._source = source
        self._transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()


@dataclasses.dataclass(frozen=True)
class BatchBlock:
    """Block ``index`` of ``count`` equal blocks along a batch's dim 0."""
    index: int
    count: int

    def take(self, a: np.ndarray) -> np.ndarray:
        n = a.shape[0]
        if n % self.count:
            raise ValueError(f"batch of {n} rows does not split into "
                             f"{self.count} data-parallel blocks")
        b = n // self.count
        return a[self.index * b:(self.index + 1) * b]


def batch_shardings(mesh, dp_axes=None) -> Dict[str, BatchBlock]:
    """This rank's block of each batch array over ``mesh``'s DP axes
    (everything but ``"model"``): the same block for every ``model``
    index of a data row."""
    dp = tuple(dp_axes or meshlib.dp_axes(mesh))
    block = BatchBlock(meshlib.axis_index(mesh, dp),
                       meshlib.axis_size(mesh, dp))
    return {"dense": block, "cat": block, "label": block}


def put_batch(batch: Dict[str, np.ndarray], device, mesh=None) -> Dict:
    """A host batch (``dense``, ``cat``, ``label``) as tensors on
    ``device``; with ``mesh``, this rank's data-parallel block of it."""
    dtypes = {"dense": torch.float32, "cat": torch.int32,
              "label": torch.float32}
    if mesh is not None:
        blocks = batch_shardings(mesh)
        batch = {k: blocks[k].take(v) if k in blocks else v
                 for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device=device, dtype=dtypes.get(k))
        for k, v in batch.items()}
