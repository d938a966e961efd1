"""Host input pipeline: background prefetch, then the batch onto the
device (counterpart of ``repro/data/pipeline.py``).

HugeCTR overlaps its data reader with compute via CUDA streams; here a
daemon thread fills a bounded queue while the device works, and
:func:`put_batch`, which the trainer uses, moves a host batch onto one
device. The reference's ``put_batch`` takes a mesh and places each array
by its ``batch_shardings``; a mesh is ROADMAP queue 1 item 4, so
:func:`batch_shardings` raises. ``Prefetcher`` is a copy; the trainer
does not use it, as the reference's does not.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.roadmap import MULTI_DEVICE, not_ported


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


def batch_shardings(mesh, dp_axes=None):
    """The reference's per-array shardings of a batch over a mesh."""
    raise not_ported("data.pipeline.batch_shardings (a mesh)", MULTI_DEVICE)


def put_batch(batch: Dict[str, np.ndarray], device) -> Dict:
    """A host batch (``dense``, ``cat``, ``label``) as tensors on
    ``device``."""
    dtypes = {"dense": torch.float32, "cat": torch.int32,
              "label": torch.float32}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device=device, dtype=dtypes.get(k))
        for k, v in batch.items()}
