"""Atomic, async checkpointing with integrity checks, in the reference's
on-disk format (``repro/train/checkpoint.py``), so a checkpoint written by
either package loads in the other.

Layout:  <dir>/step_<N>/
           manifest.json   — tree structure, shapes, dtypes, crc32s, meta
           arrays.npz      — flattened key-path -> ndarray

Key paths are ``"/".join`` of the sorted dict keys (:mod:`repro_torch.tree`).
Writes go to ``<dir>/.tmp_step_<N>`` then ``os.rename`` (atomic on POSIX).
Arrays are stored in the logical layout (embedding mega-tables unpadded).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.convert import state_from_flat, state_to_flat
from repro_torch.tree import unflatten


def _template_json(tree):
    if isinstance(tree, Mapping):
        return {k: _template_json(v) for k, v in tree.items()}
    return None


def save(directory: str, step: int, tree: Mapping, *,
         meta: Optional[Dict] = None, keep_last: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = os.path.join(directory, f".tmp_step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = state_to_flat(tree)
    manifest = {
        "step": step,
        "meta": meta or {},
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes())}
                   for k, v in flat.items()},
        "template": _template_json(tree),
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(directory, keep_last)
    return final


def _cleanup(directory: str, keep_last: int):
    steps = list_checkpoints(directory)
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def list_checkpoints(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def load(directory: str, step: int, *, verify: bool = True
         ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Returns (flat arrays by key-path, manifest)."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    if verify:
        for k, info in manifest["arrays"].items():
            crc = zlib.crc32(np.ascontiguousarray(flat[k]).tobytes())
            if crc != info["crc32"]:
                raise IOError(f"checkpoint corruption in {k} @ step {step}")
    return flat, manifest


def load_tree(directory: str, step: int, *,
              device=None) -> Tuple[Dict, Dict]:
    """:func:`load`, then the flat arrays as a nested dict of tensors on
    ``device`` (dtypes kept)."""
    flat, manifest = load(directory, step)
    return state_from_flat(flat, device=device), manifest


class AsyncSaver:
    """Snapshot-on-call, write-on-thread checkpointing."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Mapping, meta: Optional[Dict] = None):
        self.wait()
        # snapshot NOW: copies to host memory, so later updates of the
        # device tensors cannot reach the file
        host = unflatten({k: np.array(v) for k, v in
                          state_to_flat(tree).items()})

        def work():
            try:
                save(self.directory, step, host, meta=meta,
                     keep_last=self.keep_last)
            except BaseException as e:     # re-raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
