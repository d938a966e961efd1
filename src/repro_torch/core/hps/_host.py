"""Build and bind the HPS host stage's C++ passes (``csrc/hps_host.cpp``).

The source is host-only C++17 (no CUDA, no PyTorch headers). At the first
call of a process it is compiled by the host compiler (``$CXX``, else
``c++`` or ``g++`` on ``PATH``) with :data:`FLAGS` into
``repro_torch/_build/host-<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the source, the compiler and the flags; a build lands in a
temporary directory renamed into place, so racing processes end up with
one library. Nothing builds at import, and a failed build raises: no
caller has another path.

The library is bound with ``ctypes.PyDLL``: a call keeps the interpreter
lock. A served call takes microseconds, and a thread back from a call
that dropped the lock would wait to win it again from the serving
threads, up to the switch interval (5 ms), while still holding its
owner's lock (the cache's, a namespace's, the store's): the owners' locks
would convoy. With every call off the lock (``ctypes.CDLL``), the open
loop of ``tools/open_loop_times.py`` at 67 requests/s shed or expired 62
of 343 requests on an H100's host, with every call on it 0 (``PERF.md``
§6). The caller holds the owner's Python lock across a call and keeps
every array it passes alive until it returns. :data:`CALLS` counts the calls into the
library by entry point, the host code's counterpart of
``kernels._build.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from typing import Dict, Optional

import numpy as np

from repro_torch.kernels._build import LaunchCounter

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "hps_host.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]
LIB_NAME = "libhps_host.so"

_P, _L = ctypes.c_void_p, ctypes.c_longlong
SIGNATURES = {
    "hps_map_new": ([_P, _P, _L], _P),
    "hps_map_free": ([_P], None),
    "hps_map_size": ([_P], _L),
    "hps_map_find": ([_P, _P, _L, _P], None),
    "hps_map_update": ([_P, _P, _L, _P, _P, _L], _L),
    "hps_map_dump": ([_P, _P, _P], None),
    "hps_l1_pass1": ([_P, _L, _P, _P, _L, _P], _L),
    "hps_l1_pass2": ([_P, _L, _P, _P, _P, _P, _L, _P, _P, _L, _L], _L),
    "hps_l2_query": ([_P, _P, _P, _L, _P, _L, _P, _L, _P, _P], _L),
    "hps_l2_insert": ([_P, _P, _P, _L, _L, _P, _P, _P, _L, _L, _L, _P, _P],
                      _L),
    "hps_l2_place": ([_P, _P, _P, _P, _P, _L, _L, _L, _P, _P, _P, _L], _L),
    "hps_gather_rows": ([_P, _L, _L, _P, _L, _P], _L),
}

#: the rows of an L1 probe's work buffer (``L1_ROWS`` x ld int64), as the
#: source's enum names them
(W_IDS, W_UNIQ, W_COUNTS, W_INV, W_SLOTS_U, W_MISS_POS, W_MISS_IDS,
 W_MISS_COUNTS, W_HIT_SLOTS, W_OUT, L1_ROWS) = range(11)

_lib: Optional[ctypes.PyDLL] = None
_lib_lock = threading.Lock()
#: the loaded library's path, and the seconds this process spent building
#: it (0 when it was found built)
build_info: Dict[str, object] = {"path": "", "seconds": 0.0}


#: calls into the library by entry point
CALLS = LaunchCounter()


def compiler() -> list:
    """The host compiler's command: ``$CXX``, else ``c++`` or ``g++``."""
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return [found]
    raise RuntimeError("no host C++ compiler ($CXX, c++ or g++ on $PATH); "
                       "the HPS host library cannot be built")


def _key(cxx) -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(list(cxx) + FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library if this source, compiler and flags have none
    yet, and return its path."""
    cxx = compiler()
    final = os.path.join(BUILD_ROOT, "host-" + _key(cxx))
    lib_path = os.path.join(final, LIB_NAME)
    if os.path.exists(lib_path):
        build_info.update(path=lib_path, seconds=0.0)
        return lib_path
    os.makedirs(BUILD_ROOT, exist_ok=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".tmp_host_", dir=BUILD_ROOT)
    try:
        cmd = [*cxx, *FLAGS, SOURCE, "-o", os.path.join(tmp, LIB_NAME)]
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"the host compiler failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{p.stdout}")
        try:
            os.rename(tmp, final)       # atomic: a racing build may win
        except OSError:
            if not os.path.exists(lib_path):
                raise
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(path=lib_path, seconds=time.perf_counter() - t0)
    return lib_path


def lib() -> ctypes.PyDLL:
    """The bound library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.PyDLL(build())
            for name, (args, res) in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = res
            _lib = handle
        return _lib


def call(entry: str, *args):
    """Call the entry point ``entry`` and count the call."""
    out = getattr(_lib or lib(), entry)(*args)
    CALLS.add(entry)
    return out


def ptr(a: np.ndarray) -> Optional[int]:
    """The address of a C-contiguous array's data (None when empty)."""
    if a.size == 0:
        return None
    if not a.flags.c_contiguous:
        raise ValueError("the host passes take C-contiguous arrays")
    try:
        return ctypes.addressof(ctypes.c_char.from_buffer(a))
    except (TypeError, ValueError, BufferError):   # read-only
        return a.ctypes.data


def i64(a) -> np.ndarray:
    """``a`` as a C-contiguous int64 array (itself when it is one)."""
    return np.ascontiguousarray(a, np.int64)


def info_buffer():
    """An out-array of five int64 counts for the passes that report some
    (one per owner, used under its lock)."""
    return (ctypes.c_longlong * 5)()


def check(entry: str, rc: int) -> None:
    """Raise where a pass reported an error (a negative code)."""
    if rc == -2:
        raise MemoryError(f"{entry}: out of memory")
    if rc < 0:
        raise ValueError(f"{entry}: a slot is negative")


class HostMap:
    """An owned handle of the library's id -> slot map, freed with the
    object."""

    __slots__ = ("handle", "__weakref__")

    def __init__(self, ids: np.ndarray, slots: np.ndarray):
        ids, slots = i64(ids), i64(slots)
        if len(ids) != len(slots):
            raise ValueError(f"{len(ids)} ids for {len(slots)} slots")
        handle = call("hps_map_new", ptr(ids), ptr(slots), len(ids))
        if not handle:
            raise ValueError("the map's ids repeat, a slot is negative or "
                             "memory ran out")
        self.handle = handle
        weakref.finalize(self, lib().hps_map_free, handle)
