"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, bound with ``ctypes`` (no PyTorch headers,
so a build takes seconds); ``csrc/*.cuh`` holds what several sources share.
Objects are compiled in parallel, one ``nvcc`` per source, then linked. The
library lands in ``repro_torch/_build/<hash>/`` (listed in ``.gitignore``),
keyed by a hash of the sources, headers and flags, beside the build's
ptxas log, and is built at the first kernel launch of a process: nothing
here runs at import. :func:`serialised_wgmma` names the kernels whose
``wgmma`` products that log says ptxas serialised.

The module also owns the launch counters: :func:`launch`, the one place a
wrapper starts its kernel, counts each successful launch and nothing else,
so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_kernels.so"
#: the build's ptxas report, kept beside the library
LOG_NAME = "ptxas.log"

#: ctypes signatures: pointers and the stream as c_void_p (a plain int
#: would be cut to 32 bits), sizes as c_longlong/c_int; every entry point
#: returns cudaGetLastError() after its launch
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "repro_lookup_fwd": [_P, _P, _P, _I, _I, _L, _I, _P, _L, _P],
    "repro_lookup_fwd_one": [_P, _P, _I, _I, _L, _I, _P, _P],
    "repro_lookup_bwd": [_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _I,
                         _P],
    "repro_gather_rows": [_P, _P, _I, _I, _L, _I, _P, _P],
    "repro_dequant_gather_rows": [_P, _P, _P, _P, _I, _I, _L, _I, _P, _L,
                                  _P],
    "repro_dequant_gather_rows_one": [_P, _P, _P, _I, _I, _L, _I, _P, _P],
    # the owner-mapped twins: ..., out, (out_stride,) rows, rows_stride,
    # stripes, first, owned, pool, stream
    "repro_gather_rows_mesh": [_P, _P, _I, _I, _I, _L, _I, _P, _P, _L, _I,
                               _I, _I, _I, _P],
    "repro_gather_rows_grouped_mesh": [_P, _P, _P, _P, _P, _I, _I, _L, _I,
                                       _P, _L, _P, _L, _I, _I, _I, _I, _P],
    "repro_dequant_gather_rows_one_mesh": [_P, _P, _P, _I, _I, _I, _L, _I,
                                           _P, _P, _L, _I, _I, _I, _I, _P],
    "repro_dequant_gather_rows_mesh": [_P, _P, _P, _P, _P, _P, _I, _I, _L,
                                       _I, _P, _L, _P, _L, _I, _I, _I, _I,
                                       _P],
    "repro_interaction_fwd": [_P, _P, _L, _I, _I, _I, _P],
    "repro_interaction_bwd": [_P, _I, _P, _P, _L, _I, _I, _I, _P],
    "repro_flash_fwd": [_P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _I, _I,
                        _I, _P],
    "repro_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I,
                           _I, _I, _I, _I, _I, _I, _P],
    "repro_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                            _L, _I, _I, _I, _I, _I, _I, _I, _P],
}

#: dtype codes the C entry points switch on
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
               torch.int8: 3}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
#: what the build of the loaded library printed (ptxas register and
#: shared-memory report, read back from beside the library when it was
#: cached) and how long this process spent building it (0 when cached)
build_info: Dict[str, object] = {"log": "", "seconds": 0.0, "path": ""}


class LaunchCounter:
    """Per-kernel launch counts, safe to bump from serving threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


LAUNCHES = LaunchCounter()


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _key(srcs) -> str:
    h = hashlib.sha256()
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands concurrently; raise with the output of any that
    failed. Returns the combined output (ptxas reports)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{o}")
    return "".join(outs)


def build() -> str:
    """Compile the kernels if this source hash has no library yet and
    return the library's path."""
    srcs = _sources()
    final = os.path.join(BUILD_ROOT, _key(srcs))
    lib_path = os.path.join(final, LIB_NAME)
    if os.path.exists(lib_path):
        log_path = os.path.join(final, LOG_NAME)
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        build_info.update(log=log, seconds=0.0, path=lib_path)
        return lib_path
    nvcc = _nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".tmp_", dir=BUILD_ROOT)
    try:
        objs = [os.path.join(tmp, os.path.basename(s)[:-3] + ".o")
                for s in srcs]
        log = _run([[nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", s, "-o", o]
                    for s, o in zip(srcs, objs)])
        _run([[nvcc, *ARCH_FLAGS, "-shared", "-o",
               os.path.join(tmp, LIB_NAME), *objs]])
        with open(os.path.join(tmp, LOG_NAME), "w") as f:
            f.write(log)
        try:
            os.rename(tmp, final)       # atomic: a racing build may win
        except OSError:
            if not os.path.exists(lib_path):
                raise
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(log=log, seconds=time.perf_counter() - t0,
                      path=lib_path)
    return lib_path


#: the function a ptxas note names
_FUNCTION = re.compile(r"function '([^']+)'")


def serialised_wgmma(log: str) -> list:
    """The functions whose ``wgmma`` products ptxas serialised, as the
    ``(C7515)`` lines of a build's log name them (mangled), in log order
    (a line that names none gives itself); other ptxas lines (registers,
    spills, C7517's injected waits) are ignored."""
    out = []
    for line in log.splitlines():
        if "(C7515)" in line:
            named = _FUNCTION.search(line)
            out.append(named.group(1) if named else line.strip())
    return out


def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, args in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and PyTorch's current
    stream on ``device`` (with ``device`` current, so a launch from any
    thread lands on the tensors' card); raise if it returns an error,
    count the launch if not."""
    fn = getattr(lib(), entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES.add(kernel)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """The wrapper-side checks every launch makes on its CUDA operands."""
    require(t.is_cuda, f"{name} must be a CUDA tensor, got {t.device}")
    require(t.dtype in dtypes,
            f"{name} dtype {t.dtype} not in {tuple(dtypes)}")
    require(t.dim() == ndim, f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain version's case);
    False when all are CUDA; raises on a mix or any other device."""
    if tensors and all(t.is_cuda for t in tensors):
        return False
    if tensors and all(t.is_cpu for t in tensors):
        return True
    raise ValueError(f"operands must all be on the CPU or all on CUDA, "
                     f"got {sorted({t.device.type for t in tensors})}")
