"""The kernel build's bookkeeping on the CPU: the ptxas log that
``_build.build`` keeps beside the library comes back on a cache hit, and
``_build.serialised_wgmma`` names the kernels whose ``wgmma`` products
ptxas serialised (its C7515 notes) and nothing else. ``nvcc`` is stubbed:
the fake compile prints a ptxas report, the fake link writes the
library. The HPS host library (``core/hps/_host.py``) is built for real
by the host compiler into a temporary build root: a clean build, a cache
hit, two processes racing to one library, a failing compiler raising,
and no build at import."""
import pytest

torch = pytest.importorskip("torch")

import ctypes
import os
import subprocess
import sys

from repro_torch.core.hps import _host
from repro_torch.kernels import _build

#: the directory that holds the ``repro_torch`` package
SRC = os.path.dirname(_host._PKG)

DQ = ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_ee2381fc4wg6427"
      "flash_bwd_dq_wgmma64_kernelE14CUtensorMap_stS1_S1_S1_PK13__nv_"
      "bfloat16S4_PKfPfPS2_iiiiiiif")
DKV = ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_ee2381fc4wg6428"
       "flash_bwd_dkv_wgmma64_kernelILb0EEEvPK13__nv_bfloat16S4_14CUtensorMap"
       "_stS5_PKfS7_PS2_S8_iiiiiiifi")
#: a ptxas report as ``nvcc -Xptxas -v`` prints it: the entry, its
#: registers and spills, C7517's injected wait, C7515's serialisation
LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{DQ}' for 'sm_90a'
ptxas info    : Function properties for {DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : (C7517) warpgroup.wait is injected in around line 63515 by \
compiler to allow use of registers defined by GMMA in function '{DKV}'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to non wgmma instructions defining \
accumulator registers of a wgmma between start and end of the pipeline \
stage in the function '{DKV}'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to non wgmma instructions defining \
accumulator registers of a wgmma between start and end of the pipeline \
stage in the function '{DQ}'
ptxas info    : Compile time = 105.855 ms
"""


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """``build`` into ``tmp_path`` with ``nvcc`` stubbed; returns the list
    of the command batches it ran."""
    calls = []

    def run(cmds):
        calls.append(cmds)
        for c in cmds:
            with open(c[c.index("-o") + 1], "wb") as f:
                f.write(b"\0")
        return "" if "-shared" in cmds[0] else LOG

    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run", run)
    monkeypatch.setattr(_build, "build_info", dict(_build.build_info))
    return calls


def test_log_survives_a_cache_hit(fake_nvcc):
    """The first build compiles, links and keeps ptxas's report beside the
    library; the second finds the library and reads the report back, so
    ``build_info["log"]`` is the build's log either way."""
    path = _build.build()
    assert len(fake_nvcc) == 2                  # compile, then link
    assert _build.build_info["log"] == LOG
    assert _build.build_info["path"] == path
    kept = os.path.join(os.path.dirname(path), _build.LOG_NAME)
    with open(kept) as f:
        assert f.read() == LOG
    _build.build_info.update(log="", seconds=1.0, path="")
    assert _build.build() == path
    assert len(fake_nvcc) == 2                  # nothing compiled again
    assert _build.build_info == {"log": LOG, "seconds": 0.0, "path": path}


def test_cached_library_without_a_log(fake_nvcc):
    """A library found with no report beside it gives an empty log, not a
    stale one."""
    path = _build.build()
    os.remove(os.path.join(os.path.dirname(path), _build.LOG_NAME))
    _build.build_info.update(log=LOG)
    assert _build.build() == path
    assert _build.build_info["log"] == ""


def test_serialised_wgmma_names_c7515_functions():
    """The C7515 lines' functions, in log order; the entry, register,
    spill and C7517 lines (which name functions too) are ignored."""
    assert _build.serialised_wgmma(LOG) == [DKV, DQ]


@pytest.mark.parametrize("log", [
    "",
    LOG.replace("(C7515)", "(C7514)"),
    "\n".join(line for line in LOG.splitlines() if "C7515" not in line),
])
def test_serialised_wgmma_empty(log):
    """A log without a C7515 line names nothing."""
    assert _build.serialised_wgmma(log) == []


def test_serialised_wgmma_unnamed_line():
    """A C7515 line that names no function still counts: it gives itself."""
    line = "ptxas info    : (C7515) Potential Performance Loss: serialized"
    assert _build.serialised_wgmma(f"x\n{line}\n") == [line]


@pytest.fixture
def host_root(monkeypatch, tmp_path):
    """``_host.build`` into ``tmp_path`` (the real host compiler)."""
    monkeypatch.setattr(_host, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_host, "build_info", dict(_host.build_info))
    return tmp_path


def test_host_build_then_a_cache_hit(host_root):
    """A clean build compiles one library under the root, keyed by the
    source, compiler and flags, which loads and maps ids; the second
    build finds it and compiles nothing."""
    path = _host.build()
    assert os.path.dirname(os.path.dirname(path)) == str(host_root)
    assert os.path.basename(os.path.dirname(path)).startswith("host-")
    assert _host.build_info["path"] == path
    assert _host.build_info["seconds"] > 0
    built = os.path.getmtime(path)
    assert _host.build() == path
    assert _host.build_info == {"path": path, "seconds": 0.0}
    assert os.path.getmtime(path) == built
    assert os.listdir(host_root) == [os.path.basename(os.path.dirname(path))]
    lib = ctypes.CDLL(path)
    lib.hps_map_new.restype = ctypes.c_void_p
    lib.hps_map_new.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
    lib.hps_map_size.restype = ctypes.c_longlong
    lib.hps_map_size.argtypes = [ctypes.c_void_p]
    lib.hps_map_free.argtypes = [ctypes.c_void_p]
    ids = (ctypes.c_longlong * 3)(5, -9, 1 << 62)
    slots = (ctypes.c_longlong * 3)(0, 1, 2)
    m = lib.hps_map_new(ids, slots, 3)
    assert lib.hps_map_size(m) == 3
    lib.hps_map_free(m)


def test_two_processes_race_to_one_host_library(host_root):
    """Two processes building into one empty root at once end with one
    library, the same path for both, and no temporary directory left."""
    code = ("import sys; from repro_torch.core.hps import _host; "
            "_host.BUILD_ROOT = sys.argv[1]; print(_host.build())")
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(host_root)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    path = paths.pop()
    assert os.path.isfile(path)
    assert os.listdir(host_root) == [os.path.basename(os.path.dirname(path))]


def test_a_failing_host_compiler_raises(host_root, monkeypatch):
    """A compiler that fails raises with its command; nothing is left
    under the root, and no library is bound."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host compiler failed"):
        _host.build()
    assert os.listdir(host_root) == []


def test_no_host_build_at_import():
    """Importing the HPS, the servers and the launchers builds and loads
    nothing: with a compiler that cannot run, the imports pass and the
    library is still unbound."""
    code = ("import repro_torch.core.hps.hps, repro_torch.serve.server, "
            "repro_torch.launch.serve, repro_torch.launch.loadtest; "
            "from repro_torch.core.hps import _host; "
            "assert _host._lib is None and _host.build_info['path'] == '' "
            "and not _host.CALLS.snapshot(); print('ok')")
    env = {**os.environ, "PYTHONPATH": SRC, "CXX": "/nonexistent/c++"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
