"""The kernel build's bookkeeping on the CPU: the ptxas log that
``_build.build`` keeps beside the library comes back on a cache hit, and
``_build.serialised_wgmma`` names the kernels whose ``wgmma`` products
ptxas serialised (its C7515 notes) and nothing else. ``nvcc`` is stubbed:
the fake compile prints a ptxas report, the fake link writes the
library."""
import pytest

torch = pytest.importorskip("torch")

import os

from repro_torch.kernels import _build

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
