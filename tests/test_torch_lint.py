"""The port passes the reference's static gate: ``python -m repro.analysis
--root src/repro_torch --check`` reports no failing finding and no stale
baseline entry, with the checked-in baseline (which stays empty). It also
passes its own twin, ``python -m repro_torch.analysis --check``, whose
LOCK002 table adds PyTorch's host syncs; the twin flags each of them
under a lock in a small fixture, where the reference's table flags none.

Both gates are stdlib AST only, so this file needs neither torch nor
jax."""
import os

import pytest

from repro.analysis import concurrency
from repro.analysis.__main__ import main as analysis_main
from repro.analysis.findings import load_baseline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
BASELINE = os.path.join(ROOT, "src", "repro", "analysis", "baseline.toml")


def test_port_passes_the_analysis_gate(capsys):
    rc = analysis_main(["--root", PORT, "--check"])
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0, summary
    assert " 0 failing finding(s)" in summary, summary
    assert " 0 stale baseline entries" in summary, summary


def test_baseline_stays_empty():
    assert load_baseline(BASELINE) == []


def test_port_waives_the_probe_fetch_as_the_reference_does():
    """The findings the port waives are exactly the reference's, file for
    file and message for message: the two blocking calls under the cache
    lock (the HPS probe's ``fetch_fn`` and ``resize``'s re-pull of the
    survivors) and ``MultiModelServer._rebalance_tick``'s three (the
    guarded state it reads inside ``acquire(blocking=False)`` / ``finally:
    release()``). Each carries the reference's reviewed waiver, so all
    show as waived rather than failing."""
    files = ("core/hps/embedding_cache.py", "serve/server.py")
    findings = concurrency.lint_tree(PORT, ROOT)
    waived = [f for f in findings if f.waived]
    assert [(f.rule, f.file) for f in waived] == \
        [("LOCK002", f"src/repro_torch/{files[0]}")] * 2 + \
        [("LOCK001", f"src/repro_torch/{files[1]}")] * 2 + \
        [("LOCK004", f"src/repro_torch/{files[1]}")]
    assert not [f for f in findings if not f.waived and not f.advice]
    ref = concurrency.lint_tree(os.path.join(ROOT, "src", "repro"), ROOT)
    assert [(f.rule, f.file, f.message, f.symbol) for f in ref
            if f.waived and f.file.endswith(files)] == [
        (f.rule, f.file.replace("repro_torch", "repro"), f.message, f.symbol)
        for f in waived]


# ---------------------------------------------------------------------------
# the port's own twin: python -m repro_torch.analysis
# ---------------------------------------------------------------------------

def test_twin_gate_passes_over_the_port(capsys):
    from repro_torch.analysis.__main__ import main as twin_main
    rc = twin_main(["--root", PORT, "--check"])
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0, summary
    assert summary == ("repro_torch.analysis: 0 failing finding(s), "
                       "5 waived"), summary


def test_twin_sees_the_reference_findings_over_the_port():
    """The twin's table only adds entries: over the port it reports the
    findings the reference's pass reports, the same waivers included."""
    from repro_torch.analysis import concurrency as twin
    key = (lambda f: (f.rule, f.file, f.line, f.message, f.waived))
    assert [key(f) for f in twin.lint_tree(PORT, ROOT)] == \
        [key(f) for f in concurrency.lint_tree(PORT, ROOT)]


#: the torch host syncs the twin's LOCK002 table adds, as written in code
TORCH_SYNCS = ("x.item()", "x.cpu()", "x.numpy()", "x.tolist()",
               "torch.cuda.synchronize()", "self._stream.synchronize()",
               "done_event.synchronize()", "devmod.synchronize(dev)")

FIXTURE = """
import os
import threading

import numpy as np
import torch


class Holder:
    _GUARDED_BY = {{"_n": "_lock"}}

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def under_lock(self, x, done_event, dev):
        with self._lock:
            self._n += 1
            {call}

    def outside_lock(self, x, done_event, dev):
        {call}
        with self._lock:
            self._n += 1

    def host_only(self, x):
        with self._lock:
            self._n += 1
            os.path.join("a", "b")
            return np.asarray(x).tolist(), np.array(x).item()
"""


@pytest.mark.parametrize("call", TORCH_SYNCS)
def test_twin_flags_each_torch_sync_under_a_lock(tmp_path, call):
    from repro_torch.analysis import concurrency as twin
    path = tmp_path / "holder.py"
    path.write_text(FIXTURE.format(call=call))
    found = twin.lint_paths([str(path)], str(tmp_path))
    assert [(f.rule, f.symbol) for f in found] == [
        ("LOCK002", "Holder.under_lock")], [f.format() for f in found]
    assert call.split("(")[0] in found[0].message
    # the reference's table knows none of them (it stays as it is)
    assert concurrency.lint_paths([str(path)], str(tmp_path)) == []


def test_twin_honors_an_inline_waiver(tmp_path):
    from repro_torch.analysis import concurrency as twin
    waived = "# lock-ok: LOCK002 reviewed\n            x.cpu()"
    src = FIXTURE.replace("            {call}\n", f"            {waived}\n",
                          1).replace("        {call}\n", "", 1)
    path = tmp_path / "holder.py"
    path.write_text(src)
    found = twin.lint_paths([str(path)], str(tmp_path))
    assert [(f.rule, f.waived, f.waive_reason) for f in found] == [
        ("LOCK002", True, "reviewed")]
