"""The port passes the reference's static gate: ``python -m repro.analysis
--root src/repro_torch --check`` reports no failing finding and no stale
baseline entry, with the checked-in baseline (which stays empty). It also
passes its own twin, ``python -m repro_torch.analysis --check``, whose
LOCK002 table adds PyTorch's host syncs; the twin flags each of them
under a lock in a small fixture, where the reference's table flags none.
The twin's reachability pass (``--rules dead``) runs the reference's
synthetic trees with the port's roots (``chip_smoke.py``, ``tools/``,
``tests/test_torch_*.py``) and reports over the port what the reference's
pass reports.

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
                       "5 waived, 0 informational"), summary


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


# ---------------------------------------------------------------------------
# the twin's reachability pass: python -m repro_torch.analysis --rules dead
# ---------------------------------------------------------------------------

def _tree(tmp_path, files):
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(body)
    return str(tmp_path / "src" / "pkg")


@pytest.mark.parametrize("test_file,testutil", [
    ("test_torch_it.py", "test_only"), ("test_it.py", "orphans")],
    ids=["port-test", "reference-test"])
def test_twin_deadcode_on_synthetic_tree(tmp_path, test_file, testutil):
    """The reference's synthetic tree on the twin: a port test
    (``tests/test_torch_*.py``) is a test root, any other test is not."""
    from repro_torch.analysis import deadcode as twin
    src = _tree(tmp_path, {
        "src/pkg/api.py": "import pkg.used\n",
        "src/pkg/used.py": "x = 1\n",
        "src/pkg/testutil.py": "y = 2\n",
        "src/pkg/orphan.py": "z = 3\n",
        "src/pkg/plugins/alpha.py": "w = 4\n",
        "src/pkg/loader.py": 'NAME = "pkg.plugins." + "alpha"\n',
        f"tests/{test_file}": "import pkg.testutil\n",
    })
    rep = twin.reachability(str(tmp_path), src)
    assert "pkg.api" in rep.runtime and "pkg.used" in rep.runtime
    # loader is NOT a runtime seed (not api/launch/scripts) => its prefix
    # edge only matters once something reaches it
    assert "pkg.testutil" in getattr(rep, testutil)
    assert "pkg.orphan" in rep.orphans
    fs = twin.lint(str(tmp_path), src)
    dead1 = [f for f in fs if f.rule == "DEAD001"]
    assert any("pkg.orphan" in f.message for f in dead1)
    assert all(f.advice for f in fs if f.rule == "DEAD002")


def test_twin_deadcode_dynamic_prefix_marks_subpackage(tmp_path):
    from repro_torch.analysis import deadcode as twin
    src = _tree(tmp_path, {
        "src/pkg/api.py": 'MOD = "pkg.plugins." + NAME\n',
        "src/pkg/plugins/alpha.py": "w = 4\n",
        "src/pkg/plugins/beta.py": "v = 5\n",
    })
    rep = twin.reachability(str(tmp_path), src)
    assert {"pkg.plugins.alpha", "pkg.plugins.beta"} <= rep.runtime
    assert rep.orphans == set()


def test_twin_deadcode_roots_are_the_ports_scripts(tmp_path):
    """``chip_smoke.py`` and ``tools/*.py`` are runtime roots (the port's
    scripts, as ``benchmarks/`` and ``examples/`` are the reference's)."""
    from repro_torch.analysis import deadcode as twin
    src = _tree(tmp_path, {
        "src/pkg/api.py": "x = 0\n",
        "src/pkg/smoke_only.py": "x = 1\n",
        "src/pkg/tool_only.py": "x = 2\n",
        "src/pkg/bench_only.py": "x = 3\n",
        "chip_smoke.py": "import pkg.smoke_only\n",
        "tools/kernel_times.py": "from pkg import tool_only\n",
        "benchmarks/run.py": "import pkg.bench_only\n",
    })
    rep = twin.reachability(str(tmp_path), src)
    assert {"pkg.smoke_only", "pkg.tool_only"} <= rep.runtime
    assert rep.orphans == {"pkg.bench_only"}


def test_twin_deadcode_over_the_port_equals_the_reference_pass():
    """Over ``src/repro_torch`` the twin's DEAD findings are the
    reference pass's but for what the example twins reach (the twin's
    own roots, ``repro_torch.examples.*``, where the reference's
    ``examples/`` lie outside its package): the port's scripts
    (``chip_smoke.py``, ``tools/``) reach no module that ``launch/*``,
    ``api``, ``examples/*`` and ``__main__`` do not."""
    from repro.analysis import deadcode as ref
    from repro_torch.analysis import deadcode as twin
    key = (lambda f: (f.rule, f.file, f.advice))
    got = twin.lint(ROOT, PORT)
    by_examples = {
        os.path.relpath(twin.reachability(ROOT, PORT).modules[m], ROOT)
        for m in (twin.reachability(ROOT, PORT).runtime
                  - ref.reachability(ROOT, PORT).runtime)}
    assert by_examples and all(
        f.startswith("src/repro_torch/examples/")
        for f in by_examples - {"src/repro_torch/export.py"})
    want = [key(f) for f in ref.lint(ROOT, PORT)
            if f.file not in by_examples]
    assert [key(f) for f in got] == want
    assert [f.rule for f in got if not f.advice] == []
    scripts = twin.reachability(ROOT, PORT).runtime
    without = twin.reachability(ROOT, PORT, runtime_roots=()).runtime
    assert scripts - without == set()


def test_twin_cli_runs_each_pass(capsys):
    from repro_torch.analysis.__main__ import main as twin_main
    for rules, tail in (("lock", "5 waived, 0 informational"),
                        ("dead", "0 waived, 0 informational"),
                        ("lock,dead", "5 waived, 0 informational")):
        assert twin_main(["--root", PORT, "--check", "--rules", rules]) == 0
        summary = capsys.readouterr().out.strip().splitlines()[-1]
        assert summary == ("repro_torch.analysis: 0 failing finding(s), "
                           + tail), summary
