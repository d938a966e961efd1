"""The port passes the reference's static gate: ``python -m repro.analysis
--root src/repro_torch --check`` reports no failing finding and no stale
baseline entry, with the checked-in baseline (which stays empty).

The gate is stdlib AST only, so this file needs neither torch nor jax."""
import os

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
    """The blocking calls under a lock in the port are the reference's
    two: the HPS probe's ``fetch_fn`` and ``resize``'s re-pull of the
    survivors. Each carries the reference's reviewed waiver, so both show
    as waived rather than failing, and the reference's waived list is the
    same."""
    cache = "core/hps/embedding_cache.py"
    findings = concurrency.lint_tree(PORT, ROOT)
    waived = [f for f in findings if f.waived]
    assert [(f.rule, f.file) for f in waived] == [
        ("LOCK002", f"src/repro_torch/{cache}")] * 2
    assert not [f for f in findings if not f.waived and not f.advice]
    ref = concurrency.lint_tree(os.path.join(ROOT, "src", "repro"), ROOT)
    assert [(f.rule, f.file, f.message) for f in ref
            if f.waived and f.file.endswith(cache)] == [
        (f.rule, f.file.replace("repro_torch", "repro"), f.message)
        for f in waived]
