"""What the benchmark loads: no JAX and no JAX package anywhere, nothing of
the port in the reference; and the command's refusal without a card."""

import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PKG = os.path.join(ROOT, "portbench")


def _modules_of(script: str) -> set:
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_forbidden_names_compare_whole_top_level_names():
    mod = object()
    assert harness.forbidden_loaded({"sparkfm_tpu_torch.api": mod,
                                     "jaxtyping": mod}) == []
    assert harness.forbidden_loaded({"sparkfm_tpu.config": mod,
                                     "jax.numpy": mod, "flax": mod}) == [
        "flax", "jax", "sparkfm_tpu"]
    assert harness.forbidden_loaded({"jax": None}) == []


def test_a_run_loads_no_jax_and_no_jax_package():
    script = f"""
import sys, time, glob, os, tempfile, torch
sys.path.insert(0, {PKG + '/tests'!r})
from conftest import write_tiny
from portbench import harness, run, calibrate, tracing
for path in glob.glob({PKG!r} + "/**/*.py", recursive=True):
    if "/tests/" not in path:
        harness.load_module(path, "m_" + str(abs(hash(path))))
tmp = tempfile.mkdtemp()
spec = write_tiny(tmp)
for name in ("ctr-train-hostplan", "ml25m-als-sweep"):
    cell = harness.resolve_cell(spec, name, tmp, tmp + "/b")
    harness.run_cell(cell, 3, 0.2, True, torch.device("cpu"),
                     time.perf_counter())
print(" ".join(harness.forbidden_loaded(dict(sys.modules))) or "none")
"""
    assert _modules_of(script) == {"none"}


def test_the_reference_loads_nothing_of_the_port():
    script = """
import sys
from portbench.reference import als, fm, judge
print(" ".join(sorted({m.split(".")[0] for m, v in sys.modules.items()
                       if v is not None})))
"""
    tops = _modules_of(script)
    assert "sparkfm_tpu_torch" not in tops and "sparkfm_tpu" not in tops
    assert "jax" not in tops


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    rc = run.main(["--workload", "ctr-train-hostplan", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA card" in out.err


def test_unknown_workload_raises():
    spec = harness.load_spec(ROOT)
    with pytest.raises(KeyError):
        harness.resolve_cell(spec, "no-such-cell", ROOT)


def test_every_named_file_exists():
    spec = harness.load_spec(ROOT)
    for w in spec["workloads"]:
        cell = harness.resolve_cell(spec, w["name"], ROOT)
        harness.entry_of(cell)
        for m in cell.per_layer:
            harness.reader_of(cell, m["name"])
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(PKG, "metrics",
                                           m["name"] + ".py"))
