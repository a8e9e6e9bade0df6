"""The xDeepFM cell on the CPU at a tiny size (the port against the plain
reference, the faults and controls failing its limits), the CIN's count
against a hand sum and its laws, and the reference's imports."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.counts import xdeepfm as counts

CELL = "xdeepfm-train-criteo"
SEED = 2 ** 31 + 77


@pytest.fixture
def tiny_xdeepfm(tiny):
    """The tiny benchmark with the xDeepFM configuration cut to CPU sizes
    (2^16 buckets, so that "auto" takes the dedup path under adam)."""
    spec, root, bench = tiny
    entry = next(c for c in spec["configs"]
                 if c["name"] == "criteo-xdeepfm-lian18")
    c = json.load(open(os.path.join(harness.PACKAGE_DIR, "configs",
                                    "criteo-xdeepfm-lian18.json")))
    c.update(num_buckets=1 << 16, num_examples=2048, hidden=[16, 16],
             cin=[8, 8, 6], num_integer_fields=2, num_categorical_fields=4)
    c["training"]["batch_size"] = 256
    c["assumed"].update(categorical_cardinalities=[50, 300, 7, 1000],
                        integer_cardinalities=[16, 16])
    entry["file"] = "b/configs/criteo-xdeepfm-lian18.json"
    json.dump(c, open(os.path.join(root, entry["file"]), "w"))
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return spec, root, bench


def _cell(tiny):
    spec, root, bench = tiny
    return harness.resolve_cell(spec, CELL, root, bench)


def test_xdeepfm_cell_is_correct_and_traced(tiny_xdeepfm):
    cell = _cell(tiny_xdeepfm)
    line = harness.run_cell(cell, SEED, 0.3, True, torch.device("cpu"),
                            time.perf_counter())
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(cell.limits)
    # the CPU records no device times: the CIN's readers read None
    assert not any(m.startswith("xdeepfm.") for m in line["metrics"])
    assert line["metrics"]["mfu_pct.train"]["value"] > 0


@pytest.mark.parametrize("stand_in", [
    "bfloat16", "float64:half", "float64:stale", "float64:unchanged",
    "float64:no_cin", "float64:cin_short"])
def test_controls_and_faults_fail_the_limits(tiny_xdeepfm, stand_in):
    cell = _cell(tiny_xdeepfm)
    ctx = harness.Context(cell, SEED, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    dtype, _, fault = stand_in.partition(":")
    readings = harness.entry_of(cell).stand_in(ctx, getattr(torch, dtype),
                                               fault or None)
    ok, checks = harness.judge(readings, cell.limits)
    assert not ok, checks


def test_float32_reference_in_the_programs_place_passes(tiny_xdeepfm):
    cell = _cell(tiny_xdeepfm)
    ctx = harness.Context(cell, SEED, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    readings = harness.entry_of(cell).stand_in(ctx, torch.float32)
    ok, checks = harness.judge(readings, cell.limits)
    assert ok, checks


def test_cin_flops_by_hand_and_the_sum_over_layers():
    m, k = 3, 2
    # layer 1: Z = 3 x 3, H = 4; layer 2: Z = 4 x 3, H = 5
    one = 9 * 2 + 2 * 4 * 9 * 2 + 4 * 2 + 4 * 2 + 4 * 4 * 9 * 2 + 4 * 9 * 2
    two = 12 * 2 + 2 * 5 * 12 * 2 + 5 * 2 + 5 * 2 + 4 * 5 * 12 * 2 + 4 * 12 * 2
    emb = 3 * m * k
    assert counts.cin_flops(m, k, (4,)) == emb + one
    assert counts.cin_flops(m, k, (4, 5)) == emb + one + two
    assert counts.cin_params(m, (4, 5)) == 4 * 9 + 5 * 12 + 9


def test_the_published_cin_is_about_205_mflop_an_example():
    # forward GEMMs 2 D (200 x 1521 + 2 x 200 x 7800) = 68.5 MFLOP, x 3
    got = counts.cin_flops(39, 10, (200, 200, 200))
    gemms = 3 * 2 * 10 * (200 * 1521 + 2 * 200 * 7800)
    assert gemms < got < gemms * 1.02
    assert counts.cin_params(39, (200, 200, 200)) == 3_424_800


@pytest.mark.parametrize("batch", [1, 7, 4096])
def test_step_flops_grow_linearly_in_the_batch(batch):
    a = counts.step_work(batch, 39, 100, 10, (400, 400), (200, 200, 200))
    b = counts.step_work(2 * batch, 39, 100, 10, (400, 400), (200, 200, 200))
    fixed = counts.step_work(0, 39, 100, 10, (400, 400), (200, 200, 200))
    assert b["flops"] - a["flops"] == pytest.approx(
        a["flops"] - fixed["flops"], rel=1e-12)
    assert (b["flops"] - a["flops"]) / batch > counts.cin_flops(
        39, 10, (200, 200, 200))


@pytest.mark.parametrize("batch", [1, 4096])
def test_the_dense_phase_is_the_step_less_the_cin_and_per_row_work(batch):
    """The step's FLOPs are the dense phase's, the CIN's and the work that
    grows with neither (the dense L2, the per-row sums, Adam); the dense
    phase holds the tower's three GEMMs a layer."""
    widths, hidden = (200, 200, 200), (400, 400)
    step = counts.step_work(batch, 39, 100, 10, hidden, widths)["flops"]
    dense = counts.dense_flops(batch, 39, 10, hidden, widths)
    cin = batch * counts.cin_flops(39, 10, widths)
    rest = counts.step_work(0, 39, 100, 10, hidden, widths)["flops"]
    assert step == pytest.approx(dense + cin + rest + batch * 39 * 11,
                                 rel=1e-12)
    gemms = 3 * 2 * batch * (390 * 400 + 400 * 400 + 400)
    assert gemms < dense < gemms * 1.02


def test_the_xdeepfm_reference_loads_nothing_of_the_port():
    script = """
import sys
from portbench.reference import xdeepfm
print(" ".join(sorted({m.split(".")[0] for m, v in sys.modules.items()
                       if v is not None})))
"""
    root = os.path.dirname(harness.PACKAGE_DIR)
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(out.stdout.split())
    assert not tops & {"sparkfm_tpu_torch", "sparkfm_tpu", "jax"}


@pytest.mark.cuda
def test_tf32_in_the_programs_products_fails_the_limits(card):
    """On the card, at the cell's own size: the program itself with TF32
    on for its matrix products (the CIN's and the tower's) fails a limit
    (the per-coordinate median: every coordinate moves)."""
    root = os.path.dirname(harness.PACKAGE_DIR)
    cell = harness.resolve_cell(harness.load_spec(root), CELL, root)
    ctx = harness.Context(cell, SEED, 0.0, False, card, time.perf_counter())
    readings = harness.entry_of(cell).stand_in(ctx, torch.float32, "tf32")
    ok, checks = harness.judge(readings, cell.limits)
    assert not ok, checks
    assert torch.backends.cuda.matmul.allow_tf32 is False
