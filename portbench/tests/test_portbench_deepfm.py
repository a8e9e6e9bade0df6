"""The DeepFM cell on the CPU at a tiny size (the port against the plain
reference, the faults and controls failing its limits), the count of its
step's work against a hand sum, and the reference's imports."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.counts import deepfm as counts

CELL = "deepfm-train-criteo"
SEED = 2 ** 31 + 99


@pytest.fixture
def tiny_deepfm(tiny):
    """The tiny benchmark with the DeepFM configuration cut to CPU sizes
    (2^16 buckets, so that "auto" takes the dedup path under adam)."""
    spec, root, bench = tiny
    entry = next(c for c in spec["configs"]
                 if c["name"] == "criteo-deepfm-guo17")
    c = json.load(open(os.path.join(harness.PACKAGE_DIR, "configs",
                                    "criteo-deepfm-guo17.json")))
    c.update(num_buckets=1 << 16, num_examples=2048, hidden=[16, 16, 16],
             num_integer_fields=2, num_categorical_fields=4)
    c["training"]["batch_size"] = 256
    c["assumed"].update(categorical_cardinalities=[50, 300, 7, 1000],
                        integer_cardinalities=[16, 16])
    entry["file"] = "b/configs/criteo-deepfm-guo17.json"
    json.dump(c, open(os.path.join(root, entry["file"]), "w"))
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return spec, root, bench


def _cell(tiny):
    spec, root, bench = tiny
    return harness.resolve_cell(spec, CELL, root, bench)


def test_deepfm_cell_is_correct_and_traced(tiny_deepfm):
    cell = _cell(tiny_deepfm)
    line = harness.run_cell(cell, SEED, 0.3, True, torch.device("cpu"),
                            time.perf_counter())
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(cell.limits)
    # the CPU records no device times: the four DeepFM readers read None
    assert not any(m.startswith("deepfm.") for m in line["metrics"])
    assert line["metrics"]["mfu_pct.train"]["value"] > 0


@pytest.mark.parametrize("stand_in", [
    "bfloat16", "float64:half", "float64:stale", "float64:unchanged",
    "float64:no_dropout", "float64:wrong_step"])
def test_controls_and_faults_fail_the_limits(tiny_deepfm, stand_in):
    cell = _cell(tiny_deepfm)
    ctx = harness.Context(cell, SEED, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    dtype, _, fault = stand_in.partition(":")
    readings = harness.entry_of(cell).stand_in(ctx, getattr(torch, dtype),
                                               fault or None)
    ok, checks = harness.judge(readings, cell.limits)
    assert not ok, checks


def test_float32_reference_in_the_programs_place_passes(tiny_deepfm):
    cell = _cell(tiny_deepfm)
    ctx = harness.Context(cell, SEED, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    readings = harness.entry_of(cell).stand_in(ctx, torch.float32)
    ok, checks = harness.judge(readings, cell.limits)
    assert ok, checks


def test_dense_flops_and_step_work_by_hand():
    b, l, k, hidden = 2, 3, 2, (5, 4)
    n = b * l
    fm = n * 10 + b * 8 + n * 10
    emb = n * k * 3
    mm = 2 * b * (6 * 5 + 5 * 4 + 4 * 1)
    bias = b * (5 + 4 + 1)
    units = 4 * b * 9
    assert counts.dense_flops(b, l, k, hidden) == (
        fm + emb + 3 * mm + 2 * bias + units + 8 * b)
    p = 6 * 5 + 5 + 5 * 4 + 4 + 4 + 1
    assert counts.tower_params(l, k, hidden) == p
    w = counts.step_work(b, l, 7, k, hidden)
    assert w["flops"] == counts.dense_flops(b, l, k, hidden) + n * 3 + 12 * (
        7 * 3 + p + 1)
    assert w["bytes"] == 4 * (2 * n + b + 2 * 7 * 9 + 6 * (p + 1) + b + 1)


def test_the_published_step_counts_the_towers_flops():
    # 2 B (390 x 400 + 2 x 400 x 400 + 400) forward, twice that backward
    tower = 2 * 16384 * (390 * 400 + 2 * 400 * 400 + 400)
    got = counts.dense_flops(16384, 39, 10, (400, 400, 400))
    assert 3 * tower < got < 3 * tower * 1.01


def test_the_deepfm_reference_loads_nothing_of_the_port():
    script = """
import sys
from portbench.reference import deepfm
print(" ".join(sorted({m.split(".")[0] for m, v in sys.modules.items()
                       if v is not None})))
"""
    root = os.path.dirname(harness.PACKAGE_DIR)
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(out.stdout.split())
    assert not tops & {"sparkfm_tpu_torch", "sparkfm_tpu", "jax"}
