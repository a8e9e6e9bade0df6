"""Every cell on the CPU at tiny sizes: the port against the plain
reference (``correct``), the result line, discovery of a new mix from
files, and ``correct`` coming out false when the timed path is broken
underneath or the reference in a lower precision stands in for it."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import harness

CELLS = ["ctr-train-hostplan", "ml25m-als-sweep", "ctr-train-deviceplan"]
SEED = 2 ** 31 + 99


def _run(tiny, name, trace=False, seconds=0.5, seed=SEED):
    spec, root, bench = tiny
    cell = harness.resolve_cell(spec, name, root, bench)
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_against_the_reference(tiny, name):
    line = _run(tiny, name)
    assert line["correct"], line["checks"]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    limits = harness.resolve_cell(tiny[0], name, tiny[1], tiny[2]).limits
    assert set(line["checks"]) == set(limits)
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(tiny, name):
    line = _run(tiny, name, trace=True)
    assert line["correct"]
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    spec = tiny[0]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert not set(line["metrics"]) & e2e
    allowed = {m["name"] for m in spec["per_layer"]
               if name in m.get("workloads", [name])}
    assert set(line["metrics"]) <= allowed


def test_a_new_mix_is_found_by_its_files(tiny):
    spec, root, bench = tiny
    os.makedirs(os.path.join(bench, "limits"))
    json.dump({"entry": "sgd_train", "why": "throwaway",
               "sgd": {"update_path": "fused", "host_plan": True}},
              open(os.path.join(bench, "traffic", "tiny-fused.json"), "w"))
    limits = harness.resolve_cell(spec, "ctr-train-hostplan", root,
                                  bench).limits
    json.dump(limits, open(os.path.join(bench, "limits",
                                        "ctr-train-tinyfused.json"), "w"))
    spec["workloads"].append({"name": "ctr-train-tinyfused",
                              "config": "criteo-fm-r32",
                              "traffic": "tiny-fused", "chips": 1,
                              "why": "throwaway"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ctr-train-hostplan" in m.get("workloads", []):
            m["workloads"].append("ctr-train-tinyfused")
    line = _run((spec, root, bench), "ctr-train-tinyfused")
    assert line["correct"], line["checks"]
    assert "train_examples_per_s" in line["metrics"]


# ---- the timed path broken underneath: correct must come out false


def _unchanged_step(module, attr):
    real = getattr(module, attr)

    def factory(cfg, sgd_cfg):
        step = real(cfg, sgd_cfg)

        def broken(state, batch):
            _, aux = step(dataclasses.replace(state,
                                              table=state.table.clone()),
                          batch)
            return state, aux
        return broken
    return factory


def _half_batch_step(module, attr):
    real = getattr(module, attr)

    def factory(cfg, sgd_cfg):
        step = real(cfg, sgd_cfg)

        def broken(state, batch):
            mask = batch.mask.clone()
            mask[mask.shape[0] // 2:] = False
            return step(state, dataclasses.replace(batch, mask=mask))
        return broken
    return factory


@pytest.mark.parametrize("name,attr", [
    ("ctr-train-hostplan", "make_hybrid_train_step"),
    ("ctr-train-deviceplan", "make_fused_train_step")])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step])
def test_training_faults_fail(tiny, monkeypatch, name, attr, fault):
    from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid
    module = sgd_hybrid if "hybrid" in attr else sgd_fused
    monkeypatch.setattr(module, attr, fault(module, attr))
    assert not _run(tiny, name)["correct"]


def test_als_unchanged_sweep_fails(tiny, monkeypatch):
    from sparkfm_tpu_torch.models.fm import FMParams
    from sparkfm_tpu_torch.solvers import als
    monkeypatch.setattr(als, "als_sweep_compact", lambda p, *a, **k: FMParams(
        p.w0.clone(), p.w.clone(), p.v.clone()))
    assert not _run(tiny, "ml25m-als-sweep")["correct"]


def test_als_half_of_the_ratings_fails(tiny, monkeypatch):
    from sparkfm_tpu_torch.solvers import als
    real = als.build_workspace

    def half(ds, *a, **k):
        h = ds.num_examples // 2
        return real(ds.slice(np.arange(h)), *a, **k)
    monkeypatch.setattr(als, "build_workspace", half)
    line = _run(tiny, "ml25m-als-sweep")
    assert not line["correct"]


# ---- the reference put in the program's place: the control (bfloat16)
# and the faults planted in it must fail the cell's limits


@pytest.mark.parametrize("name,stand_in", [
    ("ctr-train-hostplan", "bfloat16"), ("ctr-train-hostplan", "float32:half"),
    ("ctr-train-hostplan", "float32:stale"),
    ("ml25m-als-sweep", "bfloat16"), ("ml25m-als-sweep", "float32:half"),
    ("ml25m-als-sweep", "float32:stale")])
def test_controls_fail_the_limits(tiny, name, stand_in):
    spec, root, bench = tiny
    cell = harness.resolve_cell(spec, name, root, bench)
    ctx = harness.Context(cell, SEED, 1.0, False, torch.device("cpu"),
                          time.perf_counter())
    dtype, _, fault = stand_in.partition(":")
    readings = harness.entry_of(cell).stand_in(ctx, getattr(torch, dtype),
                                               fault or None)
    ok, checks = harness.judge(readings, cell.limits)
    assert not ok, checks


def test_the_float32_reference_in_the_programs_place_passes(tiny):
    spec, root, bench = tiny
    for name in ("ctr-train-hostplan", "ml25m-als-sweep"):
        cell = harness.resolve_cell(spec, name, root, bench)
        ctx = harness.Context(cell, SEED, 1.0, False, torch.device("cpu"),
                              time.perf_counter())
        readings = harness.entry_of(cell).stand_in(ctx, torch.float32)
        ok, checks = harness.judge(readings, cell.limits)
        assert ok, (name, checks)
