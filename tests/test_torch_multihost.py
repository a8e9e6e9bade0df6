"""Multi-process runs of the port: ``python -m sparkfm_tpu_torch train
--mesh ... --distributed`` under ``torchrun`` (two gloo ranks on this CPU)
against the one-process run, a one-process run refusing a mesh it cannot
form, and the dry run of every sharded path
(``parallel/multihost.py::dryrun``, the port's analogue of
``__graft_entry__.py::dryrun_multichip``) on 8 ranks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch.cli import main
from sparkfm_tpu_torch.parallel import multihost as MH

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["train", "--synth", "movielens", "--synth-examples", "3000",
         "--solver", "sgd", "--factors", "4", "--iters", "3",
         "--batch-size", "128", "--lr", "0.1", "--split", "0.8,0.2",
         "--device", "cpu"]


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def test_torchrun_two_ranks_match_one_process(tmp_path):
    """Two ranks of a 2 x 1 mesh under torchrun train what one process
    trains on the 1 x 1 mesh: the same batches and padding, the sums in
    another order. Rank 0 alone prints and saves."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
         "--master-port", str(MH.free_port()), "-m", "sparkfm_tpu_torch",
         *TRAIN, "--mesh", "2x1", "--distributed",
         "--save-model", str(tmp_path / "model")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, run.stdout
    two = json.loads(lines[0])
    assert os.path.isdir(tmp_path / "model")

    one = subprocess.run([sys.executable, "-m", "sparkfm_tpu_torch", *TRAIN,
                          "--mesh", "1x1"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-3000:]
    one = _json_line(one.stdout)
    assert set(one) == set(two) - {"saved_to"}
    for key in ("test_rmse", "test_mae"):
        np.testing.assert_allclose(two[key], one[key], rtol=1e-4, atol=2e-6)
    assert two["train_examples"] == one["train_examples"]


def test_one_process_refuses_a_larger_mesh(capsys):
    """Without torchrun a 2 x 1 mesh cannot form: the run raises and names
    the world it needs; --distributed without torchrun's environment
    exits with a message."""
    with pytest.raises(ValueError, match="world of 2 processes"):
        main([*TRAIN, "--mesh", "2x1"])
    with pytest.raises(SystemExit, match="torchrun"):
        main([*TRAIN, "--mesh", "1x1", "--distributed"])


def test_dryrun_every_sharded_path_on_8_ranks():
    out = MH.dryrun_multichip(8, "cpu", timeout=300)
    assert list(out) == [
        "unique step loss", "sharded score mean", "global step loss",
        "global hybrid step loss", "ALS sweep mean |v|",
        "MCMC eval_rmse_avg", "per-group L2 step loss",
        "FFM unique step loss", "FFM global step loss",
        "DeepFM unique step loss", "DeepFM global step loss"]
    assert all(np.isfinite(v) for v in out.values())
