"""The port's entry points run on the card unless the caller asks for the
CPU: with ``torch.cuda.is_available()`` false (patched so, whatever the
machine), each one's default device raises ``RuntimeError`` naming the
missing card; none falls back to the CPU. ``device="cpu"`` runs."""

import inspect

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch import api, cli
from sparkfm_tpu_torch.config import (ALSConfig, FMConfig, MCMCConfig,
                                      SGDConfig)
from sparkfm_tpu_torch.data import relational, synth
from sparkfm_tpu_torch.models import deepfm
from sparkfm_tpu_torch.parallel import multihost
from sparkfm_tpu_torch.solvers.als import train_als
from sparkfm_tpu_torch.solvers.als_bs import train_als_relational
from sparkfm_tpu_torch.solvers.mcmc import train_mcmc
from sparkfm_tpu_torch.training.trainer import (train_sgd,
                                                train_sgd_relational)
from sparkfm_tpu_torch.utils import device as device_util

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """An FM and a DeepFM model directory, made on the CPU."""
    root = tmp_path_factory.mktemp("models")
    ml = synth.synth_movielens(num_users=10, num_items=12, num_examples=200)
    api.FM(num_factors=2, max_iter=1).fit(ml, device="cpu").save(
        str(root / "fm"))
    ctr = synth.synth_ctr(num_examples=128, num_fields=4, num_buckets=64)
    api.FM(num_factors=2, num_fields=4, model="deepfm", solver="sgd",
           hidden=(4,), max_iter=1, batch_size=64).fit(
               ctr, device="cpu").save(str(root / "deepfm"))
    return root


def _entry_points(root):
    ml = synth.synth_movielens(num_users=10, num_items=12, num_examples=200)
    ctr = synth.synth_ctr(num_examples=128, num_fields=4, num_buckets=64)
    cfg = FMConfig(num_features=ml.num_features, num_factors=2)
    dcfg = deepfm.DeepFMConfig(fm=FMConfig(num_features=64, num_factors=2,
                                           num_fields=4), hidden=(4,))
    rel = relational.RelationalDataset(
        main_ids=ml.ids[:, 1:], main_vals=ml.vals[:, 1:], y=ml.y,
        keys=ml.ids[:, :1], num_features=ml.num_features,
        tables=(relational.RelationTable(
            ids=np.arange(11, dtype=np.int32)[:, None],
            vals=(np.arange(11) < 10).astype(np.float32)[:, None]),))
    return {
        "FM.fit": lambda **kw: api.FM(num_factors=2, max_iter=1).fit(
            ml, **kw),
        "FMModel.load": lambda **kw: api.FMModel.load(str(root / "fm"),
                                                      **kw),
        "DeepFMModel.load": lambda **kw: api.DeepFMModel.load(
            str(root / "deepfm"), **kw),
        "load_model": lambda **kw: api.load_model(str(root / "deepfm"),
                                                  **kw),
        "train_sgd": lambda **kw: train_sgd(cfg, SGDConfig(epochs=1), ml,
                                            **kw),
        "train_als": lambda **kw: train_als(cfg, ALSConfig(epochs=1), ml,
                                            **kw),
        "train_deepfm": lambda **kw: deepfm.train_deepfm(
            dcfg, SGDConfig(epochs=1, batch_size=64), ctr, **kw),
        "train_mcmc": lambda **kw: train_mcmc(cfg, MCMCConfig(epochs=1),
                                              ml, **kw),
        "train_sgd_relational": lambda **kw: train_sgd_relational(
            cfg, SGDConfig(epochs=1, batch_size=64), rel, **kw),
        "train_als_relational": lambda **kw: train_als_relational(
            cfg, ALSConfig(epochs=1), rel, **kw),
        "cli": lambda **kw: cli.main(
            ["train", "--synth", "movielens", "--synth-examples", "200",
             "--iters", "1"] + (["--device", kw["device"]] if kw else [])),
        "cli --solver mcmc": lambda **kw: cli.main(
            ["train", "--synth", "movielens", "--synth-examples", "200",
             "--iters", "1", "--solver", "mcmc"]
            + (["--device", kw["device"]] if kw else [])),
        "dryrun_multichip": lambda **kw: multihost.dryrun_multichip(
            1, timeout=120, **kw),
    }


@pytest.mark.parametrize("name", ["FM.fit", "FMModel.load",
                                  "DeepFMModel.load", "load_model",
                                  "train_sgd", "train_als", "train_deepfm",
                                  "train_mcmc", "train_sgd_relational",
                                  "train_als_relational", "cli",
                                  "cli --solver mcmc", "dryrun_multichip"])
def test_default_device_is_the_card_and_raises_without_one(
        saved, monkeypatch, name, capsys):
    call = _entry_points(saved)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    out = call(device="cpu")                    # asked for: runs
    assert out is not None
    capsys.readouterr()


def test_resolve():
    assert device_util.DEFAULT == "cuda"
    assert device_util.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device_util.resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device_util.resolve()
    for fn in (api.FM.fit, api.FMModel.load, api.DeepFMModel.load,
               api.load_model, train_sgd, train_als, deepfm.train_deepfm,
               train_mcmc, train_sgd_relational, train_als_relational,
               multihost.spawn, multihost.dryrun_multichip):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__
    assert cli.build_parser().parse_args(["eval", "--model", "m", "--libfm",
                                          "f"]).device == "cuda"
