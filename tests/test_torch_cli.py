"""The port's command line (``sparkfm_tpu_torch/cli.py``, ``python -m
sparkfm_tpu_torch``) against the JAX package's on the same inputs, every
subcommand with ``--device cpu``: ``vectorize`` writes byte-equal files
and the same JSON; ``train``, ``eval``, ``predict`` and
``movielens-demo`` print the JAX CLI's keys with values within rtol 1e-4,
atol 1e-5 (both packages' inits patched to the same numpy weights; the
port's ``examples_per_sec`` is its own and not compared); ``verify-data``
prints the same report but for the command it names; ``train --solver
mcmc`` under the same injected draws. Also ``--mesh`` and
``--distributed`` refusing a one-process run they cannot serve, and the
DeepFM save -> eval round trip, which the JAX CLI cannot make."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu import cli as jcli
from sparkfm_tpu.api import DeepFMModel as JDeepFMModel
from sparkfm_tpu.data import libfm as jlibfm
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu.models import deepfm as JDF
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu.solvers import sgd_fused as jsgd_fused
from sparkfm_tpu_torch import cli as pcli
from sparkfm_tpu_torch.models import deepfm as PDF
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.solvers import sgd_fused as psgd_fused
from test_torch_mcmc import FakeDraws, jax_fakes  # noqa: F401 (a fixture)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ML = os.path.join(ROOT, "tests", "fixtures", "ml_fixture")
RATINGS = os.path.join(ML, "ratings.dat")
TOL = dict(rtol=1e-4, atol=1e-5)
OWN = ("examples_per_sec",)         # the port's own timing


def _weights(cfg):
    """Numpy w0, w, v for an FMConfig-shaped config (a DeepFM's tables
    are plain FM), seeded by its shape."""
    vk = cfg.num_factors * max(1, cfg.num_fields)
    rng = np.random.default_rng([cfg.num_features, vk])
    return (np.float32(0.0), np.zeros(cfg.num_features, np.float32),
            rng.normal(0, cfg.init_stdev,
                       (cfg.num_features, vk)).astype(np.float32))


def _tower(cfg):
    rng = np.random.default_rng(len(cfg.hidden))
    dims = (cfg.tower_in,) + tuple(cfg.hidden) + (1,)
    return ([rng.normal(0, np.sqrt(2 / a), (a, b)).astype(np.float32)
             for a, b in zip(dims[:-1], dims[1:])],
            [np.zeros(b, np.float32) for b in dims[1:]])


@pytest.fixture
def same_init(monkeypatch):
    """Both packages' FM, fused-record and DeepFM inits give the same
    numpy weights."""
    def jparams(cfg, key=None):
        return jfm.FMParams(*(jnp.asarray(x) for x in _weights(cfg)))

    def pparams(cfg, generator=None, *, device):
        return pfm.params_from_numpy(*_weights(cfg), device=device)
    monkeypatch.setattr(jfm, "init_params", jparams)
    monkeypatch.setattr(pfm, "init_params", pparams)
    monkeypatch.setattr(jsgd_fused, "init_fused_state",
                        lambda cfg, key=None: jsgd_fused.fused_from_params(
                            jparams(cfg), cfg))
    monkeypatch.setattr(psgd_fused, "init_fused_state",
                        lambda cfg, generator=None, *, device:
                        psgd_fused.fused_from_params(
                            pparams(cfg, device=device), cfg,
                            device=device))

    def jdeep(cfg, key=None):
        mw, mb = _tower(cfg)
        return JDF.DeepFMParams(
            fm=jparams(cfg.fm.replace(num_fields=0)),
            mlp_w=tuple(jnp.asarray(x) for x in mw),
            mlp_b=tuple(jnp.asarray(x) for x in mb))
    monkeypatch.setattr(JDF, "init_params", jdeep)
    monkeypatch.setattr(
        PDF, "init_params", lambda cfg, generator=None, *, device:
        PDF.deepfm_params_from_numpy(
            *_weights(cfg.fm.replace(num_fields=0)), *_tower(cfg),
            device=device))


def _run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def _json(out):
    return json.loads(out.strip().splitlines()[-1])


def _both(capsys, argv, tmp_path, device=True):
    """Run argv through both CLIs, each in its own directory (paths with
    {d} in them name it); returns the two outputs."""
    outs = []
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        args = [a.format(d=d) for a in argv]
        if name == "port" and device:
            args += ["--device", "cpu"]
        outs.append(_run(capsys, main, args))
    return outs


def _same_json(jout, pout, tmp_path):
    want, got = _json(jout), _json(pout)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in OWN:
            continue
        if isinstance(v, str):
            assert got[k] == v.replace(str(tmp_path / "jax"),
                                       str(tmp_path / "port")), k
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    return got


VECTORIZE = [
    ["vectorize", "--input", RATINGS, "--schema",
     "identity,identity,target,ignored", "--output", "{d}/out.libfm",
     "--save-vocab", "{d}/vocab.json", "--save-groups", "{d}/groups.json"],
    ["vectorize", "--input", RATINGS, "--schema",
     "identity,identity,target,ignored", "--output", "{d}/out.libfm",
     "--relation",
     os.path.join(ML, "users.dat") + ";target,identity,identity,identity,"
     "ignored;0", "--save-vocab", "{d}/vocab.json"],
]


@pytest.mark.parametrize("argv", VECTORIZE, ids=["plain", "relation"])
def test_vectorize_is_byte_equal(capsys, tmp_path, argv):
    jout, pout = _both(capsys, argv, tmp_path, device=False)
    _same_json(jout, pout, tmp_path)
    for name in ("out.libfm", "vocab.json", "groups.json"):
        j, p = tmp_path / "jax" / name, tmp_path / "port" / name
        assert j.exists() == p.exists()
        if j.exists():
            assert p.read_bytes() == j.read_bytes(), name


def _vectorized(capsys, tmp_path):
    _both(capsys, VECTORIZE[0], tmp_path, device=False)
    return "{d}/out.libfm"


TRAIN = {
    "als": ["--solver", "als", "--factors", "4", "--iters", "3",
            "--reg-v", "0.5"],
    "sgd": ["--solver", "sgd", "--factors", "4", "--iters", "3",
            "--lr", "0.1", "--batch-size", "2048", "--reg-v", "0.01"],
    "sgd-groups": ["--solver", "sgd", "--factors", "2", "--iters", "2",
                   "--batch-size", "2048", "--groups", "{d}/groups.json",
                   "--group-reg-v", "0.01,0.05"],
}


@pytest.mark.parametrize("solver", sorted(TRAIN))
def test_train_eval_predict_match_jax(capsys, tmp_path, same_init, solver):
    """train on the vectorized fixture with a split and --save-model, then
    eval and predict on it: the JSON and the predictions of both CLIs."""
    data = _vectorized(capsys, tmp_path)
    jout, pout = _both(capsys, ["train", "--libfm", data, "--split",
                                "0.8,0.2", "--save-model", "{d}/model",
                                *TRAIN[solver]], tmp_path)
    got = _same_json(jout, pout, tmp_path)
    assert "test_rmse" in got and got["saved_to"].endswith("port/model")
    jout, pout = _both(capsys, ["eval", "--model", "{d}/model", "--libfm",
                                data], tmp_path)
    _same_json(jout, pout, tmp_path)
    jout, pout = _both(capsys, ["predict", "--model", "{d}/model",
                                "--libfm", data, "--batch-size", "4096"],
                       tmp_path)
    np.testing.assert_allclose(np.array(pout.split(), float),
                               np.array(jout.split(), float), **TOL)
    assert len(pout.split()) == 12000
    jout, pout = _both(capsys, ["predict", "--model", "{d}/model",
                                "--libfm", data, "--output", "{d}/p.txt"],
                       tmp_path)
    _same_json(jout, pout, tmp_path)


def test_train_raw_groups_auto_matches_jax(capsys, tmp_path, same_init):
    jout, pout = _both(capsys, [
        "train", "--raw", RATINGS, "--schema",
        "identity,identity,target,ignored", "--solver", "sgd",
        "--factors", "4", "--iters", "2", "--lr", "0.1", "--batch-size",
        "2048", "--groups", "auto", "--group-reg-w", "0.01,0.05",
        "--group-reg-v", "0.02,0.1", "--split", "0.8,0.2"], tmp_path)
    _same_json(jout, pout, tmp_path)


def test_train_synth_ctr_matches_jax(capsys, tmp_path, same_init):
    """--synth ctr (2^18 buckets): the hybrid path in both packages."""
    jout, pout = _both(capsys, [
        "train", "--synth", "ctr", "--synth-examples", "3000", "--task",
        "classification", "--solver", "sgd", "--factors", "4", "--iters",
        "2", "--reg-v", "1e-6", "--batch-size", "512", "--split",
        "0.8,0.2"], tmp_path)
    got = _same_json(jout, pout, tmp_path)
    assert 0.4 <= got["test_auc"] <= 1.0


def test_movielens_demo_matches_jax(capsys, tmp_path, same_init):
    jout, pout = _both(capsys, ["movielens-demo", "--synth-examples",
                                "4000", "--iters", "3"], tmp_path)
    got = _same_json(jout, pout, tmp_path)
    assert got["train_examples"] == 3200


def test_verify_data_matches_jax(capsys, tmp_path):
    """The report of a fixture (row count below the published one: exit
    1) equal to the JAX CLI's but for the command it names."""
    for path, rc in ((os.path.join(ML, "u.data"), 1),):
        outs = []
        for main in (jcli.main, pcli.main):
            assert main(["verify-data", path]) == rc
            outs.append(json.loads(capsys.readouterr().out))
        want, got = outs
        assert got.pop("repro") == want.pop("repro").replace(
            "sparkfm_tpu train", "python -m sparkfm_tpu_torch train")
        assert got == want


def test_deepfm_save_then_eval_and_predict(capsys, tmp_path, same_init):
    """train --model deepfm --save-model D, then eval and predict --model
    D. The JAX CLI loads every model directory as a plain FM, so its eval
    fails with a KeyError on D (a known reference defect); the port's
    loads D as a DeepFM by its tag, and its eval equals the JAX package's
    DeepFMModel.load(D).evaluate on the same file."""
    ds = jsynth.synth_ctr(num_examples=2000, seed=0)
    data = str(tmp_path / "ctr.libfm")
    jlibfm.save_libfm(ds, data)
    train = ["train", "--model", "deepfm", "--fields", "16", "--hidden",
             "16,8", "--synth", "ctr", "--synth-examples", "2000",
             "--solver", "sgd", "--task", "classification", "--iters", "2",
             "--batch-size", "512", "--split", "0.8,0.2", "--save-model",
             "{d}/D"]
    jout, pout = _both(capsys, train, tmp_path)
    _same_json(jout, pout, tmp_path)
    jdir, pdir = str(tmp_path / "jax" / "D"), str(tmp_path / "port" / "D")
    with pytest.raises(KeyError):
        jcli.main(["eval", "--model", jdir, "--libfm", data])
    capsys.readouterr()
    got = _json(_run(capsys, pcli.main, ["eval", "--model", pdir, "--libfm",
                                          data, "--device", "cpu"]))
    want = JDeepFMModel.load(jdir).evaluate(jlibfm.load_libfm(
        data, num_features=1 << 18))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    preds = np.array(_run(capsys, pcli.main, [
        "predict", "--model", pdir, "--libfm", data, "--device",
        "cpu"]).split(), float)
    np.testing.assert_allclose(
        preds, JDeepFMModel.load(jdir).predict_dataset(jlibfm.load_libfm(
            data, num_features=1 << 18)), **TOL)


def test_train_mcmc_matches_jax(capsys, tmp_path, same_init, jax_fakes,
                                monkeypatch):
    """``train --solver mcmc`` prints the JAX CLI's JSON, both packages
    from the same initial weights and under the same injected draws
    (``tests/test_torch_mcmc.py``: JAX unjitted with its normal and gamma
    patched, the port's default draw source replaced)."""
    from sparkfm_tpu_torch.solvers import mcmc as pmcmc
    monkeypatch.setattr(pmcmc, "TorchDraws", lambda generator: FakeDraws())
    jout, pout = _both(capsys, [
        "train", "--synth", "movielens", "--synth-examples", "1500",
        "--solver", "mcmc", "--iters", "3", "--factors", "4", "--split",
        "0.8,0.2"], tmp_path)
    got = _same_json(jout, pout, tmp_path)
    assert np.isfinite(got["test_rmse"])


@pytest.mark.parametrize("extra,error,match", [
    pytest.param(["--solver", "sgd", "--mesh", "2x1"], ValueError,
                 "world of 2 processes", id="extra0-A15"),
    pytest.param(["--solver", "sgd", "--distributed"], SystemExit,
                 "torchrun", id="extra1-A15"),
])
def test_unported_options_raise(extra, error, match):
    """``--mesh`` and ``--distributed`` (ported since A15) in a one-process
    run without torchrun: a mesh larger than 1 x 1 raises naming the
    world it needs, and ``--distributed`` exits naming torchrun."""
    with pytest.raises(error, match=match):
        pcli.main(["train", "--synth", "movielens", "--synth-examples",
                   "500", "--device", "cpu", *extra])


def test_parse_schema_matches_jax():
    spec = "target,identity,list:|,number,time,hashed:64,ignored"
    got, want = pcli.parse_schema(spec), jcli.parse_schema(spec)
    assert [(c.kind.value, c.name, c.separator, c.num_buckets)
            for c in got] == [(c.kind.value, c.name, c.separator,
                               c.num_buckets) for c in want]
    for mod in (pcli, jcli):
        with pytest.raises(ValueError, match="unknown column kind"):
            mod.parse_schema("identity,bogus")


def test_module_entry_runs_and_defaults_to_the_card(tmp_path):
    """``python -m sparkfm_tpu_torch`` with jax blocked: --help lists the
    JAX CLI's subcommands; train with --device cpu prints its JSON; train
    without --device asks for the card, which this machine lacks when
    ``torch.cuda.is_available()`` is false, and fails naming it."""
    prog = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.argv = ['sparkfm_tpu_torch'] + sys.argv[1:]; "
            "runpy.run_module('sparkfm_tpu_torch', run_name='__main__')")

    def run(*args):
        return subprocess.run([sys.executable, "-c", prog, *args], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
    r = run("--help")
    assert r.returncode == 0, r.stderr
    for cmd in ("train", "vectorize", "eval", "predict", "verify-data",
                "movielens-demo"):
        assert cmd in r.stdout
    r = run("train", "--synth", "movielens", "--synth-examples", "800",
            "--iters", "2", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "examples_per_sec" in json.loads(r.stdout.splitlines()[-1])
    if not torch.cuda.is_available():
        r = run("train", "--synth", "movielens", "--synth-examples", "800")
        assert r.returncode != 0 and "no CUDA device" in r.stderr
