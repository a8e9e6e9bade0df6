"""The port's checkpoints (``utils/checkpoint.py::Checkpointer``) and
checkpointed, resumable ``train_sgd``, after ``tests/test_checkpoint.py``:
round trips, retention, a missing checkpoint, exact resume.

A resumed port run must equal the uninterrupted port run bit for bit, and
the JAX package's uninterrupted run from the same numpy parameters at
``tests/test_torch_trainer.py``'s tolerances (parameters rtol 1e-4, atol
1e-6 on the direct path; 2e-4 / 2e-5 on the hybrid path; losses rtol
1e-5).

One divergence from the JAX trainer, on purpose: its restore rewrites
every failure as an update-path mismatch (``sparkfm_tpu/training/
trainer.py:182-192``). The port raises the update-path ``ValueError`` only
for a checkpoint of another state layout; a missing or corrupt file
raises as itself."""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu.models.fm import FMParams as JFMParams
from sparkfm_tpu.training import trainer as jtrainer
from sparkfm_tpu_torch import FMConfig, SGDConfig, Task, train_sgd
from sparkfm_tpu_torch.data import synth as psynth
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.solvers import sgd as psgd
from sparkfm_tpu_torch.solvers import sgd_fused
from sparkfm_tpu_torch.utils import checkpoint
from sparkfm_tpu_torch.utils.checkpoint import Checkpointer, LayoutMismatch

torch.set_num_threads(1)


def _states():
    cfg = FMConfig(num_features=32, num_factors=4, seed=1)
    params = pfm.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    fused = sgd_fused.init_fused_state(cfg, device="cpu")
    fused.w0.fill_(0.5)
    fused.step.fill_(7)
    lean = psgd.pad_state_for_dedup(psgd.init_state(params, "adagrad"))
    lean.slot_v.normal_()
    return {"FusedState": fused, "SGDState": lean, "FMParams": params}


def _assert_equal(a, b):
    assert type(a) is type(b)
    ta, tb = checkpoint.state_tensors(a), checkpoint.state_tensors(b)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name
        assert ta[name].dtype == tb[name].dtype, name


@pytest.mark.parametrize("kind", ["FusedState", "SGDState", "FMParams"])
@pytest.mark.parametrize("async_save", [True, False])
def test_state_roundtrip(tmp_path, kind, async_save):
    state = _states()[kind]
    with Checkpointer(str(tmp_path / "ck"), async_save=async_save) as ck:
        ck.save(0, state, extra={"epoch": 0, "note": "hi"})
        ck.wait()
        restored, extra = ck.restore(template=state)
        bare, _ = ck.restore(0)
    _assert_equal(state, restored)
    _assert_equal(state, bare)
    assert extra == {"epoch": 0, "note": "hi"}


def test_save_copies_the_state_before_returning(tmp_path):
    """The steps after a save update the tensors in place: the checkpoint
    holds the state as it was at the save."""
    state = _states()["FusedState"]
    before = state.table.clone()
    with Checkpointer(str(tmp_path / "ck")) as ck:
        ck.save(3, state)
        state.table.add_(1.0)
        ck.wait()
        restored, extra = ck.restore()
    assert torch.equal(restored.table, before) and extra == {}


def test_latest_step_and_retention(tmp_path):
    state = _states()["FMParams"]
    with Checkpointer(str(tmp_path / "ck"), max_to_keep=2) as ck:
        for s in (0, 1, 2, 3):
            ck.save(s, state)
        ck.wait()
        assert ck.latest_step() == 3
        assert list(ck.all_steps()) == [2, 3]
        ck.save(3, state, extra={"again": True})  # a step saved again
        ck.wait()
        assert ck.all_steps() == [2, 3] and ck.restore()[1] == {
            "again": True}
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3"]


def test_restore_missing_raises(tmp_path):
    with Checkpointer(str(tmp_path / "empty")) as ck:
        assert ck.latest_step() is None and ck.all_steps() == []
        with pytest.raises(FileNotFoundError):
            ck.restore()
        ck.save(0, _states()["FMParams"])
        with pytest.raises(FileNotFoundError):
            ck.restore(5)


def test_template_mismatch_raises_layout_mismatch(tmp_path):
    states = _states()
    with Checkpointer(str(tmp_path / "ck")) as ck:
        ck.save(0, states["FusedState"])
        with pytest.raises(LayoutMismatch):
            ck.restore(template=states["SGDState"])
        other = sgd_fused.init_fused_state(
            FMConfig(num_features=33, num_factors=4), device="cpu")
        with pytest.raises(LayoutMismatch):
            ck.restore(template=other)
    assert issubclass(LayoutMismatch, ValueError)


def test_failed_save_keeps_the_last_good_checkpoint(tmp_path, monkeypatch):
    """A save that dies while writing leaves the previous step whole; the
    error comes out of wait()."""
    state = _states()["FusedState"]
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(0, state)
    ck.wait()

    def dies(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", dies)
    ck.save(1, state)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    monkeypatch.undo()
    assert ck.all_steps() == [0]
    restored, _ = ck.restore(template=state)
    _assert_equal(state, restored)
    ck.close()


def _movielens():
    return (jsynth.synth_movielens(num_users=30, num_items=40,
                                   num_examples=1000, seed=0),
            psynth.synth_movielens(num_users=30, num_items=40,
                                   num_examples=1000, seed=0))


def _numpy_params(f, k, seed=5):
    rng = np.random.default_rng(seed)
    return (np.float32(0.1), rng.normal(0, 0.05, f).astype(np.float32),
            rng.normal(0, 0.05, (f, k)).astype(np.float32))


def _jax_run(cfg_kw, sgd_kw, ds, params, task="regression"):
    w0, w, v = params
    return jtrainer.train_sgd(
        JFMConfig(task=JTask(task), **cfg_kw), JSGDConfig(**sgd_kw), ds,
        init_params=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                              v=jnp.asarray(v)))


def _port_run(cfg_kw, sgd_kw, ds, params, task="regression", **kw):
    return train_sgd(FMConfig(task=Task(task), **cfg_kw),
                     SGDConfig(**sgd_kw), ds,
                     init_params=pfm.params_from_numpy(*params,
                                                       device="cpu"),
                     device="cpu", **kw)


def _assert_same(a, b):
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(a.params, name),
                           getattr(b.params, name)), name
    assert a.history == b.history


@pytest.mark.parametrize("path,sgd_kw,tol", [
    ("direct", {}, (1e-4, 1e-6)),
    ("hybrid", dict(update_path="hybrid", steps_per_dispatch=2),
     (2e-4, 2e-5)),
])
def test_resume_reproduces_uninterrupted_run(tmp_path, path, sgd_kw, tol):
    """Interrupted after epoch 3 and resumed == the straight 6-epoch run,
    bit for bit, and == the JAX package's straight run at the trainer
    tests' tolerance."""
    if path == "direct":
        jds, pds = _movielens()
        task = "regression"
    else:
        kw = dict(num_examples=700, num_fields=5, num_buckets=1 << 17,
                  seed=4)
        jds, pds = jsynth.synth_ctr(**kw), psynth.synth_ctr(**kw)
        task = "classification"
    cfg_kw = dict(num_features=jds.num_features, num_factors=4, reg_v=0.01,
                  seed=5)
    params = _numpy_params(jds.num_features, 4)

    def mk(epochs):
        return dict(batch_size=128, epochs=epochs, learning_rate=0.1,
                    **sgd_kw)
    straight = _port_run(cfg_kw, mk(6), pds, params, task)
    ckdir = str(tmp_path / "resume_ck")
    first = _port_run(cfg_kw, mk(3), pds, params, task,
                      checkpoint_dir=ckdir)
    assert len(first.history) == 3
    resumed = _port_run(cfg_kw, mk(6), pds, params, task,
                        checkpoint_dir=ckdir, resume=True)
    _assert_same(straight, resumed)
    assert Checkpointer(ckdir).all_steps() == [3, 4, 5]

    jres = _jax_run(cfg_kw, mk(6), jds, params, task)
    rtol, atol = tol
    for g, h in zip(resumed.history, jres.history):
        np.testing.assert_allclose(g["train_loss"], h["train_loss"],
                                   rtol=1e-5)
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(resumed.params, name).numpy(),
                                   np.asarray(getattr(jres.params, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("path_kw", [
    dict(update_path="fused"), dict(update_path="sorted"),
    dict(update_path="dedup", optimizer="adam")])
def test_resume_on_the_other_paths(tmp_path, path_kw):
    """2 epochs, then a resumed call to 4, equal a straight 4-epoch run
    bit for bit on the fused, sorted and dedup (adam) paths."""
    _, pds = _movielens()
    cfg_kw = dict(num_features=pds.num_features, num_factors=4, seed=5)
    params = _numpy_params(pds.num_features, 4)

    def mk(epochs):
        return dict(dict(batch_size=256, epochs=epochs, learning_rate=0.05),
                    **path_kw)
    straight = _port_run(cfg_kw, mk(4), pds, params)
    ckdir = str(tmp_path / "ck")
    _port_run(cfg_kw, mk(2), pds, params, checkpoint_dir=ckdir)
    resumed = _port_run(cfg_kw, mk(4), pds, params, checkpoint_dir=ckdir)
    _assert_same(straight, resumed)


def test_checkpoint_every_and_resume_false(tmp_path):
    _, pds = _movielens()
    cfg_kw = dict(num_features=pds.num_features, num_factors=4, seed=5)
    params = _numpy_params(pds.num_features, 4)
    sgd_kw = dict(batch_size=256, epochs=5)
    ckdir = str(tmp_path / "ck")
    _port_run(cfg_kw, sgd_kw, pds, params, checkpoint_dir=ckdir,
              checkpoint_every=2)
    assert Checkpointer(ckdir).all_steps() == [1, 3, 4]
    fresh = _port_run(cfg_kw, sgd_kw, pds, params, checkpoint_dir=ckdir,
                      resume=False)
    assert [h["epoch"] for h in fresh.history] == [0, 1, 2, 3, 4]
    with open(os.path.join(ckdir, "4", checkpoint.EXTRA_FILE)) as f:
        assert json.load(f)["history"] == fresh.history


def test_max_seconds_writes_a_final_checkpoint(tmp_path):
    """A budget spent after the first epoch stops the run there, and that
    epoch is saved though checkpoint_every has not come round."""
    _, pds = _movielens()
    cfg_kw = dict(num_features=pds.num_features, num_factors=4, seed=5)
    params = _numpy_params(pds.num_features, 4)
    ckdir = str(tmp_path / "ck")
    res = _port_run(cfg_kw, dict(batch_size=256, epochs=50,
                                 max_seconds=1e-6),
                    pds, params, checkpoint_dir=ckdir, checkpoint_every=10)
    assert len(res.history) == 1
    ck = Checkpointer(ckdir)
    assert ck.all_steps() == [0]
    state, extra = ck.restore()
    assert extra["epoch"] == 0 and extra["history"] == res.history
    assert torch.equal(state.params.v[:pds.num_features], res.params.v)


def test_update_path_mismatch_raises_value_error(tmp_path):
    """A checkpoint written on the hybrid path (a FusedState) cannot
    resume the dedup path (an SGDState): the update-path ValueError, with
    the layout mismatch as its cause."""
    kw = dict(num_examples=300, num_fields=5, num_buckets=1 << 16, seed=2)
    pds = psynth.synth_ctr(**kw)
    cfg_kw = dict(num_features=1 << 16, num_factors=4, seed=2)
    params = _numpy_params(1 << 16, 4)
    ckdir = str(tmp_path / "ck")
    _port_run(cfg_kw, dict(batch_size=128, epochs=1, update_path="hybrid"),
              pds, params, checkpoint_dir=ckdir)
    with pytest.raises(ValueError, match="update_path") as e:
        _port_run(cfg_kw, dict(batch_size=128, epochs=2,
                               update_path="dedup"),
                  pds, params, checkpoint_dir=ckdir)
    assert isinstance(e.value.__cause__, LayoutMismatch)


def test_corrupt_or_missing_file_raises_as_itself(tmp_path):
    """Not the reference's rewrite: a corrupt state file raises
    torch.load's own error, a missing one FileNotFoundError."""
    _, pds = _movielens()
    cfg_kw = dict(num_features=pds.num_features, num_factors=4, seed=5)
    params = _numpy_params(pds.num_features, 4)
    ckdir = str(tmp_path / "ck")
    sgd_kw = dict(batch_size=256, epochs=1)
    _port_run(cfg_kw, sgd_kw, pds, params, checkpoint_dir=ckdir)
    path = os.path.join(ckdir, "0", checkpoint.STATE_FILE)
    with open(path, "wb") as f:
        f.write(b"not a checkpoint" * 8)
    with pytest.raises(pickle.UnpicklingError) as e:
        _port_run(cfg_kw, dict(sgd_kw, epochs=2), pds, params,
                  checkpoint_dir=ckdir)
    assert "update_path" not in str(e.value)
    os.remove(path)
    with pytest.raises(FileNotFoundError):
        _port_run(cfg_kw, dict(sgd_kw, epochs=2), pds, params,
                  checkpoint_dir=ckdir)


def _deepfm_run(ds, epochs, dropout=0.5, **kw):
    from sparkfm_tpu_torch.models import deepfm as DF
    cfg = DF.DeepFMConfig(fm=FMConfig(num_features=ds.num_features,
                                      num_factors=4, num_fields=5,
                                      task=Task.CLASSIFICATION, reg_w=1e-3,
                                      reg_v=1e-3, seed=11),
                          hidden=(8, 8), dropout=dropout)
    return DF.train_deepfm(cfg, SGDConfig(
        optimizer="adam", learning_rate=1e-2, batch_size=64, epochs=epochs,
        update_path="dedup"), ds,
        generator=torch.Generator().manual_seed(0), device="cpu", **kw)


def test_deepfm_adam_dropout_resume_is_bit_exact(tmp_path):
    """DeepFM under adam with dropout 0.5: 2 epochs into a checkpoint,
    then a new run resumed to 4 equals 4 straight epochs bit for bit (the
    rows' slot2 and the tower's second moments saved and restored, the
    dropout masks keyed on the restored global step)."""
    ds = psynth.synth_ctr(num_examples=200, num_fields=5,
                          num_buckets=1 << 16, seed=2)
    ck = str(tmp_path / "ck")
    _deepfm_run(ds, 2, checkpoint_dir=ck)
    saved, _ = Checkpointer(ck).restore()
    tensors = checkpoint.state_tensors(saved)
    assert {"fm.slot2_v", "fm.slot2_w", "smw2.0", "smb2.2"} <= set(tensors)
    assert tensors["fm.slot2_v"].shape == (ds.num_features + 1, 4)
    assert float(tensors["smw2.0"].abs().sum()) > 0
    resumed = _deepfm_run(ds, 4, checkpoint_dir=ck)
    straight = _deepfm_run(ds, 4)
    assert resumed.history == straight.history
    for a, b in zip(resumed.params.parameters(),
                    straight.params.parameters()):
        assert torch.equal(a, b)
    # dropout on: the run differs from one without it
    plain = _deepfm_run(ds, 4, dropout=0.0)
    assert plain.history != straight.history


def test_deepfm_checkpoint_of_the_old_layout_still_loads(tmp_path):
    """A DeepFM checkpoint written before adam's second moments existed
    (no smw2/smb2 entries) restores into a state without adam, as
    before."""
    from sparkfm_tpu_torch.models import deepfm as DF
    cfg = DF.DeepFMConfig(fm=FMConfig(num_features=64, num_factors=4,
                                      num_fields=5), hidden=(8,))
    state = DF.init_state(DF.init_params(cfg, torch.Generator().manual_seed(
        1), device="cpu"))
    assert state.smw2 == () and state.smb2 == ()
    old = {k: t.clone() for k, t in checkpoint.state_tensors(state).items()}
    assert not any(k.startswith(("smw2", "smb2")) for k in old)
    os.makedirs(tmp_path / "ck" / "3")
    torch.save({"kind": "DeepFMState", "tensors": old},
               tmp_path / "ck" / "3" / checkpoint.STATE_FILE)
    got, _ = Checkpointer(str(tmp_path / "ck")).restore(template=state)
    assert got.smw2 == () and got.smb2 == ()
    for k, t in checkpoint.state_tensors(got).items():
        assert torch.equal(t, old[k]), k
