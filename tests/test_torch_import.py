"""The port imports without jax and without the JAX package."""

import os
import pkgutil
import subprocess
import sys
import textwrap

import sparkfm_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_blocked(code: str) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter where importing jax fails."""
    prog = "import sys\nsys.modules['jax'] = None\n" + textwrap.dedent(code)
    return subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_imports_with_jax_blocked():
    r = _run_blocked("""
        import sparkfm_tpu_torch
        import sparkfm_tpu_torch.ops.rowio
        import sparkfm_tpu_torch.serving
        import sparkfm_tpu_torch.api
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_every_module_imports_without_jax_or_reference():
    names = [m.name for m in pkgutil.walk_packages(
        sparkfm_tpu_torch.__path__, "sparkfm_tpu_torch.")]
    assert "sparkfm_tpu_torch.ops.rowio" in names
    r = _run_blocked(f"""
        import importlib
        for name in {names!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "sparkfm_tpu" or m.startswith("sparkfm_tpu."))
        print(bad)
    """)
    assert r.returncode == 0, r.stderr
    # jax stays None in sys.modules (blocked); nothing else may appear
    assert r.stdout.strip() == "['jax']"


def test_import_builds_nothing():
    """Importing the package compiles no kernel: building happens at the
    first call that needs the library."""
    r = _run_blocked("""
        import sparkfm_tpu_torch.ops.rowio as rowio
        print(rowio.GATHER.path, rowio.GATHER.launches)
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "None 0"


def test_training_slice_imports_with_jax_blocked():
    r = _run_blocked("""
        import sparkfm_tpu_torch.solvers.sgd_hybrid
        import sparkfm_tpu_torch.ops.segsum as segsum
        import sparkfm_tpu_torch.ops.rowio as rowio
        import sparkfm_tpu_torch.training.trainer
        from sparkfm_tpu_torch import SGDConfig, evaluate, train_sgd
        kernels = (rowio.GATHER, rowio.SCATTER, segsum.FACTORED)
        print([(k.path, k.launches) for k in kernels])
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[(None, 0), (None, 0), (None, 0)]"


def test_als_slice_imports_with_jax_blocked():
    """The ALS solver, the facade, the data helpers and B7 import without
    jax, and importing them builds no kernel."""
    r = _run_blocked("""
        import sparkfm_tpu_torch.solvers.als
        import sparkfm_tpu_torch.data.split
        import sparkfm_tpu_torch.data.synth
        import sparkfm_tpu_torch.ops.segsum as segsum
        from sparkfm_tpu_torch import FM, ALSConfig, train_als
        from sparkfm_tpu_torch.data.synth import synth_movielens
        print(segsum.COLSUMS.path, segsum.COLSUMS.launches)
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "None 0"


def test_direct_dedup_and_ffm_train_with_jax_blocked():
    """With jax blocked: train_sgd under "auto" on a small MovieLens set
    (the direct path) and FM(solver="sgd") with no pinned path train;
    FM(num_fields=...) fits and predicts; adam and momentum train on the
    dedup path; importing and training build no kernel (CPU tensors)."""
    r = _run_blocked("""
        import numpy as np
        import sparkfm_tpu_torch as sft
        from sparkfm_tpu_torch.data import synth
        from sparkfm_tpu_torch.ops import segsum
        from sparkfm_tpu_torch.solvers import sgd
        ml = synth.synth_movielens(num_users=40, num_items=50,
                                   num_examples=2000, seed=0)
        cfg = sft.FMConfig(num_features=ml.num_features, num_factors=4,
                           reg_v=0.01)
        sgd_cfg = sft.SGDConfig(batch_size=256, epochs=3,
                                learning_rate=0.1)
        assert sgd.resolve_update_path(cfg, sgd_cfg) == "direct"
        res = sft.train_sgd(cfg, sgd_cfg, ml, device="cpu")
        losses = [h["train_loss"] for h in res.history]
        assert losses[-1] < losses[0], losses
        model = sft.FM(num_factors=4, solver="sgd", max_iter=3,
                       batch_size=256, learning_rate=0.1,
                       reg_v=0.01).fit(ml, device="cpu")
        assert np.isfinite(model.compute_rmse(ml))
        ctr = synth.synth_ctr(num_examples=512, num_fields=4,
                              num_buckets=256, seed=1)
        ffm = sft.FM(num_factors=2, num_fields=4, solver="sgd",
                     max_iter=2, batch_size=128, task="classification",
                     reg_v=0.001).fit(ctr, device="cpu")
        p = ffm.predict(ctr.ids[:8], ctr.vals[:8], ctr.field_ids[:8])
        assert ffm.cfg.slot_major_fields and p.shape == (8,)
        big = sft.FMConfig(num_features=1 << 16, num_factors=2,
                           task=sft.Task.CLASSIFICATION)
        ctr = synth.synth_ctr(num_examples=512, num_fields=4,
                              num_buckets=1 << 16, seed=2)
        for kw in (dict(optimizer="adam"),
                   dict(optimizer="sgd", momentum=0.9)):
            run_cfg = sft.SGDConfig(batch_size=128, epochs=1, **kw)
            assert sgd.resolve_update_path(big, run_cfg) == "dedup"
            res = sft.train_sgd(big, run_cfg, ctr, device="cpu")
            assert np.isfinite(res.history[-1]["train_loss"])
        print(segsum.ROWSUM_SQ.path, segsum.ROWSUM_SQ.launches)
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "None 0"
