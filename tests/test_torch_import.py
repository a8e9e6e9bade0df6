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


def test_grouped_and_checkpointed_training_with_jax_blocked(tmp_path):
    """With jax blocked: the graph, checkpoint and profiling modules
    import; train_sgd on the hybrid path with steps_per_dispatch=2 into a
    checkpoint_dir, resumed to a third epoch, equals three straight
    epochs; no kernel is built (CPU tensors)."""
    r = _run_blocked(f"""
        import torch
        import sparkfm_tpu_torch as sft
        from sparkfm_tpu_torch.data import synth
        from sparkfm_tpu_torch.ops import rowio
        from sparkfm_tpu_torch.utils import checkpoint, graphs, profiling
        ds = synth.synth_ctr(num_examples=600, num_fields=5,
                             num_buckets=1 << 16, seed=1)
        cfg = sft.FMConfig(num_features=1 << 16, num_factors=4,
                           task=sft.Task.CLASSIFICATION)
        def run(epochs, **kw):
            return sft.train_sgd(cfg, sft.SGDConfig(
                batch_size=128, epochs=epochs, steps_per_dispatch=2,
                update_path="hybrid"), ds, device="cpu", **kw)
        timer = profiling.StepTimer(sync="fetch")
        timer.start()
        run(2, checkpoint_dir={str(tmp_path / "ck")!r})
        res = run(3, checkpoint_dir={str(tmp_path / "ck")!r})
        timer.stop(res.params.w0)
        straight = run(3)
        assert res.history == straight.history
        assert torch.equal(res.params.v, straight.params.v)
        assert sorted(timer.stats()) == ["mean_ms", "p50_ms", "p95_ms",
                                         "steps"]
        print(rowio.GATHER.path, rowio.GATHER.launches)
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "None 0"


def test_data_cli_and_deepfm_import_with_jax_blocked():
    """The data pipeline, the CLI, DeepFM and its serving import with jax
    blocked, load no module of the JAX package, build no kernel, and a
    DeepFM fits, saves, loads by its tag and serves on the CPU."""
    r = _run_blocked("""
        import os, tempfile
        import sparkfm_tpu_torch.__main__
        from sparkfm_tpu_torch import cli
        from sparkfm_tpu_torch.api import DeepFMModel, FM, load_model
        from sparkfm_tpu_torch.data import (datasets, libfm, native_io,
                                            schema, vectorizer, verify)
        from sparkfm_tpu_torch.data.batching import pack_examples
        from sparkfm_tpu_torch.data.synth import synth_ctr
        from sparkfm_tpu_torch.models import deepfm
        from sparkfm_tpu_torch.ops import rowio
        from sparkfm_tpu_torch.serving import MicroBatcher
        ds = synth_ctr(num_examples=256, num_fields=4, num_buckets=1 << 16)
        m = FM(num_factors=2, num_fields=4, model="deepfm", solver="sgd",
               hidden=(4,), max_iter=1, batch_size=128,
               task="classification").fit(ds, device="cpu")
        d = tempfile.mkdtemp()
        m.save(d)
        back = load_model(d, device="cpu")
        mb = MicroBatcher(back.params, back.cfg, model="deepfm",
                          use_plans=True)
        mb.submit(ds.ids[:3], ds.vals[:3])
        assert isinstance(back, DeepFMModel)
        assert (mb.flush()[0] == back.predict(ds.ids[:3], ds.vals[:3])).all()
        bad = sorted(m for m in sys.modules
                     if m == "sparkfm_tpu" or m.startswith("sparkfm_tpu."))
        print(bad, rowio.GATHER_VW.path, rowio.GATHER_VW.launches)
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[] None 0"


def test_mcmc_relational_and_bs_als_train_with_jax_blocked():
    """With jax blocked: FM(solver="mcmc") fits; a relational dataset from
    transform_relational trains by relational SGD and by BS-ALS through the
    facade; load_movielens_relational loads; no kernel is built."""
    r = _run_blocked("""
        import numpy as np
        from sparkfm_tpu_torch import FM, MCMCConfig, Solver, TrainConfig
        from sparkfm_tpu_torch.data import datasets, schema, synth
        from sparkfm_tpu_torch.data.vectorizer import RelationVectorizer
        from sparkfm_tpu_torch.ops import segsum
        ml = synth.synth_movielens(num_users=30, num_items=40,
                                   num_examples=1500, seed=0)
        m = FM(num_factors=2, solver="mcmc", max_iter=3).fit(
            ml, eval_ds=ml, device="cpu")
        assert "eval_rmse_avg" in m.history[-1]
        fix = "tests/fixtures/ml_fixture"
        vec = RelationVectorizer([schema.Identity("user"),
                                  schema.Identity("item"),
                                  schema.Target("rating"),
                                  schema.Ignored("ts")])
        vec.add_relation(schema.read_delimited(fix + "/users.dat", "::"),
                         [schema.Target("uid"), schema.Identity("gender"),
                          schema.Identity("age"), schema.Identity("occ"),
                          schema.Ignored("zip")], join_column=0)
        rows = list(schema.read_delimited(fix + "/ratings.dat", "::"))[:800]
        rel = vec.fit(rows).transform_relational(rows)
        for solver in ("sgd", "als"):
            fit = FM(num_factors=2, solver=solver, max_iter=2,
                     batch_size=256, reg_v=0.5).fit(rel, device="cpu")
            assert np.isfinite(fit.params.v.numpy()).all()
        ds, _ = datasets.load_movielens_relational(fix, max_examples=300)
        assert ds.num_examples == 300
        print(segsum.COLSUMS.path, segsum.COLSUMS.launches)
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "None 0"


def _jax_in_rank(mesh):
    """The dry run of every sharded path, then the modules a rank holds
    that belong to jax or the JAX package."""
    from sparkfm_tpu_torch.parallel import multihost
    multihost.dryrun(mesh)
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "sparkfm_tpu" or m.startswith("sparkfm_tpu."))


def test_parallel_imports_and_runs_without_jax():
    """``sparkfm_tpu_torch.parallel.*`` imports with jax blocked, and a
    rank that runs every sharded path loads neither jax nor the JAX
    package."""
    r = _run_blocked("""
        import sparkfm_tpu_torch.parallel.mesh
        import sparkfm_tpu_torch.parallel.multihost
        import sparkfm_tpu_torch.parallel.sharded_sgd
        import sparkfm_tpu_torch.parallel.sharded_als
        import sparkfm_tpu_torch.parallel.sharded_deepfm
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    from sparkfm_tpu_torch.parallel import multihost
    assert multihost.spawn(_jax_in_rank, (2, 1), "cpu", timeout=180) == [
        [], []]
