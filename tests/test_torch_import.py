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
