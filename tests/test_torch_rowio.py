"""The port's row gather and row write against the JAX package's Pallas
kernels (``gather_rows_pallas`` and ``scatter_set_rows`` in interpret mode
on the CPU). Both are copies, so the two must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.ops import pallas_rowio as PR
from sparkfm_tpu_torch.ops import rowio
from sparkfm_tpu_torch.utils.build import BuildError, CudaKernel

torch.set_num_threads(1)


def _table_ids(rows, width, n, seed, fill_tail=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    ids = rng.integers(0, rows, n).astype(np.int32)
    if fill_tail:   # a plan's unused budget slots repeat the fill row
        ids[-fill_tail:] = rows - 1
    return table, ids


@pytest.mark.parametrize("rows,width,n,fill_tail", [
    (256, 128, 64, 0), (300, 32, 48, 0), (300, 32, 48, 20),
    (1000, 128, 32, 16)])
def test_gather_matches_pallas_interpret(rows, width, n, fill_tail):
    table, ids = _table_ids(rows, width, n, seed=rows + width,
                            fill_tail=fill_tail)
    want = np.asarray(PR.gather_rows_pallas(
        jnp.asarray(table), jnp.asarray(ids), tile=16, interpret=True))
    before = rowio.GATHER.launches
    got = rowio.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert rowio.GATHER.launches == before     # CPU: plain version


@pytest.mark.parametrize("n", [1, 37])
def test_gather_matches_padded_dispatch(n):
    """U that is no multiple of a tile: the JAX dispatcher pads to 1024
    and slices; the port needs no padding."""
    table, ids = _table_ids(200, 128, n, seed=n, fill_tail=min(n, 5))
    want = np.asarray(PR.gather_rows(jnp.asarray(table), jnp.asarray(ids),
                                     force="interpret"))
    got = rowio.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.shape == (n, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [1, 5, 33])
def test_any_width_matches_xla_gather(width):
    """Widths the TPU kernel does not take go to XLA there; the port's
    kernel takes them all."""
    table, ids = _table_ids(50, width, 23, seed=width, fill_tail=3)
    want = np.asarray(PR.gather_rows(jnp.asarray(table), jnp.asarray(ids)))
    got = rowio.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rowio.gather_rows_reference(torch.from_numpy(table),
                                    torch.from_numpy(ids)).numpy(), want)


def test_empty_ids():
    got = rowio.gather_rows(torch.zeros((4, 3)),
                            torch.zeros((0,), dtype=torch.int32))
    assert got.shape == (0, 3)


@pytest.mark.parametrize("table,ids,match", [
    (torch.zeros((4, 3), dtype=torch.float64),
     torch.zeros((2,), dtype=torch.int32), "float32"),
    (torch.zeros((4,)), torch.zeros((2,), dtype=torch.int32), "2-D"),
    (torch.zeros((4, 3)), torch.zeros((2,), dtype=torch.int64), "int32"),
    (torch.zeros((4, 3)), torch.zeros((2, 1), dtype=torch.int32), "1-D"),
    (torch.zeros((3, 4)).t(), torch.zeros((2,), dtype=torch.int32),
     "contiguous"),
    (torch.zeros((4, 3), device="meta"),
     torch.zeros((2,), dtype=torch.int32, device="meta"), "no kernel"),
    (torch.zeros((4, 3)), torch.zeros((2,), dtype=torch.int32,
                                      device="meta"), "ids on"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(table, ids, match):
    with pytest.raises(ValueError, match=match):
        rowio.gather_rows(table, ids)


def test_cpu_out_of_range_id_raises():
    with pytest.raises(IndexError):
        rowio.gather_rows(torch.zeros((4, 3)),
                          torch.tensor([0, 4], dtype=torch.int32))


def _fresh(kernel):
    """An unbuilt copy of a module's kernel binding."""
    return CudaKernel(kernel.library, kernel.source, kernel.symbol,
                      kernel.argtypes)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    """No fallback: without a CUDA compiler the kernel build raises, and
    nothing is counted as launched."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    kernel = _fresh(rowio.GATHER)
    with pytest.raises(BuildError, match="nvcc"):
        kernel.build()
    assert kernel.launches == 0 and kernel.path is None


def test_scatter_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    kernel = _fresh(rowio.SCATTER)
    with pytest.raises(BuildError, match="nvcc"):
        kernel.build()
    assert kernel.launches == 0 and kernel.path is None


# ---- B2: the row write-back, against the JAX package's Pallas writer

def _write_case(rows, width, n, seed, fill_tail):
    """A table, unique ids with the last `fill_tail` slots repeating the
    fill row (R - 1), and new rows: a plan's write-back."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    ids = rng.permutation(rows - 1)[:n].astype(np.int32)
    ids[n - fill_tail:] = rows - 1
    new = rng.normal(size=(n, width)).astype(np.float32)
    return table, ids, new


@pytest.mark.parametrize("width", [1, 4, 68, 128])
@pytest.mark.parametrize("fill_tail", [0, 5])
def test_scatter_matches_pallas_interpret(width, fill_tail):
    """Exact equality on every row except the fill row (the JAX package
    leaves its content unspecified when repeated), against the Pallas
    writer in interpret mode and against the JAX dispatcher; the port
    writes the fill row once, with the first of its slots' rows."""
    table, ids, new = _write_case(300, width, 48, seed=width + fill_tail,
                                  fill_tail=fill_tail)
    want = np.asarray(PR.scatter_set_rows(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(new), tile=16,
        interpret=True))
    want_dispatch = np.asarray(PR.scatter_set(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(new),
        force="interpret", unique_indices=True))
    t = torch.from_numpy(table.copy())
    before = rowio.SCATTER.launches
    got = rowio.scatter_set_rows(t, torch.from_numpy(ids),
                                 torch.from_numpy(new))
    assert got is t                              # in place
    assert rowio.SCATTER.launches == before      # CPU: plain version
    keep = slice(0, 299) if fill_tail else slice(None)
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    np.testing.assert_array_equal(got.numpy()[keep], want_dispatch[keep])
    if fill_tail:      # the first of the fill row's slots wrote it
        np.testing.assert_array_equal(got.numpy()[299], new[48 - fill_tail])


@pytest.mark.parametrize("width", [1, 68])
def test_scatter_writes_the_first_row_of_each_run(width):
    """Slot r writes only if r == 0 or ids[r] != ids[r - 1]: a device
    plan's long fill tail (budget 2^18 for ~40k uniques, cut to scale
    here) leaves the fill row equal to its first slot's row, and every
    other row equals the JAX Pallas writer's and ``scatter_set_rows_xla``'s
    on the same inputs."""
    table, ids, new = _write_case(3000, width, 2048, seed=width,
                                  fill_tail=1700)
    ids[:2048 - 1700] = np.sort(ids[:2048 - 1700])    # ascending uids
    ids[3] = ids[2]                                   # a repeat inside
    got = rowio.scatter_set_rows(torch.from_numpy(table.copy()),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(new)).numpy()
    want = table.copy()
    keep = np.r_[True, ids[1:] != ids[:-1]]
    want[ids[keep]] = new[keep]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2999], new[2048 - 1700])
    np.testing.assert_array_equal(got[ids[2]], new[2])
    for jax_out in (
            PR.scatter_set_rows(jnp.asarray(table), jnp.asarray(ids),
                                jnp.asarray(new), tile=16, interpret=True),
            PR.scatter_set_rows_xla(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(new))):
        rest = np.ones(3000, bool)
        rest[[2999, ids[2]]] = False
        np.testing.assert_array_equal(got[rest], np.asarray(jax_out)[rest])


def test_scatter_reference_is_index_copy():
    table, ids, new = _write_case(50, 3, 20, seed=1, fill_tail=0)
    want = table.copy()
    want[ids] = new
    got = rowio.scatter_set_rows_reference(torch.from_numpy(table),
                                           torch.from_numpy(ids),
                                           torch.from_numpy(new))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_empty_ids_leaves_table():
    t = torch.ones((4, 3))
    out = rowio.scatter_set_rows(t, torch.zeros((0,), dtype=torch.int32),
                                 torch.zeros((0, 3)))
    assert out is t and torch.equal(t, torch.ones((4, 3)))


@pytest.mark.parametrize("rows,match", [
    (torch.zeros((2, 4)), r"\(U, W\)"),
    (torch.zeros((2, 3), dtype=torch.float64), "float32"),
    (torch.zeros((3, 2)).t(), "contiguous"),
    (torch.zeros((2, 3), device="meta"), "device"),
])
def test_scatter_rejects_what_the_kernel_does_not_take(rows, match):
    with pytest.raises(ValueError, match=match):
        rowio.scatter_set_rows(torch.zeros((4, 3)),
                               torch.zeros((2,), dtype=torch.int32), rows)


def test_scatter_cpu_out_of_range_id_raises():
    with pytest.raises(IndexError):
        rowio.scatter_set_rows(torch.zeros((4, 3)),
                               torch.tensor([0, 4], dtype=torch.int32),
                               torch.ones((2, 3)))
