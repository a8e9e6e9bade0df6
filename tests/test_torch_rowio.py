"""The port's row gather against the JAX package's Pallas gather
(``gather_rows_pallas`` in interpret mode on the CPU). A gather is a copy,
so the two must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.ops import pallas_rowio as PR
from sparkfm_tpu_torch.ops import rowio
from sparkfm_tpu_torch.utils.build import BuildError

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


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    """No fallback: without a CUDA compiler the kernel build raises, and
    nothing is counted as launched."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    kernel = rowio.CudaGather()
    with pytest.raises(BuildError, match="nvcc"):
        kernel.build()
    assert kernel.launches == 0 and kernel.path is None
