"""The port on a CUDA card: the gather kernel against its plain version,
and the scoring paths on the card against the CPU.

These tests skip without a card. This file imports no jax, so it also
runs on a GPU machine without it, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch import FMConfig, MicroBatcher, Task
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.ops import rowio

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,width,n", [
    (1000, 1, 777), (1000, 4, 1), (100003, 32, 40960), (5000, 33, 333),
    (5000, 128, 1025)])
def test_gather_kernel_equals_plain(dev, rows, width, n):
    g = torch.Generator(device=dev).manual_seed(rows + width)
    table = torch.randn((rows, width), generator=g, device=dev)
    ids = torch.randint(0, rows, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    before = rowio.GATHER.launches
    got = rowio.gather_rows(table, ids)
    assert rowio.GATHER.launches == before + 1
    assert torch.equal(got, rowio.gather_rows_reference(table, ids))


def test_gather_kernel_misaligned_table(dev):
    table = torch.randn(600 * 4 + 1, device=dev)[1:].view(600, 4)
    ids = torch.arange(599, -1, -2, dtype=torch.int32, device=dev)
    assert torch.equal(rowio.gather_rows(table, ids),
                       rowio.gather_rows_reference(table, ids))


@pytest.mark.parametrize("feats,plan", [(100, "none"), (1 << 17, "none"),
                                        (1 << 17, "host")])
def test_scores_on_card_match_cpu(dev, feats, plan):
    rng = np.random.default_rng(feats)
    cfg = FMConfig(num_features=feats, num_factors=8,
                   task=Task.CLASSIFICATION)
    arrays = (np.float32(0.1), rng.normal(0, 0.5, feats).astype(np.float32),
              rng.normal(0, 0.3, (feats, 8)).astype(np.float32))
    ids = rng.integers(0, feats, (64, 10)).astype(np.int32)
    vals = rng.normal(size=(64, 10)).astype(np.float32)
    outs = []
    for device in ("cpu", dev):
        hp = (PE.plan_to_device(PE.host_dedup(ids, 1024, feats - 1), device)
              if plan == "host" else None)
        outs.append(pfm.predict(
            pfm.params_from_numpy(*arrays, device=device), cfg,
            torch.as_tensor(ids, device=device),
            torch.as_tensor(vals, device=device), plan=hp).cpu().numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


def test_microbatcher_on_card_runs_the_kernel(dev):
    cfg = FMConfig(num_features=1 << 17, num_factors=8,
                   task=Task.CLASSIFICATION)
    params = pfm.init_params(cfg, device=dev)
    rng = np.random.default_rng(0)
    mb = MicroBatcher(params, cfg, max_batch=256)
    for n in (1, 300, 17):
        mb.submit(rng.integers(0, 1 << 17, (n, 39)).astype(np.int32),
                  np.ones((n, 39), np.float32))
    before = rowio.GATHER.launches
    out = mb.flush()
    assert rowio.GATHER.launches - before == 2 * 2     # 2 chunks x (V, w)
    assert [o.shape for o in out] == [(1,), (300,), (17,)]
    assert all(np.all((o > 0) & (o < 1)) for o in out)
