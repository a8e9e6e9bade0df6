"""The port's metrics against the JAX package's on the same numpy inputs,
with and without a validity mask; AUC also with tied scores.

Tolerance rtol 1e-5, atol 1e-6: float32 sums in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.ops import metrics as JM
from sparkfm_tpu_torch.ops import metrics as PM

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, n=200, ties=False):
    rng = np.random.default_rng(seed)
    pred = rng.random(n).astype(np.float32)
    if ties:
        pred = np.round(pred * 8) / 8          # few distinct scores
    target = (rng.random(n) < 0.4).astype(np.float32)
    mask = rng.random(n) < 0.8
    return pred, target, mask


@pytest.mark.parametrize("name", ["rmse", "mae", "accuracy", "auc",
                                  "logloss"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_metric_matches_jax(name, masked, ties):
    pred, target, mask = _inputs(seed=len(name), ties=ties)
    jmask = jnp.asarray(mask) if masked else None
    pmask = torch.from_numpy(mask) if masked else None
    want = float(getattr(JM, name)(jnp.asarray(pred), jnp.asarray(target),
                                   mask=jmask))
    got = getattr(PM, name)(torch.from_numpy(pred), torch.from_numpy(target),
                            mask=pmask)
    np.testing.assert_allclose(got.item(), want, **TOL)


def test_auc_single_class_is_half():
    s = torch.tensor([0.1, 0.5, 0.9])
    assert PM.auc(s, torch.zeros(3)).item() == 0.5
    assert PM.auc(s, torch.ones(3)).item() == 0.5


def test_auc_masked_entries_do_not_count():
    """A masked entry with an extreme score changes nothing."""
    s = torch.tensor([0.2, 0.8, 0.4, float("inf")])
    y = torch.tensor([0.0, 1.0, 1.0, 0.0])
    mask = torch.tensor([True, True, True, False])
    assert PM.auc(s, y, mask).item() == 1.0
    assert PM.auc(s[:3], y[:3]).item() == 1.0
