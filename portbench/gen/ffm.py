"""Field-aware FM weights and instance-normalised values, made on the
device from a seed, as LIBFFM (Juan et al. 2016) sets them up.

V ~ U(0, 1/sqrt(k)) (F, fields * k), LIBFFM's ``coef * uniform()``: each
feature's row holds one k-vector a field, field-major. w and w0 zero:
the model has no bias and no linear term, and the record keeps their
columns at 0. float32, the type they are trained in. The same seed gives
the same weights on one device, so the reference makes them again rather
than reading the program's copy.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def ffm_weights(num_features: int, fields: int, k: int, seed: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w0 (), w (F,), v (F, fields * k)) float32 on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    v = torch.empty((num_features, fields * k), device=device).uniform_(
        0.0, 1.0 / math.sqrt(k), generator=g)
    w = torch.zeros(num_features, device=device)
    return torch.zeros((), device=device), w, v


def normalized(vals: np.ndarray) -> np.ndarray:
    """Each example's values (N, L) scaled to unit length, LIBFFM's
    default instance normalisation (which scales each pair by 1 / |x|^2):
    1/sqrt(L) a slot for L one-hot fields."""
    norm = np.sqrt(np.square(vals, dtype=np.float64).sum(1, keepdims=True))
    return (vals / np.maximum(norm, 1e-300)).astype(vals.dtype)
