"""FM weights made on the device from a seed, in a few large calls.

V ~ N(0, v_stdev) (F, K), w and w0 zero: float32, the type they are
trained in. The same seed gives the same weights on one device, so the reference
makes them again rather than reading the program's copy.
"""

from __future__ import annotations

from typing import Tuple

import torch


def fm_weights(num_features: int, k: int, seed: int, device, *,
               v_stdev: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w0 (), w (F,), v (F, K)) float32 on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    v = torch.randn((num_features, k), generator=g, device=device)
    v.mul_(v_stdev)
    w = torch.zeros(num_features, device=device)
    return torch.zeros((), device=device), w, v
