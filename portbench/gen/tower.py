"""The DeepFM tower's weights made on the device from a seed: He-normal
N(0, 2 / fan_in) weights and zero biases, float32, for the layers
``tower_in -> hidden... -> 1``. The same seed gives the same weights on
one device, so the reference makes them again rather than reading the
program's copy."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch


def tower_weights(tower_in: int, hidden: Sequence[int], seed: int, device
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(weights (in, out) a layer, biases (out,) a layer) on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    dims = (int(tower_in),) + tuple(int(h) for h in hidden) + (1,)
    ws, bs = [], []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((fan_in, fan_out), generator=g, device=device)
        ws.append(w.mul_(math.sqrt(2.0 / fan_in)))
        bs.append(torch.zeros((fan_out,), device=device))
    return ws, bs
