"""xDeepFM's CIN weights made on the device from a seed: W^k (H_k,
H_{k-1} m) with H_0 = m fields, then w_cin (sum H_k,), each
Glorot-uniform U(-b, b), b = sqrt(6 / (fan_in + fan_out)), with fans
(H_{k-1} m, H_k) and (sum H_k, 1): float32. The same seed gives the same
weights on one device, so the reference makes them again rather than
reading the program's copy."""

from __future__ import annotations

import math
from typing import List, Sequence

import torch


def cin_weights(fields: int, widths: Sequence[int], seed: int,
                device) -> List[torch.Tensor]:
    """[W^1, ..., W^K, w_cin] on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    shapes, prev = [], int(fields)
    for h in widths:
        shapes.append(((int(h), prev * int(fields)), prev * int(fields),
                       int(h)))
        prev = int(h)
    total = sum(int(h) for h in widths)
    shapes.append(((total,), total, 1))
    out = []
    for shape, fan_in, fan_out in shapes:
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=g, device=device)
        out.append(u.mul_(2.0 * bound).sub_(bound))
    return out
