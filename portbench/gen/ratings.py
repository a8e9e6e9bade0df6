"""MovieLens-25M-shape ratings from a seed, drawn on the device.

How many ratings each user and each movie has follows a fixed law of rank
(``rating_counts`` in the configuration), the same for every seed:

    count(r) = floor + A ((r + offset)^-exponent - (n + offset)^-exponent)

for ranks r = 1..n (from 2 where the configuration pins the first count),
with A set so that the counts sum to ``num_ratings``, rounded to whole
ratings by largest remainder. The least count is ``floor`` and the law's
exponent and offset were fitted once to the published figures the
configuration lists (``fit_law``). A seed decides which user or movie takes
each rank, pairs the users' ratings with the movies' at random and draws
each rating, uniform over the half stars 0.5 to 5. Slot 0 holds the user
id, slot 1 the movie id offset by the user count.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _shape(n: int, law: dict) -> Tuple[np.ndarray, float]:
    """The law's rank terms x(r) (from the first free rank) and the count
    pinned before them (0 where none is)."""
    first = law.get("first")
    r = np.arange(1 if first is None else 2, n + 1, dtype=np.float64)
    s, q = float(law["exponent"]), float(law["offset"])
    return (r + q) ** -s - (n + q) ** -s, float(first or 0)


def counts(n: int, total: int, law: dict) -> np.ndarray:
    """(n,) int64 counts by rank, summing to ``total``."""
    x, first = _shape(n, law)
    floor = float(law["floor"])
    extra = total - first - floor * x.size
    if extra < 0:
        raise ValueError(f"{total} ratings cannot give {n} items "
                         f"{law['floor']} each")
    c = np.concatenate([[first] if first else [],
                        floor + x * (extra / x.sum())])
    out = np.floor(c).astype(np.int64)
    short = total - int(out.sum())
    out[np.argsort(-(c - out), kind="stable")[:short]] += 1
    return out


def fit_law(n: int, total: int, floor: float, anchors, first=None):
    """(exponent, offset) of the law whose counts at two ranks hold the
    given ``anchors`` ((rank, count), (rank, count)) while all counts sum
    to ``total``: how the configuration's law was found (needs scipy)."""
    from scipy.optimize import brentq
    (ra, ca), (rb, cb) = anchors
    r0 = 1 if first is None else 2
    rest = total - floor * (n - r0 + 1) - (first or 0)

    def term(r, s, q):
        return (r + q) ** -s - (n + q) ** -s

    def offset_for(s):
        ratio = (ca - floor) / (cb - floor)
        return brentq(lambda q: term(ra, s, q) / term(rb, s, q) - ratio,
                      -r0 + 1e-9, 1e7)

    def miss(s):
        x, _ = _shape(n, {"exponent": s, "offset": offset_for(s),
                          "first": first})
        return x.sum() * (ca - floor) / x[ra - r0] - rest

    grid = np.linspace(0.3, 4.0, 75)
    vals = []
    for s in grid:
        try:
            vals.append(miss(s))
        except ValueError:
            vals.append(np.nan)
    for i in range(len(grid) - 1):
        if vals[i] * vals[i + 1] < 0:
            s = brentq(miss, grid[i], grid[i + 1])
            return s, offset_for(s)
    raise ValueError("no law holds these anchors")


def ratings(config: dict, seed: int, device
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids (n, 2) int32, vals (n, 2) float32, y (n,) float32) on the
    host, drawn on ``device``."""
    n = int(config["num_ratings"])
    users, movies = int(config["num_users"]), int(config["num_movies"])
    laws = config["rating_counts"]
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))

    def column(count: int, law: dict) -> torch.Tensor:
        c = torch.as_tensor(counts(count, n, law), device=device)
        who = torch.randperm(count, generator=g, device=device)
        col = torch.repeat_interleave(who, c)
        return col[torch.randperm(n, generator=g, device=device)]

    uid = column(users, laws["users"])
    mid = column(movies, laws["movies"])
    ids = torch.stack([uid, users + mid], dim=1).to(torch.int32)
    y = torch.randint(1, 11, (n,), generator=g, device=device).float() * 0.5
    return (ids.cpu().numpy(), np.ones((n, 2), np.float32),
            y.cpu().numpy())
