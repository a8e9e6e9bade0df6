"""Criteo-shape examples, made on the device from a seed.

One active id per field, value 1.0. Field f takes value ranks in [0, C_f)
under a Zipf law truncated at its cardinality C_f (P(r) ~ (r + 1)^-a, the
exponent ``assumed.zipf_exponent``), laid out by quantiles: every seed
gets the same count of each rank, and the seed shuffles them over the
rows, field by field. The id is the hashed bucket of the (field, value)
key: key = r + the cardinalities of the fields before f, id = bits 20.. of
key * 2654435761, mod the bucket count (a power of two). Labels are
Bernoulli from a planted logistic FM on a small projected space of the ids
(the idea of the port's ``data/synth.py::synth_ctr``, frozen here). The
planted model is the same for every seed (``planted.seed``), and its bias
is solved on the run's examples so that the mean probability is the
configuration's ``positive_rate``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

HASH = 2654435761
CHUNK = 1 << 16                 # rows scored at once by the planted model


def cardinalities(config: dict) -> List[int]:
    """Per-field value counts: the integer fields, then the categorical."""
    a = config["assumed"]
    return [int(c) for c in (a["integer_cardinalities"]
                             + a["categorical_cardinalities"])]


def bucket(key: torch.Tensor, num_buckets: int) -> torch.Tensor:
    if num_buckets & (num_buckets - 1):
        raise ValueError(f"num_buckets {num_buckets} is no power of two")
    return ((key * HASH) >> 20) & (num_buckets - 1)


def _zipf_ranks(card: int, a: float, n: int, g: torch.Generator,
                device) -> torch.Tensor:
    """The law's n quantiles, shuffled by ``g``."""
    cdf = torch.arange(1, card + 1, dtype=torch.float64,
                       device=device).pow_(-a).cumsum_(0)
    cdf /= cdf[-1].clone()
    u = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    r = torch.searchsorted(cdf, u, right=True).clamp_(max=card - 1)
    return r[torch.randperm(n, generator=g, device=device)]


def examples(config: dict, n: int, seed: int, device
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ids (n, L) int32, vals (n, L) float32, y (n,) float32) on
    ``device``; the same seed gives the same examples on one device."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    cards = cardinalities(config)
    a = float(config["assumed"]["zipf_exponent"])
    nb = int(config["num_buckets"])
    ids = torch.empty((n, len(cards)), dtype=torch.int32, device=device)
    offset = 0
    for f, card in enumerate(cards):
        r = _zipf_ranks(card, a, n, g, device)
        ids[:, f] = bucket(r + offset, nb).to(torch.int32)
        offset += card
    vals = torch.ones((n, len(cards)), dtype=torch.float32, device=device)
    y = planted_labels(config["assumed"]["planted"],
                       float(config["positive_rate"]), ids, g)
    return ids, vals, y


def planted_labels(planted: dict, rate: float, ids: torch.Tensor,
                   g: torch.Generator) -> torch.Tensor:
    """Bernoulli labels of a logistic FM on ids projected to ``proj_dim``
    rows, with N(0, w_scale) and N(0, v_scale) weights drawn from
    ``planted.seed`` and the bias that makes the mean probability
    ``rate``; ``g`` draws the labels."""
    device = ids.device
    p, k = int(planted["proj_dim"]), int(planted["k"])
    pg = torch.Generator(device=device).manual_seed(int(planted["seed"]))
    pw = torch.randn(p, generator=pg, device=device) * planted["w_scale"]
    pv = torch.randn((p, k), generator=pg, device=device) * planted["v_scale"]
    n = ids.shape[0]
    score = torch.empty(n, dtype=torch.float64, device=device)
    for s in range(0, n, CHUNK):
        proj = (ids[s:s + CHUNK].long() * HASH) % p
        vs = pv[proj]                                   # (c, L, k)
        score[s:s + CHUNK] = (pw[proj].sum(1) + 0.5 * (
            vs.sum(1).square().sum(1) - vs.square().sum((1, 2))))
    lo, hi = -60.0, 60.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if float(torch.sigmoid(score + mid).mean()) < rate:
            lo = mid
        else:
            hi = mid
    u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    return (u < torch.sigmoid(score + 0.5 * (lo + hi))).float()
