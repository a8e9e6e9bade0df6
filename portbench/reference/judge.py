"""The numbers compared, built from the program's readings and the
reference's.

A training cell compares each step's loss (relative gap), and per leaf
(w0, w, V) the norm of a quantity as the program has it against the
reference's: the gap of the two norms, not the norm of their difference,
over the larger of the reference leaf's norm and the median leaf's. The
worst counted leaf is the number. A leaf whose reference gradient (or, for
ALS, first update) is under a thousandth of the median leaf's moves by
round-off alone and is not counted.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

SMALL_LEAF = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def counted_leaves(ref_grad_norms: Dict[str, float]) -> Iterable[str]:
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, n in ref_grad_norms.items() if n >= SMALL_LEAF * med]


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Iterable[str]) -> float:
    leaves = list(leaves)
    med = float(np.median([ref[k] for k in leaves]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
               for k in leaves)
