"""Model checkpoints: a module's tensors with ``torch.save`` and a JSON
metadata file beside them (the JAX package uses Orbax)."""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

PARAMS_FILE = "params.pt"
META_FILE = "meta.json"


def save(directory: str, state: Dict[str, torch.Tensor], meta: dict) -> None:
    """Write ``state`` (tensors, copied to the host) and ``meta``."""
    os.makedirs(directory, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               os.path.join(directory, PARAMS_FILE))
    with open(os.path.join(directory, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)


def restore(directory: str, device) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state on ``device``, meta) as written by :func:`save`."""
    state = torch.load(os.path.join(directory, PARAMS_FILE),
                       map_location=device, weights_only=True)
    with open(os.path.join(directory, META_FILE)) as f:
        meta = json.load(f)
    return state, meta
