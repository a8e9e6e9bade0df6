"""The device an entry point runs on.

Entry points (``FM.fit``, ``FMModel.load``, ``DeepFMModel.load``,
``train_sgd``, ``train_als``, ``train_deepfm``, ``parallel.multihost.spawn``
and ``dryrun_multichip``, and the CLI) run on the
card unless the caller asks for another device: their ``device`` defaults
to ``"cuda"``. Without a card that default raises; nothing falls back to
the CPU, which must be asked for (``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises
    ``RuntimeError`` when ``torch.cuda.is_available()`` is false."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device={str(device)!r}: this entry point "
            "runs on the card unless asked otherwise; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU")
    return device
