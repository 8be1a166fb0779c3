"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    With no card and no ``device`` this raises instead of moving to the
    CPU: a run that silently fell back would report CPU numbers as the
    card's.  Pass ``device="cpu"`` to run the plain versions on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: vulcan_tpu_torch runs on the card by default; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")
