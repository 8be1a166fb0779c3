"""Counted device->host reads.

The reference runs its data-dependent loops (the integrate chunks, the two
splat tiers) as ``lax.while_loop``s on device counts.  Eager PyTorch needs
each trip count on the host, which waits for the device.  Every such read
goes through ``read_int`` so a run can report how many it made per frame
(``read_int.count``); a later change that removes them (for CUDA graphs)
shows up there.
"""
from __future__ import annotations

import torch


def read_int(t: torch.Tensor) -> int:
    """Read a 0-d integer tensor on the host (a device sync on CUDA)."""
    read_int.count += 1
    return int(t.item())


read_int.count = 0


def read_ints(*ts: torch.Tensor) -> list[int]:
    """Read several 0-d integer tensors in ONE transfer (counted once)."""
    read_int.count += 1
    return [int(v) for v in torch.stack(list(ts)).tolist()]
