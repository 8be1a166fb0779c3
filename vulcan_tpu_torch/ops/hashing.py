"""Spatial hashing for voxel blocks.

Counterpart of ``vulcan_tpu/ops/hashing.py``: packed-code open addressing
with triangular probing, and the reference's deterministic parallel
insertion.  In each probe round the lowest candidate row that targets a
slot wins it (a scatter-min over slots), and new block indices are handed
out in cumsum order -- NOT an atomicCAS insert, whose winners depend on
thread timing and would break array-for-array parity with the reference
for every later stage.

Table layout: ``codes`` (hash_size,) int32 packed block coord (EMPTY_CODE =
empty) and ``values`` (hash_size,) int32 block storage index.  The hash is
``(x * 73856093 ^ y * 19349669 ^ z * 83492791) mod hash_size``.
"""
from __future__ import annotations

import torch

from ..config import Config

EMPTY_CODE = 0x7FFFFFFF  # == blocks.INVALID_CODE

_P1 = 73856093
_P2 = 19349669
_P3 = 83492791
_U32 = 0xFFFFFFFF


def hash_coords(coords: torch.Tensor, hash_size: int) -> torch.Tensor:
    """Block coords (..., 3) int32 -> slot (...,) int64 in [0, hash_size).

    The reference multiplies in uint32; torch's uint32 lacks most kernels,
    so this works in int64 masked to 32 bits -- the low bits are the same.
    """
    c = coords.to(torch.int64) & _U32
    h = ((c[..., 0] * _P1) & _U32) ^ ((c[..., 1] * _P2) & _U32) ^ (
        (c[..., 2] * _P3) & _U32
    )
    return h & (hash_size - 1)


def probe_slot(slot0: torch.Tensor, p: int, hash_size: int) -> torch.Tensor:
    """p-th probe position: triangular probing, full-cycle on 2^k tables."""
    return (slot0 + (p * (p + 1)) // 2) & (hash_size - 1)


def lookup_codes(table_codes, values, qcodes, slot0, config: Config):
    """Batched lookup by packed code.  Returns (block_idx, found);
    block_idx is -1 where absent."""
    live = torch.ones(qcodes.shape, dtype=torch.bool, device=qcodes.device)
    hit_slot = torch.zeros(qcodes.shape, dtype=torch.int64, device=qcodes.device)
    found = torch.zeros_like(live)
    for p in range(config.max_probes):
        slot = probe_slot(slot0, p, config.hash_size)
        c = table_codes[slot]
        match = c == qcodes
        hit = live & match
        hit_slot = torch.where(hit, slot, hit_slot)
        found = found | hit
        # An empty slot ends the probe chain (no deletions ever).
        live = live & ~match & (c != EMPTY_CODE)
    idx = torch.where(found, values[hit_slot], -1)
    return idx, found


def lookup(table_codes, values, coords: torch.Tensor, config: Config):
    """Lookup by block coords (..., 3): packs and bounds-checks them, then
    ``lookup_codes``.  Returns (block_idx, found); -1 where absent or out
    of bounds."""
    from . import blocks as B

    inb = B.coords_in_bounds(coords)
    qcodes = torch.where(inb, B.pack_block_coords(coords), EMPTY_CODE)
    slot0 = hash_coords(coords, config.hash_size)
    idx, found = lookup_codes(table_codes, values, qcodes, slot0, config)
    found = found & inb
    return torch.where(found, idx, -1), found


def insert_unique(table_codes, values, free_count, coords, want, config: Config):
    """Insert up to N *unique* block coords; allocate block slots in order.

    Args/returns as the reference: ``free_count`` is a 0-d int32 tensor
    (next free block index); ``coords`` (N, 3) int32 candidates without
    duplicates, ``want`` (N,) bool.  Returns (table_codes, values,
    free_count, inserted_idx (N,) int32 with -1 where not inserted, ok (N,)
    bool -- False where the probe bound or block capacity ran out).
    """
    from . import blocks as B

    n = coords.shape[0]
    hs = config.hash_size
    cap = config.num_blocks
    dev = coords.device

    qcodes = torch.where(want, B.pack_block_coords(coords), EMPTY_CODE)
    slot0 = hash_coords(coords, hs)

    existing_idx, exists = lookup_codes(table_codes, values, qcodes, slot0, config)
    exists = exists & want
    pending = want & ~exists
    assigned = torch.where(exists, existing_idx, -1)

    row_ids = torch.arange(n, dtype=torch.int32, device=dev)

    # Capacity gate BEFORE probing: rows beyond the free block slots never
    # claim a hash slot, so no rollback is ever needed.
    remaining = cap - free_count
    order_pending = torch.cumsum(pending.to(torch.int32), 0) - 1
    pending = pending & (order_pending < remaining)

    # The tables get one trash slot (index hs) for masked scatters; only it
    # ever sees duplicate indices, so every real slot stays deterministic.
    codes_t = torch.cat([table_codes, table_codes.new_full((1,), EMPTY_CODE)])
    claimed_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for p in range(config.max_probes):
        slot = probe_slot(slot0, p, hs)
        claimable = pending & (codes_t[slot] == EMPTY_CODE)
        # Contention: the lowest candidate row targeting a slot wins it.
        winner = torch.full((hs + 1,), n, dtype=torch.int32, device=dev)
        winner.scatter_reduce_(
            0, torch.where(claimable, slot, hs), row_ids, "amin"
        )
        is_winner = claimable & (winner[slot] == row_ids)
        codes_t.index_put_((torch.where(is_winner, slot, hs),), qcodes)
        claimed_slot = torch.where(is_winner, slot, claimed_slot)
        pending = pending & ~is_winner

    # Dense, gap-free block-index assignment over the actual winners.
    success = claimed_slot >= 0
    order = torch.cumsum(success.to(torch.int32), 0) - 1
    new_block_idx = torch.where(success, free_count + order, -1).to(torch.int32)
    values_t = torch.cat([values, values.new_zeros(1)])
    values_t.index_put_((torch.where(success, claimed_slot, hs),), new_block_idx)
    assigned = torch.where(success, new_block_idx, assigned).to(torch.int32)

    ok = ~want | exists | success
    free_count = (free_count + success.sum()).to(torch.int32)
    return codes_t[:hs], values_t[:hs], free_count, assigned, ok
