"""Fixed-capacity slot allocation for masked SoA state (port of
hslam_tpu/utils/compaction.py).

Semantics as documented there: the j-th valid candidate goes to the j-th
free slot, in index order. Unlike the JAX `scatter_update` (which sends
every unwritten candidate, with its slot's old value, to the slot of the
valid candidate before it, so duplicate scatter indices decide which write
survives), the writes here touch only the slots that are really written.
"""
from __future__ import annotations

from typing import Tuple

import torch


def assign_free_slots(free_mask: torch.Tensor, cand_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """free_mask (S,) bool, cand_mask (C,) bool -> (slots (C,) int64,
    write (C,) bool): candidate j writes to slots[j] iff write[j]."""
    S = free_mask.shape[0]
    slot_order = torch.argsort((~free_mask).to(torch.int8), stable=True)
    n_free = free_mask.sum()
    rank = torch.cumsum(cand_mask.long(), 0) - 1
    fits = cand_mask & (rank < n_free) & (rank < S)
    slots = slot_order[torch.clamp(rank, 0, S - 1)]
    return slots, fits


def scatter_update(arr: torch.Tensor, slots: torch.Tensor, write: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """Return a copy of arr with arr[slots[j]] = values[j] where write[j].

    Unwritten candidates are routed to one scratch row past the end, which
    is dropped: no real slot ever sees two writes, and no host sync is
    needed to compact the index list."""
    S = arr.shape[0]
    out = torch.cat([arr, arr[:1]], dim=0)
    idx = torch.where(write, slots, torch.full_like(slots, S))
    out[idx] = values.to(arr.dtype).expand((idx.shape[0],) + tuple(arr.shape[1:]))
    return out[:S]
