"""Sums into bins with a fixed order (the port's `jax.ops.segment_sum`).

A float `index_add_` on CUDA adds in no fixed order (ROADMAP C4), and one
differing bit grows into another trajectory over a long sequence (C11,
C14). Here the entries are sorted by bin once, summed in float64 as a
running sum, and each bin's total is read at its last entry, so it is
rounded once to the values' dtype: the same bits on every run and in any
order of the entries. `SortedBins` keeps the sort, for a solver that sums
by the same indices many times (a CG loop); `bin_sums` is the one-off.
"""
from __future__ import annotations

import torch


class SortedBins:
    """Sums of values into `size` bins by the bin indices `idx` (N,)."""

    def __init__(self, idx: torch.Tensor, size: int):
        n = idx.shape[0]
        dev = idx.device
        self.size = size
        self.order = torch.argsort(idx, stable=True)
        i = idx[self.order]
        new_bin = torch.ones(n, dtype=torch.bool, device=dev)
        new_bin[1:] = i[1:] != i[:-1]
        last = torch.ones_like(new_bin)
        last[:-1] = new_bin[1:]
        pos = torch.arange(n, device=dev)
        self.start = torch.cummax(torch.where(new_bin, pos, 0), 0).values
        # the other entries land in a row that is dropped
        self.dest = torch.where(last, i, size)

    def sum_sorted(self, v: torch.Tensor) -> torch.Tensor:
        """Bin sums (size, ...) in float64 of values (N, ...) already in
        the sorted order (`vals[self.order]`). The running sum runs along
        the innermost dimension: on CUDA a scan along an outer one is a
        sequential loop over the entries."""
        rest = tuple(v.shape[1:])
        vt = v.double().reshape(v.shape[0], -1).T.contiguous()         # (C, N)
        cs = torch.cumsum(vt, 1)
        total = cs - (cs - vt)[:, self.start]    # inclusive sum since the bin's start
        out = torch.zeros((vt.shape[0], self.size + 1), dtype=torch.float64,
                          device=v.device)
        out[:, self.dest] = total
        return out[:, :self.size].T.contiguous().reshape((self.size,) + rest)

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        """Bin sums (size, ...) of values (N, ...), in their dtype."""
        return self.sum_sorted(vals[self.order]).to(vals.dtype)


def bin_sums(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """vals (N, ...) summed into `size` bins by idx (N,)."""
    return SortedBins(idx, size)(vals)
