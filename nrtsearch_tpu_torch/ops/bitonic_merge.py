"""Compare-exchange stages of the bitonic merge, with their CUDA kernels.

Counterpart: nrtsearch_tpu/ops/pallas_merge.py (``far_stage``,
``near_stages``, ``merge_level_pallas``). The (docs, contribs) pair moves
together over [B, N]; stages run in place.

- ``near_stages``: every stage d0, d0/2, ..., 1 inside one on-chip tile
  (csrc/bitonic_merge.cu). The TPU tile holds 2^17 pairs in VMEM; a Hopper
  block holds at most 227 KB of shared memory, so the port's tile is
  ``NEAR_TILE`` pairs (64 KB), or the whole row when it is shorter.
- ``far_stage``: one stage at a distance d >= the tile.
- ``merge_level``: one merge level as far stages down to the tile, then one
  near pass (the counterpart of ``merge_level_pallas``).

Each has a plain torch twin (``*_twin``). The dispatching functions take the
twin only for CPU tensors; CUDA tensors go to the kernel, which raises on
what it does not take. The tie rule is the reference's: swap only when
lo > hi strictly, so equal docs keep their stream order.
"""

from __future__ import annotations

import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.device import on_cuda

NEAR_TILE = 8192  # pairs per shared-memory tile: 8192 x (4 + 4) B = 64 KB


def far_stage_twin(docs: torch.Tensor, contribs: torch.Tensor, d: int,
                   m: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch compare-exchange at distance d over [B, N], in place.
    ``m``: alternating-direction sort-block size (0 = ascending)."""
    B, N = docs.shape
    nblk = N // (2 * d)
    dv = docs.view(B, nblk, 2, d)
    cv = contribs.view(B, nblk, 2, d)
    lo_d, hi_d = dv[:, :, 0, :], dv[:, :, 1, :]
    swap = lo_d > hi_d
    if m and m < N:
        start = torch.arange(nblk, device=docs.device, dtype=torch.int64) * (2 * d)
        desc = (start & m) != 0
        swap = swap != desc[None, :, None]
    new_lo, new_hi = torch.where(swap, hi_d, lo_d), torch.where(swap, lo_d, hi_d)
    lo_c, hi_c = cv[:, :, 0, :], cv[:, :, 1, :]
    new_lo_c, new_hi_c = torch.where(swap, hi_c, lo_c), torch.where(swap, lo_c, hi_c)
    dv[:, :, 0, :] = new_lo
    dv[:, :, 1, :] = new_hi
    cv[:, :, 0, :] = new_lo_c
    cv[:, :, 1, :] = new_hi_c
    return docs, contribs


def near_stages_twin(docs: torch.Tensor, contribs: torch.Tensor, d0: int,
                     m: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch stages d0 down to 1, in place."""
    d = d0
    while d >= 1:
        far_stage_twin(docs, contribs, d, m)
        d //= 2
    return docs, contribs


def near_tile(n: int) -> int:
    """The shared-memory tile for a row of n pairs."""
    return min(NEAR_TILE, n)


def far_stage(docs: torch.Tensor, contribs: torch.Tensor, d: int,
              m: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One stage at distance d >= near_tile(N), in place."""
    N = docs.shape[-1]
    if d < near_tile(N):
        raise ValueError(f"far_stage needs d >= {near_tile(N)}, got {d}")
    m = m if m < N else 0
    if on_cuda(docs):
        kernels.far_stage(docs, contribs, d, m)
        return docs, contribs
    return far_stage_twin(docs, contribs, d, m)


def near_stages(docs: torch.Tensor, contribs: torch.Tensor, d0: int,
                m: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """All stages d0 down to 1 in one pass (requires 2*d0 <= near_tile(N))."""
    N = docs.shape[-1]
    tile = near_tile(N)
    if 2 * d0 > tile:
        raise ValueError(f"near_stages needs 2*d0 <= {tile}, got d0={d0}")
    m = m if m < N else 0
    if on_cuda(docs):
        kernels.near_stages(docs, contribs, d0, tile, m)
        return docs, contribs
    return near_stages_twin(docs, contribs, d0, m)


def merge_level(docs: torch.Tensor, contribs: torch.Tensor,
                run_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge adjacent sorted runs of length run_len (after the caller's
    bitonic reversal): stages run_len, run_len/2, ..., 1, in place."""
    tile = near_tile(docs.shape[-1])
    d = run_len
    while d >= tile:
        far_stage(docs, contribs, d)
        d //= 2
    if d >= 1:
        near_stages(docs, contribs, d)
    return docs, contribs
