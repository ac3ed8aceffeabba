"""Compare-exchange stages of the bitonic merge, with their CUDA kernels.

Counterpart: nrtsearch_tpu/ops/pallas_merge.py (``far_stage``,
``far_pair_stage``, ``near_stages``, ``merge_level_pallas``,
``merge_sorted_runs_alt``). The (docs, contribs) pair moves together over
[B, N]; stages run in place.

- ``near_stages``: every stage d0, d0/2, ..., 1 inside one on-chip tile
  (csrc/bitonic_merge.cu: registers and warp shuffles, one barrier). The
  TPU tile holds 2^17 pairs in VMEM; a Hopper block holds at most 227 KB
  of shared memory, so the port's tile is ``NEAR_TILE`` pairs (128 KB), or
  the whole row when it is shorter. A 16384-pair tile runs the alternating
  network of the merge batch ([32, 128 runs of 16384]) in 23 passes
  against 26 with 8192, and measured faster on the H100 (PERF.md).
- ``far_stage``: one stage at a distance d >= the tile.
- ``far_pair_stage``: stages d and d/2 in one read and one write, for
  d/2 >= the tile.
- ``merge_level``: one merge level as far stages down to the tile, then one
  near pass (the counterpart of ``merge_level_pallas``).
- ``merge_sorted_runs_alt``: the alternating-direction merge of runs that
  alternate ascending/descending; every level compares inside odd m-blocks
  the other way, so no level reverses a run.

Each has a plain torch twin (``*_twin``). The dispatching functions take the
twin only for CPU tensors; CUDA tensors go to the kernel, which raises on
what it does not take. The tie rule is the reference's: swap only when
lo > hi strictly, so equal docs keep their stream order.
"""

from __future__ import annotations

import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.device import on_cuda

NEAR_TILE = 16384  # pairs per tile: 16384 x (4 + 4) B = 128 KB of shared memory


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


def far_pair_stage_twin(docs: torch.Tensor, contribs: torch.Tensor, d: int,
                        m: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch stages d and d/2 over [B, N], in place: each 2d block is
    four quarters q0..q3 of d/2; stage d exchanges (q0, q2) and (q1, q3),
    stage d/2 then (q0, q1) and (q2, q3). ``m``: alternating-direction
    sort-block size (0 = ascending); a block compares descending when its
    start has the m bit set."""
    B, N = docs.shape
    if d < 2 or 2 * d > N or d & (d - 1):
        raise ValueError(f"far_pair_stage needs d a power of two in [2, N/2], got d={d}, N={N}")
    nblk = N // (2 * d)
    dq = docs.view(B, nblk, 4, d // 2)
    cq = contribs.view(B, nblk, 4, d // 2)
    desc = None
    if m and m < N:
        start = torch.arange(nblk, device=docs.device, dtype=torch.int64) * (2 * d)
        desc = ((start & m) != 0)[None, :, None]

    def ce(a: int, b: int) -> None:
        lo_d, hi_d = dq[:, :, a, :], dq[:, :, b, :]
        swap = lo_d > hi_d
        if desc is not None:
            swap = swap != desc
        lo_c, hi_c = cq[:, :, a, :], cq[:, :, b, :]
        new = (torch.where(swap, hi_d, lo_d), torch.where(swap, lo_d, hi_d),
               torch.where(swap, hi_c, lo_c), torch.where(swap, lo_c, hi_c))
        dq[:, :, a, :], dq[:, :, b, :], cq[:, :, a, :], cq[:, :, b, :] = new

    ce(0, 2)
    ce(1, 3)   # stage d
    ce(0, 1)
    ce(2, 3)   # stage d/2
    return docs, contribs


def far_pair_stage(docs: torch.Tensor, contribs: torch.Tensor, d: int,
                   m: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages d and d/2 in one pass (requires d/2 >= near_tile(N)), in
    place."""
    N = docs.shape[-1]
    if d // 2 < near_tile(N):
        raise ValueError(f"far_pair_stage needs d/2 >= {near_tile(N)}, got d={d}")
    m = m if m < N else 0
    if on_cuda(docs):
        kernels.far_pair_stage(docs, contribs, d, m)
        return docs, contribs
    return far_pair_stage_twin(docs, contribs, d, m)


def _merge_alt(docs, contribs, far_pair, far, near):
    B, R, L = docs.shape
    N = R * L
    docs = docs.reshape(B, N)
    contribs = contribs.reshape(B, N)
    tile = near_tile(N)
    m = 2 * L
    while m <= N:
        d = m // 2
        while d >= tile:
            if d // 2 >= tile:
                far_pair(docs, contribs, d, m)
                d //= 4
            else:
                far(docs, contribs, d, m)
                d //= 2
        if d >= 1:
            near(docs, contribs, d, m)
        m *= 2
    return docs, contribs


def merge_sorted_runs_alt(docs: torch.Tensor, contribs: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, R, L] runs, even runs ascending and odd runs descending (the
    alternating gather) -> [B, R*L] sorted ascending.

    Level m (= 2L, 4L, ..., N) merges adjacent m/2-blocks, which alternate
    direction and so are bitonic pairs as they stand: stages m/2 ... 1 with
    blocks whose start has the m bit set compared descending, so the level's
    m-blocks alternate again; the last level (m = N) is ascending. Far
    stages pair up while both distances are at least the tile. The stage
    sequence is the reference's (pallas_merge.py:486), so the output is
    bit-equal to it whatever the tile. Works in place on the [B, N] views."""
    return _merge_alt(docs, contribs, far_pair_stage, far_stage, near_stages)


def merge_sorted_runs_alt_twin(docs: torch.Tensor, contribs: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``merge_sorted_runs_alt`` over the plain torch twins, on any device."""
    return _merge_alt(docs, contribs, far_pair_stage_twin, far_stage_twin,
                      near_stages_twin)
