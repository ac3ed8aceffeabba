"""Bucket-local BM25 retrieval with 15-bit quantized scores (counterpart:
nrtsearch_tpu/ops/bucket_retrieval.py).

Doc space is cut into buckets of ``bucket_docs`` (a power of two, at most
32768, so a bucket-local id fits 15 bits). For every (query, bucket) pair the
reference runs two kernels, which the plain versions here follow:

1. ``gather_pack_plain`` packs the pair's slice of each of the query's T
   term runs back to back into one int32 key per posting,
   ``local_doc << 16 | clip(int(w * imp + 0.5), 1, QMAX)``, padded with
   ``I32_SENT`` to the batch's ``tile``. ``w`` is the term weight already
   multiplied by the query's quantization scale, so a contribution is an
   integer number of quanta of ``QMAX`` over the query's largest possible
   score. A deleted posting (impact 0) packs as ``I32_SENT``.
2. ``sort_finish_plain`` sums the contributions per local doc, counts the
   doc's postings, and writes the rank key ``min(sum, QMAX)`` where the doc
   has a posting, a positive sum and (AND mode) at least ``n_terms[q]``
   postings; ``I32_MIN`` everywhere else. The output is dense,
   [B, m * bucket_docs] in global doc order, so a position is a doc id.

The reference sorts each key tile with a bitonic network in VMEM and sums
with a bounded segmented scan; it returns (rank, doc) per tile position.
The sort exists only to group equal docs. Here the sum is an integer
scatter-add into a per-bucket accumulator, which is exact in any order, so
the dense rank equals the reference's (rank, doc) pairs scattered into an
``I32_MIN`` array. Ties then break to the lower doc id as ``lax.top_k``'s
lower-index rule does over the reference's layout (buckets ascend, docs
ascend inside a sorted tile).

``bucket_rank`` is both steps at once. On CUDA tensors it launches one
hand-written kernel (csrc/bucket_rank.cu) that adds each posting straight
into the row's shared-memory accumulator, so no key tile exists on the
card; on CPU tensors it runs ``bucket_rank_plain``, the two plain versions
composed over the plan's tile. ``BucketIndex.build``, ``plan_bucket_batch``
and ``reference_bucket_search`` are not ported: the serving caller is
``PackedFieldView.bucket_search_batch``, which plans its own batches.
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops.topk import topk_i32_lowest_index

I32_SENT = np.int32(2**31 - 1)     # padding and deleted postings
I32_MIN = np.int32(-(2**31))       # no hit at this doc: never tops
QMAX = 32000                       # 15-bit contribution quantization ceiling
MIN_TILE = 1024                    # smallest key tile (the reference's 8 x 128)


def gather_pack_plain(post_docs, post_impacts, toffs, bounds, wts, *,
                      tile: int, bucket_bits: int) -> torch.Tensor:
    """The reference's ``gather_pack_pallas`` in plain torch: int32
    [B * m, tile] keys.

    Row q * m + b holds, back to back in slot order, each slot t's postings
    ``[toffs[q, t] + bounds[q, t, b], toffs[q, t] + bounds[q, t, b + 1])``
    packed as ``(doc - (b << bucket_bits)) & (bucket_docs - 1)`` in the high
    half and ``clip(int(w * imp + 0.5), 1, QMAX)`` in the low half, or
    ``I32_SENT`` where the impact is not positive; slots with weight 0 take
    no room; the rest of the row is ``I32_SENT``. ``w * imp + 0.5`` is
    computed in f64 (exact: the product of two f32 has 48 bits) and rounded
    once to f32 before truncation, the single rounding of the FMA that the
    reference's compiled kernel takes."""
    dev = post_docs.device
    B, T, m1 = bounds.shape
    m = m1 - 1
    live = (wts != 0.0)[..., None]
    lens = torch.where(live, bounds[..., 1:] - bounds[..., :-1], 0).to(torch.int64)
    lens = lens.permute(0, 2, 1).reshape(B * m, T)                  # row q * m + b
    ends = torch.cumsum(lens, dim=1)                                # inclusive
    starts = toffs.to(torch.int64)[..., None] + bounds[..., :-1]
    starts = starts.permute(0, 2, 1).reshape(B * m, T)
    pos = torch.arange(tile, device=dev, dtype=torch.int64).expand(B * m, tile).contiguous()
    slot = torch.searchsorted(ends, pos, right=True)                # [B * m, tile]
    inside = slot < T
    slot_c = torch.clamp(slot, max=T - 1)
    dest = torch.gather(ends - lens, 1, slot_c)
    src = torch.where(inside, torch.gather(starts, 1, slot_c) + pos - dest, 0)
    docs = post_docs[src]
    imps = post_impacts[src]
    w = torch.gather(wts.repeat_interleave(m, dim=0), 1, slot_c)
    quant = (w.double() * imps.double() + 0.5).float().to(torch.int32)
    quant = torch.clamp(quant, 1, QMAX)
    bucket = torch.arange(B * m, device=dev, dtype=torch.int32)[:, None] % m
    local = (docs - (bucket << bucket_bits)) & ((1 << bucket_bits) - 1)
    keys = (local << 16) | quant
    sent = torch.full((), int(I32_SENT), dtype=torch.int32, device=dev)
    return torch.where(inside & (imps > 0.0), keys, sent)


def sort_finish_plain(keys, n_terms, *, m: int, bucket_bits: int,
                      require_all: bool) -> torch.Tensor:
    """The reference's ``sort_finish_pallas`` in plain torch: int32
    [B * m, tile] keys -> int32 [B, m * bucket_docs] rank keys in global
    doc order.

    Per local doc of each row: the sum of its postings' contributions (the
    low 16 bits) and their count, both exact int32 scatter-adds. The rank
    key is ``min(sum, QMAX)`` where count > 0, sum > 0 and, with
    ``require_all``, count >= n_terms[q]; ``I32_MIN`` elsewhere."""
    dev = keys.device
    nbm = keys.shape[0]
    B = nbm // m
    bd = 1 << bucket_bits
    valid = keys != int(I32_SENT)
    row = torch.arange(nbm, device=dev, dtype=torch.int64)[:, None]
    flat = (row * bd + (keys >> 16).to(torch.int64))[valid]
    sums = torch.zeros(nbm * bd, dtype=torch.int32, device=dev)
    sums.index_add_(0, flat, (keys & 0xFFFF)[valid])
    counts = torch.zeros(nbm * bd, dtype=torch.int32, device=dev)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    sums, counts = sums.reshape(B, m * bd), counts.reshape(B, m * bd)
    ok = (counts > 0) & (sums > 0)
    if require_all:
        ok = ok & (counts >= n_terms[:, None])
    return torch.where(ok, torch.clamp(sums, max=QMAX),
                       torch.full((), int(I32_MIN), dtype=torch.int32, device=dev))


def bucket_rank_plain(post_docs, post_impacts, toffs, bounds, wts, n_terms, *,
                      tile: int, bucket_bits: int, require_all: bool) -> torch.Tensor:
    """Plain torch version of ``bucket_rank``: ``sort_finish_plain`` over
    ``gather_pack_plain``'s [B * m, tile] keys (``tile`` at least the
    largest row's live postings)."""
    keys = gather_pack_plain(post_docs, post_impacts, toffs, bounds, wts,
                             tile=tile, bucket_bits=bucket_bits)
    return sort_finish_plain(keys, n_terms, m=bounds.shape[2] - 1,
                             bucket_bits=bucket_bits, require_all=require_all)


def bucket_rank(post_docs, post_impacts, toffs, bounds, wts, n_terms, *,
                tile: int, bucket_bits: int, require_all: bool) -> torch.Tensor:
    """[B, T] / [B, T, m+1] plan tables -> int32 [B, m * bucket_docs] rank
    keys in global doc order: the CUDA kernel for CUDA tensors (which needs
    no ``tile``), ``bucket_rank_plain`` for CPU ones."""
    if on_cuda(post_docs):
        return kernels.bucket_rank(post_docs, post_impacts, toffs, bounds, wts,
                                   n_terms, bucket_bits, require_all)
    return bucket_rank_plain(post_docs, post_impacts, toffs, bounds, wts, n_terms,
                             tile=tile, bucket_bits=bucket_bits, require_all=require_all)


def bucket_search_topk(post_docs, post_impacts, toffs, bounds, wts, n_terms, *,
                       tile: int, bucket_bits: int, k: int,
                       require_all: bool = False):
    """Bucket-local retrieval. Returns (rank keys int32 [B, k], doc ids int32
    [B, k], hits int32 [B]); keys are quantized score sums (dequantize with
    the plan's per-query scale), and ``I32_MIN`` marks an empty slot. The
    bucket count m is ``bounds.shape[2] - 1``."""
    rank = bucket_rank(post_docs, post_impacts, toffs, bounds, wts, n_terms,
                       tile=tile, bucket_bits=bucket_bits, require_all=require_all)
    hits = (rank != int(I32_MIN)).sum(dim=-1, dtype=torch.int32)
    top_keys, top_docs = topk_i32_lowest_index(rank, min(k, rank.shape[1]))
    if top_keys.shape[1] < k:       # fewer docs than k: empty slots
        pad = k - top_keys.shape[1]
        top_keys = torch.nn.functional.pad(top_keys, (0, pad), value=int(I32_MIN))
        top_docs = torch.nn.functional.pad(top_docs, (0, pad), value=0)
    return top_keys, top_docs.to(torch.int32), hits


def decode_topk(top_keys, top_docs, scales):
    """Score keys + doc ids -> (scores f32 [B, k], doc ids int32 [B, k]).
    Empty slots (key == I32_MIN) come back as (-inf, -1)."""
    top_keys = np.asarray(top_keys)
    top_docs = np.asarray(top_docs)
    valid = top_keys != I32_MIN
    scores = top_keys.astype(np.float32) / scales[:, None]
    return (
        np.where(valid, scores, -np.inf).astype(np.float32),
        np.where(valid, top_docs, -1).astype(np.int32),
    )
