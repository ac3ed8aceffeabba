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
composed over the plan's tile. The dense tail (ops/dense_head.py) reads its
dense keys.

``bucket_search_topk`` wants only each query's top k, and takes
``bucket_rank_topk``: the same accumulate phase in a second kernel entry,
which selects each row's top kk = min(k, bucket_docs) in shared memory and
writes only those candidates and the hit counts, so the dense
[B, m * bucket_docs] keys are never written on the card; one
``torch.topk`` over the [B, m * kk] candidates finishes. On CPU tensors
``bucket_rank_topk_plain`` runs the same two stages over the dense keys.

The standalone API is the reference's as well: ``BucketIndex.build`` (the
refresh-time per-term bucket bounds), ``plan_bucket_batch`` (a batch's
tables, slots by descending mass, the per-query quantization scale),
``reference_bucket_search`` (the numpy oracle). A ``BucketPlan`` drives
``bucket_search_topk`` as it is. The reference's ``_hierarchical_topk_i32``
and its plans' frozen shapes (``force_caps`` / ``force_tile``) are not
ported: the per-row selection and one top k over its candidates give the
same top k, and eager torch compiles no shapes to freeze. The serving caller,
``PackedFieldView.bucket_search_batch``, plans its own batches from the
packed view.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops.topk import (
    lowest_index_keys, top_lowest_index_keys, topk_i32_lowest_index,
)

I32_SENT = np.int32(2**31 - 1)     # padding and deleted postings
I32_MIN = np.int32(-(2**31))       # no hit at this doc: never tops
QMAX = 32000                       # 15-bit contribution quantization ceiling
MIN_TILE = 1024                    # smallest key tile (the reference's 8 x 128)


# ---------------------------------------------------------------------------
# Refresh-time index and query planning (the reference's
# bucket_retrieval.py:67-211, numpy)
# ---------------------------------------------------------------------------


@dataclass
class BucketIndex:
    """Per-term bucket split offsets + impact bounds over packed postings."""

    bucket_bits: int               # bucket_docs = 1 << bucket_bits
    n_buckets: int
    bounds: np.ndarray             # int32 [vocab, m+1] term-relative offsets
    max_impact: np.ndarray         # float32 [vocab] per-term impact bound

    @classmethod
    def build(
        cls,
        post_docs: np.ndarray,     # int32 [P] doc ids, term-major, doc-sorted
        post_impacts: np.ndarray,  # float32 [P] impacts (0 for deleted)
        term_offsets: np.ndarray,  # int64 [V]
        term_lengths: np.ndarray,  # int32 [V]
        capacity: int,             # padded doc-space size (power of two)
        bucket_docs: int = 16384,
    ) -> "BucketIndex":
        """One histogram of every term's postings over the buckets and a
        cumulative sum: bounds[t, b] is where bucket b starts inside term
        t's run (the reference's bucket_retrieval.py:83-115)."""
        assert bucket_docs & (bucket_docs - 1) == 0 and bucket_docs <= 32768
        bits = int(bucket_docs).bit_length() - 1
        m = max(1, -(-capacity // bucket_docs))
        V = len(term_lengths)
        term_of = np.repeat(
            np.arange(V, dtype=np.int64), np.asarray(term_lengths, np.int64)
        )
        post_docs = np.asarray(post_docs)
        post_impacts = np.asarray(post_impacts)
        docs = post_docs[: len(term_of)]
        g = docs.astype(np.int64) >> bits
        counts = np.zeros((V, m), np.int32)
        np.add.at(counts, (term_of, g), 1)
        bounds = np.zeros((V, m + 1), np.int32)
        np.cumsum(counts, axis=1, out=bounds[:, 1:])
        max_impact = np.zeros(V, np.float32)
        imps = post_impacts[: len(term_of)]
        np.maximum.at(max_impact, term_of, imps)
        return cls(bits, m, bounds, max_impact)


@dataclass
class BucketPlan:
    """Host tables for one batch (the reference's bucket_retrieval.py:118-129)."""

    term_offs: np.ndarray    # int32 [B, T] absolute run starts
    bounds: np.ndarray       # int32 [B, T, m+1] term-relative bucket offsets
    weights: np.ndarray      # float32 [B, T] idf*boost*scale (0 = unused)
    n_terms: np.ndarray      # int32 [B]
    scales: np.ndarray       # float32 [B] score quantization scales
    caps: tuple              # per-slot largest slice, rounded up (elements)
    tile: int                # per-bucket key tile width (pow2)
    shape_key: tuple         # (T, caps, tile, m)


def _pow2(n: int, minimum: int = 1) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


def plan_bucket_batch(
    idx: BucketIndex,
    queries: list[list[tuple[int, float]]],  # per query [(term_id, weight)]
    term_offsets: np.ndarray,
    *,
    max_terms: int = 8,
) -> BucketPlan:
    """Queries -> plan tables and shape (the reference's
    bucket_retrieval.py:139-211, without its frozen ``force_caps`` /
    ``force_tile``). Slots are ordered by descending slice mass, duplicate
    term ids merge their weights, and each query's weights carry its scale
    QMAX / (sum of w * max impact)."""
    B = len(queries)
    T = max_terms
    m = idx.n_buckets
    term_offs = np.zeros((B, T), np.int32)
    bounds = np.zeros((B, T, m + 1), np.int32)
    weights = np.zeros((B, T), np.float32)
    n_terms = np.zeros(B, np.int32)
    scales = np.ones(B, np.float32)
    for qi, entries in enumerate(queries):
        merged: dict[int, float] = {}
        for tid, w in entries:
            if w != 0.0:
                merged[tid] = merged.get(tid, 0.0) + w
        ents = sorted(
            merged.items(),
            key=lambda kv: -(idx.bounds[kv[0], -1]),
        )[:T]
        n_terms[qi] = len(ents)
        smax = sum(w * float(idx.max_impact[t]) for t, w in ents)
        scale = QMAX / smax if smax > 0 else 1.0
        scales[qi] = scale
        for ti, (tid, w) in enumerate(ents):
            term_offs[qi, ti] = int(term_offsets[tid])
            bounds[qi, ti] = idx.bounds[tid]
            weights[qi, ti] = w * scale

    lens = bounds[:, :, 1:] - bounds[:, :, :-1]      # [B, T, m]
    per_slot = lens.max(axis=(0, 2)) if lens.size else np.zeros(T, np.int64)
    caps = tuple(max(MIN_TILE, -(-int(c) // 1024) * 1024) for c in per_slot)
    max_sum = int(lens.sum(axis=1).max()) if lens.size else 0
    tile = _pow2(max_sum, MIN_TILE)
    return BucketPlan(
        term_offs, bounds, weights, n_terms, scales, caps, tile,
        (T, caps, tile, m),
    )


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


def bucket_rank_topk_plain(post_docs, post_impacts, toffs, bounds, wts, n_terms, *,
                           tile: int, bucket_bits: int, require_all: bool, k: int):
    """Plain torch version of ``bucket_rank_topk``: ``bucket_rank_plain``'s
    dense keys, then each (query, bucket) row's top kk = min(k, bucket_docs)
    by ``topk_i32_lowest_index`` (I32_MIN docs included). Returns (int64
    [B, m * kk] ``lowest_index_keys`` of (key, global doc), each row's in
    order; int32 [B] hits)."""
    rank = bucket_rank_plain(post_docs, post_impacts, toffs, bounds, wts, n_terms,
                             tile=tile, bucket_bits=bucket_bits, require_all=require_all)
    B, m = rank.shape[0], bounds.shape[2] - 1
    kk = min(k, 1 << bucket_bits)
    keys, local = topk_i32_lowest_index(rank.reshape(B * m, 1 << bucket_bits), kk)
    first = torch.arange(m, device=rank.device, dtype=torch.int64).repeat(B) << bucket_bits
    cands = lowest_index_keys(keys, local + first[:, None])
    hits = (rank != int(I32_MIN)).sum(dim=-1, dtype=torch.int32)
    return cands.reshape(B, m * kk), hits


def bucket_rank_topk(post_docs, post_impacts, toffs, bounds, wts, n_terms, *,
                     tile: int, bucket_bits: int, require_all: bool, k: int):
    """Plan tables -> (int64 [B, m * kk] candidates, int32 [B] hits): each
    (query, bucket) row's top kk = min(k, bucket_docs) rank keys with their
    global docs, as ``lowest_index_keys``. The CUDA kernel for CUDA tensors
    (which needs no ``tile`` and writes no dense keys),
    ``bucket_rank_topk_plain`` for CPU ones."""
    if on_cuda(post_docs):
        return kernels.bucket_rank_topk(post_docs, post_impacts, toffs, bounds, wts,
                                        n_terms, bucket_bits, require_all, k)
    return bucket_rank_topk_plain(post_docs, post_impacts, toffs, bounds, wts, n_terms,
                                  tile=tile, bucket_bits=bucket_bits,
                                  require_all=require_all, k=k)


def bucket_search_topk(post_docs, post_impacts, toffs, bounds, wts, n_terms, *,
                       tile: int, bucket_bits: int, k: int,
                       require_all: bool = False):
    """Bucket-local retrieval. Returns (rank keys int32 [B, k], doc ids int32
    [B, k], hits int32 [B]); keys are quantized score sums (dequantize with
    the plan's per-query scale), and ``I32_MIN`` marks an empty slot. The
    bucket count m is ``bounds.shape[2] - 1``. Every entry of a query's top
    k is among its own row's top kk, so the top k of the rows' candidates
    (``bucket_rank_topk``) is the top k of the dense rank keys, ties to
    the lower doc; slots beyond the m * bucket_docs docs are (I32_MIN, 0)."""
    cands, hits = bucket_rank_topk(post_docs, post_impacts, toffs, bounds, wts, n_terms,
                                   tile=tile, bucket_bits=bucket_bits,
                                   require_all=require_all, k=k)
    top_keys, top_docs = top_lowest_index_keys(cands, min(k, cands.shape[1]))
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


# ---------------------------------------------------------------------------
# The numpy oracle (the reference's bucket_retrieval.py:535-576)
# ---------------------------------------------------------------------------


def reference_bucket_search(
    post_docs, post_impacts, idx: BucketIndex, plan: BucketPlan, k: int,
    *, require_all: bool = False,
):
    """The same quantized algorithm in numpy: per query, gather each term's
    postings, quantize contributions with the plan's folded scale and
    weight, sum per doc, rank by (quantized sum, -doc). Returns (scores
    f32 [B, k] -inf padded, docs int32 [B, k] -1 padded, hits int64 [B])."""
    post_docs = np.asarray(post_docs)
    post_impacts = np.asarray(post_impacts)
    B, T = plan.term_offs.shape
    out_scores = np.full((B, k), -np.inf, np.float32)
    out_docs = np.full((B, k), -1, np.int32)
    hits = np.zeros(B, np.int64)
    for qi in range(B):
        acc: dict[int, int] = {}
        cnt: dict[int, int] = {}
        for ti in range(T):
            w = plan.weights[qi, ti]
            if w == 0.0:
                continue
            off = int(plan.term_offs[qi, ti])
            ln = int(plan.bounds[qi, ti, -1])
            docs = post_docs[off : off + ln]
            imps = post_impacts[off : off + ln]
            live = imps > 0.0
            quant = np.clip((w * imps + 0.5).astype(np.int64), 1, QMAX)
            for d, qv, lv in zip(docs, quant, live):
                if not lv:
                    continue
                acc[d] = acc.get(d, 0) + int(qv)
                cnt[d] = cnt.get(d, 0) + 1
        items = [
            (min(s, QMAX), d)
            for d, s in acc.items()
            if s > 0 and (not require_all or cnt[d] >= plan.n_terms[qi])
        ]
        hits[qi] = len(items)
        items.sort(key=lambda sd: (-sd[0], sd[1]))
        for j, (s, d) in enumerate(items[:k]):
            out_scores[qi, j] = s / plan.scales[qi]
            out_docs[qi, j] = d
    return out_scores, out_docs, hits
