"""Dense-head + sparse-tail BM25 retrieval (counterpart:
nrtsearch_tpu/ops/dense_head.py).

Head terms (df >= ``min_df``, at most ``max_rows`` of them) are dense bf16
impact rows [Hp, D] on the device; a batch scores all of them with one
product ``S = W[B, Hp] @ rows`` (bf16 operands, f32 accumulation: the
port's ``ops.dense_fused._mm``), unused rows multiplying by zero. Tail terms
keep sparse postings. Two tails, as in the reference:

- ``dense_tail_topk`` (``dispatch``): the bucket kernel (ops/bucket_retrieval
  ``bucket_rank``; kernels #7 and #8 of the reference in one launch on the
  card) with its 15-bit quantized scores. The reference sorts each bucket
  tile and finds a head doc in the sorted support by binary search; the
  port's rank keys are dense, [B, m * bucket_docs] in global doc order, so a
  position is a doc id: a doc's head share is ``S`` at its own position, a
  head doc is a duplicate where its rank key is not ``I32_MIN``, and the
  tail's own hits are the valid keys where ``S`` is 0. Packed [B, 2k+1]
  (``decode_packed``).
- ``dense_merge_topk`` (``dispatch_merge``): exact f32 tail runs through the
  bitonic merge (``merge_sorted_runs``: the far and near stage kernels on the
  card) and the plain ``segmented_scores``; the theta candidate window
  prunes the combine when it certifies the result (hits are then lower
  bounds), ``exact_counts`` forces the full combine. The reference picks the
  branch with ``lax.cond``; the port reads the certificate on the host: one
  sync per windowed batch, counted in ``HOST_SYNCS``; ``WINDOW_BRANCH``
  counts the branch taken. Packed [B, 2k+2] (``decode_packed2``).

Ties go (score desc, docid asc) everywhere (``_topk_docid``). The
reference's shape pins (``force_caps``, ``force_tile``, ``force_run_len``)
are not ported: eager torch compiles no shapes. ``reference_dense_search``
is the reference's numpy oracle of the bucket-tail route.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nrtsearch_tpu_torch.device import resolve_device
from nrtsearch_tpu_torch.ops.bucket_retrieval import (
    I32_MIN, QMAX, BucketIndex, BucketPlan, bucket_rank, plan_bucket_batch,
)
from nrtsearch_tpu_torch.ops.merge_scoring import (
    _hierarchical_topk, _pow2, gather_runs, merge_sorted_runs, segmented_scores,
)
from nrtsearch_tpu_torch.ops.topk import topk_f32_total_order, topk_lowest_index

NEG_INF = np.float32(-np.inf)
_NEG = float(NEG_INF)
_DOC_MAX = 2**31 - 1

# host syncs taken by dense_merge_topk's window certificate, one per
# windowed batch, and the combine that served each windowed batch (window =
# certified, full = escalated)
HOST_SYNCS = {"window_certificate": 0}
WINDOW_BRANCH = {"window": 0, "full": 0}


def _searchsorted_rows(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-row searchsorted (side left): a [B, N] non-decreasing, v [B, K]."""
    return torch.searchsorted(a, v)


def _topk_docid(s: torch.Tensor, d: torch.Tensor, k: int):
    """Exact top-k under Lucene's (score desc, docid asc) tie contract.

    The reference sorts on the two keys (-score, docid); here two stable
    sorts do the same: by docid, then by score descending. Padding entries
    (-inf) sort last and carry docid 2^31-1, as in the reference."""
    dk = torch.where(s == float(NEG_INF), torch.full_like(d, _DOC_MAX), d)
    o1 = torch.sort(dk, dim=1, stable=True).indices
    s1 = torch.gather(s, 1, o1)
    d1 = torch.gather(dk, 1, o1)
    o2 = torch.sort(s1, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s1, 1, o2), torch.gather(d1, 1, o2)


def _combine_topk_docid(s_a, d_a, s_b, d_b, k: int):
    """Top-k of two candidate sets under (score desc, docid asc).

    Source A's entries must ascend by docid (so the lowest-index tie rule
    IS the docid tie rule); it is cut to k (one top-k in the total order,
    no sort) before the small lexicographic combine with source B."""
    if s_a.shape[1] > k:
        s_a, ia = topk_f32_total_order(s_a, k)
        d_a = torch.gather(d_a, 1, ia)
    return _topk_docid(torch.cat([s_a, s_b], dim=1), torch.cat([d_a, d_b], dim=1), k)


def decode_packed2(packed, k: int):
    """[B, 2k+2] int32 -> (scores f32 [B,k], docs i32 [B,k], hits i64 [B],
    counts_exact bool [B]) as numpy arrays."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    scores = packed[:, :k].view(np.float32)
    docs = packed[:, k : 2 * k]
    hits = packed[:, 2 * k].astype(np.int64)
    exact = packed[:, 2 * k + 1].astype(bool)
    return scores, docs, hits, exact


def decode_packed(packed, k: int):
    """[B, 2k+1] int32 -> (scores f32 [B,k], docs i32 [B,k], hits i64 [B])
    as numpy arrays."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    scores = packed[:, :k].view(np.float32)
    docs = packed[:, k : 2 * k]
    hits = packed[:, 2 * k].astype(np.int64)
    return scores, docs, hits


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (nearest even) and widened back to f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# Refresh-time index
# ---------------------------------------------------------------------------


@dataclass
class DenseHeadIndex:
    """Dense bf16 impact rows for head terms + a bucket index for the tail."""

    rows: torch.Tensor              # bf16 [Hp, D] per-doc impacts (0 = absent)
    head_ids: np.ndarray            # int32 [H] term ids, df-descending
    head_pos: dict                  # term id -> row index
    tail: BucketIndex               # bucket bounds of ALL terms (queried for
                                    # tail terms only)
    capacity: int                   # D (padded doc-space size)
    min_df: int
    row_max: torch.Tensor = None    # f32 [Hp] per-row max impact (head_ub)
    rows_lo: torch.Tensor = None    # bf16 [Hp, D] Dekker residual rows
                                    # bf16(imp - f32(rows)), or None

    @classmethod
    def build(
        cls,
        post_docs: np.ndarray,      # int32 [P] doc ids, term-major, doc-sorted
        post_impacts: np.ndarray,   # float32 [P] impacts (0 for deleted)
        term_offsets: np.ndarray,   # int64 [V]
        term_lengths: np.ndarray,   # int32 [V]
        capacity: int,              # padded doc-space size (mult of 128)
        *,
        max_rows: int = 256,
        min_df: int | None = None,
        bucket_docs: int = 32768,
        residual: bool = False,
        device: str | torch.device = "cuda",
    ) -> "DenseHeadIndex":
        """The rows are built on the host (one f32 scatter per head term,
        one bf16 rounding, the residual rows in blocks of 64) and moved to
        ``device`` once; the f32 matrix is freed before the bucket bounds
        are built."""
        assert capacity % 128 == 0
        dev = resolve_device(device)
        if min_df is None:
            min_df = max(1024, capacity // 64)
        post_docs = np.asarray(post_docs)
        post_impacts = np.asarray(post_impacts)
        lengths = np.asarray(term_lengths, np.int64)
        cand = np.nonzero(lengths >= min_df)[0]
        if len(cand) > max_rows:
            cand = cand[np.argsort(-lengths[cand], kind="stable")[:max_rows]]
        head_ids = cand[np.argsort(-lengths[cand], kind="stable")].astype(np.int32)
        H = len(head_ids)
        head_pos = {int(t): i for i, t in enumerate(head_ids)}
        # row count pads to a multiple of 8 (the reference's sublane
        # padding); pad rows are zero
        Hp = max(8, -(-H // 8) * 8)
        rows_f32 = np.zeros((Hp, capacity), dtype=np.float32)
        for i, tid in enumerate(head_ids):
            off = int(term_offsets[tid])
            ln = int(term_lengths[tid])
            rows_f32[i, post_docs[off : off + ln]] = post_impacts[off : off + ln]
        host = torch.from_numpy(rows_f32)
        hi = host.to(torch.bfloat16)
        rows_lo = None
        if residual:
            # Dekker-style split: lo = bf16(imp - f32(hi)), in row blocks so
            # the f32 temporary stays bounded
            lo = torch.empty_like(hi)
            for s in range(0, Hp, 64):
                e = min(s + 64, Hp)
                lo[s:e] = (host[s:e] - hi[s:e].float()).to(torch.bfloat16)
            rows_lo = lo.to(dev)
            del lo
        del host, rows_f32
        rows = hi.to(dev)
        del hi
        tail = BucketIndex.build(
            post_docs, post_impacts, term_offsets, term_lengths,
            capacity=capacity, bucket_docs=bucket_docs,
        )
        # max in bf16 then widen (no f32 copy of the rows)
        row_max = rows.amax(dim=1).float()
        return cls(rows, head_ids, head_pos, tail, capacity, int(min_df), row_max, rows_lo)

    @property
    def n_rows(self) -> int:
        return len(self.head_ids)


# ---------------------------------------------------------------------------
# Query planning
# ---------------------------------------------------------------------------


@dataclass
class DensePlan:
    """Host-compiled tables for one dense+tail batch."""

    W: np.ndarray            # float32 [B, Hp] full head weight matrix
    tail: BucketPlan | None  # bucket plan of the tail terms (None: none)
    has_head: bool
    shape_key: tuple


def plan_dense_batch(
    idx: DenseHeadIndex,
    queries: list[list[tuple[int, float]]],   # per query [(term_id, weight)]
    term_offsets: np.ndarray,
    *,
    max_terms: int = 8,
) -> DensePlan:
    """Split each query's terms into head rows and tail postings. The head
    weight matrix is the full [B, Hp] scatter; duplicate term ids merge
    their weights (as plan_bucket_batch does)."""
    B = len(queries)
    Hp = idx.rows.shape[0]
    W = np.zeros((B, Hp), np.float32)
    tail_qs: list[list[tuple[int, float]]] = []
    any_tail = False
    has_head = False
    for qi, entries in enumerate(queries):
        merged: dict[int, float] = {}
        for tid, w in entries[: max_terms if max_terms else None]:
            if w != 0.0:
                merged[tid] = merged.get(tid, 0.0) + w
        tq: list[tuple[int, float]] = []
        for tid, w in merged.items():
            row = idx.head_pos.get(int(tid))
            if row is not None:
                W[qi, row] += w
                has_head = True
            else:
                tq.append((tid, w))
                any_tail = True
        tail_qs.append(tq)

    tail = None
    if any_tail:
        tail = plan_bucket_batch(idx.tail, tail_qs, term_offsets, max_terms=max_terms)
    tail_key = tail.shape_key if tail is not None else None
    return DensePlan(W, tail, has_head, (B, Hp, has_head, tail_key))


# ---------------------------------------------------------------------------
# Head + bucket tail
# ---------------------------------------------------------------------------


def _head(rows, W_full, k: int):
    """Head scores S f32 [B, D] of the full weight matrix (quantized through
    bf16), the head's top k (``_hierarchical_topk``) and its hit counts."""
    from nrtsearch_tpu_torch.ops.dense_fused import _mm

    S = _mm(W_full.to(torch.bfloat16), rows)
    masked = torch.where(S > 0.0, S, _NEG)
    head_s, head_d = _hierarchical_topk(masked, k)
    return S, head_s, head_d.to(torch.int32), (S > 0.0).sum(dim=-1, dtype=torch.int32)


def _no_head(B: int, k: int, dev):
    return (torch.full((B, k), _NEG, dtype=torch.float32, device=dev),
            torch.zeros((B, k), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev))


def dense_tail_topk(
    rows,             # bf16 [Hp, D] dense head impact rows
    post_docs,        # int32 [P] packed postings (shared with other paths)
    post_impacts,     # float32 [P]
    W,                # f32 [B, Hp] full head weight matrix
    toffs, bounds, wts, n_terms,   # tail bucket tables (unused if m == 0)
    scales,           # f32 [B] tail quantization scales
    *,
    k: int,
    has_head: bool,
    tile: int = 0,
    bucket_bits: int = 0,
    m: int = 0,
):
    """Fused dense-head + bucket-tail retrieval.

    Returns one packed int32 tensor [B, 2k+1]: scores (f32 bits) | docs |
    hits; decode with ``decode_packed``. ``m`` is the tail's bucket count
    (0: no tail); ``tile`` the plan's key tile, which only the CPU's plain
    bucket_rank reads."""
    B = W.shape[0]
    D = rows.shape[1]
    dev = W.device
    if has_head:
        S, head_s, head_d, head_hits = _head(rows, W, k)
    else:
        head_s, head_d, head_hits = _no_head(B, k, dev)

    if m > 0:
        # dense rank keys: position = doc id; a doc beyond the padded doc
        # space has no postings
        rank = bucket_rank(post_docs, post_impacts, toffs, bounds, wts, n_terms,
                           tile=tile, bucket_bits=bucket_bits, require_all=False)[:, :D]
        valid = rank != int(I32_MIN)
        if has_head:
            s_at = S
        else:
            s_at = torch.zeros((B, D), dtype=torch.float32, device=dev)
        sup_s = torch.where(valid, rank.float() / scales[:, None] + s_at, _NEG)
        tail_hits = (valid & (s_at == 0.0)).sum(dim=-1, dtype=torch.int32)
        if has_head:
            # a head entry whose doc has a tail key carries an incomplete
            # score: its complete entry is the doc's own position
            dup = torch.gather(valid, 1, head_d.long())
            head_s = torch.where(dup, _NEG, head_s)
        # the dense candidates ascend by doc id (position = doc id)
        pos = torch.arange(D, dtype=torch.int32, device=dev).expand(B, D)
        fs, fd = _combine_topk_docid(sup_s, pos, head_s, head_d, k)
    else:
        fs, fd = head_s, head_d
        tail_hits = torch.zeros((B,), dtype=torch.int32, device=dev)

    hits = head_hits + tail_hits
    fd = torch.where(fs == _NEG, -1, fd.to(torch.int32))
    return torch.cat([fs.contiguous().view(torch.int32), fd.to(torch.int32),
                      hits[:, None].to(torch.int32)], dim=1)


def dispatch(
    idx: DenseHeadIndex,
    plan: DensePlan,
    post_docs,
    post_impacts,
    k: int,
):
    """Move one plan's tables to the index's device and run the fused step.
    Returns the packed [B, 2k+1] tensor (decode with ``decode_packed``)."""
    dev = idx.rows.device
    tail = plan.tail
    B = plan.W.shape[0]

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    if tail is not None:
        args = tuple(put(x) for x in (tail.term_offs, tail.bounds, tail.weights,
                                      tail.n_terms, tail.scales))
        static = dict(tile=tail.tile, bucket_bits=idx.tail.bucket_bits,
                      m=idx.tail.n_buckets)
    else:
        args = (torch.zeros((B, 1), dtype=torch.int32, device=dev),
                torch.zeros((B, 1, 2), dtype=torch.int32, device=dev),
                torch.zeros((B, 1), dtype=torch.float32, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev),
                torch.ones(B, dtype=torch.float32, device=dev))
        static = dict(tile=0, bucket_bits=0, m=0)
    return dense_tail_topk(idx.rows, post_docs, post_impacts, put(plan.W), *args,
                           k=k, has_head=plan.has_head, **static)


# ---------------------------------------------------------------------------
# Head + merge tail
# ---------------------------------------------------------------------------


@dataclass
class DenseMergePlan:
    """Host-compiled tables for one dense+merge-tail batch. The head weight
    matrix is compact, ``W[B, U]`` over ``row_idx[U]`` (the union of head
    rows the batch uses, padded to a power of two >= 8; pad slots repeat
    row 0 with weight 0); the step scatters it into the full [B, Hp]
    matrix."""

    W: np.ndarray             # float32 [B, U] compact head weight matrix
    row_idx: np.ndarray       # int32 [U] head row ids (pad rows repeat 0)
    run_offs: np.ndarray      # int32 [B, R] tail run offsets
    run_lens: np.ndarray      # int32 [B, R]
    run_weights: np.ndarray   # float32 [B, R]
    run_len: int              # padded run length
    has_head: bool
    has_tail: bool
    shape_key: tuple


def plan_dense_merge(
    idx: DenseHeadIndex,
    queries: list[list[tuple[int, float]]],
    term_offsets: np.ndarray,
    term_lengths: np.ndarray,
    *,
    max_terms: int = 8,
) -> DenseMergePlan:
    """Split terms into head rows and tail merge runs (plan_run_lists)."""
    from nrtsearch_tpu_torch.ops.merge_scoring import plan_run_lists

    B = len(queries)
    used: dict[int, int] = {}       # head row id -> compact slot
    per_q: list[list[tuple[int, float]]] = []
    rows_tail: list[list[tuple[int, int, float]]] = []
    any_tail = False
    for entries in queries:
        merged: dict[int, float] = {}
        for tid, w in entries[: max_terms if max_terms else None]:
            if w != 0.0:
                merged[tid] = merged.get(tid, 0.0) + w
        row: list[tuple[int, int, float]] = []
        slots: list[tuple[int, float]] = []
        for tid, w in merged.items():
            r = idx.head_pos.get(int(tid))
            if r is not None:
                if r not in used:
                    used[r] = len(used)
                slots.append((used[r], w))
            else:
                ln = int(term_lengths[tid])
                if ln > 0:
                    row.append((int(term_offsets[tid]), ln, w))
                    any_tail = True
        per_q.append(slots)
        rows_tail.append(row)
    has_head = bool(used)
    U = _pow2(max(len(used), 1), 8)
    W = np.zeros((B, U), np.float32)
    row_idx = np.zeros(U, np.int32)
    for r, slot in used.items():
        row_idx[slot] = r
    for qi, slots in enumerate(per_q):
        for slot, w in slots:
            W[qi, slot] += w
    if any_tail:
        run_offs, run_lens, run_w, run_len = plan_run_lists(rows_tail, min_run=512)
    else:
        run_offs = np.zeros((B, 1), np.int32)
        run_lens = np.zeros((B, 1), np.int32)
        run_w = np.zeros((B, 1), np.float32)
        run_len = 0
    return DenseMergePlan(
        W, row_idx, run_offs, run_lens, run_w, run_len, has_head, any_tail,
        (B, U, has_head, any_tail, run_offs.shape[1], run_len),
    )


def _pack2(fs, fd, hits, exact):
    fd = torch.where(fs == _NEG, -1, fd.to(torch.int32))
    return torch.cat([fs.contiguous().view(torch.int32), fd.to(torch.int32),
                      hits[:, None].to(torch.int32), exact[:, None].to(torch.int32)],
                     dim=1)


def dense_merge_topk(
    rows,             # bf16 [Hp, D] dense head impact rows
    row_max,          # f32 [Hp] per-row max impact (head_ub ingredient)
    post_docs,        # int32 [P] packed postings
    post_impacts,     # float32 [P]
    W,                # f32 [B, U] compact head weight matrix
    row_idx,          # int32 [U] head rows used by this batch
    run_offs,         # int32 [B, R] tail run tables
    run_lens,         # int32 [B, R]
    run_weights,      # f32 [B, R]
    *,
    k: int,
    has_head: bool,
    has_tail: bool,
    run_len: int,
    exact_counts: bool = False,
):
    """Fused dense-head + merge-tail retrieval (exact f32 tail).

    Returns one packed int32 tensor [B, 2k+2]: scores (f32 bits) | docs |
    hits | counts_exact flag; decode with ``decode_packed2``."""
    B = W.shape[0]
    D = rows.shape[1]
    dev = W.device

    if has_head:
        # scatter the compact W into the full [B, Hp] matrix (pad slots add
        # 0 to row 0) and stream every row through one product
        W_full = torch.zeros((B, rows.shape[0]), dtype=torch.float32, device=dev)
        W_full.index_add_(1, row_idx.long(), W)
        S, head_s, head_d, head_hits = _head(rows, W_full, k)
        head_ub = torch.mv(W_full, row_max)                # [B]
    else:
        head_s, head_d, head_hits = _no_head(B, k, dev)
        head_ub = torch.zeros((B,), dtype=torch.float32, device=dev)

    if not has_tail:
        return _pack2(head_s, head_d, head_hits,
                      torch.ones((B,), dtype=torch.int32, device=dev))

    # ---- tail: gather runs -> bitonic merge -> per-doc segment sums -------
    R = run_offs.shape[1]
    docs, contribs = gather_runs(post_docs, post_impacts, run_offs, run_lens,
                                 run_weights, run_len)
    docs, contribs = merge_sorted_runs(docs, contribs)
    N = docs.shape[-1]
    seg_scores, _cnt, tail_pos, valid = segmented_scores(docs, contribs, max_seg=R)
    live = tail_pos & valid & (seg_scores > 0.0)
    tail_sum = torch.where(live, seg_scores, _NEG)             # [B, N]

    # head top-k entries whose doc also appears in the tail stream carry an
    # incomplete score: drop them (their complete score reaches the top-k
    # through the candidate window, guaranteed under the certificate)
    if has_head:
        p = _searchsorted_rows(docs, head_d)
        pc = torch.clamp(p, 0, N - 1)
        dup = (torch.gather(docs, 1, pc) == head_d) & (p < N)
        head_s2 = torch.where(dup, _NEG, head_s)
    else:
        head_s2 = head_s

    M = min(_pow2(4 * k, 128), N)

    def full():
        dc = torch.clamp(docs, 0, D - 1).long()
        if has_head:
            s_at = torch.gather(S, 1, dc)
        else:
            s_at = torch.zeros((B, N), dtype=torch.float32, device=dev)
        fin = torch.where(live, tail_sum + s_at, _NEG)
        # fin ascends by docid (the merged stream's order)
        fs, fd = _combine_topk_docid(fin, docs, head_s2, head_d, k)
        hits = head_hits + (live & (s_at == 0.0)).sum(dim=-1, dtype=torch.int32)
        return fs, fd, hits, torch.ones((B,), dtype=torch.int32, device=dev)

    if exact_counts or M >= N or not has_head:
        return _pack2(*full())

    # candidate window: the top-M tail docs by tail sum (the order of their
    # final-score upper bound tail_sum + head_ub), exact finals for those;
    # theta = the k-th of the candidate + head set lower-bounds the true
    # k-th score. An unselected tail doc scores at most the M-th tail sum +
    # head_ub: strictly below theta, the window's result is exact on docs
    # and scores (hits stay lower bounds)
    sel_sum, sel_pos = topk_lowest_index(tail_sum, M)
    sel_doc = torch.gather(docs, 1, sel_pos)
    sd = torch.clamp(sel_doc, 0, D - 1).long()
    s_at = torch.gather(S, 1, sd)
    fin = torch.where(sel_sum > _NEG, sel_sum + s_at, _NEG)
    # sel_doc is in tail-sum order, not docid order: the whole M + k set
    # goes through the lexicographic sort
    fs_p, fd_p = _topk_docid(torch.cat([fin, head_s2], dim=1),
                             torch.cat([sel_doc, head_d], dim=1), k)
    theta = fs_p[:, k - 1]
    residual = sel_sum[:, M - 1]
    all_selected = residual == _NEG
    safe_q = all_selected | (residual + head_ub < theta)
    HOST_SYNCS["window_certificate"] += 1
    if bool(safe_q.all().item()):
        WINDOW_BRANCH["window"] += 1
        hits_p = head_hits + ((sel_sum > _NEG) & (s_at == 0.0)).sum(
            dim=-1, dtype=torch.int32)
        return _pack2(fs_p, fd_p, hits_p, all_selected.to(torch.int32))
    WINDOW_BRANCH["full"] += 1
    return _pack2(*full())


def dispatch_merge(
    idx: DenseHeadIndex,
    plan: DenseMergePlan,
    post_docs,
    post_impacts,
    k: int,
    *,
    exact_counts: bool = False,
):
    """Run one planned batch on the merge-tail path. Returns the packed
    [B, 2k+2] tensor (decode with ``decode_packed2``)."""
    dev = idx.rows.device

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return dense_merge_topk(
        idx.rows, idx.row_max, post_docs, post_impacts, put(plan.W), put(plan.row_idx),
        put(plan.run_offs), put(plan.run_lens), put(plan.run_weights),
        k=k, has_head=plan.has_head, has_tail=plan.has_tail, run_len=plan.run_len,
        exact_counts=exact_counts,
    )


# ---------------------------------------------------------------------------
# The numpy oracle of the bucket-tail route
# ---------------------------------------------------------------------------


def reference_dense_search(
    post_docs,
    post_impacts,
    idx: DenseHeadIndex,
    queries: list[list[tuple[int, float]]],
    term_offsets,
    term_lengths,
    k: int,
    *,
    max_terms: int = 8,
):
    """The reference's numpy replication: head contributions of bf16-rounded
    weights and impacts (f32 products), the tail's 15-bit quantization with
    the plan's own f32 weight tables, per-doc sums in f64 in the reference's
    order (head rows in row order, then the tail), rank by (-score, doc).
    Vectorized per term. Returns (scores f32 [B, k] -inf padded, docs int32
    [B, k] -1 padded, hits int64 [B])."""
    post_docs = np.asarray(post_docs)
    post_impacts = np.asarray(post_impacts)
    plan = plan_dense_batch(idx, queries, term_offsets, max_terms=max_terms)
    B = len(queries)
    out_scores = np.full((B, k), -np.inf, np.float32)
    out_docs = np.full((B, k), -1, np.int32)
    hits = np.zeros(B, np.int64)
    n_docs = int(post_docs.max(initial=0)) + 1
    for qi in range(B):
        acc = np.zeros(n_docs, np.float64)
        seen = np.zeros(n_docs, bool)
        for row in np.nonzero(plan.W[qi])[0]:
            tid = int(idx.head_ids[int(row)])
            wq = _bf16_round(plan.W[qi, row : row + 1])[0]
            off = int(term_offsets[tid])
            ln = int(term_lengths[tid])
            docs = post_docs[off : off + ln]
            imps = post_impacts[off : off + ln]
            contrib = wq * _bf16_round(imps)
            lv = imps > 0.0
            acc[docs[lv]] += contrib[lv].astype(np.float64)
            seen[docs[lv]] = True
        if plan.tail is not None:
            tp = plan.tail
            tail_acc = np.zeros(n_docs, np.int64)
            tail_seen = np.zeros(n_docs, bool)
            for ti in range(tp.term_offs.shape[1]):
                wt = tp.weights[qi, ti]
                if wt == 0.0:
                    continue
                off = int(tp.term_offs[qi, ti])
                ln = int(tp.bounds[qi, ti, -1])
                docs = post_docs[off : off + ln]
                imps = post_impacts[off : off + ln]
                quant = np.clip((wt * imps + 0.5).astype(np.int64), 1, QMAX)
                lv = imps > 0.0
                np.add.at(tail_acc, docs[lv], quant[lv])
                tail_seen[docs[lv]] = True
            td = np.nonzero(tail_seen)[0]
            share = (np.minimum(tail_acc[td], QMAX).astype(np.float32)
                     / tp.scales[qi]).astype(np.float32)
            acc[td] += share.astype(np.float64)
            seen[td] = True
        cand = np.nonzero(seen & (acc > 0))[0]
        hits[qi] = len(cand)
        order = np.lexsort((cand, -acc[cand]))[:k]
        out_scores[qi, : len(order)] = acc[cand[order]]
        out_docs[qi, : len(order)] = cand[order]
    return out_scores, out_docs, hits
