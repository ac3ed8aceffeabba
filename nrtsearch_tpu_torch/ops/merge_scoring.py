"""Scatter-free batched BM25: bitonic merge of doc-sorted postings runs.

Counterpart: nrtsearch_tpu/ops/merge_scoring.py. Each query term's postings
are contiguous doc-sorted runs; the runs are gathered into [B, R, run_len]
with LOW/HIGH doc sentinels, merged into one doc-sorted stream by a bitonic
network, summed per doc with a bounded-distance segmented scan, and cut to
the top k under Lucene's (score desc, docid asc) contract. Scores are exact
f32 and bit-equal to the reference: every stage keeps its operation order.

``merge_score_topk`` has the reference's two branches, chosen by
``use_pallas`` (the reference's name; default: the postings live on CUDA):

- the accelerator branch (the counterpart of ``merge_scoring.py:372-429``):
  the unclamped run gather (``gather_runs_accel``); from a merged width of
  ``ALT_MIN_WIDTH`` on, odd runs come out descending and the
  alternating-direction network (``bitonic_merge.merge_sorted_runs_alt``)
  merges them with no per-level reversal, and ``finish_mask`` sums and masks
  in one pass; below it, the plain network and ``_finish``. On CUDA every
  step is a kernel; on the CPU the twins run, which is how tests reach it.
- the plain branch (the reference's XLA path): the clamping ``gather_runs``,
  the plain network with a reversal per level and the shifted-add scan.
  On CUDA its merge levels still go through the far/near kernels.

Both branches take the reference's column arguments in its order
(``merge_scoring.py:372-462``): a filter gates the merged contributions
before the finish; flat reductions read the finish's match stream; then
sort keys replace the masked scores (negated for an ascending sort, and
negated back after the top-k), or the additive column is added to them; a
count threshold counts the masked values at or above it.
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops import bitonic_merge
from nrtsearch_tpu_torch.ops.topk import topk_lowest_index

DOC_SENTINEL = np.int32(2**31 - 1)       # back padding (sorts last)
DOC_SENTINEL_LOW = np.int32(-(2**31) + 1)  # front padding (sorts first)

# host syncs taken by _hierarchical_topk's exactness check, one per call
HOST_SYNCS = {"hierarchical_topk": 0}
# _hierarchical_topk calls whose check failed and that took the full
# stable sort (a tie plateau at tau, or fewer than k rows with a match)
TOPK_FALLBACKS = {"hierarchical_topk": 0}
# merged width from which the accelerator branch takes the alternating
# network: the reference's TILE (pallas_merge.py:31). It picks the network,
# not a tile, so it keeps the reference's value.
ALT_MIN_WIDTH = 1 << 17
# networks taken by the accelerator branch, one per merge_score_topk call
MERGE_BRANCH = {"alt": 0, "plain": 0}


def _pow2(n: int, minimum: int = 1) -> int:
    """Smallest power of two >= n (and >= minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def plan_run_lists(
    rows: list[list[tuple[int, int, float]]],  # per-query [(off, len, weight)]
    *,
    min_run: int = 1024,
    max_run: int = 0,   # cap run_len (must not exceed the postings array)
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Plan per-query run lists into padded [B, R] tables with one shared
    power-of-two run_len that minimizes the merged width R * run_len
    (ties go to the longer run_len: fewer merge levels). Long runs are
    chunked; chunks of one term partition its docs, so per-doc term counts
    are unchanged. Returns (run_offs, run_lens, run_weights, run_len)."""
    B = len(rows)
    max_df = max((ln for row in rows for _, ln, _ in row), default=1)

    def width(rl: int) -> int:
        max_runs = 1
        for row in rows:
            runs = sum(-(-ln // rl) for _, ln, _ in row)
            max_runs = max(max_runs, runs)
        return _pow2(max_runs, 2) * rl

    if max_run:
        min_run = min(min_run, max_run)
    candidates = []
    rl = _pow2(max(min_run, 1))
    top = max(_pow2(max_df), rl)
    if max_run:
        top = min(top, _pow2(max_run) if max_run == _pow2(max_run) else max_run)
    while rl <= top:
        candidates.append(rl)
        rl <<= 1
    if not candidates:
        candidates = [rl]
    run_len = min(candidates, key=lambda rl_: (width(rl_), -rl_))

    chunked = []
    max_runs = 1
    for row in rows:
        runs = []
        for off, ln, w in row:
            for start in range(0, ln, run_len):
                runs.append((off + start, min(run_len, ln - start), w))
        chunked.append(runs)
        max_runs = max(max_runs, len(runs))
    R = _pow2(max_runs, 2)
    out_offs = np.zeros((B, R), np.int32)
    out_lens = np.zeros((B, R), np.int32)
    out_w = np.zeros((B, R), np.float32)
    for b, runs in enumerate(chunked):
        for i, (o, ln, w) in enumerate(runs):
            out_offs[b, i] = o
            out_lens[b, i] = ln
            out_w[b, i] = w
    return out_offs, out_lens, out_w, run_len


def gather_runs(post_docs, post_impacts, offs, lens, weights, run_len: int):
    """[B, R] run tables -> docs int32 [B, R, run_len], contribs f32.

    A run that would read past the postings end is clamped back (as
    ``dynamic_slice`` clamps): its data then starts at ``shift``. Front
    padding gets the LOW sentinel and back padding the HIGH one, so every
    run stays sorted. Unused slots (weight 0) are all HIGH sentinel."""
    dev = post_docs.device
    p_total = post_docs.shape[0]
    offs = offs.to(torch.int64)
    start = torch.clamp(offs, max=p_total - run_len)
    shift = (offs - start)[..., None]
    pos = torch.arange(run_len, device=dev, dtype=torch.int64)
    idx = start[..., None] + pos
    docs = post_docs[idx]
    imps = post_impacts[idx]
    in_run = (pos >= shift) & (pos < shift + lens[..., None]) & (weights != 0.0)[..., None]
    high = torch.full((), int(DOC_SENTINEL), dtype=torch.int32, device=dev)
    low = torch.full((), int(DOC_SENTINEL_LOW), dtype=torch.int32, device=dev)
    docs = torch.where(pos < shift, low, torch.where(in_run, docs, high))
    contribs = torch.where(in_run, weights[..., None] * imps,
                           torch.zeros((), dtype=torch.float32, device=dev))
    return docs, contribs


def gather_runs_twin(post_docs, post_impacts, offs, lens, weights, run_len: int,
                     alternating: bool = False):
    """Plain torch twin of the accelerator gather (``gather_runs_pallas``):
    [B, R] run tables -> docs int32 [B, R, run_len], contribs f32.

    Position p of a run holds source entry q = p (q = run_len-1-p for an odd
    run when ``alternating``: the whole run reversed, so it reads
    descending). Where q < len and the weight is not 0 it holds the posting's
    doc and ``w * imp``; everywhere else the HIGH sentinel and 0. Nothing is
    clamped and there is no LOW padding: a run never reads past its own
    length, which the caller keeps inside the postings."""
    dev = post_docs.device
    pos = torch.arange(run_len, device=dev, dtype=torch.int64)
    q = pos.expand(offs.shape[1], run_len)
    if alternating:
        odd = (torch.arange(offs.shape[1], device=dev) % 2 == 1)[:, None]
        q = torch.where(odd, run_len - 1 - pos, pos)
    valid = (q < lens[..., None]) & (weights != 0.0)[..., None]
    idx = torch.where(valid, offs.to(torch.int64)[..., None] + q, 0)
    docs = torch.where(valid, post_docs[idx],
                       torch.full((), int(DOC_SENTINEL), dtype=torch.int32, device=dev))
    contribs = torch.where(valid, weights[..., None] * post_impacts[idx],
                           torch.zeros((), dtype=torch.float32, device=dev))
    return docs, contribs


def gather_runs_accel(post_docs, post_impacts, offs, lens, weights,
                      run_len: int, alternating: bool = False):
    """The accelerator branch's gather: the CUDA kernel for CUDA tensors,
    ``gather_runs_twin`` for CPU ones."""
    if on_cuda(post_docs):
        return kernels.gather_runs(post_docs, post_impacts, offs, lens, weights,
                                   run_len, alternating)
    return gather_runs_twin(post_docs, post_impacts, offs, lens, weights,
                            run_len, alternating)


def _compare_exchange(docs, payloads, d: int):
    """One ascending bitonic stage at distance d (plain torch twin): pairs
    (i, i + d) inside each 2d block swap when lo > hi strictly."""
    n = docs.shape[-1]
    shape = docs.shape[:-1]

    def halves(x):
        x2 = x.reshape(*shape, n // (2 * d), 2, d)
        return x2[..., 0, :], x2[..., 1, :]

    lo, hi = halves(docs)
    swap = lo > hi

    def ce(x):
        a, b = halves(x)
        out = torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)], dim=-2)
        return out.reshape(*shape, n)

    return ce(docs), [ce(p) for p in payloads]


def _bitonic_merge_level(docs, payloads, run_len: int):
    """Merge adjacent sorted runs of length run_len into runs of 2*run_len."""
    n = docs.shape[-1]
    shape = docs.shape[:-1]

    # reverse every second run -> bitonic sequences of length 2*run_len
    def rev(x):
        x2 = x.reshape(*shape, n // (2 * run_len), 2, run_len)
        x2 = torch.stack([x2[..., 0, :], torch.flip(x2[..., 1, :], dims=(-1,))], dim=-2)
        return x2.reshape(*shape, n)

    docs = rev(docs)
    payloads = [rev(p) for p in payloads]
    if on_cuda(docs):
        if len(payloads) != 1 or docs.dim() != 2:
            raise NotImplementedError(
                "the CUDA merge takes [B, N] docs with exactly one f32 payload"
            )
        docs, p0 = bitonic_merge.merge_level(docs, payloads[0], run_len)
        return docs, [p0]
    d = run_len
    while d >= 1:
        docs, payloads = _compare_exchange(docs, payloads, d)
        d //= 2
    return docs, payloads


def merge_sorted_runs(docs, *payloads):
    """Merge R sorted runs [..., R, L] -> fully sorted [..., R*L].

    R and L must be powers of two; pad runs with DOC_SENTINEL."""
    shape = docs.shape[:-2]
    R, L = docs.shape[-2], docs.shape[-1]
    docs = docs.reshape(*shape, R * L)
    payloads = [p.reshape(*shape, R * L) for p in payloads]
    run_len = L
    while run_len < R * L:
        docs, payloads = _bitonic_merge_level(docs, payloads, run_len)
        run_len *= 2
    return (docs, *payloads)


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    pad = torch.full((*x.shape[:-1], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def segmented_scores(docs_sorted, contribs, max_seg: int):
    """Per-doc segment sums over a doc-sorted stream.

    Returns (seg_scores, seg_counts, is_tail, valid): seg_scores holds the
    full per-doc sum at each segment's tail position, seg_counts the number
    of entries of the doc. ``max_seg`` is the most entries one doc can have
    (the run count): the sums are the reference's bounded-distance
    segmented scan, log2(max_seg) shifted adds in the same order, so scores
    are bit-equal to it. (The reference's unbounded cumsum form serves only
    streams of one entry per run, which no ported caller builds.)"""
    n = docs_sorted.shape[-1]
    if not 0 < max_seg < n:
        raise ValueError(f"max_seg must be in (0, {n}), got {max_seg}")
    valid = (docs_sorted != int(DOC_SENTINEL)) & (docs_sorted != int(DOC_SENTINEL_LOW))
    nxt = torch.cat(
        [docs_sorted[..., 1:], torch.full_like(docs_sorted[..., :1], -2)], dim=-1
    )
    tail = docs_sorted != nxt
    zero_f = torch.zeros((), dtype=contribs.dtype, device=contribs.device)
    # segmented inclusive scan: equal doc ids are contiguous, so
    # docs[i] == docs[i-d] implies no segment boundary in between
    seg_scores = contribs
    seg_counts = valid.to(torch.int32)
    d = 1
    while d < max_seg:
        same = docs_sorted == _shift_right(docs_sorted, d, -1)
        shifted_s = _shift_right(seg_scores, d, 0.0)
        shifted_c = _shift_right(seg_counts, d, 0)
        seg_scores = seg_scores + torch.where(same, shifted_s, zero_f)
        seg_counts = seg_counts + torch.where(same, shifted_c, 0)
        d <<= 1
    return seg_scores, seg_counts, tail, valid


def finish_mask_twin(docs_sorted, contribs, n_terms, max_seg: int,
                     require_all: bool):
    """Plain torch twin of ``finish_mask_pallas``: [B, N] merged stream ->
    f32 [B, N], the per-doc sum at each doc's last entry where it is valid,
    > 0 and (with ``require_all``) counts at least n_terms[b] entries; -inf
    everywhere else. The sums are ``segmented_scores``'."""
    seg_scores, seg_counts, tail, valid = segmented_scores(docs_sorted, contribs, max_seg)
    ok = tail & valid & (seg_scores > 0.0)
    if require_all:
        ok = ok & (seg_counts >= n_terms[:, None])
    return torch.where(ok, seg_scores, float("-inf"))


def finish_mask(docs_sorted, contribs, n_terms, max_seg: int, require_all: bool):
    """One-pass segmented sum and tail mask: the CUDA kernel for CUDA
    tensors, ``finish_mask_twin`` for CPU ones."""
    n = docs_sorted.shape[-1]
    if not 0 < max_seg < n:
        raise ValueError(f"max_seg must be in (0, {n}), got {max_seg}")
    if on_cuda(docs_sorted):
        return kernels.finish_mask(docs_sorted, contribs, n_terms, max_seg, require_all)
    return finish_mask_twin(docs_sorted, contribs, n_terms, max_seg, require_all)


def merge_score_topk(
    post_docs: torch.Tensor,      # int32 [P_pad] doc-sorted postings (flat)
    post_impacts: torch.Tensor,   # float32 [P_pad] impacts, 0 for deleted docs
    term_offsets: torch.Tensor,   # int32 [B, R]
    term_lengths: torch.Tensor,   # int32 [B, R]
    term_weights: torch.Tensor,   # float32 [B, R] idf * boost (0 => unused)
    n_terms: torch.Tensor,        # int32 [B] required term count (AND mode)
    *,
    run_len: int,
    k: int,
    require_all_terms: bool = False,
    use_pallas: bool | None = None,
    filter_mask=None,
    additive=None,
    sort_keys=None,
    sort_ascending: bool = True,
    count_threshold=None,
    reduce_cols=(),
    reduce_kinds=(),
):
    """Scatter-free retrieval. Returns (scores [B, k], docs [B, k],
    hits [B]), plus counts [B] of masked values at or above
    ``count_threshold`` [B] when it is given, or else the list of flat
    reductions when ``reduce_kinds`` is given (see ``_flat_reductions``).
    Deleted docs carry zero impacts and drop out through the ``score > 0``
    mask. ``filter_mask`` (bool [D]), ``additive`` and ``sort_keys`` (f32
    [D]) are indexed by doc id; with sort keys the returned scores are the
    keys. ``use_pallas`` picks the accelerator branch (None: when the
    postings live on CUDA); see the module docstring."""
    if use_pallas is None:
        use_pallas = on_cuda(post_docs)
    R = term_offsets.shape[1]
    cols = dict(additive=additive, sort_keys=sort_keys, sort_ascending=sort_ascending,
                count_threshold=count_threshold, reduce_cols=reduce_cols,
                reduce_kinds=reduce_kinds)
    if not use_pallas:
        docs, contribs = gather_runs(
            post_docs, post_impacts, term_offsets, term_lengths, term_weights, run_len
        )
        docs, contribs = merge_sorted_runs(docs, contribs)
        if filter_mask is not None:
            contribs = contribs * _filter_gate(docs, filter_mask)
        return _finish(docs, contribs, n_terms, k, require_all_terms, max_seg=R, **cols)
    alt = R * run_len >= ALT_MIN_WIDTH
    MERGE_BRANCH["alt" if alt else "plain"] += 1
    docs, contribs = gather_runs_accel(
        post_docs, post_impacts, term_offsets, term_lengths, term_weights,
        run_len, alternating=alt,
    )
    if alt:
        docs, contribs = bitonic_merge.merge_sorted_runs_alt(docs, contribs)
    else:
        docs, contribs = merge_sorted_runs(docs, contribs)
    if filter_mask is not None:
        contribs = contribs * _filter_gate(docs, filter_mask)
    if not alt:
        return _finish(docs, contribs, n_terms, k, require_all_terms, max_seg=R, **cols)
    masked = finish_mask(docs, contribs, n_terms, R, require_all_terms)
    return _rank_topk(masked, docs, k, _hierarchical_topk, **cols)


def _hierarchical_topk(masked: torch.Tensor, k: int):
    """Exact top-k over a long masked stream via row-max thresholding.

    tau = the k-th largest per-128-entry row maximum is a lower bound of the
    k-th value, so every top-k entry lives in a row whose max >= tau. When
    at most r_take rows reach tau, the top-k of those rows (in ascending
    row order, so ties keep the lowest index) equals the full top-k. The
    reference picks the branch with ``lax.cond``; the port checks on the
    host: one sync per call, counted in HOST_SYNCS."""
    B, N = masked.shape
    nr = N // 128
    r_take = 256
    while r_take < 2 * k:
        r_take <<= 1
    if nr < 2 * r_take or N % 128:
        return topk_lowest_index(masked, k)
    m3 = masked.reshape(B, nr, 128)
    row_max = m3.amax(dim=-1)
    rm_top, rm_idx = topk_lowest_index(row_max, r_take)
    tau = rm_top[:, k - 1 : k]
    safe = ((row_max >= tau).sum(dim=-1) <= r_take).all() & (tau > float("-inf")).all()
    HOST_SYNCS["hierarchical_topk"] += 1
    if not bool(safe.item()):
        TOPK_FALLBACKS["hierarchical_topk"] += 1
        return topk_lowest_index(masked, k)
    rows_sorted = torch.sort(rm_idx, dim=-1).values
    cand = torch.gather(m3, 1, rows_sorted[..., None].expand(B, r_take, 128))
    cs, ci = topk_lowest_index(cand.reshape(B, r_take * 128), k)
    row = torch.gather(rows_sorted, 1, ci // 128)
    return cs, row * 128 + ci % 128


def _filter_gate(docs: torch.Tensor, filter_mask: torch.Tensor) -> torch.Tensor:
    """Per-entry gate: 1.0 where the doc passes the filter, else 0.0.
    Sentinel entries read a clamped index; their contribs are already 0."""
    idx = torch.clamp(docs, 0, filter_mask.shape[0] - 1)
    return filter_mask[idx].to(torch.float32)


def _rank_by_keys(masked, docs, sort_keys, ascending: bool):
    """Matched entries take their doc's sort key (negated when ascending,
    so the largest-first top-k ranks them; ties keep the lower position,
    that is the lower doc id)."""
    keys = sort_keys[torch.clamp(docs, 0, sort_keys.shape[0] - 1)]
    if ascending:
        keys = -keys
    return torch.where(masked > float("-inf"), keys, float("-inf"))


def _flat_reductions(match, docs, reduce_cols, reduce_kinds) -> list:
    """Flat field reductions over the finish's unique-match stream.

    match: bool [B, W], True exactly at matched docs' tail entries.
    docs: int32 [B, W] doc ids. reduce_cols: per reduction, (values [D],
    present [D] or None); ordinal columns hold the global ordinal (-1 where
    absent). reduce_kinds: per reduction, ("ordinal", n_ords) |
    ("sum"|"min"|"max",) | ("count",). Returns int32 [B, n_ords] per
    ordinal reduction, f32 [B] per stat (f64 for an f64 sum), int32 [B] per
    count."""
    out = []
    for (vals, present), kind in zip(reduce_cols, reduce_kinds):
        if kind[0] == "count":
            out.append(match.sum(dim=-1, dtype=torch.int32))
            continue
        safe = torch.clamp(docs, 0, vals.shape[0] - 1)
        g = vals[safe]
        eff = match if present is None else match & present[safe]
        if kind[0] == "ordinal":
            n_ords = int(kind[1])
            gi = g.to(torch.int32)
            # ordinal n collects every entry that counts for none
            slot = torch.where(eff & (gi >= 0), gi, n_ords).to(torch.int64)
            counts = torch.zeros((match.shape[0], n_ords + 1), dtype=torch.int32,
                                 device=match.device)
            counts.scatter_add_(1, slot, torch.ones_like(gi))
            out.append(counts[:, :n_ords])
        elif kind[0] == "sum":
            v = g if g.dtype == torch.float64 else g.to(torch.float32)
            out.append(torch.where(eff, v, 0.0).sum(dim=-1))
        elif kind[0] == "min":
            out.append(torch.where(eff, g.to(torch.float32), float("inf")).amin(dim=-1))
        elif kind[0] == "max":
            out.append(torch.where(eff, g.to(torch.float32), float("-inf")).amax(dim=-1))
        else:
            raise ValueError(f"unknown reduction kind: {kind!r}")
    return out


def _rank_topk(masked, docs, k: int, topk, *, additive=None, sort_keys=None,
               sort_ascending: bool = True, count_threshold=None, reduce_cols=(),
               reduce_kinds=()):
    """The column half of the finish, over a masked stream (the per-doc
    sum at each matched doc's last entry, -inf elsewhere): hit counts and
    reductions from the match stream, then sort keys or the additive
    column, then the top-k by ``topk`` (a top-k with the lower-index tie
    rule)."""
    neg = float("-inf")
    ok = masked > neg
    total_hits = ok.sum(dim=-1, dtype=torch.int32)
    reductions = (_flat_reductions(ok, docs, reduce_cols, reduce_kinds)
                  if reduce_kinds else None)
    if sort_keys is not None:
        masked = _rank_by_keys(masked, docs, sort_keys, sort_ascending)
    elif additive is not None:
        extra = additive[torch.clamp(docs, 0, additive.shape[0] - 1)]
        masked = torch.where(ok, masked + extra, neg)
    top_scores, pos = topk(masked, k)
    top_docs = torch.gather(docs, 1, pos)
    if sort_keys is not None and sort_ascending:
        top_scores = torch.where(top_scores > neg, -top_scores, top_scores)
    if count_threshold is not None:
        n_above = (masked >= count_threshold[:, None]).sum(dim=-1, dtype=torch.int32)
        return top_scores, top_docs, total_hits, n_above
    if reductions is not None:
        return top_scores, top_docs, total_hits, reductions
    return top_scores, top_docs, total_hits


def _finish(docs, contribs, n_terms, k: int, require_all_terms: bool,
            max_seg: int, **cols):
    masked = finish_mask_twin(docs, contribs, n_terms, max_seg, require_all_terms)
    return _rank_topk(masked, docs, k, topk_lowest_index, **cols)
