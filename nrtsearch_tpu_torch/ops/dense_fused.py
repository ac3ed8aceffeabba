"""Fused dense-head retrieval: compact head rows + window combine.

Counterpart: nrtsearch_tpu/ops/dense_fused.py (``gather_rows``,
``dense_fused_topk``, ``dispatch_fused``). Head terms (df >= min_df) are dense bf16 impact rows
[Hp, D]; a batch scores just its U rows with bf16 products accumulated in
f32, and the Dekker residual rows recover ~f32 head scores with three more
products (``head_scores``: on the card one kernel, csrc/head_scores.cu, that
reads each gathered row slice once and never writes the [U, D] gather;
``head_scores_plain``, the reference's gather and products, elsewhere). Tail
terms are exact f32 postings runs through the bitonic merge
(ops/merge_scoring.py). The combine is either the candidate window under
its theta certificate (plain OR queries) or the full combine at every tail
position.

Score contract (as the reference's): query weights and head impacts
quantize through bf16 with f32 accumulation, the Dekker rows make head
scores ~f32-exact (rel err ~2^-17), the tail is exact f32, and ties break
(score desc, docid asc).

Where the reference branches on the device with ``lax.cond`` (the window
certificate, and _hierarchical_topk), the port reads the condition on the
host: one sync per batch each, counted in ``HOST_SYNCS``.
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.device import exact_cuda_matmul, on_cuda
from nrtsearch_tpu_torch.ops.dense_head import (
    NEG_INF,
    _combine_topk_docid,
    _searchsorted_rows,
    _topk_docid,
)
from nrtsearch_tpu_torch.ops.merge_scoring import (
    _hierarchical_topk,
    _pow2,
    gather_runs,
    merge_sorted_runs,
    segmented_scores,
)
from nrtsearch_tpu_torch.ops.topk import topk_lowest_index

# host syncs taken by the window certificate, one per windowed batch
HOST_SYNCS = {"window_certificate": 0}
# which combine served each windowed batch (window = certified, full =
# escalated) — lets tests and the smoke run see both branches
WINDOW_BRANCH = {"window": 0, "full": 0}

_NEG = float(NEG_INF)


def _gather_rows_scan(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch row gather rows[idx] (the reference's scan gather). Pad
    slots in ``idx`` may repeat row 0; their weights are zero."""
    return rows.index_select(0, idx.to(torch.int64))


def cuda_bf16_mm_f32_out() -> bool:
    """Whether this torch has a CUDA kernel for ``mm`` with an f32 output
    of bf16 operands (``torch.mm(..., out_dtype=torch.float32)``)."""
    return "dtype" in torch.ops.aten.mm.overloads() and \
        torch._C._dispatch_has_kernel_for_dispatch_key("aten::mm.dtype", "CUDA")


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-accumulated product of two bf16 operands, f32 out. On CUDA a
    bf16 product with f32 output where torch has one; otherwise (and on the
    CPU, as the reference does there) an f32 product of the bf16 values,
    whose products are exact in f32."""
    if on_cuda(a):
        exact_cuda_matmul()
        if cuda_bf16_mm_f32_out():
            return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def head_scores_plain(rows, rows_lo, row_idx, W, require_all: bool):
    """Plain torch version of the head-scores kernel, in the reference's
    order: gather the U rows, S = W_hi·R (+ W_hi·L + W_lo·R + W_lo·L with
    the Dekker rows), W quantized through bf16; C = (W != 0)·(R > 0) for
    the all-head conjunction, else None."""
    rows_used = _gather_rows_scan(rows, row_idx)         # [U, D] bf16
    # W always quantizes through bf16 (the dense score contract)
    W_hi = W.to(torch.bfloat16)
    S = _mm(W_hi, rows_used)                             # [B, D] f32
    if rows_lo is not None:
        # Dekker-style correction: three more compact products recover the
        # bf16 quantization of both operands, lo-lo term included
        lo_used = _gather_rows_scan(rows_lo, row_idx)
        W_lo = (W - W_hi.float()).to(torch.bfloat16)
        S = S + _mm(W_hi, lo_used) + _mm(W_lo, rows_used) + _mm(W_lo, lo_used)
    C = None
    if require_all:
        ind = (rows_used > 0).to(torch.bfloat16)
        Wind = (W != 0.0).to(torch.bfloat16)
        C = _mm(Wind, ind)
    return S, C


def head_scores(rows, rows_lo, row_idx, W, require_all: bool):
    """Head scores S f32 [B, D] of weights W f32 [B, U] over the head rows
    ``row_idx`` (and, with ``require_all``, the count C f32 [B, D] of each
    query's head terms a doc holds; else None). The CUDA kernel for CUDA
    tensors, ``head_scores_plain`` for CPU tensors; inputs on two devices
    raise."""
    ins = [rows, row_idx, W] + ([] if rows_lo is None else [rows_lo])
    if len({t.device for t in ins}) != 1:
        raise ValueError(f"head_scores inputs on several devices: "
                         f"{sorted({str(t.device) for t in ins})}")
    if not on_cuda(rows):
        return head_scores_plain(rows, rows_lo, row_idx, W, require_all)
    W_hi = W.to(torch.bfloat16)
    W_lo = None if rows_lo is None else (W - W_hi.float()).to(torch.bfloat16)
    return kernels.head_scores(rows, rows_lo, row_idx, W_hi, W_lo, require_all)


def dense_fused_topk(
    rows,             # bf16 [Hp, D] resident head impact rows
    row_max,          # f32 [Hp] per-row max impact (head_ub ingredient)
    post_docs,        # int32 [P] packed postings
    post_impacts,     # float32 [P]
    W,                # f32 [B, U] compact head weight matrix
    row_idx,          # int32 [U] head rows used by this batch (pad: 0)
    n_req,            # int32 [B] required distinct terms (AND mode)
    run_offs,         # int32 [B, R] tail run tables
    run_lens,         # int32 [B, R]
    run_weights,      # f32 [B, R]
    filt=None,        # optional bool [D]: docs failing it match nothing
    additive=None,    # optional f32 [D]: added to matched docs' scores
    sort_keys=None,   # optional f32 [D]: rank matched docs by this key
    rows_lo=None,     # optional bf16 [Hp, D] Dekker residual rows
    *,
    k: int,
    has_head: bool,
    has_tail: bool,
    run_len: int,
    require_all: bool = False,
    sort_ascending: bool = True,
    prune: bool = True,
    exact_counts: bool = False,
):
    """Fused dense retrieval: exact docs and scores for every variant.

    Returns one packed int32 tensor [B, 2k+2]: scores (f32 bits) | docs |
    hits | counts_exact flag; decode with ``ops.dense_head.decode_packed2``.
    Plain OR queries take the candidate-window combine (hits may then be
    lower bounds); ``exact_counts=True`` forces the full combine."""
    B = W.shape[0]
    D = rows.shape[1]
    dev = W.device
    filt_b = None if filt is None else filt.to(torch.bool)

    if has_head:
        S, C = head_scores(rows, rows_lo, row_idx, W, require_all)   # [B, D] f32
        matched = S > 0.0
        if require_all:
            matched = matched & (C >= n_req[:, None].float())
        if filt_b is not None:
            matched = matched & filt_b[None, :]
        base = S if additive is None else S + additive[None, :]
        if sort_keys is not None:
            skey = -sort_keys if sort_ascending else sort_keys
            rank = skey[None, :].expand(B, D)
        else:
            rank = base
        masked = torch.where(matched, rank, _NEG)
        head_s, head_d = _hierarchical_topk(masked, k)
        head_d = head_d.to(torch.int32)
        head_hits = matched.sum(dim=-1, dtype=torch.int32)
        # per-query head upper bound for the window certificate; the small
        # slack covers bf16 upward rounding. A negative weight makes this an
        # under-estimate: kept as the reference computes it (ROADMAP §3)
        rmax = torch.clamp(row_max[row_idx.long()], min=0.0)
        head_ub = (W * rmax[None, :]).sum(dim=1) * (1.0 + 2.0**-6)
    else:
        S = None
        head_s = torch.full((B, k), _NEG, dtype=torch.float32, device=dev)
        head_d = torch.zeros((B, k), dtype=torch.int32, device=dev)
        head_hits = torch.zeros((B,), dtype=torch.int32, device=dev)
        head_ub = torch.zeros((B,), dtype=torch.float32, device=dev)

    def pack(fs, fd, hits, exact):
        if sort_keys is not None and sort_ascending:
            fs = torch.where(fs > _NEG, -fs, fs)
        fd = torch.where(fs == _NEG, -1, fd.to(torch.int32))
        return torch.cat(
            [fs.view(torch.int32), fd.to(torch.int32),
             hits[:, None].to(torch.int32), exact[:, None].to(torch.int32)],
            dim=1,
        )

    if not has_tail:
        return pack(head_s, head_d, head_hits,
                    torch.ones((B,), dtype=torch.int32, device=dev))

    # ---- tail: gather runs -> bitonic merge -> per-doc segment sums -------
    R = run_offs.shape[1]
    docs, contribs = gather_runs(
        post_docs, post_impacts, run_offs, run_lens, run_weights, run_len
    )
    docs, contribs = merge_sorted_runs(docs, contribs)
    N = docs.shape[-1]
    seg_scores, _cnt, tail_pos, valid = segmented_scores(docs, contribs, max_seg=R)
    live = tail_pos & valid & (seg_scores > 0.0)

    # head top-k entries whose doc also appears live in the tail stream
    # would double-count: drop the head copy (the complete entry reaches the
    # top-k through the stream)
    if has_head:
        p = _searchsorted_rows(docs, head_d)
        pc = torch.clamp(p, 0, N - 1)
        dup = (
            (torch.gather(docs, 1, pc) == head_d)
            & torch.gather(live, 1, pc)
            & (p < N)
        )
        head_s2 = torch.where(dup, _NEG, head_s)
    else:
        head_s2 = head_s

    dc = torch.clamp(docs, 0, D - 1).long()

    def full():
        """Exact combine: head scores (+ filter/additive/sort columns) at
        every tail position by element gathers; exact hit counts."""
        if has_head:
            s_at = torch.gather(S, 1, dc)
        else:
            s_at = torch.zeros((B, N), dtype=torch.float32, device=dev)
        lv = live
        if filt_b is not None:
            lv = lv & filt_b[dc]
        fin_base = seg_scores + s_at
        if additive is not None:
            fin_base = fin_base + additive[dc]
        if sort_keys is not None:
            skey = -sort_keys if sort_ascending else sort_keys
            fin_rank = skey[dc]
        else:
            fin_rank = fin_base
        fin = torch.where(lv, fin_rank, _NEG)
        fs, fd = _combine_topk_docid(fin, docs, head_s2, head_d, k)
        hits = head_hits + (lv & (s_at == 0.0)).sum(dim=-1, dtype=torch.int32)
        return fs, fd, hits, torch.ones((B,), dtype=torch.int32, device=dev)

    plain = (
        has_head and filt is None and additive is None
        and sort_keys is None and not require_all
    )
    M = min(_pow2(4 * k, 128), N)
    if not (plain and prune and not exact_counts) or M >= N:
        return pack(*full())

    # candidate window: top-M tail docs by tail sum, exact finals for just
    # those, theta = k-th of the combined candidate + head set. Any
    # unselected tail doc has final <= M-th tail sum + head_ub; when that is
    # strictly below theta the window result is exact on docs and scores
    tail_sum = torch.where(live, seg_scores, _NEG)
    sel_sum, sel_pos = topk_lowest_index(tail_sum, M)
    sel_doc = torch.gather(docs, 1, sel_pos)
    sd = torch.clamp(sel_doc, 0, D - 1).long()
    s_at = torch.gather(S, 1, sd)
    fin = torch.where(sel_sum > _NEG, sel_sum + s_at, _NEG)
    fs_p, fd_p = _topk_docid(
        torch.cat([fin, head_s2], dim=1), torch.cat([sel_doc, head_d], dim=1), k
    )
    theta = fs_p[:, k - 1]
    residual = sel_sum[:, M - 1]
    all_selected = residual == _NEG
    safe_q = all_selected | (residual + head_ub < theta)
    HOST_SYNCS["window_certificate"] += 1
    if bool(safe_q.all().item()):
        WINDOW_BRANCH["window"] += 1
        hits_p = head_hits + ((sel_sum > _NEG) & (s_at == 0.0)).sum(
            dim=-1, dtype=torch.int32
        )
        return pack(fs_p, fd_p, hits_p, all_selected.to(torch.int32))
    WINDOW_BRANCH["full"] += 1
    return pack(*full())


def dispatch_fused(
    idx,                      # ops.dense_head.DenseHeadIndex
    plan,                     # ops.dense_head.DenseMergePlan
    post_docs,
    post_impacts,
    k: int,
    *,
    n_req=None,
    filt=None,
    additive=None,
    sort_keys=None,
    require_all: bool = False,
    sort_ascending: bool = True,
    prune: bool = True,
    exact_counts: bool = False,
):
    """Run one planned batch on the fused path (the reference's
    ``dispatch_fused``, dense_fused.py:389-421, without its ``use_pallas``:
    the kernel runs where the index lives). Returns the packed [B, 2k+2]
    tensor (decode with ``ops.dense_head.decode_packed2``)."""
    dev = idx.rows.device
    B = plan.W.shape[0]
    if n_req is None:
        n_req = np.ones(B, np.int32)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return dense_fused_topk(
        idx.rows, idx.row_max, post_docs, post_impacts,
        put(plan.W), put(plan.row_idx), put(n_req),
        put(plan.run_offs), put(plan.run_lens), put(plan.run_weights),
        filt, additive, sort_keys, getattr(idx, "rows_lo", None),
        k=k, has_head=plan.has_head, has_tail=plan.has_tail,
        run_len=plan.run_len, require_all=require_all,
        sort_ascending=sort_ascending, prune=prune, exact_counts=exact_counts,
    )
