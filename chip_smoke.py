#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nrtsearch_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: require CUDA; print torch/CUDA versions and the card's name and
   power limit (nvidia-smi); keep matmuls at full f32.
2. build: compile the kernels from nrtsearch_tpu_torch/csrc with nvcc.
3. kernels vs their plain torch twins on the card at main-path shapes
   (gather_rows at Hp=536, D=1,000,064, U in {32, 128}; near_stages and
   far_stage at B=32, N from 2^15 up to the first B=32 batch's width with
   duplicate docs, both sentinels and an all-pad row, near_stages also with
   a direction per pair; the accelerator merge branch on the first B=32
   batch of phase 5 as the merge path plans it: gather_runs (alternating),
   the alternating network, finish_mask; far_pair_stage and finish_mask at
   B=32 and N from 4 near tiles up to that batch's width): outputs must be
   bit-equal; CUDA-event times at the batch's shapes (the L2 evicted
   before each timed launch), each beside its bound (bytes over 3.35 TB/s
   or operations over 67 TFLOP/s, the larger) and, for gather_rows, beside
   torch.index_select.
4. index: SyntheticCorpus(1M docs, 100k vocab, 48 draws/doc, seed 42) cut
   into 4 doc-range segments on the card, Searcher.warm builds the dense
   head rows; device memory is printed.
5. search: 8 single queries through Searcher.search, 4 batches of 32
   through fast_search_batch, one conjunction with a tail term (merge
   path). Launch counters are reset just before and read just after; every
   kernel must have launched, and every B=32 batch must have taken the
   merge path's alternating branch. Latencies at B=1 and B=32; then
   torch.profiler over one run of the first B=32 batch: device busy time
   (and its share of the B=32 p50) and the largest device items.
6. the answers against an independent numpy BM25 of the same corpus.
7. ingest ~2,000 text docs through IndexWriter on the card and on the CPU;
   merge results bit-equal, fused results within 1e-6 relative.
8. the bucket path (NRT_FAST_PATH=bucket for this phase only) on the same
   index: bucket_rank against its plain version at the first B=32 batch's
   plan, bit-equal with require_all both ways, CUDA-event times; the 8 singles and 4 batches of phase 5 through
   the merge path (timed), then, with the launch counters reset just before
   and read just after, through the bucket path: every spec must be served
   there and bucket_rank must launch once per bucket batch. Answers against
   the merge path's: equal hit counts, scores
   within one quantum (1 / scale) per query term, docs equal up to
   near-ties at the k-th score; a query whose plan shares a scale bound
   between two slots (a repeated term, or two terms of equal weight) can
   clip at QMAX, as in the reference, and is held to equal hit counts only.
   p50 at B=1 and B=32 of both paths, the bucket phase's peak device
   memory, and torch.profiler over one bucket run of the first B=32 batch.

Launches per main-path batch: the counters around one fast_search_batch
of the first B=32 batch (merge path), one B=1 query (fused path) and, for
the bucket kernels, one bucket batch.

The last lines are the kernel table as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 42
NUM_DOCS, VOCAB, DRAWS = 1_000_000, 100_000, 48   # bench.py:26-28 defaults
SEGMENTS = 4
TOP_K = 100            # bench.py TOP_K
BATCH = 32             # bench.py BATCH
TERMS_PER_QUERY = 4    # bench.py TERMS_PER_QUERY
FUSED_REL = 1e-4       # fused bound vs exact (tests/test_dense_path_matrix.py)
MERGE_REL = 1e-5       # exact f32, numpy sums in another order
CPU_GPU_FUSED_REL = 1e-6

KERNEL_SOURCES = {
    "gather_rows": ("nrtsearch_tpu_torch/csrc/gather_rows.cu",
                    "nrtsearch_tpu/ops/dense_fused.py:77"),
    "near_stages": ("nrtsearch_tpu_torch/csrc/bitonic_merge.cu",
                    "nrtsearch_tpu/ops/pallas_merge.py:194"),
    "far_stage": ("nrtsearch_tpu_torch/csrc/bitonic_merge.cu",
                  "nrtsearch_tpu/ops/pallas_merge.py:54"),
    "far_pair_stage": ("nrtsearch_tpu_torch/csrc/bitonic_merge.cu",
                       "nrtsearch_tpu/ops/pallas_merge.py:112"),
    "gather_runs": ("nrtsearch_tpu_torch/csrc/gather_runs.cu",
                    "nrtsearch_tpu/ops/pallas_merge.py:317"),
    "finish_mask": ("nrtsearch_tpu_torch/csrc/finish_mask.cu",
                    "nrtsearch_tpu/ops/pallas_merge.py:450"),
    # one kernel for both TPU kernels of the bucket path
    "bucket_rank": ("nrtsearch_tpu_torch/csrc/bucket_rank.cu",
                    "nrtsearch_tpu/ops/bucket_retrieval.py:293 (gather_pack_pallas); "
                    "nrtsearch_tpu/ops/bucket_retrieval.py:418 (sort_finish_pallas)"),
}
# the kernels of phase 8's bucket path; phase 5 drives the others
BUCKET_KERNELS = ("bucket_rank",)
# the one PyTorch call that computes a kernel's function, timed beside it
# (the port never calls it), or why there is none
LIBRARY = {
    "gather_rows": "torch.index_select",
    "near_stages": "none: no torch call runs a fixed compare-exchange network",
    "far_stage": "none: no torch call runs one compare-exchange stage",
    "far_pair_stage": "none: no torch call runs two compare-exchange stages",
    "gather_runs": "none: no torch call gathers ragged runs with a weight",
    "finish_mask": "none: no torch call runs a bounded segmented scan",
    "bucket_rank": "none: torch.Tensor.index_add_ sums but weighs, quantizes and "
                   "masks nothing",
}
# the card's peaks (H100 SXM data sheet): device memory, and the f32 rate
# outside the tensor cores, at which one compare-exchange or add counts
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
L2_FLUSH_BYTES = 128 << 20   # written before each timed launch: > the 50 MB L2


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _log2(x: int) -> int:
    return x.bit_length() - 1


def scan_steps(max_seg: int) -> int:
    """The segmented scan's steps: distances 1, 2, 4, ... below max_seg."""
    return max(0, (max_seg - 1).bit_length())


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, setup=lambda: (), reps: int = 25, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times of ``fn(*setup())``, in ms;
    ``setup`` (fresh inputs for in-place kernels) runs outside the timed
    window, then a write of L2_FLUSH_BYTES evicts the L2, so that no launch
    finds its input (or the copy setup just made) there."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    times = []
    for i in range(warmup + reps):
        args = setup()
        scratch.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        if i >= warmup:
            times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------


def _merge_inputs(gen, B: int, N: int, dev):
    """[B, N] rows of two sorted halves, the second reversed (one bitonic
    merge level of run_len N/2): duplicate docs, LOW front padding in the
    first half, HIGH back padding, and row B-1 all HIGH padding."""
    from nrtsearch_tpu_torch.ops.merge_scoring import DOC_SENTINEL, DOC_SENTINEL_LOW

    half = N // 2
    docs = torch.randint(0, N // 4, (B, 2, half), generator=gen, device=dev, dtype=torch.int32)
    docs[:, 0, :64] = int(DOC_SENTINEL_LOW)
    docs[:, :, -half // 8 :] = int(DOC_SENTINEL)
    docs = torch.sort(docs, dim=-1).values
    docs[:, 1] = torch.flip(docs[:, 1], dims=(-1,))
    docs = docs.reshape(B, N).contiguous()
    docs[B - 1] = int(DOC_SENTINEL)
    contribs = torch.rand((B, N), generator=gen, device=dev)
    contribs[docs == int(DOC_SENTINEL)] = 0.0
    return docs, contribs


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _inplace_bytes(docs: torch.Tensor, contribs: torch.Tensor, fn) -> int:
    """Bytes an in-place compare-exchange pass must move on this input:
    every doc read once (the compares), and for each entry it changes the
    contrib read and both written once; a pair that stays needs no
    contrib."""
    x, y = docs.clone(), contribs.clone()
    fn(x, y)
    changed = (x != docs) | (y.view(torch.int32) != contribs.view(torch.int32))
    return 4 * docs.numel() + 12 * int(changed.sum())


def _abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries where either is finite (both -inf
    counts as equal)."""
    a, b = a.double(), b.double()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def phase_kernels(dev, merge_widths, batch_n: int) -> dict:
    from nrtsearch_tpu_torch.ops import bitonic_merge as bm
    from nrtsearch_tpu_torch.ops import dense_fused

    gen = torch.Generator(device=dev).manual_seed(SEED)
    stats = {name: {"max_abs_err": 0.0} for name in ("gather_rows", "near_stages", "far_stage")}

    Hp, D = 536, 1_000_064
    rows = torch.rand((Hp, D), generator=gen, device=dev).to(torch.bfloat16)
    for U in (32, 128):
        idx = torch.randint(0, Hp, (U,), generator=gen, device=dev, dtype=torch.int32)
        idx[U - 4 :] = 0   # pad slots repeat row 0
        out = dense_fused.gather_rows(rows, idx)
        ref = dense_fused._gather_rows_scan(rows, idx)
        err = float((out.float() - ref.float()).abs().max())
        stats["gather_rows"]["max_abs_err"] = max(stats["gather_rows"]["max_abs_err"], err)
        if not torch.equal(out.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"gather_rows differs from its twin at U={U}")
        ms = cuda_ms(lambda: dense_fused.gather_rows(rows, idx))
        plain = cuda_ms(lambda: dense_fused._gather_rows_scan(rows, idx))
        lib = cuda_ms(lambda: torch.index_select(rows, 0, idx))
        gbs = 2 * U * D * 2 / (ms * 1e-3) / 1e9
        log(f"kernel gather_rows Hp={Hp} D={D} U={U}: bit-equal; {ms:.4f} ms "
            f"({gbs:.0f} GB/s moved), twin {plain:.4f} ms, index_select {lib:.4f} ms")
        if U == 128:
            # bytes: the U rows read and written (2 B each), the index
            stats["gather_rows"].update(ms=ms, plain_ms=plain, library_ms=lib,
                                        shape=[Hp, D, U], bytes=2 * U * D * 2 + 4 * U, ops=0)
    del rows

    B = 32
    for N in merge_widths:
        docs, contribs = _merge_inputs(gen, B, N, dev)
        kd, kc = docs.clone(), contribs.clone()
        bm.merge_level(kd, kc, N // 2)                     # kernels
        td, tc = docs.clone(), contribs.clone()
        d = N // 2
        while d >= 1:                                      # twins
            bm.far_stage_twin(td, tc, d)
            d //= 2
        err = max(float((kd.long() - td.long()).abs().max()),
                  float((kc - tc).abs().max()))
        for name in ("near_stages", "far_stage"):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if not (torch.equal(kd, td) and torch.equal(kc.view(torch.int32), tc.view(torch.int32))):
            raise AssertionError(f"merge level differs from its twin at N={N}")
        if not bool((kd[:, 1:] >= kd[:, :-1]).all()):
            raise AssertionError(f"merge level output not sorted at N={N}")
        # each timed launch gets a fresh copy of the input the level hands
        # it (the stages before it applied), so the in-place stages swap as
        # they do on the main path
        d0 = bm.near_tile(N) // 2
        far_d = bm.near_tile(N)          # the far stage the merge batch runs
        far_in = (docs.clone(), contribs.clone())
        d = N // 2
        while d > far_d:
            bm.far_stage(*far_in, d)
            d //= 2
        near_in = (far_in[0].clone(), far_in[1].clone())
        bm.far_stage(*near_in, far_d)

        def fresh_far():
            return far_in[0].clone(), far_in[1].clone()

        def fresh():
            return near_in[0].clone(), near_in[1].clone()

        near_ms = cuda_ms(lambda x, y: bm.near_stages(x, y, d0), fresh)
        near_plain = cuda_ms(lambda x, y: bm.near_stages_twin(x, y, d0), fresh)
        far_ms = cuda_ms(lambda x, y: bm.far_stage(x, y, far_d), fresh_far)
        far_plain = cuda_ms(lambda x, y: bm.far_stage_twin(x, y, far_d), fresh_far)
        log(f"kernel merge level B={B} N={N}: bit-equal; near_stages(d0={d0}) "
            f"{near_ms:.4f} ms, twin {near_plain:.4f} ms; far_stage(d={far_d}) "
            f"{far_ms:.4f} ms, twin {far_plain:.4f} ms")
        if N == batch_n:
            # bytes: _inplace_bytes (docs read, changed entries moved); ops:
            # one compare-exchange per pair and stage
            near_b = _inplace_bytes(*near_in, lambda x, y: bm.near_stages(x, y, d0))
            far_b = _inplace_bytes(*far_in, lambda x, y: bm.far_stage(x, y, far_d))
            stats["near_stages"].update(ms=near_ms, plain_ms=near_plain, shape=[B, N, d0],
                                        bytes=near_b, ops=(_log2(d0) + 1) * B * N // 2)
            stats["far_stage"].update(ms=far_ms, plain_ms=far_plain, shape=[B, N, far_d],
                                      bytes=far_b, ops=B * N // 2)
        if N == 1 << 15:
            # short runs: one direction per pair (m below the tile)
            for m in (64, 2048):
                kd, kc = docs.clone(), contribs.clone()
                bm.near_stages(kd, kc, m // 2, m)
                td, tc = bm.near_stages_twin(docs.clone(), contribs.clone(), m // 2, m)
                if not (_bits_equal(kd, td) and _bits_equal(kc, tc)):
                    raise AssertionError(f"near_stages differs from its twin at m={m}")
            log(f"kernel near_stages B={B} N={N} m in (64, 2048): bit-equal")
        del docs, contribs, kd, kc, td, tc, far_in, near_in
    return stats


def batch_plan(searcher, queries):
    """The [B, R] run tables and run_len the merge path plans for one batch
    of term lists (PackedFieldView.search_batch -> PrunedIndex._run_full)."""
    from nrtsearch_tpu_torch.ops.merge_scoring import plan_run_lists

    view = searcher.packed_view("body")
    idx = view.index
    rows = []
    for q in queries:
        spec = searcher.fast_query_spec(_match(q))
        rows.append([
            (int(idx.run_offsets[r]), int(idx.run_lengths[r]), w)
            for _t, w, runs in view.term_entries(spec.terms, spec.boost) if w
            for r in runs if idx.run_lengths[r]
        ])
    return plan_run_lists(rows, max_run=int(idx.doc_ids.shape[0]))


def phase_accel_kernels(dev, searcher, batch) -> dict:
    """The merge path's accelerator branch, kernels against twins: the
    batch's own gather, network and finish, then far_pair_stage and
    finish_mask at B=32 and N from four near tiles up to the batch's width."""
    from nrtsearch_tpu_torch.ops import bitonic_merge as bm
    from nrtsearch_tpu_torch.ops import merge_scoring as ms

    idx = searcher.packed_view("body").index
    offs, lens, weights, run_len = batch_plan(searcher, batch)
    B, R = offs.shape
    width = R * run_len
    log(f"kernel plan: first B={B} batch -> R={R} run_len={run_len} width {width} "
        f"(alternating branch from {ms.ALT_MIN_WIDTH}: {width >= ms.ALT_MIN_WIDTH})")
    if width < ms.ALT_MIN_WIDTH:
        raise AssertionError("the B=32 batch would not take the alternating branch")
    tabs = [torch.as_tensor(a, device=dev) for a in (offs, lens, weights)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    stats = {name: {"max_abs_err": 0.0} for name in ("gather_runs", "far_pair_stage", "finish_mask")}

    def hold(name, out, ref, ctx):
        for o, r in zip(out, ref):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], _abs_err(o, r))
            if not _bits_equal(o, r):
                raise AssertionError(f"{name} differs from its twin: {ctx}")

    gather_args = (idx.doc_ids, idx.impacts, *tabs, run_len, True)
    kd, kc = ms.gather_runs_accel(*gather_args)
    td, tc = ms.gather_runs_twin(*gather_args)
    hold("gather_runs", (kd, kc), (td, tc), f"B={B} R={R} run_len={run_len}")
    g_ms = cuda_ms(lambda: ms.gather_runs_accel(*gather_args))
    g_plain = cuda_ms(lambda: ms.gather_runs_twin(*gather_args))
    # bytes: the runs' live postings read (doc + impact), the tables, the
    # [B, R, run_len] docs and contribs written
    live = int(np.minimum(lens, run_len).sum())
    stats["gather_runs"].update(ms=g_ms, plain_ms=g_plain, shape=[B, R, run_len],
                                bytes=8 * live + 12 * B * R + 8 * B * R * run_len,
                                ops=live)
    log(f"kernel gather_runs B={B} R={R} run_len={run_len} alternating: bit-equal; "
        f"{g_ms:.4f} ms, twin {g_plain:.4f} ms")

    t0 = time.perf_counter()
    md, mc = bm.merge_sorted_runs_alt(kd, kc)            # kernels, in place
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wd, wc = bm.merge_sorted_runs_alt_twin(td, tc)       # twins, in place
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not (_bits_equal(md, wd) and _bits_equal(mc, wc)):
        raise AssertionError("the alternating network differs from its twin")
    if not bool((md[:, 1:] >= md[:, :-1]).all()):
        raise AssertionError("the alternating network's output is not sorted")
    log(f"kernel merge_sorted_runs_alt B={B} N={width}: bit-equal and sorted; "
        f"{1e3 * (t1 - t0):.3f} ms, twins {1e3 * (t2 - t1):.3f} ms (host clock, one run)")
    del td, tc, wd, wc

    n_terms = torch.randint(1, 4, (B,), generator=gen, device=dev, dtype=torch.int32)
    for require_all in (False, True):
        out = ms.finish_mask(md, mc, n_terms, R, require_all)
        ref = ms.finish_mask_twin(md, mc, n_terms, R, require_all)
        hold("finish_mask", (out,), (ref,), f"batch, require_all={require_all}")
        if not bool(torch.isfinite(out).any()):
            raise AssertionError("finish_mask kept no doc of the batch")
    f_ms = cuda_ms(lambda: ms.finish_mask(md, mc, n_terms, R, False))
    f_plain = cuda_ms(lambda: ms.finish_mask_twin(md, mc, n_terms, R, False))
    # bytes: the stream read (8 B an entry), the scores written (4 B);
    # ops: one add per entry and scan step
    stats["finish_mask"].update(ms=f_ms, plain_ms=f_plain, shape=[B, width, R],
                                bytes=12 * B * width + 4 * B,
                                ops=B * width * scan_steps(R))
    log(f"kernel finish_mask B={B} N={width} max_seg={R}: bit-equal; {f_ms:.4f} ms, "
        f"twin {f_plain:.4f} ms")
    del kd, kc, md, mc

    N = 4 * bm.NEAR_TILE               # the least width far_pair_stage takes
    while N <= width:
        docs, contribs = _merge_inputs(gen, B, N, dev)
        cases = [(N // 2, 0)] + ([(N // 4, N // 2)] if N // 8 >= bm.near_tile(N) else [])
        for d, m in cases:
            kd, kc = docs.clone(), contribs.clone()
            bm.far_pair_stage(kd, kc, d, m)
            td, tc = docs.clone(), contribs.clone()
            bm.far_pair_stage_twin(td, tc, d, m)
            hold("far_pair_stage", (kd, kc), (td, tc), f"N={N} d={d} m={m}")

        def fresh():
            return docs.clone(), contribs.clone()

        p_ms = cuda_ms(lambda x, y: bm.far_pair_stage(x, y, N // 2), fresh)
        p_plain = cuda_ms(lambda x, y: bm.far_pair_stage_twin(x, y, N // 2), fresh)
        pair_b = _inplace_bytes(docs, contribs, lambda x, y: bm.far_pair_stage(x, y, N // 2))
        bm.merge_level(docs, contribs, N // 2)            # a sorted stream
        fk = ms.finish_mask(docs, contribs, n_terms, R, True)
        ft = ms.finish_mask_twin(docs, contribs, n_terms, R, True)
        hold("finish_mask", (fk,), (ft,), f"N={N}")
        fn_ms = cuda_ms(lambda: ms.finish_mask(docs, contribs, n_terms, R, True))
        fn_plain = cuda_ms(lambda: ms.finish_mask_twin(docs, contribs, n_terms, R, True))
        log(f"kernel B={B} N={N}: far_pair_stage(d={N // 2}) bit-equal {p_ms:.4f} ms, twin "
            f"{p_plain:.4f} ms; finish_mask(max_seg={R}, require_all) bit-equal "
            f"{fn_ms:.4f} ms, twin {fn_plain:.4f} ms")
        if 2 * N > width:
            stats["far_pair_stage"].update(ms=p_ms, plain_ms=p_plain, shape=[B, N, N // 2],
                                           bytes=pair_b, ops=B * N)
        del docs, contribs, kd, kc, td, tc, fk, ft
        N *= 2
    return stats


# ---------------------------------------------------------------------------
# phases 4-7: index, search, exact answers, ingest
# ---------------------------------------------------------------------------


def body_field_defs():
    from nrtsearch_tpu_torch.schema import create_field_def

    return {"body": create_field_def("body", {"type": "TEXT", "search": True})}


def phase_index(dev, num_docs: int, vocab: int, draws: int, segments: int):
    from nrtsearch_tpu_torch.convert import segment_from_numpy
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    t0 = time.perf_counter()
    corpus = SyntheticCorpus(num_docs, vocab, draws, seed=SEED)
    t1 = time.perf_counter()
    segs = [segment_from_numpy(a, dev) for a in corpus.segment_arrays(segments)]
    t2 = time.perf_counter()
    searcher = Searcher(segs, body_field_defs())
    searcher.warm(["body"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    st = searcher.packed_view("body")._dense_state()
    log(f"index: {num_docs} docs, vocab {vocab}, {len(corpus.post_docs)} postings, "
        f"{segments} segments; corpus {t1 - t0:.1f} s, segments to device "
        f"{t2 - t1:.1f} s, pack + dense rows {t3 - t2:.1f} s")
    log(f"index: {len(st['head_pos'])} head rows x D={st['D']} (+ residual rows: "
        f"{st['rows_lo'] is not None}), tail_max_df {st['tail_max_df']}")
    return corpus, searcher


def fused_tail_width(searcher) -> int:
    """R * run_len of the fused path's fixed tail shape on this snapshot."""
    from nrtsearch_tpu_torch.ops.merge_scoring import _pow2

    st = searcher.packed_view("body")._dense_state()
    run_len = int(os.environ.get("NRT_DENSE_RL", 0)) or _pow2(
        min(max(4096, st["tail_max_df"]), 65536))
    return int(os.environ.get("NRT_DENSE_R", "8")) * run_len


def conjunction_terms(corpus, searcher) -> list[str]:
    """Two head terms and the most frequent tail term: a conjunction the
    fused path refuses (a tail term), served by the merge path."""
    head = searcher.packed_view("body")._dense_state()["head_pos"]
    order = np.argsort(-corpus.term_lengths, kind="stable")
    tail = next(str(t) for t in order if str(t) not in head)
    return [str(order[0]), str(order[1]), tail]


def _match(terms, operator="SHOULD"):
    from nrtsearch_tpu_torch.query import parse_query

    return parse_query({"matchQuery": {"field": "body", "query": " ".join(terms),
                                       "operator": operator}})


def sample_search_queries(corpus) -> tuple[list, list]:
    """Phase 5's queries: 8 singles and 4 batches of 32."""
    singles = corpus.sample_queries(8, TERMS_PER_QUERY)
    batches = [corpus.sample_queries(BATCH, TERMS_PER_QUERY) for _ in range(4)]
    return singles, batches


def phase_search(corpus, searcher, singles, batches, reps: int = 3) -> dict:
    """The main path. Returns results, latencies, path counts and the merge
    branch each B=32 batch took."""
    from nrtsearch_tpu_torch.ops.merge_scoring import MERGE_BRANCH

    conj = conjunction_terms(corpus, searcher)
    view = searcher.packed_view("body")
    paths0 = dict(view.path_counts)
    lat1, lat32, batch_branches = [], [], []
    single_out = batch_out = None
    for _ in range(reps):
        single_out = []
        for q in singles:
            t = time.perf_counter()
            single_out.append(searcher.search(_match(q), TOP_K))
            lat1.append(time.perf_counter() - t)
        batch_out = []
        for qs in batches:
            t = time.perf_counter()
            specs = [searcher.fast_query_spec(_match(q)) for q in qs]
            before = dict(MERGE_BRANCH)
            batch_out.append(searcher.fast_search_batch(specs, TOP_K))
            lat32.append(time.perf_counter() - t)
            batch_branches.append({k: MERGE_BRANCH[k] - before[k] for k in before})
    conj_out = searcher.search(_match(conj, "MUST"), TOP_K)
    paths = {k: view.path_counts[k] - paths0[k] for k in paths0}
    return {
        "singles": singles, "single_out": single_out, "batches": batches,
        "batch_out": batch_out, "conj": conj, "conj_out": conj_out,
        "lat1": lat1, "lat32": lat32, "paths": paths, "batch_branches": batch_branches,
    }


def profile_batch(searcher, batch) -> dict:
    """``torch.profiler`` over one ``fast_search_batch`` of ``batch``: the
    device's busy time (the sum of the durations of every kernel, copy and
    memset on the card; one stream, so they do not overlap), the largest
    device items and the traced wall time on the host clock. The tracer's
    own host cost varies from run to run (tens to hundreds of ms), so the
    busy share is taken against the untraced latency, not this wall."""
    specs = [searcher.fast_query_spec(_match(q)) for q in batch]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        searcher.fast_search_batch(specs, TOP_K)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    # device items only: an operator's row would count its kernels again,
    # and the profiler's own step annotation spans the whole batch on the
    # device's timeline
    per_name: dict[str, list] = {}
    for e in prof.events():
        annotation = getattr(e, "is_user_annotation", False) or e.name.startswith("ProfilerStep")
        if e.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    items = sorted(((k, ms, n) for k, (ms, n) in per_name.items()), key=lambda x: -x[1])
    busy = sum(x[1] for x in items)
    return {"traced_wall_ms": wall, "device_busy_ms": busy,
            "top": [[k[:60], ms, n] for k, ms, n in items[:10]]}


def launches_per_batch(searcher, single, batch) -> dict:
    """Kernel launches of one main-path request: the first B=32 batch
    through fast_search_batch (the merge path's kernels) and one B=1 query
    (gather_rows, on the fused path)."""
    from nrtsearch_tpu_torch import kernels

    specs = [searcher.fast_query_spec(_match(q)) for q in batch]
    kernels.reset_launch_counts()
    searcher.fast_search_batch(specs, TOP_K)
    torch.cuda.synchronize()
    b32 = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    searcher.search(_match(single), TOP_K)
    torch.cuda.synchronize()
    b1 = dict(kernels.LAUNCHES)
    log(f"search: launches per B=32 batch {b32}; per B=1 query {b1}")
    return {k: b1[k] if k == "gather_rows" else b32[k] for k in KERNEL_SOURCES}


def _check_topk(td, exact, rel: float, ctx: str) -> int:
    """Scores rank by rank within ``rel``; a doc may differ from the exact
    answer only where the two scores at that rank are within ``rel`` (a
    near-tie: f32 sums taken in another order break ties by score, not by
    docid). Hits exact, or a lower bound when the relation says so.
    Returns the number of near-tie swaps."""
    s, d, total = exact
    docs = np.array([h.global_ord for h in td.hits], np.int64)
    scores = np.array([h.score for h in td.hits], np.float32)
    if len(docs) != len(d):
        raise AssertionError(f"{ctx}: {len(docs)} hits, exact has {len(d)}")
    err = np.abs(scores - s) / np.maximum(np.abs(s), 1e-9)
    if len(err) and err.max() > rel:
        raise AssertionError(f"{ctx}: score rel err {err.max():.3g} > {rel}")
    swaps = np.nonzero(docs != d)[0]
    if len(set(docs.tolist())) != len(docs):
        raise AssertionError(f"{ctx}: duplicate docs in the top-k")
    for i in swaps:
        if abs(float(s[i]) - float(scores[i])) > rel * abs(float(s[i])):
            raise AssertionError(f"{ctx}: doc {docs[i]} != {d[i]} at rank {i}")
    exact_hits = td.relation == "EQUAL_TO"
    if (exact_hits and td.total_hits != total) or td.total_hits > total:
        raise AssertionError(f"{ctx}: hits {td.total_hits} ({td.relation}) vs {total}")
    return len(swaps)


def phase_exact(corpus, res) -> dict:
    """The 8 singles (fused path) and the conjunction (merge path) against
    the corpus's independent numpy BM25."""
    out = {"fused_rel": 0.0, "merge_rel": 0.0, "swaps": 0}
    for q, td in zip(res["singles"], res["single_out"]):
        ex = corpus.exact_topk(q, TOP_K)
        out["swaps"] += _check_topk(td, ex, FUSED_REL, f"single {q}")
        out["fused_rel"] = max(out["fused_rel"], _max_rel(td, ex))
    ex = corpus.exact_topk(res["conj"], TOP_K, require_all=True)
    td = res["conj_out"]
    if td.relation != "EQUAL_TO" or td.total_hits != ex[2]:
        raise AssertionError(f"conjunction hits {td.total_hits} vs exact {ex[2]}")
    out["swaps"] += _check_topk(td, ex, MERGE_REL, f"conjunction {res['conj']}")
    out["merge_rel"] = _max_rel(td, ex)
    out["conj_hits"] = ex[2]
    return out


def _max_rel(td, exact) -> float:
    s = exact[0]
    if not len(s):
        return 0.0
    sc = np.array([h.score for h in td.hits], np.float32)
    return float(np.max(np.abs(sc - s) / s))


INGEST_QUERIES = {
    "or_head": ("common alpha", "SHOULD"),
    "or_mixed": ("common needle beta", "SHOULD"),
    "tail_only": ("needle", "SHOULD"),
    "must_head": ("common gamma", "MUST"),
    "must_tail": ("delta needle", "MUST"),
}


def _ingest_docs(n: int) -> list[dict]:
    rng = np.random.default_rng(SEED)
    words = ["alpha", "beta", "gamma", "delta"]
    docs = []
    for i in range(n):
        toks = ["common"] * int(rng.integers(1, 4))
        toks += [words[j] for j in rng.integers(0, 4, size=int(rng.integers(1, 6)))]
        if i % 23 == 0:
            toks.append("needle")
        docs.append({"id": str(i), "body": " ".join(toks)})
    return docs


def _with_path(path: str, fn):
    """Run ``fn()`` with NRT_FAST_PATH set to ``path``, then restore it."""
    saved = os.environ.get("NRT_FAST_PATH")
    os.environ["NRT_FAST_PATH"] = path
    try:
        return fn()
    finally:
        if saved is None:
            os.environ.pop("NRT_FAST_PATH", None)
        else:
            os.environ["NRT_FAST_PATH"] = saved


def phase_ingest(dev, n_docs: int = 2000) -> dict:
    """IndexWriter -> refresh on the card and on the CPU; search both."""
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.schema import create_field_def

    fds = {"id": create_field_def("id", {"type": "_ID", "store": True}),
           **body_field_defs()}
    docs = _ingest_docs(n_docs)
    searchers = {}
    for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        w = IndexWriter(fds, d)
        w.add_documents([dict(x) for x in docs[: n_docs // 2]])
        w.refresh()
        w.add_documents([dict(x) for x in docs[n_docs // 2 :]])
        searchers[name] = Searcher(w.refresh(), fds)
    from nrtsearch_tpu_torch.ops.merge_scoring import MERGE_BRANCH

    def check(path: str) -> int:
        for qname, (text, op) in INGEST_QUERIES.items():
            node = _match(text.split(), op)
            alt0 = MERGE_BRANCH["alt"]
            g = searchers["gpu"].search(node, 50)
            c = searchers["cpu"].search(node, 50)
            ctx = f"ingest {qname}/{path}"
            gd = [h.global_ord for h in g.hits]
            cd = [h.global_ord for h in c.hits]
            gs = np.array([h.score for h in g.hits], np.float32)
            cs = np.array([h.score for h in c.hits], np.float32)
            if (g.total_hits, g.relation) != (c.total_hits, c.relation) or not gd:
                raise AssertionError(f"{ctx}: hits {g.total_hits} vs {c.total_hits}")
            if path == "merge":
                # the card runs the accelerator branch (unclamped gather),
                # the CPU the plain branch (clamping gather): bit-equal
                # only because these widths stay below ALT_MIN_WIDTH, so
                # both use the plain network, and no run clamps (the
                # packed postings carry 2 * 8192 entries of slack)
                if MERGE_BRANCH["alt"] != alt0:
                    raise AssertionError(f"{ctx}: took the alternating branch")
                if gd != cd or not np.array_equal(gs, cs):
                    raise AssertionError(f"{ctx}: cuda and cpu differ")
            else:
                if len(gd) != len(cd) or np.max(np.abs(gs - cs) / cs) > CPU_GPU_FUSED_REL:
                    raise AssertionError(f"{ctx}: scores differ beyond 1e-6")
                for i, (a, b) in enumerate(zip(gd, cd)):
                    if a != b and abs(gs[i] - cs[i]) > CPU_GPU_FUSED_REL * cs[i]:
                        raise AssertionError(f"{ctx}: doc {a} != {b} at rank {i}")
        return len(INGEST_QUERIES)

    checked = sum(_with_path(path, lambda: check(path)) for path in ("merge", "fused"))
    return {"docs": n_docs, "queries_checked": checked}


# ---------------------------------------------------------------------------
# phase 8: the bucket path
# ---------------------------------------------------------------------------


def _timed_searches(searcher, singles, batches, reps: int = 3) -> dict:
    lat1, lat32 = [], []
    single_out = batch_out = None
    for _ in range(reps):
        single_out = []
        for q in singles:
            t = time.perf_counter()
            single_out.append(searcher.search(_match(q), TOP_K))
            lat1.append(time.perf_counter() - t)
        batch_out = []
        for qs in batches:
            t = time.perf_counter()
            specs = [searcher.fast_query_spec(_match(q)) for q in qs]
            batch_out.append(searcher.fast_search_batch(specs, TOP_K))
            lat32.append(time.perf_counter() - t)
    return {"single_out": single_out, "batch_out": batch_out, "lat1": lat1, "lat32": lat32}


def phase_bucket_kernels(dev, view, specs) -> dict:
    """bucket_rank against its plain version at the plan the bucket path
    makes for ``specs``."""
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.ops import bucket_retrieval as br

    plan = view.bucket_plan(specs)
    if plan is None or plan["live"] is None:
        raise AssertionError("the bucket path refused the first B=32 batch")
    docs, imps = view.index.doc_ids, view.index.impacts
    toffs, bounds, wts, n_terms = (torch.as_tensor(plan[k], device=dev) for k in
                                   ("term_offs", "bounds", "weights", "n_terms"))
    B, T, m1 = bounds.shape
    m, tile, bits = m1 - 1, plan["tile"], plan["bits"]
    # bytes: the live slots' postings read (doc + impact), the plan tables,
    # the [B, m * 2^bits] rank written
    live = int(np.where(plan["weights"][..., None] != 0,
                        plan["bounds"][..., 1:] - plan["bounds"][..., :-1], 0).sum())
    tables = 4 * (toffs.numel() + bounds.numel() + wts.numel() + n_terms.numel())
    rank_bytes = 4 * B * (m << bits)
    log(f"bucket plan: first B={B} batch -> T={T} slots, m={m} buckets of {1 << bits} "
        f"docs; bucket_rank reads {8 * live / 2**20:.1f} MiB of postings ({live} live) "
        f"and writes {rank_bytes / 2**20:.1f} MiB of rank keys (the plain version's key "
        f"tile: {B * m * tile * 4 / 2**20:.0f} MiB at tile {tile})")
    args = (docs, imps, toffs, bounds, wts)
    need = torch.randint(1, 3, (B,), device=dev, dtype=torch.int32)
    for require_all, nt in ((False, n_terms), (True, need)):
        ref = br.bucket_rank_plain(*args, nt, tile=tile, bucket_bits=bits,
                                   require_all=require_all)
        out = kernels.bucket_rank(*args, nt, bits, require_all)
        if not _bits_equal(out, ref):
            raise AssertionError(f"bucket_rank differs from its plain version, "
                                 f"require_all={require_all}")
        if not bool((ref != int(br.I32_MIN)).any()):
            raise AssertionError("bucket_rank kept no doc of the batch")
        del ref, out
    ms = cuda_ms(lambda: kernels.bucket_rank(*args, n_terms, bits, False))
    plain_ms = cuda_ms(lambda: br.bucket_rank_plain(*args, n_terms, tile=tile,
                                                    bucket_bits=bits, require_all=False))
    log(f"kernel bucket_rank B={B} T={T} m={m} bits={bits}: bit-equal (require_all both "
        f"ways); {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"bucket_rank": {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                            "shape": [B, T, m, 1 << bits],
                            "bytes": 8 * live + tables + rank_bytes, "ops": live}}


def _check_bucket_answer(b, mres, tol: float, ctx: str) -> float:
    """Bucket TopDocs against merge TopDocs: equal hit counts, scores of a
    doc in both within ``tol``, a doc in one top-k only within ``tol`` of
    the other's k-th score. Returns the worst score difference."""
    if b.total_hits != mres.total_hits or b.relation != mres.relation:
        raise AssertionError(f"{ctx}: bucket hits {b.total_hits} vs merge {mres.total_hits}")
    bs = {h.global_ord: h.score for h in b.hits}
    ms = {h.global_ord: h.score for h in mres.hits}
    if len(bs) != len(ms):
        raise AssertionError(f"{ctx}: {len(bs)} bucket hits returned vs {len(ms)}")
    worst = 0.0
    for d in bs.keys() & ms.keys():
        worst = max(worst, abs(bs[d] - ms[d]))
        if abs(bs[d] - ms[d]) > tol:
            raise AssertionError(f"{ctx}: doc {d} bucket {bs[d]} vs merge {ms[d]}")
    b_kth = b.hits[-1].score if b.hits else 0.0
    m_kth = mres.hits[-1].score if mres.hits else 0.0
    for d in bs.keys() - ms.keys():
        if bs[d] > m_kth + tol:
            raise AssertionError(f"{ctx}: doc {d} only in the bucket top-k")
    for d in ms.keys() - bs.keys():
        if ms[d] > b_kth + tol:
            raise AssertionError(f"{ctx}: doc {d} only in the merge top-k")
    return worst


def _shares_scale_bound(view, spec) -> bool:
    """Two slots of one weight on different query terms, or a repeated
    term: the bucket plan keys its scale bounds by weight."""
    weights = [w for _t, w, runs in view.term_entries(spec.terms, spec.boost)
               if w and any(view.index.run_lengths[r] for r in runs)]
    return len(set(weights)) < len(weights)


def phase_bucket(dev, searcher, singles, batches, card: str) -> dict:
    from nrtsearch_tpu_torch import kernels

    view = searcher.packed_view("body")
    t = time.perf_counter()
    st = view._bucket_state()
    torch.cuda.synchronize()
    log(f"bucket state: {len(st['bounds'])} runs x {st['m'] + 1} bounds "
        f"({st['bounds'].nbytes / 2**20:.1f} MiB on the host) in "
        f"{time.perf_counter() - t:.2f} s")
    stats = phase_bucket_kernels(
        dev, view, [searcher.fast_query_spec(_match(q)) for q in batches[0]])
    torch.cuda.empty_cache()

    merge = _with_path("merge", lambda: _timed_searches(searcher, singles, batches))
    paths0 = dict(view.path_counts)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    bucket = _with_path("bucket", lambda: _timed_searches(searcher, singles, batches))
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in BUCKET_KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    paths = {k: view.path_counts[k] - paths0[k] for k in paths0}
    n_specs = 3 * (len(singles) + sum(len(b) for b in batches))
    n_batches = 3 * (len(singles) + len(batches))
    log(f"bucket: launches {launches} over {n_batches} bucket batches; specs by path {paths}")
    if paths["bucket"] != n_specs or paths["merge"] or paths["fused"]:
        raise AssertionError(f"every bucket-phase spec must take the bucket path: {paths}")
    if any(n != n_batches for n in launches.values()):
        raise AssertionError(f"bucket kernels must launch once per bucket batch: {launches}")
    specs = [searcher.fast_query_spec(_match(q)) for q in batches[0]]
    kernels.reset_launch_counts()
    _with_path("bucket", lambda: searcher.fast_search_batch(specs, TOP_K))
    per_batch = {k: kernels.LAUNCHES[k] for k in BUCKET_KERNELS}
    prof = _with_path("bucket", lambda: profile_batch(searcher, batches[0]))
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiled bucket batch ran nothing on the device")

    worst, shared = 0.0, 0
    pairs = list(zip(singles, bucket["single_out"], merge["single_out"]))
    for qs, bo, mo in zip(batches, bucket["batch_out"], merge["batch_out"]):
        pairs += list(zip(qs, bo, mo))
    for q, b, mres in pairs:
        spec = searcher.fast_query_spec(_match(q))
        if _shares_scale_bound(view, spec):
            # the reference's scale: one bound per weight, so sums can clip
            # at QMAX and the clipped docs rank by doc id (ROADMAP §3)
            shared += 1
            if (b.total_hits, b.relation) != (mres.total_hits, mres.relation):
                raise AssertionError(f"bucket {q}: hits {b.total_hits} vs merge "
                                     f"{mres.total_hits}")
            continue
        scale = float(view.bucket_plan([spec])["scales"][0])
        worst = max(worst, scale * _check_bucket_answer(
            b, mres, len(q) / scale, f"bucket {q}"))
    p50 = {name: (1e3 * float(np.median(r["lat1"])), 1e3 * float(np.median(r["lat32"])))
           for name, r in (("merge", merge), ("bucket", bucket))}
    log(f"bucket: {len(pairs)} answers against the merge path: hits equal; "
        f"{len(pairs) - shared} with scores, worst difference {worst:.3f} quanta "
        f"(bound: 1 per query term); {shared} whose plan shares a scale bound "
        f"held to hit counts only")
    log(f"bucket: p50 B=1 {p50['bucket'][0]:.2f} ms (merge {p50['merge'][0]:.2f}), "
        f"B=32 {p50['bucket'][1]:.2f} ms (merge {p50['merge'][1]:.2f}); n = "
        f"{len(bucket['lat1'])} / {len(bucket['lat32'])}; peak device memory "
        f"{peak / 2**30:.3f} GiB | {card}")
    log(f"bucket profile: first B={BATCH} batch, device busy {prof['device_busy_ms']:.3f} ms "
        f"({100 * prof['device_busy_ms'] / p50['bucket'][1]:.1f}% of the bucket B={BATCH} "
        f"p50; traced wall {prof['traced_wall_ms']:.3f} ms); top device items "
        f"{json.dumps(prof['top'])} | {card}")
    return {"stats": stats, "launches": launches, "per_batch": per_batch}


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.device import exact_cuda_matmul, resolve_device
    from nrtsearch_tpu_torch.ops import dense_fused, merge_scoring

    dev = resolve_device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(dev)} | {card} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}")
    exact_cuda_matmul()
    log(f"device: bf16 mm with f32 out on CUDA: {dense_fused.cuda_bf16_mm_f32_out()}")

    # 2. build
    t = time.perf_counter()
    so = kernels.build()
    kernels._library()
    log(f"build: {so.name} in {time.perf_counter() - t:.2f} s (nvcc {kernels.BUILD_INFO['seconds']:.2f} s)")
    for line in kernels.BUILD_INFO["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"build: {line.strip()}")

    # 4 (before 3: the main path's tail width and first batch pick the
    # timed merge shapes)
    corpus, searcher = phase_index(dev, NUM_DOCS, VOCAB, DRAWS, SEGMENTS)
    log(f"index: torch.cuda.memory_allocated {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
    main_n = fused_tail_width(searcher)
    singles, batches = sample_search_queries(corpus)
    offs, _lens, _w, run_len = batch_plan(searcher, batches[0])
    batch_n = offs.shape[1] * run_len

    # 3. kernels vs twins
    widths = sorted({1 << p for p in range(15, 20)} | {main_n, batch_n})
    stats = phase_kernels(dev, widths, batch_n)
    stats.update(phase_accel_kernels(dev, searcher, batches[0]))
    torch.cuda.empty_cache()

    # 5. search on the main path
    kernels.reset_launch_counts()
    syncs0 = (dense_fused.HOST_SYNCS["window_certificate"],
              merge_scoring.HOST_SYNCS["hierarchical_topk"])
    branch0 = dict(merge_scoring.MERGE_BRANCH)
    res = phase_search(corpus, searcher, singles, batches)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    syncs = (dense_fused.HOST_SYNCS["window_certificate"] - syncs0[0],
             merge_scoring.HOST_SYNCS["hierarchical_topk"] - syncs0[1])
    branches = {k: merge_scoring.MERGE_BRANCH[k] - branch0[k] for k in branch0}
    log(f"search: launches {launches}")
    log(f"search: specs by path {res['paths']}; host syncs window {syncs[0]}, "
        f"hierarchical_topk {syncs[1]}; window branch {dense_fused.WINDOW_BRANCH}; "
        f"merge branch {branches}")
    missing = [k for k in KERNEL_SOURCES
               if k not in BUCKET_KERNELS and launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if res["paths"]["fused"] == 0 or res["paths"]["merge"] == 0:
        raise AssertionError(f"both paths must serve: {res['paths']}")
    if any(b != {"alt": 1, "plain": 0} for b in res["batch_branches"]):
        raise AssertionError(f"a B=32 batch left the alternating branch: {res['batch_branches']}")
    p50_1 = 1e3 * float(np.median(res["lat1"]))
    p50_32 = 1e3 * float(np.median(res["lat32"]))
    log(f"search: p50 latency B=1 {p50_1:.2f} ms (n={len(res['lat1'])}), B=32 "
        f"{p50_32:.2f} ms (n={len(res['lat32'])}) | {card}")
    per_batch = launches_per_batch(searcher, singles[0], batches[0])
    prof = profile_batch(searcher, batches[0])
    log(f"profile: first B={BATCH} batch, device busy {prof['device_busy_ms']:.3f} ms "
        f"({100 * prof['device_busy_ms'] / p50_32:.1f}% of the B={BATCH} p50; traced wall "
        f"{prof['traced_wall_ms']:.3f} ms); top device items {json.dumps(prof['top'])} | {card}")
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiled batch ran nothing on the device")

    # 6. against the independent numpy answer
    ex = phase_exact(corpus, res)
    log(f"exact: 8 singles within {FUSED_REL} (worst {ex['fused_rel']:.3g}), "
        f"conjunction {res['conj']} hits {ex['conj_hits']} exact, scores within "
        f"{MERGE_REL} (worst {ex['merge_rel']:.3g}); near-tie doc swaps {ex['swaps']}")

    # 7. ingest on the card
    ing = phase_ingest(dev)
    log(f"ingest: {ing['docs']} docs, {ing['queries_checked']} queries; merge bit-equal, "
        f"fused within {CPU_GPU_FUSED_REL} between cuda and cpu")

    # 8. the bucket path
    bucket = phase_bucket(dev, searcher, singles, batches, card)
    stats.update(bucket["stats"])
    launches.update(bucket["launches"])
    per_batch.update(bucket["per_batch"])

    table = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        st = stats[name]
        bound_ms, bound_by = bound(st["bytes"], st["ops"])
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": st["max_abs_err"],
            "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": st.get("library_ms"),
            "library": LIBRARY[name], "share_of_bound": bound_ms / st["ms"],
            "launches_per_batch": per_batch[name], "shape": st["shape"],
        })
        log(f"table {name} {st['shape']}: {st['ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {100 * bound_ms / st['ms']:.1f}%), plain {st['plain_ms']:.4f} ms, "
            f"library {st.get('library_ms')} ({LIBRARY[name]}); launches {launches[name]}, "
            f"{per_batch[name]} per batch | {card}")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
