"""BM25 over term ids: a synthetic corpus with the collection's published
counts (``generate.py``), queries of Zipf term ids, the plain f64 BM25
reference (``reference.py``, with its own SmallFloat copy) and the check
of ranked hits against it.

The check, for each sampled query (traffic's ``check.mode``):

- ``score_gap`` (mode ``relative``): the widest relative gap between the
  program's score at a rank and the reference's score at that rank, or
  between the program's score of a doc and the reference's score of that
  doc; mode ``quanta`` reads the same gaps in quanta of the query's
  quantization per distinct query term (``quanta_gap``);
- ``hits_wrong``, ``short_lists``, ``order_faults`` (``compare.py``); a
  doc returned that the query does not match is an order fault.

Near-ties may swap docs without a fault: both gaps stay within the limit
when each doc's score is right and the list is sorted.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare, generate, reference

TINY = {
    "config": {"corpus": {"num_docs": 20000, "vocab_size": 2000}},
    "traffic": {"max_batches": 4096, "warmup_batches": 1, "check": {"sample": 96}},
}

QueryStream = generate.QueryStream


def make_data(cfg: dict, seed: int, device: torch.device):
    """The corpus (``generate.Corpus``) and the doc-value columns."""
    return generate.make_corpus(cfg, seed, device), generate.make_columns(cfg, seed, device)


class Reference(reference.Reference):
    """The configuration's BM25 (``cfg["bm25"]``) over the corpus; with
    ``control``, in its ``dtype`` or quantized to its ``qmax``."""

    def __init__(self, data, cfg: dict, control: dict | None = None):
        bm, ctl = cfg["bm25"], control or {}
        super().__init__(data, k1=float(bm["k1"]), b=float(bm["b"]),
                         quantized_norms=bool(bm["quantized_norms"]),
                         dtype=getattr(torch, ctl.get("dtype", "float64")),
                         qmax=int(ctl.get("qmax", 0)))


def check(ref: reference.Reference, queries: np.ndarray, prog: tuple, k: int, chk: dict) -> dict:
    """Numbers of the check over ``queries`` (int64 [S, T] term ids) and the
    program's answers ``prog`` = (scores [S, k], docs [S, k], hits [S])."""
    p_scores, p_docs, p_hits = prog
    mode = chk["mode"]
    gap_name = "score_gap" if mode == "relative" else "quanta_gap"
    out = {gap_name: 0.0, "hits_wrong": 0, "short_lists": 0, "order_faults": 0}
    N = ref.num_docs
    B = compare.BLOCK
    for lo in range(0, len(queries), B):
        qs = queries[lo:lo + B]
        dense, matched = ref.dense(qs)
        r_scores, _r_docs, r_hits = ref.topk(dense, matched, k)
        ps, pd = p_scores[lo:lo + B], p_docs[lo:lo + B]
        valid = np.isfinite(ps)
        n_valid = valid.sum(axis=1)
        # the reference's score of each doc the program returned
        safe = np.where(valid & (pd >= 0) & (pd < N), pd, 0)
        rows = torch.arange(len(qs), device=dense.device)[:, None]
        idx = torch.as_tensor(safe, device=dense.device)
        doc_ref = dense[rows, idx].to(torch.float64).cpu().numpy()
        doc_hit = matched[rows, idx].cpu().numpy()
        out["hits_wrong"] += compare.hits_wrong(p_hits[lo:lo + B], r_hits)
        out["short_lists"] += compare.short_lists(ps, r_hits, k)
        for j, q in enumerate(qs):
            n = int(n_valid[j])
            d = pd[j, :n]
            out["order_faults"] += compare.order_faults(ps[j], pd[j], n) + int(
                np.count_nonzero((d < 0) | (d >= N) | ~doc_hit[j, :n]))
            m = min(n, int(np.isfinite(r_scores[j]).sum()))
            if m == 0:
                continue
            p = ps[j, :m].astype(np.float64)
            if mode == "relative":
                scale_r, scale_d = np.abs(r_scores[j, :m]), np.abs(doc_ref[j, :m])
            else:
                unit = ref.quantum(q) * max(1, len(np.unique(q[ref.df[q] > 0])))
                scale_r = scale_d = np.full(m, unit)
            hit = doc_hit[j, :m]   # an unmatched doc is an order fault, above
            gaps = np.concatenate([np.abs(p - r_scores[j, :m]) / scale_r,
                                   np.abs(p - doc_ref[j, :m])[hit] / scale_d[hit]])
            out[gap_name] = max(out[gap_name], float(gaps.max()))
        del dense, matched
    return out


def least_bytes(data, batch: np.ndarray, k: int) -> int:
    """Least bytes of one batch of term-id queries (int [B, T]): each posting
    entry of the batch's distinct query terms read once (doc id and impact,
    8 B; the corpus's ``term_lengths`` give each term's entries) and the
    results written once (B x k scores or rank keys and doc ids, 8 B each,
    and B hit counts, 4 B). The count is of the work, not of the launches,
    so a redesigned kernel is read against the same work."""
    terms = np.unique(batch)
    return int(data.term_lengths[terms].sum()) * 8 + batch.shape[0] * (k * 8 + 4)
