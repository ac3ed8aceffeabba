"""BM25 pieces of the search slice (counterpart: nrtsearch_tpu/ops/bm25.py).

    idf(t)  = ln(1 + (docCount - df + 0.5) / (df + 0.5))      [host, plan time]
    impact  = tf / (tf + k1 * (1 - b + b * dl / avgdl))       [device, refresh]

with dl the byte-quantized field length (nrtsearch_tpu/utils/smallfloat.py).
A posting's score contribution is ``idf * boost * impact``.

``score_text_clause`` is the general evaluator's scorer: it scores one
query's terms over a whole segment into dense [capacity] scores and
matched-term counts. The reference gathers a window of the concatenated
postings runs and scatter-adds it in one XLA program; an XLA scatter adds
in update order. A float ``index_add_`` on CUDA adds colliding updates in
any order, so the port scatters one term at a time, in term order: within
one term's run a doc appears once, so no two updates collide and every
doc's sum is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch.device import scalar_f32


def lucene_idf(doc_count: int, doc_freq: int) -> float:
    """Lucene BM25Similarity idf."""
    return float(np.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5)))


def precompute_impacts(
    post_docs: torch.Tensor,   # int32 [P]
    post_freqs: torch.Tensor,  # float32 [P]
    doc_lens: torch.Tensor,    # float32 [D] quantized lengths
    live: torch.Tensor,        # bool [D]
    k1: float,
    b: float,
    avgdl: float,
) -> torch.Tensor:
    """Per-posting BM25 tf-norm impact, zeroed for deleted docs.

    The f32 formula runs in the reference's order, with one difference of
    form: the reference's compiled program contracts ``tf + k1 * norm``
    into one fused multiply-add (one rounding). The port computes that
    FMA in f64 (the f32 product is exact there) and rounds once to f32,
    which makes impacts bit-equal to the reference on the same inputs.
    k1, b and avgdl are 0-d f32 tensors on the postings' device: a
    Python-scalar divisor lets CUDA's ``div`` multiply by a rounded
    reciprocal instead."""
    dev = post_docs.device
    k1_t, b_t, avgdl_t = (scalar_f32(x, dev) for x in (k1, b, avgdl))
    idx = post_docs.long()
    dl = doc_lens[idx]
    norm = 1.0 - b_t + b_t * dl / avgdl_t
    denom = (k1_t.double() * norm.double() + post_freqs.double()).float()
    impact = post_freqs / denom
    return torch.where(live[idx], impact, torch.zeros((), dtype=torch.float32, device=dev))


def score_text_clause(
    doc_ids: torch.Tensor,    # int32 [P_pad]
    freqs: torch.Tensor,      # float32 [P_pad]
    doc_lens: torch.Tensor,   # float32 [D_pad] quantized lengths
    term_offsets,             # host ints [Q]: postings run start per term
    term_lengths,             # host ints [Q]: run length (0 = absent)
    term_weights,             # host f32 [Q]: idf * term boost * boost
    k1: float,
    b: float,
    avgdl: float,
    num_docs: int,            # D_pad
    need_counts: bool = True,
    want_scores: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One query's (scores [D] f32, matched-term counts [D] int32)
    (counterpart: nrtsearch_tpu/ops/bm25.py ``score_text_clause_impl`` for
    one query). Each term's contribution ``w * tf / (tf + k1 * (1 - b + b
    * dl / avgdl))`` is computed in the reference's order, its ``tf +
    k1 * norm`` in f64 and rounded once (the FMA XLA's CPU build emits,
    as ``precompute_impacts``), and added per term in term order. With
    ``need_counts`` False the counts are ``scores > 0`` (every scored
    entry is positive), as in the reference; ``want_scores`` False skips
    the scores of a constant-score clause, whose caller reads counts only
    (the scores come back zero)."""
    dev = doc_ids.device
    scores = torch.zeros(num_docs, dtype=torch.float32, device=dev)
    runs = [(int(o), int(n), w) for o, n, w in zip(term_offsets, term_lengths, term_weights)
            if int(n) > 0]
    if want_scores and runs:
        k1_t, b_t, avgdl_t = scalar_f32(k1, dev), scalar_f32(b, dev), scalar_f32(avgdl, dev)
        one_minus_b = 1.0 - b_t
        k1_64 = k1_t.double()
        for off, n, w in runs:
            doc = doc_ids[off : off + n].long()
            tf = freqs[off : off + n]
            norm = one_minus_b + b_t * doc_lens[doc] / avgdl_t
            denom = (k1_64 * norm.double() + tf.double()).float()
            scores.index_add_(0, doc, scalar_f32(w, dev) * tf / denom)
    if need_counts or not want_scores:
        counts = torch.zeros(num_docs, dtype=torch.int32, device=dev)
        if runs:
            docs = torch.cat([doc_ids[o : o + n] for o, n, _ in runs]).long()
            counts.index_add_(0, docs, torch.ones_like(docs, dtype=torch.int32))
    else:
        counts = (scores > 0.0).to(torch.int32)
    return scores, counts


def term_match_mask(doc_ids: torch.Tensor, term_offset: int, term_length: int,
                    num_docs: int) -> torch.Tensor:
    """Bool [D] mask of the docs in one term's postings run (counterpart:
    nrtsearch_tpu/ops/bm25.py ``term_match_mask`` for one query)."""
    mask = torch.zeros(num_docs, dtype=torch.bool, device=doc_ids.device)
    if term_length:
        mask[doc_ids[term_offset : term_offset + term_length].long()] = True
    return mask
