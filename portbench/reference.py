"""The plain reference: exact BM25 over the benchmark's own postings.

Straight from the definition, in plain torch on whatever device the corpus
is on, in f64 by default; it imports nothing of the program and takes
nothing the program made:

    idf(t)    = ln(1 + (N - df + 0.5) / (df + 0.5))
    score(d)  = sum over the query's tokens t of
                idf(t) * tf / (tf + k1 * (1 - b + b * dl / avgdl))

with N the number of docs with a non-empty field, df the number of docs
holding t, dl the doc's field length (through the frozen SmallFloat copy
when the configuration states Lucene's quantized norms) and avgdl the mean
of dl over the N docs. A token that repeats in a query counts once per
occurrence, as a Lucene boolean of one SHOULD clause per token. A doc
matches when it holds one of the query's terms; the top k rank by (score
descending, doc id ascending), Lucene's order.

The bucket path's contract is 15-bit quantized scores: each term's
contribution is rounded to an integer number of quanta of ``qmax`` over
the query's largest possible score (the sum over its distinct terms of
idf times occurrences times the term's largest impact). ``quantum``
gives that quantum from this module's own impacts, so the check can hold
the bucket path to its contract; ``Reference(..., qmax=)`` computes the
same quantized algorithm (the check's control at a lower precision).
"""

from __future__ import annotations

import numpy as np
import torch


class Reference:
    """Exact (or, with ``dtype`` or ``qmax``, deliberately coarser) BM25
    over a ``generate.Corpus``."""

    def __init__(self, corpus, *, k1: float, b: float, quantized_norms: bool,
                 dtype: torch.dtype = torch.float64, qmax: int = 0):
        dev = corpus.post_docs.device
        self.corpus = corpus
        self.dtype = dtype
        self.qmax = int(qmax)
        lens = corpus.doc_lens
        if quantized_norms:
            from portbench.generate import quantized_lengths

            lens = torch.as_tensor(quantized_lengths(corpus), device=dev)
        dl = lens.to(torch.float64)
        n = int((lens > 0).sum())
        self.num_docs = corpus.num_docs
        self.doc_count = n
        avgdl = dl.sum() / n
        self.norm = (k1 * (1.0 - b + b * dl / avgdl)).to(dtype)
        self.df = np.asarray(corpus.term_lengths, np.int64)
        self._max_impact: dict[int, float] = {}

    def idf(self, term: int) -> float:
        df = int(self.df[term])
        return float(np.log(1.0 + (self.doc_count - df + 0.5) / (df + 0.5)))

    def _postings(self, term: int) -> tuple[torch.Tensor, torch.Tensor]:
        off, ln = int(self.corpus.term_offsets[term]), int(self.df[term])
        return (self.corpus.post_docs[off:off + ln].long(),
                self.corpus.post_freqs[off:off + ln])

    def _impacts(self, term: int, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        docs, tf = self._postings(term)
        tf = tf.to(dtype)
        return docs, tf / (tf + self.norm[docs].to(dtype))

    def max_impact(self, term: int) -> float:
        """The term's largest impact, exact (f64)."""
        if term not in self._max_impact:
            _, imp = self._impacts(term, torch.float64)
            self._max_impact[term] = float(imp.max()) if imp.numel() else 0.0
        return self._max_impact[term]

    def quantum(self, query) -> float:
        """One quantum of the bucket path's contract for this query: its
        largest possible score over ``qmax`` (default 32000)."""
        return self._top_score(query) / (self.qmax or 32000)

    def _top_score(self, query) -> float:
        terms, mult = np.unique(np.asarray(query, np.int64), return_counts=True)
        return sum(self.idf(int(t)) * int(c) * self.max_impact(int(t))
                   for t, c in zip(terms, mult) if self.df[t])

    def dense(self, queries) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, N], matched [Q, N]) of a block of term-id queries."""
        Q, N = len(queries), self.num_docs
        dev = self.corpus.post_docs.device
        acc_dtype = torch.int64 if self.qmax else self.dtype
        scores = torch.zeros(Q * N, dtype=acc_dtype, device=dev)
        matched = torch.zeros(Q * N, dtype=torch.bool, device=dev)
        for qi, query in enumerate(queries):
            scale = self.qmax / self._top_score(query) if self.qmax else 0.0
            for t in np.asarray(query, np.int64).tolist():
                if not self.df[t]:
                    continue
                docs, imp = self._impacts(t, torch.float64 if self.qmax else self.dtype)
                w = self.idf(t)
                if self.qmax:
                    contrib = torch.clamp((w * scale * imp + 0.5).floor(), 1, self.qmax).long()
                else:
                    contrib = imp * torch.tensor(w, dtype=self.dtype, device=dev)
                flat = docs + qi * N
                scores.index_add_(0, flat, contrib)
                matched[flat] = True
        scores = scores.view(Q, N)
        if self.qmax:
            scales = torch.tensor([self.qmax / self._top_score(q) for q in queries],
                                  dtype=torch.float64, device=dev)
            scores = scores.clamp(max=self.qmax).to(torch.float64) / scales[:, None]
        return scores, matched.view(Q, N)

    def topk(self, scores: torch.Tensor, matched: torch.Tensor, k: int):
        """(scores f64 [Q, k], docs int64 [Q, k], hits int64 [Q]) in Lucene's
        order; empty slots are (-inf, -1)."""
        key = torch.where(matched, scores.to(torch.float64),
                          torch.full((), -np.inf, dtype=torch.float64, device=scores.device))
        vals, idx = torch.sort(key, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
        return (vals.cpu().numpy(), idx.cpu().numpy(),
                matched.sum(dim=1).cpu().numpy().astype(np.int64))
