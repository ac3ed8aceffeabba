"""Zipf-distributed synthetic corpus (counterpart: the numpy body of
nrtsearch_tpu/models/flagship.py ``SyntheticCorpus``).

The same seed gives the same arrays as the reference: the random draws run
in the same order. ``segment_arrays`` cuts the corpus into doc-range
segments in the layout ``convert.segment_from_numpy`` takes.
"""

from __future__ import annotations

import numpy as np

from nrtsearch_tpu_torch.utils.smallfloat import quantize_length
from nrtsearch_tpu_torch.core.segment import pad_to_bucket


class SyntheticCorpus:
    """Packed postings generated directly (no analysis loop): term draws
    follow a Zipf law, doc lengths are lognormal."""

    def __init__(
        self,
        num_docs: int,
        vocab_size: int = 50_000,
        avg_doc_len: int = 64,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.num_docs = num_docs
        self.vocab_size = vocab_size
        # doc lengths (term draws per doc)
        doc_lens = np.maximum(
            rng.lognormal(np.log(avg_doc_len), 0.4, num_docs).astype(np.int64), 4
        )
        total = int(doc_lens.sum())
        ranks = np.arange(1, vocab_size + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        terms = rng.choice(vocab_size, size=total, p=probs).astype(np.int32)
        docs = np.repeat(np.arange(num_docs, dtype=np.int32), doc_lens)
        # collapse duplicates within a doc -> (doc, term) with freq
        key = docs.astype(np.int64) * vocab_size + terms
        uniq, counts = np.unique(key, return_counts=True)
        u_docs = (uniq // vocab_size).astype(np.int32)
        u_terms = (uniq % vocab_size).astype(np.int32)
        # sort by term, then doc (postings layout)
        order = np.lexsort((u_docs, u_terms))
        self.post_docs = u_docs[order]
        self.post_freqs = counts[order].astype(np.float32)
        post_terms = u_terms[order]
        self.term_offsets = np.zeros(vocab_size, np.int64)
        self.term_lengths = np.zeros(vocab_size, np.int32)
        t_uniq, t_start, t_count = np.unique(
            post_terms, return_index=True, return_counts=True
        )
        self.term_offsets[t_uniq] = t_start
        self.term_lengths[t_uniq] = t_count
        self.doc_lens = np.zeros(num_docs, np.float32)
        np.add.at(self.doc_lens, u_docs, counts)
        self.rng = rng

    def sample_queries(self, batch: int, terms_per_query: int = 4) -> list[list[str]]:
        """Queries drawn from the same Zipf distribution."""
        ranks = np.arange(1, self.vocab_size + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        qs = self.rng.choice(self.vocab_size, size=(batch, terms_per_query), p=probs)
        return [[str(t) for t in row] for row in qs]

    def exact_topk(self, terms: list[str], k: int, *, require_all: bool = False,
                   k1: float = 1.2, b: float = 0.75):
        """Independent exact BM25 answer in numpy, over the corpus as
        ``segment_arrays`` lays it out (quantized lengths, no deletes):
        f32 impacts with the same formula, a dense score array summed term
        by term, and a (score desc, doc asc) order. Returns (scores [<=k],
        docs [<=k], total_hits)."""
        qlens = quantize_length(self.doc_lens.astype(np.int64))
        avgdl = np.float32(int(qlens.sum()) / self.num_docs)
        qlens = qlens.astype(np.float32)
        k1, b = np.float32(k1), np.float32(b)
        scores = np.zeros(self.num_docs, np.float32)
        counts = np.zeros(self.num_docs, np.int64)
        for t in terms:
            tid = int(t)
            off, ln = int(self.term_offsets[tid]), int(self.term_lengths[tid])
            if ln == 0:
                continue
            docs = self.post_docs[off : off + ln]
            tf = self.post_freqs[off : off + ln]
            imp = tf / (tf + k1 * (np.float32(1.0) - b + b * qlens[docs] / avgdl))
            idf = np.log(1.0 + (self.num_docs - ln + 0.5) / (ln + 0.5))
            np.add.at(scores, docs, np.float32(idf) * imp)
            counts[docs] += 1
        matched = counts >= len(terms) if require_all else counts > 0
        docs = np.nonzero(matched)[0]
        order = np.lexsort((docs, -scores[docs]))[:k]
        return scores[docs[order]], docs[order], int(matched.sum())

    def segment_arrays(self, num_segments: int) -> list[dict]:
        """Cut the corpus into ``num_segments`` doc-range segments. Term t
        is the string ``str(t)``; field lengths are byte-quantized as the
        reference's segment builder does. Each dict feeds
        ``convert.segment_from_numpy``."""
        V = self.vocab_size
        post_terms = np.repeat(np.arange(V, dtype=np.int64), self.term_lengths)
        bounds = np.linspace(0, self.num_docs, num_segments + 1).astype(np.int64)
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sel = (self.post_docs >= lo) & (self.post_docs < hi)
            docs = self.post_docs[sel] - np.int32(lo)
            freqs = self.post_freqs[sel]
            lengths = np.bincount(post_terms[sel], minlength=V).astype(np.int32)
            offsets = np.zeros(V, np.int64)
            np.cumsum(lengths[:-1], out=offsets[1:])
            n = int(hi - lo)
            capacity = pad_to_bucket(n)
            raw = np.zeros(capacity, np.int64)
            raw[:n] = self.doc_lens[lo:hi].astype(np.int64)
            qlens = quantize_length(raw).astype(np.float32)
            total = len(docs)
            p_pad = pad_to_bucket(total + 16384)
            doc_ids = np.zeros(p_pad, np.int32)
            doc_ids[:total] = docs
            pf = np.zeros(p_pad, np.float32)
            pf[:total] = freqs
            live = np.zeros(capacity, bool)
            live[:n] = True
            out.append({
                "terms": {str(t): t for t in range(V)},
                "offsets": offsets,
                "lengths": lengths,
                "doc_ids": doc_ids,
                "freqs": pf,
                "doc_lens": qlens,
                "sum_doc_lens": int(qlens[:n].sum()),
                "doc_count": int(np.count_nonzero(raw[:n])),
                "postings_len": total,
                "live": live,
                "host_live": np.ones(n, bool),
                "num_docs": n,
                "capacity": capacity,
                "stored": [{} for _ in range(n)],
            })
        return out
