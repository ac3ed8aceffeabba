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


def eval_column_query(q: dict, columns: dict) -> tuple[np.ndarray, np.ndarray]:
    """(scores f32, match bool) of a query dict over numpy doc-value
    columns (``SyntheticCorpus.doc_columns``), by the semantics of the
    compiled columnar queries (nrtsearch_tpu/query/compiled.py:682-863):
    range, term and term-in-set clauses match where the value is present
    and score their boost; exists matches present docs; a boolean ANDs its
    MUST and FILTER clauses, needs one SHOULD when it has nothing else,
    drops MUST_NOT matches, and scores (sum of MUST and SHOULD scores) times
    its boost. Bounds compare in f32, as the engine rounds them."""
    boost = np.float32(float(q.get("boost", 0) or 0) or 1.0)
    if "booleanQuery" in q:
        n = len(next(iter(columns.values()))[0])
        pairs = {"MUST": [], "FILTER": [], "SHOULD": [], "MUST_NOT": []}
        for c in q["booleanQuery"]["clauses"]:
            pairs[c.get("occur", "SHOULD")].append(eval_column_query(c["query"], columns))
        match = np.ones(n, bool)
        for _, m in pairs["MUST"] + pairs["FILTER"]:
            match &= m
        if pairs["SHOULD"]:
            count = sum(m.astype(np.int32) for _, m in pairs["SHOULD"])
            if not pairs["MUST"] and not pairs["FILTER"]:
                match &= count >= 1
        for _, m in pairs["MUST_NOT"]:
            match &= ~m
        scores = np.zeros(n, np.float32)
        for s, m in pairs["MUST"] + pairs["SHOULD"]:
            scores = scores + np.where(m, s, np.float32(0))
        return np.where(match, scores * boost, np.float32(0)).astype(np.float32), match
    if "rangeQuery" in q:
        r = q["rangeQuery"]
        vals, present = columns[r["field"]][:2]
        lo = np.float32(float(r["lower"])) if r.get("lower") not in (None, "") else -np.inf
        hi = np.float32(float(r["upper"])) if r.get("upper") not in (None, "") else np.inf
        ok_lo = vals > lo if r.get("lowerExclusive") else vals >= lo
        ok_hi = vals < hi if r.get("upperExclusive") else vals <= hi
        match = ok_lo & ok_hi & present
    elif "termQuery" in q or "termInSetQuery" in q:
        if "termQuery" in q:
            field, texts = q["termQuery"]["field"], [q["termQuery"]["textValue"]]
        else:
            t = q["termInSetQuery"]
            field, texts = t["field"], t["textTerms"]["terms"]
        vals, present, names = columns[field]
        ords = [names.index(x) for x in texts if x in names]
        match = np.isin(vals, ords) & present
    elif "existsQuery" in q:
        match = columns[q["existsQuery"]["field"]][1].copy()
    else:
        raise ValueError(f"not a column query: {sorted(q)}")
    return np.where(match, boost, np.float32(0)).astype(np.float32), match


def config3_query(terms: list[str], tag_names: list[str], seed: int,
                  operator: str = "SHOULD") -> dict:
    """BASELINE config #3's query tree (benchmarks/stress_deep_boolean.py:
    140-177) as a query dict: MUST match(body, terms), FILTER range(price,
    100..900), FILTER termInSet(tag, 5 tags), MUST_NOT term(tag, the 8th
    tag), MUST boolean(8 SHOULD clauses alternating price ranges and tag
    terms, boost 1.5). Ranges and tags are drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    tags = [tag_names[i] for i in rng.choice(len(tag_names), 5, replace=False)]
    should = []
    for i in range(8):
        if i % 2 == 0:
            lo = float(rng.uniform(0, 500))
            should.append({"occur": "SHOULD", "query": {"rangeQuery": {
                "field": "price", "lower": str(lo), "upper": str(lo + 400)}}})
        else:
            should.append({"occur": "SHOULD", "query": {"termQuery": {
                "field": "tag", "textValue": tag_names[int(rng.integers(0, len(tag_names)))]}}})
    return {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {
            "field": "body", "query": " ".join(terms), "operator": operator}}},
        {"occur": "FILTER", "query": {"rangeQuery": {
            "field": "price", "lower": "100", "upper": "900"}}},
        {"occur": "FILTER", "query": {"termInSetQuery": {
            "field": "tag", "textTerms": {"terms": tags}}}},
        {"occur": "MUST_NOT", "query": {"termQuery": {"field": "tag", "textValue": tag_names[7]}}},
        {"occur": "MUST", "query": {"boost": 1.5, "booleanQuery": {"clauses": should}}},
    ]}}


def column_clauses(q: dict) -> dict:
    """The non-text part of a ``config3_query`` tree: a boolean of every
    clause but the first (the text clause), for ``eval_column_query``."""
    return {"booleanQuery": {"clauses": q["booleanQuery"]["clauses"][1:]}}


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
        scores, counts = self._bm25(terms, k1, b)
        matched = counts >= len(terms) if require_all else counts > 0
        docs = np.nonzero(matched)[0]
        order = np.lexsort((docs, -scores[docs]))[:k]
        return scores[docs[order]], docs[order], int(matched.sum())

    def exact_filtered_topk(self, terms: list[str], k: int, columns: dict,
                            node: dict | None = None, *, sort: tuple | None = None,
                            require_all: bool = False, facet: str | None = None,
                            total: str | None = None):
        """Independent answer for BASELINE config #3's forms, in numpy:
        BM25 over ``terms`` as ``exact_topk`` scores it, restricted by the
        mask of the non-text clauses ``node`` (a query dict, evaluated over
        ``columns`` by ``eval_column_query``) and plus their summed scores.
        ``sort`` = (field, ascending, missing_last) ranks matched docs by the
        column (missing values at -1e38, or 1e38 when last) with doc-id
        ties; else (score desc, doc asc). ``facet`` counts the matched docs
        per ordinal of that column; ``total`` sums that column over matched
        docs where present (f64). Returns a dict: ``scores`` (the keys when
        sorted), ``docs``, ``hits``, and ``facet`` / ``total``."""
        scores, counts = self._bm25(terms)
        matched = counts >= len(terms) if require_all else counts > 0
        if node is not None:
            extra, mask = eval_column_query(node, columns)
            matched &= mask
            scores = scores + extra
        docs = np.nonzero(matched)[0]
        if sort is not None:
            field, ascending, missing_last = sort
            vals, present = columns[field][:2]
            miss = np.float32(1e38 if missing_last else -1e38)
            key = np.where(present, vals.astype(np.float32), miss)[docs]
            order = np.lexsort((docs, key if ascending else -key))[:k]
            out = {"scores": key[order], "docs": docs[order]}
        else:
            order = np.lexsort((docs, -scores[docs]))[:k]
            out = {"scores": scores[docs[order]], "docs": docs[order]}
        out["hits"] = int(matched.sum())
        if facet is not None:
            vals, present, names = columns[facet]
            sel = matched & present
            out["facet"] = np.bincount(vals[sel], minlength=len(names))
        if total is not None:
            vals, present = columns[total][:2]
            out["total"] = float(vals[matched & present].astype(np.float64).sum())
        return out

    def _bm25(self, terms: list[str], k1: float = 1.2, b: float = 0.75):
        """Dense f32 BM25 scores and matched-term counts over all docs."""
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
        return scores, counts

    def doc_columns(self, seed: int, n_tags: int = 100, missing: float = 0.01) -> dict:
        """BASELINE config #3's doc-value columns (benchmarks/
        stress_deep_boolean.py:86-137), drawn with numpy from ``seed``:
        ``price`` FLOAT uniform over [0, 1000) with a ``missing`` share of
        docs without a value, ``ts`` FLOAT uniform over [0, 1e9), ``tag``
        ATOM ordinals over ``n_tags`` terms ``tag_000``... (names sort in
        ordinal order). Each entry is (values, present[, ord_terms]) over
        all docs; values are f32 (exact in an f32 device column)."""
        rng = np.random.default_rng(seed)
        n = self.num_docs
        price = rng.uniform(0, 1000, n).astype(np.float32)
        price_present = rng.random(n) >= missing
        ts = rng.uniform(0, 1e9, n).astype(np.float32)
        tag = rng.integers(0, n_tags, n).astype(np.int32)
        every = np.ones(n, bool)
        return {
            "price": (np.where(price_present, price, 0).astype(np.float32), price_present),
            "ts": (ts, every),
            "tag": (tag, every, [f"tag_{i:03d}" for i in range(n_tags)]),
        }

    def segment_doc_values(self, columns: dict, num_segments: int) -> list[dict]:
        """``columns`` (``doc_columns``) cut into the doc ranges of
        ``segment_arrays``, in the host layout ``convert.segment_from_numpy``
        takes: FLOAT as DOUBLE columns, ATOM as ORDINAL columns whose
        per-segment dictionary holds the terms that segment has."""
        bounds = np.linspace(0, self.num_docs, num_segments + 1).astype(np.int64)
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            n = int(hi - lo)
            capacity = pad_to_bucket(n)
            seg = {}
            for name, col in columns.items():
                vals, present = col[0][lo:hi], col[1][lo:hi]
                full_present = np.zeros(capacity, bool)
                full_present[:n] = present
                if len(col) == 3:
                    used = np.unique(vals[present])
                    host = np.full(capacity, -1, np.int32)
                    host[:n] = np.where(present, np.searchsorted(used, vals), -1)
                    seg[name] = {"kind": "ORDINAL", "values": host, "present": full_present,
                                 "ord_terms": [col[2][u] for u in used]}
                else:
                    host = np.zeros(capacity, np.float64)
                    host[:n] = np.where(present, vals, 0)
                    seg[name] = {"kind": "DOUBLE", "values": host, "present": full_present}
            out.append(seg)
        return out

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
