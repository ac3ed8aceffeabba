"""Zipf-distributed synthetic corpus (counterpart: the numpy body of
nrtsearch_tpu/models/flagship.py ``SyntheticCorpus``).

The same seed gives the same arrays as the reference: the random draws run
in the same order. ``segment_arrays`` cuts the corpus into doc-range
segments in the layout ``convert.segment_from_numpy`` takes.
``clustered_vectors`` is benchmarks/vector_recall.py's clustered Gaussian
vector corpus, drawn in the same order. ``SyntheticCorpus.to_model`` builds
the flagship model of the whole corpus (models/flagship.py).
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


# (lat range, lon range) of the synthetic ``loc`` points: the San Francisco
# peninsula's north end
METRO_BOX = ((37.6, 37.9), (-122.55, -122.25))


def haversine_meters(points: np.ndarray, lat: float, lon: float) -> np.ndarray:
    """Haversine distance in meters, in f64, from f64 [n, 2] (lat, lon)
    points to one point (the engine's formula and earth radius, computed
    independently of it and in higher precision)."""
    r = np.deg2rad(points)
    c_lat, c_lon = np.deg2rad(lat), np.deg2rad(lon)
    a = (np.sin((r[:, 0] - c_lat) / 2) ** 2
         + np.cos(r[:, 0]) * np.cos(c_lat) * np.sin((r[:, 1] - c_lon) / 2) ** 2)
    return 2 * 6371008.7714 * np.arcsin(np.sqrt(a))


def geo_radius_oracle(columns: dict, lat: float, lon: float, radius: float,
                      field: str = "loc", near_m: float = 2.0):
    """(match, near) of a geo-radius filter over ``columns[field]``: the
    docs with a point within ``radius`` meters (f64 distance), and the docs
    whose distance lies within ``near_m`` meters of the radius, where the
    engine's distance may fall on the other side. The engine computes in
    f32, as the reference does: its angle differences carry an absolute
    error of about an f32 ulp of the latitude in radians (6e-8), a few
    decimeters on the earth's surface."""
    pts, present = columns[field]
    dist = haversine_meters(pts, lat, lon)
    match = present & (dist <= radius)
    near = present & (np.abs(dist - radius) <= near_m)
    return match, near


def geo_bbox_oracle(columns: dict, min_lat: float, max_lat: float, min_lon: float,
                    max_lon: float, field: str = "loc") -> np.ndarray:
    """Docs with a point inside the box (no dateline crossing), compared
    in f32 as the engine compares its f32 column with f32 bounds."""
    pts, present = columns[field]
    p = pts.astype(np.float32)
    f = np.float32
    return (present & (p[:, 0] >= f(min_lat)) & (p[:, 0] <= f(max_lat))
            & (p[:, 1] >= f(min_lon)) & (p[:, 1] <= f(max_lon)))


def column_clauses(q: dict) -> dict:
    """The non-text part of a ``config3_query`` tree: a boolean of every
    clause but the first (the text clause), for ``eval_column_query``."""
    return {"booleanQuery": {"clauses": q["booleanQuery"]["clauses"][1:]}}


def clustered_vectors(n: int, dims: int, n_queries: int,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(base f32 [n, dims], queries f32 [n_queries, dims]): Gaussian
    clusters (one per 1,000 docs, at least 8) with sigma 0.35 around unit
    normal centers, kNN structure like real embeddings (a copy of
    benchmarks/vector_recall.py ``synthetic``)."""
    rng = np.random.default_rng(seed)
    n_clusters = max(n // 1000, 8)
    centers = rng.normal(0, 1.0, (n_clusters, dims)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    base = centers[assign] + rng.normal(0, 0.35, (n, dims)).astype(np.float32)
    qassign = rng.integers(0, n_clusters, n_queries)
    qs = centers[qassign] + rng.normal(0, 0.35, (n_queries, dims)).astype(np.float32)
    return base.astype(np.float32), qs.astype(np.float32)


class SyntheticCorpus:
    """Packed postings generated directly (no analysis loop): term draws
    follow a Zipf law, doc lengths are lognormal.

    With ``keep_positions`` the corpus also keeps the drawn token sequence
    (``tokens``, doc after doc, and each doc's first token ``doc_starts``):
    a token's position is its index within its doc, and ``segment_arrays``
    adds each segment's positions CSR. The draws and the postings are the
    same with and without it."""

    def __init__(
        self,
        num_docs: int,
        vocab_size: int = 50_000,
        avg_doc_len: int = 64,
        seed: int = 0,
        keep_positions: bool = False,
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
        self.tokens = terms if keep_positions else None
        self.doc_starts = np.concatenate([[0], np.cumsum(doc_lens)]) if keep_positions else None
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

    def to_model(self, device="cuda"):
        """The flagship model (models/flagship.py ``BatchedBM25``) of the
        whole corpus as one segment on ``device``, as the reference's
        ``SyntheticCorpus.to_model`` lays it out: raw (unquantized) doc
        lengths, docs padded to a power of two, postings padded past the
        merge gather's and the bucket kernel's reach."""
        from nrtsearch_tpu_torch.core.packed_view import GATHER_TILE
        from nrtsearch_tpu_torch.models.flagship import BatchedBM25

        d_pad = pad_to_bucket(self.num_docs)
        p_pad = pad_to_bucket(len(self.post_docs) + max(2 * GATHER_TILE, 34816))
        doc_ids = np.zeros(p_pad, np.int32)
        doc_ids[: len(self.post_docs)] = self.post_docs
        freqs = np.zeros(p_pad, np.float32)
        freqs[: len(self.post_freqs)] = self.post_freqs
        lens = np.zeros(d_pad, np.float32)
        lens[: self.num_docs] = self.doc_lens
        live = np.zeros(d_pad, bool)
        live[: self.num_docs] = True
        return BatchedBM25(
            terms={str(t): t for t in range(self.vocab_size)}, offsets=self.term_offsets,
            lengths=self.term_lengths, doc_ids=doc_ids, freqs=freqs, doc_lens=lens,
            live=live, num_docs_real=self.num_docs, device=device,
        )

    def exact_topk(self, terms: list[str], k: int, *, require_all: bool = False,
                   k1: float = 1.2, b: float = 0.75, raw_lengths: bool = False):
        """Independent exact BM25 answer in numpy, over the corpus as
        ``segment_arrays`` lays it out (quantized lengths, no deletes), or
        with ``raw_lengths`` as ``to_model`` lays it out (the raw lengths,
        their mean from the f32 sum over the padded doc space): f32 impacts
        with the same formula, a dense score array summed term by term, and
        a (score desc, doc asc) order. Returns (scores [<=k], docs [<=k],
        total_hits)."""
        scores, counts = self._bm25(terms, k1, b, raw_lengths)
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

    def exact_function_score(self, terms: list[str], k: int, columns: dict,
                             field: str = "price", match: np.ndarray | None = None):
        """The function score ``_score * log(<field> + 1)`` over a match
        query on ``terms`` (a missing value reads 0), restricted to
        ``match`` when given, in numpy f32. Returns (scores [<=k], docs
        [<=k], total_hits)."""
        scores, counts = self._bm25(terms)
        matched = counts > 0
        if match is not None:
            matched &= match
        vals, present = columns[field][:2]
        col = np.where(present, vals, 0).astype(np.float32)
        fs = (scores * np.log(col + np.float32(1))).astype(np.float32)
        docs = np.nonzero(matched)[0]
        order = np.lexsort((docs, -fs[docs]))[:k]
        return fs[docs[order]], docs[order], int(matched.sum())

    def _bm25(self, terms: list[str], k1: float = 1.2, b: float = 0.75,
              raw_lengths: bool = False):
        """Dense f32 BM25 scores and matched-term counts over all docs."""
        if raw_lengths:
            padded = np.zeros(pad_to_bucket(self.num_docs), np.float32)
            padded[: self.num_docs] = self.doc_lens
            avgdl = np.float32(float(padded.sum()) / self.num_docs)
            qlens = self.doc_lens.astype(np.float32)
        else:
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

    def doc_columns(self, seed: int, n_tags: int = 100, missing: float = 0.01,
                    loc: bool = True) -> dict:
        """BASELINE config #3's doc-value columns (benchmarks/
        stress_deep_boolean.py:86-137), drawn with numpy from ``seed``:
        ``price`` FLOAT uniform over [0, 1000) with a ``missing`` share of
        docs without a value, ``ts`` FLOAT uniform over [0, 1e9), ``tag``
        ATOM ordinals over ``n_tags`` terms ``tag_000``... (names sort in
        ordinal order). Each entry is (values, present[, ord_terms]) over
        all docs; values are f32 (exact in an f32 device column).

        With ``loc`` also a LAT_LON ``loc`` column, drawn after the others
        (which stay as they were): points uniform in ``METRO_BOX`` (a
        metro-sized box, about 33 km by 26 km), a ``missing`` share
        without one; values f64 [n, 2] (lat, lon) rounded to f32, as the
        engine keeps them on its device."""
        rng = np.random.default_rng(seed)
        n = self.num_docs
        price = rng.uniform(0, 1000, n).astype(np.float32)
        price_present = rng.random(n) >= missing
        ts = rng.uniform(0, 1e9, n).astype(np.float32)
        tag = rng.integers(0, n_tags, n).astype(np.int32)
        every = np.ones(n, bool)
        out = {
            "price": (np.where(price_present, price, 0).astype(np.float32), price_present),
            "ts": (ts, every),
            "tag": (tag, every, [f"tag_{i:03d}" for i in range(n_tags)]),
        }
        if loc:
            (lat0, lat1), (lon0, lon1) = METRO_BOX
            pts = np.stack([rng.uniform(lat0, lat1, n), rng.uniform(lon0, lon1, n)], axis=1)
            present = rng.random(n) >= missing
            pts = np.where(present[:, None], pts.astype(np.float32), 0).astype(np.float64)
            out["loc"] = (pts, present)
        return out

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
                if vals.ndim == 2:
                    host = np.zeros((capacity, 2), np.float64)
                    host[:n] = vals
                    seg[name] = {"kind": "LAT_LON", "values": host, "present": full_present}
                elif len(col) == 3:
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

    def segment_positions(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """(positions int32, position_offsets int64) of docs [lo, hi): the
        CSR over that doc range's postings entries, in postings order (term,
        then doc), each entry's positions ascending."""
        a, b = int(self.doc_starts[lo]), int(self.doc_starts[hi])
        toks = self.tokens[a:b]
        local_doc = np.repeat(np.arange(hi - lo, dtype=np.int64),
                              np.diff(self.doc_starts[lo : hi + 1]))
        pos = (np.arange(a, b, dtype=np.int64) - self.doc_starts[lo:hi][local_doc]).astype(np.int32)
        # the tokens are in (doc, position) order: a stable sort by term
        # gives (term, doc, position) order
        order = np.argsort(toks, kind="stable")
        key = toks[order].astype(np.int64) * (hi - lo) + local_doc[order]
        starts = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
        offsets = np.append(starts, len(key)).astype(np.int64)
        return pos[order], offsets

    def segment_bounds(self, num_segments: int) -> np.ndarray:
        """The doc-range bounds of ``segment_arrays``' segments."""
        return np.linspace(0, self.num_docs, num_segments + 1).astype(np.int64)

    def segment_arrays(self, num_segments: int, positions: bool = True) -> list[dict]:
        """Cut the corpus into ``num_segments`` doc-range segments. Term t
        is the string ``str(t)``; field lengths are byte-quantized as the
        reference's segment builder does. Each dict feeds
        ``convert.segment_from_numpy``; with ``keep_positions`` (and
        ``positions``) it holds the segment's ``positions`` and
        ``position_offsets``."""
        V = self.vocab_size
        post_terms = np.repeat(np.arange(V, dtype=np.int64), self.term_lengths)
        bounds = self.segment_bounds(num_segments)
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
            if positions and self.tokens is not None:
                out[-1]["positions"], out[-1]["position_offsets"] = \
                    self.segment_positions(int(lo), int(hi))
        return out
