"""The merge index tests' corpus (tests/test_maxscore.py's generator); it
imports neither package."""

import numpy as np


def build_corpus(num_docs, vocab, avg_len, seed=0):
    """A small Zipf corpus in the packed flat-postings layout: (post_docs,
    post_freqs, offsets, lengths, doc_lens)."""
    rng = np.random.default_rng(seed)
    doc_lens = np.maximum(rng.lognormal(np.log(avg_len), 0.4, num_docs).astype(np.int64), 2)
    total = int(doc_lens.sum())
    ranks = np.arange(1, vocab + 1)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    terms = rng.choice(vocab, size=total, p=probs).astype(np.int32)
    docs = np.repeat(np.arange(num_docs, dtype=np.int32), doc_lens)
    key = docs.astype(np.int64) * vocab + terms
    uniq, counts = np.unique(key, return_counts=True)
    u_docs = (uniq // vocab).astype(np.int32)
    u_terms = (uniq % vocab).astype(np.int32)
    order = np.lexsort((u_docs, u_terms))
    post_docs = u_docs[order]
    post_freqs = counts[order].astype(np.float32)
    post_terms = u_terms[order]
    offsets = np.zeros(vocab, np.int64)
    lengths = np.zeros(vocab, np.int32)
    t_uniq, t_start, t_count = np.unique(post_terms, return_index=True, return_counts=True)
    offsets[t_uniq] = t_start
    lengths[t_uniq] = t_count
    dl = np.zeros(num_docs, np.float32)
    np.add.at(dl, u_docs, counts)
    return post_docs, post_freqs, offsets, lengths, dl


def index_arrays(num_docs=4000, vocab=600, avg_len=24, seed=0):
    """(doc ids int32 [P_pad], impacts f32 [P_pad], offsets, lengths,
    num_docs): BM25 impacts over the corpus, padded to a power of two."""
    post_docs, post_freqs, offsets, lengths, dl = build_corpus(num_docs, vocab, avg_len, seed)
    k1, b = 1.2, 0.75
    avgdl = dl.sum() / num_docs
    imp = post_freqs / (post_freqs + k1 * (1.0 - b + b * dl[post_docs] / avgdl))
    pad = 1
    while pad < len(post_docs) + 256:
        pad <<= 1
    d_ids = np.zeros(pad, np.int32)
    d_ids[: len(post_docs)] = post_docs
    d_imp = np.zeros(pad, np.float32)
    d_imp[: len(post_docs)] = imp
    return d_ids, d_imp, offsets, lengths, num_docs


def idf(doc_count: int, doc_freq: int) -> float:
    return float(np.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5)))


def queries(lengths, num_docs, rng, n_queries, terms_per_q, vocab):
    """Zipf-drawn OR queries as PrunedIndex query dicts."""
    ranks = np.arange(1, vocab + 1)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    out = []
    for _ in range(n_queries):
        tids = rng.choice(vocab, size=terms_per_q, replace=False, p=probs)
        entries = [(idf(num_docs, int(lengths[t])), [int(t)]) for t in tids if lengths[t] > 0]
        out.append({"entries": entries, "require_all": False, "n_terms": 1})
    return out


def assert_topk_equal(got, want, k, ctx=""):
    """tests/test_maxscore.py's check: the same docs and scores modulo f32
    summation order; a doc may differ only at a score tie."""
    ps, pd = got[:2]
    fs, fd = want[:2]
    np.testing.assert_allclose(ps[:k], fs[:k], rtol=2e-4, atol=2e-5,
                               err_msg=f"scores diverge {ctx}")
    mism = pd[:k] != fd[:k]
    if mism.any():
        bad = np.abs(ps[:k][mism] - fs[:k][mism]) > 2e-4 * np.abs(fs[:k][mism]) + 2e-5
        assert not bad.any(), f"doc mismatch at non-tied scores {ctx}"


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in f32 units in the last place (same signs)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))
