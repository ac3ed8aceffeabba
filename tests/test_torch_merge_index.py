"""The merge path's index: the port's PrunedIndex (core/maxscore.py), whose
``search`` is the full merge, against the reference's
``search(..., prune=False)`` and a numpy oracle, on the CPU.

Each case of tests/test_maxscore.py that still applies runs on both
packages, on the same postings and the same queries. Asserted: equal
``shape_log`` (the same full dispatches and shapes), per query the same
docs, the same scores bit for bit and equal hit counts; and against the
oracle, which scores every doc in f64 from the same impacts, equal hit
counts and the same docs and scores modulo f32 summation order.
"""

import jax
import numpy as np
import pytest
import torch

from nrtsearch_tpu.core import maxscore as ref_ms
from nrtsearch_tpu_torch.core import maxscore as ms
from torch_maxscore_data import assert_topk_equal, index_arrays, queries, ulps


def _indexes(**kw):
    d_ids, d_imp, offsets, lengths, n = index_arrays(**kw)
    ref = ref_ms.PrunedIndex(jax.device_put(d_ids), jax.device_put(d_imp), offsets, lengths, n)
    port = ms.PrunedIndex(torch.from_numpy(d_ids), torch.from_numpy(d_imp), offsets, lengths, n)
    return ref, port, lengths, n


def _both(ref, port, qs, k, ref_qs=None):
    """Both packages' full search; asserts the two answers and shape logs
    agree. Returns the port's answers."""
    ref_log, port_log = {}, {}
    want = ref.search(qs if ref_qs is None else ref_qs, k, shape_log=ref_log, prune=False)
    got = port.search(qs, k, shape_log=port_log)
    assert port_log == ref_log
    for qi, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"query {qi}")
        assert ulps(g[0], w[0]) == 0, qi
        assert g[2] == w[2] and w[3], qi
    return got


def _oracle(port, q, k):
    """numpy: every doc's score in f64 from the index's impacts, the
    query's match rule and columns, then the top k by (score desc, doc
    asc), or by (key, doc asc) under a sort. Returns (scores, docs, hits)."""
    n = port.max_doc
    docs_all, imps = port.doc_ids.numpy(), port.impacts.numpy()
    score = np.zeros(n, np.float64)
    count = np.zeros(n, np.int64)
    for w, runs in q["entries"]:
        for r in runs:
            o, ln = int(port.run_offsets[r]), int(port.run_lengths[r])
            d = docs_all[o : o + ln]
            np.add.at(score, d, np.float64(w) * imps[o : o + ln])
            np.add.at(count, d, 1)
    need = q["n_terms"] if q["require_all"] else 1
    ok = (count >= max(need, 1)) & (score > 0)
    if q.get("filter") is not None:
        ok &= q["filter"].numpy()
    if q.get("additive") is not None:
        score = score + q["additive"].numpy()
    key = score
    if q.get("sort") is not None:
        keys, ascending = q["sort"]
        key = -keys.numpy().astype(np.float64) if ascending else keys.numpy().astype(np.float64)
    idx = np.nonzero(ok)[0]
    order = idx[np.lexsort((idx, -key[idx]))][:k]
    out_s = np.full(k, -np.inf, np.float32)
    out_d = np.zeros(k, np.int64)
    shown = -key if q.get("sort") is not None and q["sort"][1] else key
    out_s[: len(order)] = shown[order]
    out_d[: len(order)] = order
    return out_s, out_d, int(ok.sum())


def _check_oracle(port, qs, got, k, ctx=""):
    for qi, (q, g) in enumerate(zip(qs, got)):
        want = _oracle(port, q, k)
        assert g[2] == want[2], f"{ctx} query {qi}"
        filled = np.isfinite(want[0])
        np.testing.assert_array_equal(np.isfinite(g[0]), filled, err_msg=f"{ctx} query {qi}")
        assert_topk_equal(g, want, int(filled.sum()), ctx=f"{ctx} query {qi}")


def test_run_upper_bounds_equal_reference():
    ref, port, lengths, _ = _indexes(seed=3)
    np.testing.assert_array_equal(port.run_ub, ref.run_ub)
    imp = port.impacts.numpy()
    for t in range(0, len(lengths), 37):
        if lengths[t]:
            off = int(port.run_offsets[t])
            assert port.run_ub[t] >= imp[off : off + lengths[t]].max() - 1e-7


def test_matches_reference():
    ref, port, lengths, n = _indexes()
    qs = queries(lengths, n, np.random.default_rng(7), 24, 5, len(lengths))
    got = _both(ref, port, qs, 10)
    _check_oracle(port, qs, got, 10)
    assert all(g[2] > 0 for g in got)


@pytest.mark.parametrize("seed", range(4))
def test_many_seeds(seed):
    ref, port, lengths, n = _indexes(num_docs=2500, vocab=400, seed=seed)
    qs = queries(lengths, n, np.random.default_rng(100 + seed), 12, 4, len(lengths))
    got = _both(ref, port, qs, 25)
    _check_oracle(port, qs, got, 25, ctx=f"seed {seed}")


@pytest.mark.parametrize("column", ["filter", "additive"])
def test_with_columns(column):
    seed, qseed, terms = (11, 5, 5) if column == "filter" else (13, 9, 4)
    ref, port, lengths, n = _indexes(seed=seed)
    rng = np.random.default_rng(qseed)
    if column == "filter":
        col = rng.random(n) < 0.3
    else:
        col = (rng.random(n) * 2.0).astype(np.float32)
    qs_port = queries(lengths, n, rng, 16, terms, len(lengths))
    qs_ref = [dict(q) for q in qs_port]
    port_col, ref_col = torch.from_numpy(col), jax.device_put(col)
    for qp_, qr in zip(qs_port, qs_ref):
        qp_[column] = port_col
        qr[column] = ref_col
    got = _both(ref, port, qs_port, 10, ref_qs=qs_ref)
    _check_oracle(port, qs_port, got, 10, ctx=column)
    for g in got:
        if column == "filter":
            assert col[g[1][g[0] > -np.inf]].all()


@pytest.mark.parametrize("ascending", [False, True])
def test_require_all_and_sort(ascending):
    """Conjunctions, then the same queries ranked by a sort key: docs in
    (key, doc) order, keys returned as the scores."""
    ref, port, lengths, n = _indexes(seed=17)
    qs = queries(lengths, n, np.random.default_rng(3), 4, 4, len(lengths))
    for q in qs:
        q["require_all"] = True
        q["n_terms"] = len(q["entries"])
    _check_oracle(port, qs, _both(ref, port, qs, 10), 10, ctx="require_all")
    keys = np.random.default_rng(5).integers(0, 40, n).astype(np.float32)
    qs_port = [dict(q, require_all=False, n_terms=1, sort=(torch.from_numpy(keys), ascending))
               for q in qs]
    qs_ref = [dict(q, sort=(jax.device_put(keys), ascending)) for q in qs_port]
    got = _both(ref, port, qs_port, 10, ref_qs=qs_ref)
    for qi, (q, g) in enumerate(zip(qs_port, got)):
        ws, wd, wh = _oracle(port, q, 10)
        np.testing.assert_array_equal(g[0], ws, err_msg=str(qi))
        np.testing.assert_array_equal(g[1], wd, err_msg=str(qi))
        assert g[2] == wh > 10, qi


def test_empty_and_single_term_queries():
    ref, port, lengths, n = _indexes(seed=19)
    qs = [{"entries": [], "require_all": False, "n_terms": 0},
          {"entries": [(1.5, [int(np.argmax(lengths))])], "require_all": False,
           "n_terms": 1}]
    got = _both(ref, port, qs, 10)
    assert got[0][2] == 0 and (got[0][0] == -np.inf).all()
    _check_oracle(port, qs[1:], got[1:], 10, ctx="single-term")


def test_big_k():
    ref, port, lengths, n = _indexes(seed=23)
    qs = queries(lengths, n, np.random.default_rng(1), 4, 4, len(lengths))
    got = _both(ref, port, qs, 2048)
    _check_oracle(port, qs, got, 2048, ctx="k 2048")


@pytest.mark.parametrize("column", ["changed_in_place", "new_per_request"])
def test_additive_max_follows_each_column(column):
    """Two requests in turn with the same query: an all-zero additive
    column, then a column of 50 on the query's lowest-scoring matched doc,
    changed in place or a new tensor. The second answer's top doc is that
    doc: each request's dispatch reads its own column."""
    _ref, port, lengths, n = _indexes(seed=13)
    q = queries(lengths, n, np.random.default_rng(9), 1, 4, len(lengths))[0]
    col = torch.zeros(n)
    first = port.search([dict(q, additive=col)], 10)[0]
    score = np.zeros(n)
    for w, runs in q["entries"]:
        for r in runs:
            o, ln = int(port.run_offsets[r]), int(port.run_lengths[r])
            np.add.at(score, port.doc_ids[o : o + ln].numpy(), w * port.impacts[o : o + ln].numpy())
    matched = np.nonzero(score > 0)[0]
    doc = int(matched[np.argmin(score[matched])])
    assert doc not in first[1].tolist()
    if column == "changed_in_place":
        col[doc] = 50.0
    else:
        del col
        col = torch.zeros(n)
        col[doc] = 50.0
    req = [dict(q, additive=col)]
    got = port.search(req, 10)[0]
    assert got[1][0] == doc
    _check_oracle(port, req, [got], 10, ctx=column)
