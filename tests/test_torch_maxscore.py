"""MaxScore pruning: the port's PrunedIndex (core/maxscore.py) against the
reference's, on the CPU.

Each case of tests/test_maxscore.py runs on both packages with their
engagement thresholds lowered alike (the reference test's
``low_thresholds``), on the same postings and the same queries. Asserted:
equal ``shape_log`` (the same theta / essential / full dispatches and
shapes), per query the same docs, scores within 4 f32 ulps (the probe sums
its non-essential mass in run order; XLA may reduce in another), equal hit
counts and equal ``exact`` flags; and the reference test's own checks on
the port: pruned answers equal to the full dispatch's, pruned hits a lower
bound. Then ``probe_finish`` against the reference's and a numpy oracle, and
one served NRT_MAXSCORE=1 request through both packages' Handlers.
"""

import random

import jax
import numpy as np
import pytest
import torch
from google.protobuf import json_format

from nrtsearch_tpu.core import maxscore as ref_ms
from nrtsearch_tpu_torch.core import maxscore as ms
from torch_maxscore_data import assert_topk_equal, index_arrays, queries, ulps

ULPS = 4


@pytest.fixture()
def low_thresholds(monkeypatch):
    for mod in (ref_ms, ms):
        monkeypatch.setattr(mod, "PRUNE_MIN_WIDTH", 64)
        monkeypatch.setattr(mod, "THETA_BUDGET", 256)
        monkeypatch.setattr(mod, "WINDOW_MIN", 128)


def _indexes(**kw):
    d_ids, d_imp, offsets, lengths, n = index_arrays(**kw)
    ref = ref_ms.PrunedIndex(jax.device_put(d_ids), jax.device_put(d_imp), offsets, lengths, n)
    port = ms.PrunedIndex(torch.from_numpy(d_ids), torch.from_numpy(d_imp), offsets, lengths, n)
    return ref, port, lengths, n


def _both(ref, port, qs, k, **kw):
    """Both packages' pruned search and the port's full search; asserts
    the two pruned answers and shape logs agree. Returns (port pruned,
    port full)."""
    ref_log, port_log = {}, {}
    want = ref.search(qs, k, shape_log=ref_log, prune=True, **kw)
    got = port.search(qs, k, shape_log=port_log, prune=True, **kw)
    assert port_log == ref_log
    for qi, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"query {qi}")
        assert ulps(g[0], w[0]) <= ULPS, qi
        assert (g[2], g[3]) == (w[2], w[3]), qi
    return got, port.search(qs, k, prune=False, **kw)


def test_run_upper_bounds_equal_reference():
    ref, port, lengths, _ = _indexes(seed=3)
    np.testing.assert_array_equal(port.run_ub, ref.run_ub)
    imp = port.impacts.numpy()
    for t in range(0, len(lengths), 37):
        if lengths[t]:
            off = int(port.run_offsets[t])
            assert port.run_ub[t] >= imp[off : off + lengths[t]].max() - 1e-7


def test_pruned_matches_reference_and_full(low_thresholds):
    ref, port, lengths, n = _indexes()
    qs = queries(lengths, n, np.random.default_rng(7), 24, 5, len(lengths))
    pruned, full = _both(ref, port, qs, 10)
    for qi, (p, f) in enumerate(zip(pruned, full)):
        assert_topk_equal(p, f, 10, ctx=f"query {qi}")
        assert f[3] and p[2] <= f[2]
    assert sum(not p[3] for p in pruned) >= len(qs) // 3


@pytest.mark.parametrize("seed", range(4))
def test_pruned_many_seeds(low_thresholds, seed):
    ref, port, lengths, n = _indexes(num_docs=2500, vocab=400, seed=seed)
    qs = queries(lengths, n, np.random.default_rng(100 + seed), 12, 4, len(lengths))
    pruned, full = _both(ref, port, qs, 25)
    for qi, (p, f) in enumerate(zip(pruned, full)):
        assert_topk_equal(p, f, 25, ctx=f"seed {seed} query {qi}")


@pytest.mark.parametrize("column", ["filter", "additive"])
def test_pruned_with_columns(low_thresholds, column):
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
    ref_log, port_log = {}, {}
    want = ref.search(qs_ref, 10, shape_log=ref_log, prune=True)
    got = port.search(qs_port, 10, shape_log=port_log, prune=True)
    full = port.search(qs_port, 10, prune=False)
    assert port_log == ref_log
    for qi, (g, w, f) in enumerate(zip(got, want, full)):
        np.testing.assert_array_equal(g[1], w[1])
        assert ulps(g[0], w[0]) <= ULPS and (g[2], g[3]) == (w[2], w[3]), qi
        assert_topk_equal(g, f, 10, ctx=f"{column} query {qi}")
        if column == "filter":
            assert col[g[1][g[0] > -np.inf]].all()


def test_require_all_and_sort_take_full_path(low_thresholds):
    ref, port, lengths, n = _indexes(seed=17)
    qs = queries(lengths, n, np.random.default_rng(3), 4, 4, len(lengths))
    for q in qs:
        q["require_all"] = True
        q["n_terms"] = len(q["entries"])
    pruned, _full = _both(ref, port, qs, 10)
    assert all(p[3] for p in pruned)


def test_empty_and_single_term_queries(low_thresholds):
    ref, port, lengths, n = _indexes(seed=19)
    qs = [{"entries": [], "require_all": False, "n_terms": 0},
          {"entries": [(1.5, [int(np.argmax(lengths))])], "require_all": False,
           "n_terms": 1}]
    pruned, full = _both(ref, port, qs, 10)
    assert pruned[0][2] == 0 and (pruned[0][0] == -np.inf).all()
    assert_topk_equal(pruned[1], full[1], 10, "single-term")


def test_big_k_disables_pruning(low_thresholds):
    ref, port, lengths, n = _indexes(seed=23)
    qs = queries(lengths, n, np.random.default_rng(1), 4, 4, len(lengths))
    pruned, _full = _both(ref, port, qs, 2048)
    assert all(p[3] for p in pruned)


def test_escalation_on_window_overflow(low_thresholds, monkeypatch):
    """A 1-slot window: the certificate fails and queries escalate to the
    full dispatch, on both packages alike."""
    for mod in (ref_ms, ms):
        monkeypatch.setattr(mod, "WINDOW_MIN", 1)
        monkeypatch.setattr(mod, "WINDOW_K_MULT", 0)
    ref, port, lengths, n = _indexes(seed=29)
    qs = queries(lengths, n, np.random.default_rng(2), 12, 5, len(lengths))
    pruned, full = _both(ref, port, qs, 1)
    for qi, (p, f) in enumerate(zip(pruned, full)):
        assert_topk_equal(p, f, 1, ctx=f"overflow query {qi}")


@pytest.mark.parametrize("column", ["changed_in_place", "new_per_request"])
def test_additive_max_follows_each_column(low_thresholds, column):
    """Two requests in turn whose additive columns have different maxima
    (all 0, then 50 on one doc): the second's pruned answer equals the full
    dispatch's. The 50 sits on a doc whose only query term has the lowest
    bound, so a split that took the first column's max 0 would leave that
    term non-essential and miss the top doc. The reference caches the max
    per id(column) (maxscore.py:233-247); the port takes it per request."""
    _ref, port, lengths, n = _indexes(seed=13)
    qs = queries(lengths, n, np.random.default_rng(9), 16, 4, len(lengths))
    col = torch.zeros(n)
    first = port.search([dict(q, additive=col) for q in qs], 10, prune=True)
    q = qs[next(i for i, r in enumerate(first) if not r[3])]
    stats = port._term_stats(q["entries"])
    low = min(stats, key=lambda st: st[3])

    def docs_of(st):
        return {int(d) for r in st[1] for d in port.doc_ids[
            int(port.run_offsets[r]) : int(port.run_offsets[r]) + int(port.run_lengths[r])]}

    others = set().union(*(docs_of(st) for st in stats if st is not low))
    doc = min(docs_of(low) - others)
    if column == "changed_in_place":
        col[doc] = 50.0
    else:
        del col
        col = torch.zeros(n)
        col[doc] = 50.0
    req = [dict(q, additive=col)]
    got = port.search(req, 10, prune=True)[0]
    full = port.search(req, 10, prune=False)[0]
    assert got[1][0] == full[1][0] == doc
    assert_topk_equal(got, full, 10, ctx=column)


def _probe_inputs(seed: int):
    """Random doc-sorted runs and a window over them, some candidates and
    probe slots empty."""
    rng = np.random.default_rng(seed)
    B, M, TN, D = 3, 64, 4, 500
    runs = [np.sort(rng.choice(D, size=int(rng.integers(1, 120)), replace=False))
            for _ in range(B * TN)]
    lens = np.array([len(r) for r in runs], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    P = int(lens.sum()) + 64
    docs = np.zeros(P, np.int32)
    imps = np.zeros(P, np.float32)
    docs[: lens.sum()] = np.concatenate(runs)
    imps[: lens.sum()] = rng.uniform(0.05, 1.0, lens.sum()).astype(np.float32)
    cand = np.stack([rng.choice(D, size=M, replace=False) for _ in range(B)]).astype(np.int32)
    cs = rng.uniform(0.5, 3.0, (B, M)).astype(np.float32)
    cs[rng.random((B, M)) < 0.2] = -np.inf
    po, pl = offs.reshape(B, TN), lens.reshape(B, TN)
    pw = rng.uniform(0.5, 4.0, (B, TN)).astype(np.float32)
    pl[0, 3] = 0
    pw[1, 2] = 0.0
    return docs, imps, cand, cs, po, pl, pw


def _probe_oracle(docs, imps, cand, cs, po, pl, pw, k):
    """numpy: each candidate's mass added in run order t = 0, 1, ..., then
    the top k by (score desc, doc asc)."""
    B, M = cand.shape
    out_s = np.full((B, k), -np.inf, np.float32)
    out_d = np.zeros((B, k), np.int64)
    for b in range(B):
        final = []
        for m in range(M):
            if cs[b, m] == -np.inf:
                continue
            mass = np.float32(0.0)
            for t in range(po.shape[1]):
                run = docs[po[b, t] : po[b, t] + pl[b, t]]
                i = np.searchsorted(run, cand[b, m])
                if pw[b, t] != 0 and i < len(run) and run[i] == cand[b, m]:
                    mass = np.float32(mass + np.float32(pw[b, t] * imps[po[b, t] + i]))
            final.append((np.float32(cs[b, m] + mass), int(cand[b, m])))
        final.sort(key=lambda x: (-x[0], x[1]))
        for j, (s, d) in enumerate(final[:k]):
            out_s[b, j], out_d[b, j] = s, d
    return out_s, out_d


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_finish_matches_reference_and_oracle(seed):
    docs, imps, cand, cs, po, pl, pw = _probe_inputs(seed)
    k, steps = 16, 8
    args = (docs, imps, cand, cs, po, pl, pw)
    got = ms.probe_finish(*(torch.from_numpy(a) for a in args), k=k, steps=steps)
    want = ref_ms.probe_finish(*(jax.device_put(a) for a in args), k=k, steps=steps)
    gs, gd = got[0].numpy(), got[1].numpy()
    ws, wd = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(gd, wd)
    assert ulps(gs, ws) <= ULPS
    os_, od = _probe_oracle(*args, k)
    np.testing.assert_array_equal(gs.view(np.int32), os_.view(np.int32))
    valid = os_ > -np.inf
    np.testing.assert_array_equal(gd[valid], od[valid])


# ---------------------------------------------------------------------------
# served: NRT_MAXSCORE=1 through both packages' Handlers
# ---------------------------------------------------------------------------


def _served_node(root, port: bool):
    from nrtsearch_tpu.gen import pb

    if port:
        from nrtsearch_tpu_torch.config import NrtsearchConfig
        from nrtsearch_tpu_torch.server.handlers import Handlers
        from nrtsearch_tpu_torch.state.backend import LocalStateBackend
        from nrtsearch_tpu_torch.state.global_state import GlobalState

        cfg = NrtsearchConfig.from_dict({"stateDir": str(root / "state"),
                                         "indexDir": str(root / "index")})
        h = Handlers(GlobalState(cfg, LocalStateBackend(cfg.state_dir), device="cpu"))
    else:
        from nrtsearch_tpu.config import NrtsearchConfig
        from nrtsearch_tpu.server.handlers import Handlers
        from nrtsearch_tpu.state.backend import LocalStateBackend
        from nrtsearch_tpu.state.global_state import GlobalState

        cfg = NrtsearchConfig.from_dict({"stateDir": str(root / "state"),
                                         "indexDir": str(root / "index")})
        h = Handlers(GlobalState(cfg, LocalStateBackend(cfg.state_dir)))
    h.createIndex(pb.CreateIndexRequest(indexName="idx"))
    h.registerFields(json_format.ParseDict({"indexName": "idx", "field": [
        {"name": "id", "type": "_ID", "store": True},
        {"name": "body", "type": "TEXT", "search": True}]}, pb.FieldDefRequest()))
    h.startIndex(pb.StartIndexRequest(indexName="idx"))
    rng = random.Random(31)
    words = [f"w{i}" for i in range(40)]
    weights = [1.0 / (i + 1) for i in range(40)]
    reqs = []
    for i in range(1500):
        r = pb.AddDocumentRequest(indexName="idx")
        r.fields["id"].value.append(str(i))
        r.fields["body"].value.append(" ".join(rng.choices(words, weights, k=12)))
        reqs.append(r)
    h.addDocuments(iter(reqs))
    h.refresh(pb.RefreshRequest(indexName="idx"))
    return h


def test_served_maxscore_matches_reference(tmp_path, low_thresholds, monkeypatch):
    """NRT_MAXSCORE=1 on both nodes: the same hits, scores, totalHits and
    relation; GREATER_THAN_OR_EQUAL_TO exactly where the query pruned, and
    the same hits as without pruning (a lower hit count where pruned)."""
    from nrtsearch_tpu.gen import pb

    # a window wider than the index: every split query certifies
    for mod in (ref_ms, ms):
        monkeypatch.setattr(mod, "WINDOW_MIN", 2048)
    ref = _served_node(tmp_path / "ref", False)
    port = _served_node(tmp_path / "port", True)
    texts = ["w0 w1 w30", "w2 w25 w39", "w0 w5 w9 w33", "w1 w3", "w12 w35 w0 w7"]

    def answer(h, text):
        resp = h.search(json_format.ParseDict({
            "indexName": "idx", "topHits": 10, "retrieveFields": ["id"],
            "query": {"matchQuery": {"field": "body", "query": text}}}, pb.SearchRequest()))
        return (resp.totalHits.value, resp.totalHits.relation,
                [(h_.fields["id"].fieldValue[0].textValue, h_.score) for h_ in resp.hits])

    monkeypatch.setenv("NRT_FAST_PATH", "merge")
    exact = {t: answer(port, t) for t in texts}
    monkeypatch.setenv("NRT_MAXSCORE", "1")
    relations = []
    for t in texts:
        got = answer(port, t)
        want = answer(ref, t)
        assert got[0] == want[0] and got[1] == want[1], t
        assert [d for d, _ in got[2]] == [d for d, _ in want[2]], t
        assert [s for _, s in got[2]] == pytest.approx([s for _, s in want[2]], rel=4 * 2**-23)
        assert [d for d, _ in got[2]] == [d for d, _ in exact[t][2]], t
        if got[1] == pb.TotalHits.Relation.GREATER_THAN_OR_EQUAL_TO:
            assert got[0] <= exact[t][0]
        else:
            assert got[0] == exact[t][0]
        relations.append(got[1])
    assert pb.TotalHits.Relation.GREATER_THAN_OR_EQUAL_TO in relations
    for h in (ref, port):
        h.gs.runtimes["idx"].stop()
