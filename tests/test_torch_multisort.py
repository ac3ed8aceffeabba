"""Multi-component, docid, score, f64 and VIRTUAL sorts, terminate_after and
timeout_sec on the port vs the JAX reference, on the CPU.

The documents and sort cases of tests/test_multi_sort.py (ties on ``grp``,
a missing ``price``, "docid" and "score" components, missing_last before
reverse) and the terminateAfter cases of tests/test_profile_terminate.py
(three segments, deletes) are built and committed by the reference and
opened by the port. Hits, order, totals, relation, scores and sort values
are equal.

One divergence is on purpose: the reference's sort-key cache keys a sort
by its first component only (nrtsearch_tpu/core/searcher.py:520), so after
a single sort on ``ts`` a ``ts``-then-``price`` sort gets ``ts``'s keys and
ranks by ``ts`` alone. The port ranks by both components (ROADMAP §3).
"""

import pytest

from nrtsearch_tpu.core.directory import commit_segments
from nrtsearch_tpu.core.searcher import (
    Searcher as RefSearcher, SortComponent as RefC, SortSpec as RefS)
from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu.schema.fields import create_field_def as ref_create
from nrtsearch_tpu_torch.core.directory import open_commit
from nrtsearch_tpu_torch.core.searcher import Searcher, SortComponent, SortSpec
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def
from tests.test_multi_sort import DOCS

SPECS = {
    "doc_id": {"type": "_ID", "storeDocValues": True},
    "body": {"type": "TEXT", "search": True},
    "grp": {"type": "INT", "storeDocValues": True},
    "price": {"type": "FLOAT", "storeDocValues": True},
    "rank": {"type": "INT", "storeDocValues": True},
    # exact only as f64: the host sort
    "big": {"type": "LONG", "storeDocValues": True},
    "ts": {"type": "FLOAT", "storeDocValues": True},
    "twice": {"type": "VIRTUAL", "script": {"source": "rank * 2 - grp"}},
}
QUERY = {"matchQuery": {"field": "body", "query": "alpha"}}


def _docs():
    out = []
    for i, d in enumerate(DOCS):
        d = dict(d)
        d["big"] = str((1 << 53) - 7 * (i % 3))
        d["ts"] = str(float(i // 3))          # ties: 0, 0, 0, 1, 1, 1, 2
        out.append(d)
    return out


def _pair(tmp_path_factory, splits, deletes=()):
    ref_fds = {n: ref_create(n, s) for n, s in SPECS.items()}
    w = RefWriter(ref_fds, merge_factor=100)
    docs = _docs()
    lo = 0
    for hi in (*splits, len(docs)):
        w.add_documents(docs[lo:hi])
        w.refresh()
        lo = hi
    if deletes:
        w.delete_by_id(list(deletes))
    segs = w.refresh()
    path = tmp_path_factory.mktemp("multisort")
    commit_segments(segs, path, gen=1, version=1)
    _m, port_segs = open_commit(path, "cpu")
    port_fds = {n: create_field_def(n, s) for n, s in SPECS.items()}
    return RefSearcher(segs, ref_fds, version=1), Searcher(port_segs, port_fds)


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return _pair(tmp_path_factory, ())


@pytest.fixture(scope="module")
def many(tmp_path_factory):
    return _pair(tmp_path_factory, (3, 5), deletes=("5",))


def _spec(S, C, comps):
    cs = [C(*c) for c in comps]
    return S(cs[0].field, cs[0].reverse, cs[0].missing_last, rest=tuple(cs[1:]))


def _values(td):
    return [h.sort_key if isinstance(h.sort_key, tuple) else (h.sort_key,) for h in td.hits]


def assert_same(want, got, ctx=""):
    assert [h.global_ord for h in got.hits] == [h.global_ord for h in want.hits], ctx
    assert (got.total_hits, got.relation, got.terminated_early, got.hit_timeout) == (
        want.total_hits, want.relation, want.terminated_early, want.hit_timeout), ctx
    assert [h.score for h in got.hits] == [h.score for h in want.hits], ctx
    assert _values(got) == _values(want), ctx


SORTS = {
    "two_asc_asc": [("grp", False, False), ("price", False, False)],
    "primary_desc_secondary_asc": [("grp", True, False), ("rank", False, False)],
    "missing_last_secondary": [("grp", False, False), ("price", False, True)],
    "missing_last_before_reverse": [("price", True, True), ("docid", False, False)],
    "three_keys": [("grp", False, False), ("price", True, False), ("rank", False, False)],
    "docid_component": [("grp", False, False), ("docid", False, False)],
    "docid_desc": [("docid", True, False)],
    "score_then_grp": [("grp", False, False), ("score", False, False)],
    "score_primary": [("score", False, False), ("docid", False, False)],
    "f64_single": [("big", False, False)],
    "f64_desc_then_rank": [("big", True, False), ("rank", True, False)],
    "virtual_single": [("twice", False, False)],
    "virtual_then_docid": [("twice", True, False), ("docid", False, False)],
}


@pytest.mark.parametrize("index", ["one", "many"])
@pytest.mark.parametrize("name", sorted(SORTS))
def test_sort_matches_reference(request, index, name):
    ref, port = request.getfixturevalue(index)
    comps = SORTS[name]
    want = ref.search(ref_parse_query(QUERY), 10, sort=_spec(RefS, RefC, comps))
    got = port.search(parse_query(QUERY), 10, sort=_spec(SortSpec, SortComponent, comps))
    assert want.total_hits > 0
    assert_same(want, got, name)


def test_multi_sort_ranks_by_every_component_after_a_cached_single_sort(one):
    """A single sort on ``ts`` (it fills the sort-key cache), then a
    ``ts``-then-``price`` sort on data with ``ts`` ties: the port ranks by
    both components; the reference returns the first component's cached
    keys and ranks by ``ts`` alone (nrtsearch_tpu/core/searcher.py:520).
    The two agree on everything else."""
    ref, port = one
    ref.search(ref_parse_query(QUERY), 10, sort=RefS("ts"))
    port.search(parse_query(QUERY), 10, sort=SortSpec("ts"))
    comps = [("ts", False, False), ("price", False, False)]
    want = ref.search(ref_parse_query(QUERY), 10, sort=_spec(RefS, RefC, comps))
    got = port.search(parse_query(QUERY), 10, sort=_spec(SortSpec, SortComponent, comps))
    docs = _docs()
    ts = [float(d["ts"]) for d in docs]
    price = [float(d.get("price", "-inf")) for d in docs]
    both = sorted(range(len(docs)), key=lambda i: (ts[i], price[i], i))
    ts_only = sorted(range(len(docs)), key=lambda i: (ts[i], i))
    assert both != ts_only
    assert [h.global_ord for h in got.hits] == both
    assert [v[:2] for v in _values(got)] == [(ts[i], price[i]) for i in both]
    assert [h.global_ord for h in want.hits] == ts_only
    assert [v for v in _values(want)] == [(ts[i],) for i in ts_only]
    assert (got.total_hits, got.relation) == (want.total_hits, want.relation)
    # a fresh reference snapshot (empty cache) ranks by both, as the port
    fresh = RefSearcher(ref.segments, ref.field_defs)
    assert_same(fresh.search(ref_parse_query(QUERY), 10, sort=_spec(RefS, RefC, comps)), got)


@pytest.mark.parametrize("compiled", ["1", "0"])
@pytest.mark.parametrize("terminate_after", [1, 2, 4, 6, 50])
def test_terminate_after_matches_reference(many, monkeypatch, compiled, terminate_after):
    """terminate_after within a segment and across segments (the reference's
    TerminateAfterWrapper cases, tests/test_profile_terminate.py:100-128)."""
    ref, port = many
    monkeypatch.setenv("NRT_COMPILED_EVAL", compiled)
    for sort in (None, ("rank", True), ("big", False)):
        kw_r = {} if sort is None else {"sort": RefS(*sort)}
        kw_p = {} if sort is None else {"sort": SortSpec(*sort)}
        want = ref.search(ref_parse_query(QUERY), 5, terminate_after=terminate_after, **kw_r)
        got = port.search(parse_query(QUERY), 5, terminate_after=terminate_after, **kw_p)
        assert_same(want, got, (terminate_after, sort))
        # 6 live matches: a budget of 6 or less ends the collection early
        assert got.terminated_early == (terminate_after <= 6)


@pytest.mark.parametrize("timeout_sec", [1e-9, 1e6])
@pytest.mark.parametrize("query", ["fast", "general"])
def test_timeout_matches_reference(many, timeout_sec, query):
    """A deadline that passes at once cuts both packages at the same place
    (after the first docid chunk that holds postings on the fast path,
    after the first segment on the general path); one that never passes
    answers in full."""
    ref, port = many
    q = QUERY if query == "fast" else {"booleanQuery": {"clauses": [
        {"occur": "SHOULD", "query": QUERY},
        {"occur": "SHOULD", "query": {"rangeQuery": {"field": "rank", "lower": "3"}}}]}}
    want = ref.search(ref_parse_query(q), 10, timeout_sec=timeout_sec)
    got = port.search(parse_query(q), 10, timeout_sec=timeout_sec)
    assert_same(want, got, (query, timeout_sec))
    assert got.hit_timeout == (timeout_sec < 1)
    assert (got.relation == "GREATER_THAN_OR_EQUAL_TO") == got.hit_timeout
