"""The general evaluator (ROADMAP item 8) on the port vs the JAX reference,
on the CPU.

The query surface of tests/test_compiled_eval.py (its fields with a LAT_LON
``loc``, its six documents in two segments) is built and committed by the
reference's IndexWriter and opened by the port (``core.directory.
open_commit``); both packages' ``Searcher.search`` answer each query from
one dict spec, with the general evaluator pinned (the filtered-text
pushdown off on both sides, as the reference's own test pins it) and with
it free, through the compiled program (NRT_COMPILED_EVAL=1, the default)
and the eager evaluator (=0).

Contract: the same hit ids in the same order, the same ``total_hits`` and
relation, and bit-equal scores and sort keys. That holds for every query
here, also where a transcendental function is in the score (the function
score's ``log``, the geo radius's haversine: their f32 results agree on
these inputs), the phrase query's included. The sort-and-filter, return-arrays, count-and-masks and
after-delete cases of tests/test_compiled_eval.py:151-207 are mirrored; for
the delete the port opens a commit the reference wrote with deletes.
"""

import numpy as np
import pytest

from nrtsearch_tpu.core.directory import commit_segments
from nrtsearch_tpu.core.searcher import Searcher as RefSearcher, SortSpec as RefSortSpec
from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu_torch.core.directory import open_commit
from nrtsearch_tpu_torch.core.searcher import Searcher, SortSpec
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def
from tests.test_compiled_eval import DOCS, FIELDS as REF_FIELDS, QUERIES

SPECS = {name: fd.raw for name, fd in REF_FIELDS.items()}
PORT_FIELDS = {name: create_field_def(name, spec) for name, spec in SPECS.items()}


def _name(q: dict) -> str:
    return next(iter(q))


QUERY_IDS = [f"{i}-{_name(q)}" for i, q in enumerate(QUERIES)]


@pytest.fixture(scope="module")
def searchers(tmp_path_factory):
    """(reference, port) searchers over the same two committed segments."""
    w = RefWriter(REF_FIELDS, merge_factor=100)
    w.add_documents(DOCS[:3])
    w.refresh()
    w.add_documents(DOCS[3:])
    segs = w.refresh()
    assert len(segs) == 2
    path = tmp_path_factory.mktemp("general")
    commit_segments(segs, path, gen=1, version=1)
    _m, port_segs = open_commit(path, "cpu")
    return RefSearcher(segs, REF_FIELDS, version=1), Searcher(port_segs, PORT_FIELDS)


def _pin(monkeypatch, compiled: bool, pinned: bool):
    monkeypatch.setenv("NRT_COMPILED_EVAL", "1" if compiled else "0")
    if pinned:
        monkeypatch.setattr(RefSearcher, "_fast_filtered_text", lambda *a, **k: None)
        monkeypatch.setattr(Searcher, "_fast_filtered_text", lambda *a, **k: None)


def _keys(td):
    return [h.sort_key for h in td.hits]


def assert_same(want, got, ctx=""):
    """Hits, order, totals, relation, scores (bit-equal) and sort keys."""
    assert [h.global_ord for h in got.hits] == [h.global_ord for h in want.hits], ctx
    assert (got.total_hits, got.relation) == (want.total_hits, want.relation), ctx
    np.testing.assert_array_equal(np.array([h.score for h in got.hits], np.float32),
                                  np.array([h.score for h in want.hits], np.float32),
                                  err_msg=ctx)
    assert _keys(got) == _keys(want), ctx


@pytest.mark.parametrize("pinned", [True, False], ids=["general", "free"])
@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
@pytest.mark.parametrize("qi", range(len(QUERIES)), ids=QUERY_IDS)
def test_query_matches_reference(searchers, monkeypatch, qi, compiled, pinned):
    ref, port = searchers
    qjson = QUERIES[qi]
    _pin(monkeypatch, compiled, pinned)
    want = ref.search(ref_parse_query(qjson), top_hits=10)
    got = port.search(parse_query(qjson), top_hits=10)
    assert_same(want, got, _name(qjson))


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
def test_sort_and_filter(searchers, monkeypatch, compiled):
    ref, port = searchers
    _pin(monkeypatch, compiled, True)
    q = {"matchQuery": {"field": "body", "query": "quick brown fast"}}
    f = {"rangeQuery": {"field": "price", "upper": "45"}}
    want = ref.search(ref_parse_query(q), top_hits=10, sort=RefSortSpec("price", reverse=True),
                      extra_filter=ref_parse_query(f))
    got = port.search(parse_query(q), top_hits=10, sort=SortSpec("price", reverse=True),
                      extra_filter=parse_query(f))
    assert want.total_hits > 0
    assert_same(want, got)


@pytest.mark.parametrize("score_free", [False, True], ids=["scores", "score_free"])
@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
def test_return_arrays(searchers, monkeypatch, compiled, score_free):
    ref, port = searchers
    _pin(monkeypatch, compiled, not score_free)
    q = {"matchQuery": {"field": "body", "query": "quick"}}
    want_td, want_arr = ref.search(ref_parse_query(q), top_hits=10, return_arrays=True,
                                   arrays_score_free=score_free)
    got_td, got_arr = port.search(parse_query(q), top_hits=10, return_arrays=True,
                                  arrays_score_free=score_free)
    assert_same(want_td, got_td)
    assert len(got_arr) == len(want_arr) == 2
    for (gs, gm), (ws, wm) in zip(got_arr, want_arr):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        if score_free:
            assert gs is None and ws is None
        else:
            np.testing.assert_array_equal(np.where(gm.numpy(), gs.numpy(), 0.0),
                                          np.where(np.asarray(wm), np.asarray(ws), 0.0))


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
def test_count_and_masks(searchers, monkeypatch, compiled):
    ref, port = searchers
    _pin(monkeypatch, compiled, False)
    for q in ({"termInSetQuery": {"field": "tag", "textTerms": {"terms": ["animal", "tech"]}}},
              {"geoRadiusQuery": {"field": "loc", "center": {"latitude": 37.7,
                                                             "longitude": -122.4},
                                  "radius": "100 km"}},
              {"prefixQuery": {"field": "body", "prefix": "qu"}}):
        assert port.count(parse_query(q)) == ref.count(ref_parse_query(q)) > 0
        for g, w in zip(port.match_masks(parse_query(q)), ref.match_masks(ref_parse_query(q))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_after_delete(tmp_path, monkeypatch):
    """A commit the reference wrote after a delete: the port answers as the
    reference does, through both evaluators."""
    w = RefWriter(REF_FIELDS, merge_factor=100)
    w.add_documents(DOCS)
    w.refresh()
    w.delete_by_id(["1"])
    segs = w.refresh()
    assert sum(s.del_count for s in segs) == 1
    commit_segments(segs, tmp_path, gen=1, version=2)
    _m, port_segs = open_commit(tmp_path, "cpu")
    ref, port = RefSearcher(segs, REF_FIELDS, version=2), Searcher(port_segs, PORT_FIELDS)
    q = {"matchQuery": {"field": "body", "query": "quick"}}
    for compiled in (True, False):
        _pin(monkeypatch, compiled, True)
        want = ref.search(ref_parse_query(q), top_hits=10)
        assert_same(want, port.search(parse_query(q), top_hits=10))
        assert 0 not in [h.global_ord for h in want.hits]


def test_port_writer_builds_the_same_answers():
    """The port's own IndexWriter (LAT_LON included) over the same
    documents: the same answers as the committed copy, the phrase query's
    included."""
    w = IndexWriter(PORT_FIELDS, "cpu", merge_factor=100)
    w.add_documents([dict(d) for d in DOCS[:3]])
    w.refresh()
    w.add_documents([dict(d) for d in DOCS[3:]])
    own = Searcher(w.refresh(), PORT_FIELDS)
    ref_w = RefWriter(REF_FIELDS, merge_factor=100)
    ref_w.add_documents(DOCS[:3])
    ref_w.refresh()
    ref_w.add_documents(DOCS[3:])
    ref = RefSearcher(ref_w.refresh(), REF_FIELDS)
    for qjson in QUERIES:
        assert_same(ref.search(ref_parse_query(qjson), top_hits=10),
                    own.search(parse_query(qjson), top_hits=10), _name(qjson))


def test_geo_leaves_match_reference_masks():
    """ops.masks' geo functions against the reference's on seeded points:
    bbox and rings exact; the haversine within 4 f32 ulps (sin, cos, asin
    and sqrt are torch's, not XLA's), and the radius mask equal but for
    points within 1e-6 of the radius."""
    import jax.numpy as jnp
    import torch

    from nrtsearch_tpu.ops import masks as ref_m
    from nrtsearch_tpu_torch.ops import masks as port_m

    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(37.0, 38.5, 4096), rng.uniform(-123.0, -121.5, 4096)],
                   axis=1).astype(np.float32)
    present = rng.random(4096) < 0.95
    rp, pp = (jnp.asarray(pts), jnp.asarray(present)), (torch.from_numpy(pts),
                                                        torch.from_numpy(present))
    np.testing.assert_array_equal(
        port_m.geo_bounding_box_mask(*pp, 37.3, 38.1, -122.8, -121.9).numpy(),
        np.asarray(ref_m.geo_bounding_box_mask(*rp, 37.3, 38.1, -122.8, -121.9)))
    rings = np.array([[37.2, -122.9], [38.3, -122.7], [37.9, -121.6], [37.2, -122.9],
                      [np.nan, np.nan], [37.6, -122.5], [37.8, -122.4], [37.6, -122.3],
                      [37.6, -122.5], [np.nan, np.nan]], np.float32)
    np.testing.assert_array_equal(
        port_m.point_in_rings_mask(*pp, torch.from_numpy(rings)).numpy(),
        np.asarray(ref_m.point_in_rings_mask(*rp, jnp.asarray(rings))))
    np.testing.assert_array_equal(
        port_m.point_in_polygon_mask(*pp, torch.from_numpy(rings[:4])).numpy(),
        np.asarray(ref_m.point_in_polygon_mask(*rp, jnp.asarray(rings[:4]))))
    got = port_m.haversine_meters(pp[0], 37.75, -122.4).numpy()
    want = np.asarray(ref_m.haversine_meters(rp[0], 37.75, -122.4))
    np.testing.assert_allclose(got, want, rtol=4 * 2.0**-23, atol=0)
    radius = 40_000.0
    flips = port_m.geo_radius_mask(*pp, 37.75, -122.4, radius).numpy() != np.asarray(
        ref_m.geo_radius_mask(*rp, 37.75, -122.4, radius))
    assert np.all(np.abs(want[flips] - radius) <= 1e-6 * radius)


@pytest.mark.parametrize("need_counts", [True, False])
def test_text_ops_match_reference(need_counts):
    """ops.bm25's score_text_clause (one scatter per term, the FMA in f64)
    and term_match_mask against the reference's, on seeded postings with
    docs shared across terms and an absent term: bit-equal."""
    import jax.numpy as jnp
    import torch

    from nrtsearch_tpu.ops import bm25 as ref_bm25
    from nrtsearch_tpu_torch.ops import bm25 as port_bm25

    rng = np.random.default_rng(11)
    D, Q = 4096, 9
    runs = [np.sort(rng.choice(D, int(rng.integers(1, 900)), replace=False)) for _ in range(Q)]
    runs[4] = runs[4][:0]
    lens = np.array([len(r) for r in runs], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    docs = np.zeros(int(lens.sum()) + 128, np.int32)
    docs[: lens.sum()] = np.concatenate(runs)
    freqs = rng.integers(1, 9, len(docs)).astype(np.float32)
    dl = rng.integers(1, 60, D).astype(np.float32)
    w = rng.uniform(0.2, 6.0, Q).astype(np.float32)
    k1, b, avgdl = 1.2, 0.75, float(np.float32(23.7))
    want_s, want_c = ref_bm25.score_text_clause(
        jnp.asarray(docs), jnp.asarray(freqs), jnp.asarray(dl), jnp.asarray(offs)[None],
        jnp.asarray(lens)[None], jnp.asarray(w)[None], jnp.float32(k1), jnp.float32(b),
        jnp.float32(avgdl), cap=1 << 13, num_docs=D, need_counts=need_counts)
    got_s, got_c = port_bm25.score_text_clause(
        torch.from_numpy(docs), torch.from_numpy(freqs), torch.from_numpy(dl), offs, lens, w,
        k1, b, avgdl, num_docs=D, need_counts=need_counts)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s[0]).view(np.int32))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c[0]))
    for t in (0, 4, 8):
        want = ref_bm25.term_match_mask(jnp.asarray(docs), jnp.asarray(offs[t:t + 1]),
                                        jnp.asarray(lens[t:t + 1]), cap=1024, num_docs=D)
        got = port_bm25.term_match_mask(torch.from_numpy(docs), int(offs[t]), int(lens[t]), D)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))
