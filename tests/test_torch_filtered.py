"""BASELINE config #3 on the port vs the JAX reference, on the CPU: the
filtered, sorted and faceted search forms.

One 3-segment index with deletes is built and committed by the reference's
IndexWriter; the port opens the same directory (``core.directory.
open_commit``). Both packages' ``Searcher`` run the config-#3 query shape of
benchmarks/stress_deep_boolean.py (MUST match, FILTER range + termInSet,
MUST_NOT term, MUST boolean of SHOULD ranges and terms) from one dict spec.

Tolerances: the merge path (the CPU default) bit-equal; the fused path
(NRT_FAST_PATH=dense on both) within 1e-6 relative, the contract of
nrtsearch_tpu/ops/dense_fused.py:29-33 between two f32 summation orders;
sort keys and facet counts equal; reduction sums within 1e-6 relative.
``merge_score_topk`` with each column argument is held to the reference's
call on both branches: the accelerator branch with the reference's Pallas
kernels in TPU interpret mode (tests/test_torch_merge_alt.py's fixture).
"""

import random
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu.schema.fields import create_field_def as ref_create_field_def
from nrtsearch_tpu_torch.core.directory import open_commit
from nrtsearch_tpu_torch.core.searcher import Searcher, SortComponent, SortSpec
from nrtsearch_tpu_torch.ops import merge_scoring as port_ms
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def
from tests.test_torch_merge_alt import (  # noqa: F401
    _index, alt_merges, assert_bits_equal, interpret, to_torch,
)

FIELDS = {
    "id": {"type": "_ID", "store": True},
    "body": {"type": "TEXT", "search": True},
    "price": {"type": "FLOAT", "storeDocValues": True},
    "ts": {"type": "FLOAT", "storeDocValues": True},
    "tag": {"type": "ATOM", "storeDocValues": True},
    "big": {"type": "LONG", "storeDocValues": True},
    "small": {"type": "LONG", "storeDocValues": True},
}
N_TAGS = 20
VOCAB = [f"w{i}" for i in range(60)]
SCORE_REL = {"merge": 0.0, "fused": 1e-6}
K = 25   # one top-k everywhere: the reference compiles per k


def _docs(ids, rng):
    """Zipf-ish text (w0..w9 are head terms of the fused path at this size,
    the rest tail), f32-exact prices (about 3% missing), ts, tags, a LONG
    column above 2^24 (an f64 device column) and one just below it (f32)."""
    weights = [1.0 / (r + 1) for r in range(len(VOCAB))]
    out = []
    for i in ids:
        words = rng.choices(VOCAB, weights, k=rng.randint(4, 12))
        doc = {"id": str(i), "body": " ".join(words),
               "ts": str(float(np.float32(rng.uniform(0, 1e9)))),
               "tag": f"tag_{rng.randrange(N_TAGS)}",
               "big": str((1 << 25) + 3 * i), "small": str((1 << 24) - i % 4)}
        if rng.random() > 0.03:
            doc["price"] = str(float(np.float32(rng.uniform(0, 1000))))
        out.append(doc)
    return out


@pytest.fixture(scope="module")
def searchers(tmp_path_factory):
    from nrtsearch_tpu.core.directory import commit_segments
    from nrtsearch_tpu.core.searcher import Searcher as RefSearcher
    from nrtsearch_tpu.core.writer import IndexWriter as RefWriter

    rng = random.Random(17)
    ref_fds = {n: ref_create_field_def(n, s) for n, s in FIELDS.items()}
    writer = RefWriter(ref_fds)
    for lo, hi in ((0, 1400), (1400, 2600), (2600, 3200)):
        writer.add_documents(_docs(range(lo, hi), rng))
        writer.refresh()
        if lo == 1400:
            writer.delete_by_id([str(j) for j in range(0, 2600, 11)])
    segs = writer.refresh()
    assert len(segs) == 3 and sum(s.del_count for s in segs) > 0
    path = tmp_path_factory.mktemp("committed")
    commit_segments(segs, path, gen=1, version=1)
    _manifest, port_segs = open_commit(path, "cpu")
    port_fds = {n: create_field_def(n, s) for n, s in FIELDS.items()}
    return RefSearcher(segs, ref_fds), Searcher(port_segs, port_fds)


def config3_query(terms, tags, lo=100.0, hi=900.0, should_seed=0, text_op="SHOULD"):
    """The config-#3 tree (stress_deep_boolean.py:140-177) as a dict."""
    rng = np.random.default_rng(should_seed)
    should = []
    for i in range(8):
        if i % 2 == 0:
            s = float(rng.uniform(0, 500))
            should.append({"occur": "SHOULD", "query": {"rangeQuery": {
                "field": "price", "lower": str(s), "upper": str(s + 400)}}})
        else:
            should.append({"occur": "SHOULD", "query": {"termQuery": {
                "field": "tag", "textValue": f"tag_{rng.integers(0, N_TAGS)}"}}})
    return {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {
            "field": "body", "query": " ".join(terms), "operator": text_op}}},
        {"occur": "FILTER", "query": {"rangeQuery": {
            "field": "price", "lower": str(lo), "upper": str(hi)}}},
        {"occur": "FILTER", "query": {"termInSetQuery": {
            "field": "tag", "textTerms": {"terms": tags}}}},
        {"occur": "MUST_NOT", "query": {"termQuery": {"field": "tag", "textValue": "tag_7"}}},
        {"occur": "MUST", "query": {"boost": 1.5, "booleanQuery": {"clauses": should}}},
    ]}}


QUERIES = {
    "head": config3_query(["w0", "w1", "w3", "w5"], [f"tag_{i}" for i in (1, 3, 5, 7, 9)]),
    "tail": config3_query(["w30", "w41", "w52", "w2"], [f"tag_{i}" for i in range(0, 20, 2)],
                          lo=50.5, hi=999.25, should_seed=1),
    "must": config3_query(["w0", "w2"], [f"tag_{i}" for i in range(12)], should_seed=2,
                          text_op="MUST"),
    # FILTER / MUST_NOT only: a filter mask and no additive column
    "filters_only": {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "w1 w4 w33"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "big", "lower": "33554500",
                                                      "upper": "33560000"}}},
        {"occur": "MUST_NOT", "query": {"termInSetQuery": {
            "field": "tag", "textTerms": {"terms": ["tag_2", "tag_4"]}}}},
        {"occur": "FILTER", "query": {"existsQuery": {"field": "price"}}},
    ]}},
    # a LONG bound that f32 rounds (2^24 + 1 -> 2^24), as both packages do
    "near_2_24": {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "w0 w5 w20"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "small", "lower": "16777217"}}},
    ]}},
    # constant-score and exists as scored columnar MUST clauses
    "constant": {"boost": 2.0, "booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "w0 w8"}}},
        {"occur": "MUST", "query": {"boost": 0.3, "constantScoreQuery": {"filter": {
            "termQuery": {"field": "tag", "textValue": "tag_3"}}}}},
        {"occur": "MUST", "query": {"existsQuery": {"field": "ts"}}},
    ]}},
}


def _hits(td):
    return [h.global_ord for h in td.hits], np.array([h.score for h in td.hits], np.float32)


def _assert_same(ref_td, port_td, rel, ctx):
    rd, rs = _hits(ref_td)
    pd, ps = _hits(port_td)
    assert (port_td.total_hits, port_td.relation) == (ref_td.total_hits, ref_td.relation), ctx
    assert ref_td.total_hits > 0, ctx
    if rel == 0.0:
        assert pd == rd, ctx
        np.testing.assert_array_equal(ps.view(np.int32), rs.view(np.int32), err_msg=ctx)
    else:
        np.testing.assert_allclose(ps, rs, rtol=rel, err_msg=ctx)
        for i, (a, b) in enumerate(zip(pd, rd)):
            assert a == b or abs(ps[i] - rs[i]) <= rel * abs(rs[i]), (ctx, i)


@pytest.mark.parametrize("path", ["merge", "fused"])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_scored_filtered_matches_reference(searchers, monkeypatch, path, qname):
    ref, port = searchers
    if path == "fused":
        monkeypatch.setenv("NRT_FAST_PATH", "dense")
    view = port.packed_view("body")
    before = dict(view.path_counts)
    ref_td = ref.search(ref_parse_query(QUERIES[qname]), K)
    port_td = port.search(parse_query(QUERIES[qname]), K)
    _assert_same(ref_td, port_td, SCORE_REL[path], f"{qname}/{path}")
    served = {k: view.path_counts[k] - before[k] for k in before}
    if path == "merge" or qname in ("head", "constant"):
        assert served[path] == 1, served


PLAIN = {"matchQuery": {"field": "body", "query": "w0 w6 w44"}}
# (sort, query): the price sorts on a plain match, whose matches include
# docs without a price (the tree's price filter drops them)
SORTS = {
    "ts_desc_tree": (dict(field="ts", reverse=True), QUERIES["tail"]),
    "ts_asc_tree": (dict(field="ts"), QUERIES["head"]),
    "price_asc_missing_first": (dict(field="price"), PLAIN),
    "price_asc_missing_last": (dict(field="price", missing_last=True), PLAIN),
    "price_desc_missing_first": (dict(field="price", reverse=True), PLAIN),
    "price_desc_missing_last": (dict(field="price", reverse=True, missing_last=True), PLAIN),
    "tag_asc": (dict(field="tag"), PLAIN),
}


@pytest.mark.parametrize("path", ["merge", "fused"])
@pytest.mark.parametrize("sname", sorted(SORTS))
def test_sorted_matches_reference(searchers, monkeypatch, path, sname):
    """Keys (bit for bit, the missing sentinels included) and docs equal."""
    from nrtsearch_tpu.core.searcher import SortSpec as RefSortSpec

    ref, port = searchers
    if path == "fused":
        monkeypatch.setenv("NRT_FAST_PATH", "dense")
    sort, q = SORTS[sname]
    ref_td = ref.search(ref_parse_query(q), K, sort=RefSortSpec(**sort))
    port_td = port.search(parse_query(q), K, sort=SortSpec(**sort))
    ctx = f"{sname}/{path}"
    assert port_td.total_hits == ref_td.total_hits > 0, ctx
    assert [h.global_ord for h in port_td.hits] == [h.global_ord for h in ref_td.hits], ctx
    pk = np.array([h.sort_key for h in port_td.hits], np.float32)
    rk = np.array([h.sort_key for h in ref_td.hits], np.float32)
    np.testing.assert_array_equal(pk.view(np.int32), rk.view(np.int32), err_msg=ctx)
    if sname == "price_asc_missing_first":
        assert pk[0] == np.float32(-1e38), "missing prices sort first"


@pytest.mark.parametrize("path", ["merge", "fused"])
def test_shared_sort_batch_is_one_dispatch(searchers, monkeypatch, path):
    """Specs compiled with one SortSpec share the snapshot's key object,
    group into one dispatch, and equal the reference's batch."""
    from nrtsearch_tpu.core.searcher import SortSpec as RefSortSpec

    ref, port = searchers
    if path == "fused":
        monkeypatch.setenv("NRT_FAST_PATH", "dense")
    rng = random.Random(3)
    qs = [{"matchQuery": {"field": "body", "query": " ".join(rng.sample(VOCAB[:10], 2))}}
          for _ in range(6)]
    sort = dict(field="ts", reverse=True)
    specs = [port.compile_batchable(parse_query(q), SortSpec(**sort)) for q in qs]
    assert len({id(s.sort[0]) for s in specs}) == 1
    ref_specs = [ref.compile_batchable(ref_parse_query(q), RefSortSpec(**sort)) for q in qs]
    calls = []
    orig = port_ms.merge_score_topk
    monkeypatch.setattr("nrtsearch_tpu_torch.core.maxscore.merge_score_topk",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    out = port.fast_search_batch(specs, K)
    for i, (r, p) in enumerate(zip(ref.fast_search_batch(ref_specs, K), out)):
        assert [h.global_ord for h in p.hits] == [h.global_ord for h in r.hits], i
        assert [h.sort_key for h in p.hits] == [h.sort_key for h in r.hits], i
        assert p.total_hits == r.total_hits, i
    assert len(calls) == (1 if path == "merge" else 0)


REDUCE_PLAN = [{"kind": "ordinal", "field": "tag"}, {"kind": "sum", "field": "price"},
               {"kind": "count", "field": None}, {"kind": "min", "field": "ts"},
               {"kind": "max", "field": "big"}]


@pytest.mark.parametrize("qname", ["head", "tail", "filters_only"])
def test_fast_search_reduce_matches_reference(searchers, qname):
    ref, port = searchers
    spec = port.compile_batchable(parse_query(QUERIES[qname]))
    ref_spec = ref.compile_batchable(ref_parse_query(QUERIES[qname]))
    view = port.packed_view("body")
    before = view.path_counts["merge"]
    p_td, p_red = port.fast_search_reduce(spec, K, REDUCE_PLAN)
    r_td, r_red = ref.fast_search_reduce(ref_spec, K, REDUCE_PLAN)
    assert view.path_counts["merge"] == before + 1
    _assert_same(r_td, p_td, 0.0, qname)
    assert p_red[0] == r_red[0] and sum(p_red[0].values()) == r_td.total_hits
    np.testing.assert_allclose(p_red[1], r_red[1], rtol=1e-6)
    assert p_red[2] == r_red[2] == r_td.total_hits
    assert p_red[3:] == r_red[3:]


def test_global_column_matches_reference(searchers):
    ref, port = searchers
    for field in ("tag", "price", "big"):
        r = ref.packed_view("body").global_column(field)
        p = port.packed_view("body").global_column(field)
        assert p["ord_terms"] == r["ord_terms"], field
        np.testing.assert_array_equal(p["values"].numpy(), np.asarray(r["values"]))
        np.testing.assert_array_equal(p["present"].numpy(), np.asarray(r["present"]))


def test_filter_and_additive_columns_match_reference(searchers):
    """The compiled filter mask and additive column of the config-#3 tree
    (query/compiled.py's columnar subset, with the f64 LONG column through
    the eager leaf evaluator) equal the reference's, bit for bit."""
    ref, port = searchers
    q = {"booleanQuery": {"clauses": [
        *QUERIES["head"]["booleanQuery"]["clauses"],
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "big", "lower": "33554440"}}},
        {"occur": "MUST", "query": {"termInSetQuery": {"field": "big",
                                                        "longValues": [33554438, 33554441]}}},
    ]}}
    r = ref.compile_batchable(ref_parse_query(q))
    p = port.compile_batchable(parse_query(q))
    np.testing.assert_array_equal(p.filter.numpy(), np.asarray(r.filter))
    np.testing.assert_array_equal(p.additive.numpy().view(np.int32),
                                  np.asarray(r.additive).view(np.int32))
    assert (p.terms, p.boost) == (r.terms, r.boost)


def test_bucket_path_refuses_column_specs(searchers, monkeypatch):
    _ref, port = searchers
    monkeypatch.setenv("NRT_FAST_PATH", "bucket")
    view = port.packed_view("body")
    spec = port.compile_batchable(parse_query(QUERIES["head"]))
    assert view.bucket_plan([spec]) is None
    plain = port.fast_query_spec(parse_query({"matchQuery": {"field": "body", "query": "w0"}}))
    assert view.bucket_plan([plain]) is not None
    before = dict(view.path_counts)
    port.fast_search_batch([spec], 10)
    assert view.path_counts["merge"] == before["merge"] + 1
    assert view.path_counts["bucket"] == before["bucket"]


UNPORTED = {
    "multi_sort": lambda S, C, parse: dict(sort=S("ts", rest=(C("price"),))),
    "score_sort": lambda S, C, parse: dict(sort=S("score")),
    "f64_sort": lambda S, C, parse: dict(sort=S("big")),
    "extra_filter": lambda S, C, parse: dict(
        extra_filter=parse({"existsQuery": {"field": "ts"}})),
    # a deadline that passes at once: both packages stop after the first
    # docid chunk that holds postings, deterministically
    "timeout": lambda S, C, parse: dict(timeout_sec=1e-9),
    # a deadline that never passes: every chunk, the full answer
    "timeout_uncut": lambda S, C, parse: dict(timeout_sec=1e6),
}


def _sort_values(td):
    return [h.sort_key if isinstance(h.sort_key, tuple) or h.sort_key is None
            else (h.sort_key,) for h in td.hits]


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_options_raise(searchers, case):
    """The options the port refused before the general evaluator came
    (ROADMAP item 8) now answer as the reference does: the same hits, order,
    totals, scores and sort values, also after the single sort on the same
    first component is cached (``ts`` has no ties here, so the reference's
    cache fault does not show; tests/test_torch_multisort.py shows it)."""
    from nrtsearch_tpu.core.searcher import SortComponent as RefC, SortSpec as RefS

    ref, port = searchers
    spec = {"matchQuery": {"field": "body", "query": "w0"}}
    ref.search(ref_parse_query(spec), 10, sort=RefS("ts"))
    port.search(parse_query(spec), 10, sort=SortSpec("ts"))
    want = ref.search(ref_parse_query(spec), 10,
                      **UNPORTED[case](RefS, RefC, ref_parse_query))
    got = port.search(parse_query(spec), 10, **UNPORTED[case](SortSpec, SortComponent,
                                                              parse_query))
    assert want.total_hits > 0
    assert [h.global_ord for h in got.hits] == [h.global_ord for h in want.hits]
    assert (got.total_hits, got.relation) == (want.total_hits, want.relation)
    assert got.hit_timeout == want.hit_timeout == (case == "timeout")
    assert [h.score for h in got.hits] == [h.score for h in want.hits]
    if case == "multi_sort":
        # the reference's cached single-sort keys: its hits carry the first
        # component only (nrtsearch_tpu/core/searcher.py:520)
        assert [v[0] for v in _sort_values(got)] == [v[0] for v in _sort_values(want)]
        assert all(len(v) == 2 for v in _sort_values(got))
    else:
        assert _sort_values(got) == _sort_values(want)


def test_unported_filter_shapes_raise(searchers):
    """A text filter clause (a MUST_NOT match) takes the general evaluator,
    ported since: bit-equal to the reference."""
    ref, port = searchers
    spec = {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "w0"}}},
        {"occur": "MUST_NOT", "query": {"matchQuery": {"field": "body", "query": "w3"}}}]}}
    want = ref.search(ref_parse_query(spec), 10)
    got = port.search(parse_query(spec), 10)
    assert want.total_hits > 0
    assert [(h.global_ord, h.score) for h in got.hits] == [
        (h.global_ord, h.score) for h in want.hits]
    assert got.total_hits == want.total_hits


# ---------------------------------------------------------------------------
# merge_score_topk's column arguments against the reference's call
# ---------------------------------------------------------------------------


def _columns(rng, max_doc):
    filt = rng.random(max_doc) < 0.7
    additive = np.where(rng.random(max_doc) < 0.5, 1.5, 0.0).astype(np.float32)
    keys = rng.integers(0, 50, max_doc).astype(np.float32)   # long tie plateaus
    keys[rng.random(max_doc) < 0.01] = np.float32(-1e38)
    tags = rng.integers(-1, 12, max_doc).astype(np.int32)
    vals = (rng.random(max_doc) * 100).astype(np.float32)
    return filt, additive, keys, tags, vals


# each case puts several column arguments into one call, as a served batch
# does: a filter with an additive column; a filter with a descending sort
# and every reduction kind; an ascending sort of a conjunction. Each case
# keeps the seed it has always drawn from
COLUMN_CASES = ["filter_additive", "sort_desc_reduce", "sort_asc_and"]
CASE_SEEDS = {"filter_additive": 21, "sort_desc_reduce": 16, "sort_asc_and": 12}


def _column_kwargs(case, cols, conv):
    filt, additive, keys, tags, vals = cols
    if case == "filter_additive":
        return dict(filter_mask=conv(filt), additive=conv(additive))
    if case == "sort_asc_and":
        return dict(sort_keys=conv(keys), sort_ascending=True)
    present = conv(tags >= 0)
    return dict(filter_mask=conv(filt), sort_keys=conv(keys), sort_ascending=False,
                reduce_cols=((conv(tags), present), (conv(vals), None),
                             (conv(np.zeros(1, np.float32)), None),
                             (conv(vals), present), (conv(vals), None)),
                reduce_kinds=(("ordinal", 12), ("sum",), ("count",), ("min",), ("max",)))


def _assert_columns_equal(out, ref, case):
    assert_bits_equal(out[0], ref[0], f"{case} scores")
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]), err_msg=case)
    assert int(np.asarray(ref[2]).min()) > 0, case
    fin = np.isfinite(np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy()[fin], np.asarray(ref[1])[fin], err_msg=case)
    if case == "sort_desc_reduce":
        for i, (p, r) in enumerate(zip(out[3], ref[3])):
            if i == 1:      # the f32 sum: another summation order
                np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6)
            else:
                np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=f"{case} {i}")


@pytest.mark.parametrize("case", COLUMN_CASES)
def test_merge_score_topk_columns_plain_branch(case):
    """The plain branch (the reference's XLA path, use_pallas False)."""
    from nrtsearch_tpu.ops import merge_scoring as ref_ms

    rng = np.random.default_rng(CASE_SEEDS[case])
    post_docs, post_imps, run_offs, run_lens, max_doc = _index(rng, max_doc=120_000)
    B, R, run_len = 3, 8, 4096
    offs = np.zeros((B, R), np.int32)
    lens = np.zeros((B, R), np.int32)
    w = np.zeros((B, R), np.float32)
    for b in range(B):
        for r in range(R):
            t = (b + r) % len(run_offs)
            offs[b, r] = run_offs[t] + 1000 * r
            lens[b, r] = min(run_len, int(run_lens[t]) - 1000 * r)
            w[b, r] = 0.5 + 0.25 * r
    n_terms = np.array([2, 1, 3], np.int32)
    cols = _columns(rng, max_doc)
    args = (post_docs, post_imps, offs, lens, w, n_terms)
    kw = dict(run_len=run_len, k=40, require_all_terms=case == "sort_asc_and")
    ref = ref_ms.merge_score_topk(*map(jnp.asarray, args), **kw,
                                  **_column_kwargs(case, cols, jnp.asarray))
    out = port_ms.merge_score_topk(*map(to_torch, args), use_pallas=False, **kw,
                                   **_column_kwargs(case, cols, to_torch))
    _assert_columns_equal(out, ref, case)


@pytest.mark.parametrize("case", COLUMN_CASES)
def test_merge_score_topk_columns_accel_branch(interpret, case, monkeypatch):
    """The accelerator branch's alternating network (width 2^18) against
    the reference's Pallas kernels in interpret mode."""
    from nrtsearch_tpu.ops import merge_scoring as ref_ms

    rng = np.random.default_rng(100 + CASE_SEEDS[case])
    post_docs, post_imps, run_offs, run_lens, max_doc = _index(rng)
    B, R, run_len = 2, 4, 65536
    offs = np.tile(run_offs[:R].astype(np.int32), (B, 1))
    lens = np.tile(run_lens[:R], (B, 1))
    w = np.array([[1.3, 0.7, 2.1, 0.4], [0.9, 0.0, 1.1, 1.7]], np.float32)
    n_terms = np.array([2, 3], np.int32)
    cols = _columns(rng, max_doc)
    args = (post_docs, post_imps, offs, lens, w, n_terms)
    kw = dict(run_len=run_len, k=60, require_all_terms=case == "sort_asc_and")
    alt = alt_merges(monkeypatch)
    ref = ref_ms.merge_score_topk(*map(jnp.asarray, args), use_pallas=True, **kw,
                                  **_column_kwargs(case, cols, jnp.asarray))
    out = port_ms.merge_score_topk(*map(to_torch, args), use_pallas=True, **kw,
                                   **_column_kwargs(case, cols, to_torch))
    assert len(alt) == 1
    _assert_columns_equal(out, ref, case)


def test_sorted_spec_replaces_keys_not_scores(searchers):
    """A sorted spec's hits carry the key (score 0.0), as the reference's."""
    _ref, port = searchers
    spec = port.compile_batchable(parse_query({"matchQuery": {"field": "body", "query": "w2"}}),
                                  SortSpec("ts"))
    td = port.fast_search_batch([replace(spec)], 5)[0]
    assert all(h.score == 0.0 and h.sort_key is not None for h in td.hits)
    keys = [h.sort_key for h in td.hits]
    assert keys == sorted(keys)


def test_release_device_caches_drops_sort_keys(searchers):
    _ref, port = searchers
    port._global_sort_keys(SortSpec("ts"))
    assert port._gsort_cache
    snapshot = Searcher(port.segments, port.field_defs)
    snapshot._global_sort_keys(SortSpec("ts"))
    snapshot.release_device_caches()
    assert not snapshot._gsort_cache and not snapshot._packed_views
    assert isinstance(port._gsort_cache[("ts", False, False)][0], torch.Tensor)


# ---------------------------------------------------------------------------
# the smoke run's numpy oracle against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A small SyntheticCorpus index with the config-#3 columns, put on
    the port through ``segment_from_numpy``, committed by the port and
    opened by the reference."""
    from nrtsearch_tpu.core.directory import open_commit as ref_open
    from nrtsearch_tpu.core.searcher import Searcher as RefSearcher
    from nrtsearch_tpu_torch.convert import segment_from_numpy
    from nrtsearch_tpu_torch.core.directory import commit_segments
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    corpus = SyntheticCorpus(30_000, 3_000, 24, seed=5)
    columns = corpus.doc_columns(seed=6, missing=0.05)
    segs = [segment_from_numpy(a, "cpu", doc_values=dv) for a, dv in
            zip(corpus.segment_arrays(3), corpus.segment_doc_values(columns, 3))]
    path = tmp_path_factory.mktemp("synthetic")
    commit_segments(segs, path, gen=1, version=1)
    _m, ref_segs = ref_open(path)
    specs = {"body": {"type": "TEXT", "search": True},
             "price": {"type": "FLOAT", "storeDocValues": True},
             "ts": {"type": "FLOAT", "storeDocValues": True},
             "tag": {"type": "ATOM", "storeDocValues": True}}
    ref = RefSearcher(ref_segs, {n: ref_create_field_def(n, s) for n, s in specs.items()})
    return corpus, columns, ref


ORACLE_FORMS = ["scored", "sorted_desc", "sorted_asc", "faceted"]


@pytest.mark.parametrize("form", ORACLE_FORMS)
def test_numpy_oracle_matches_reference(synthetic, form):
    """models.synthetic's exact filtered top-k (chip_smoke.py phase 9's
    check) against the reference Searcher: hits exact, docs equal up to
    near-ties, scores within 1e-5 relative; sort keys and docs equal;
    facet counts equal, the price sum within 1e-5 relative."""
    from nrtsearch_tpu.core.searcher import SortSpec as RefSortSpec
    from nrtsearch_tpu_torch.models.synthetic import column_clauses, config3_query

    corpus, columns, ref = synthetic
    names = columns["tag"][2]
    seed = ORACLE_FORMS.index(form)
    terms = [str(t) for t in np.random.default_rng(seed).choice(40, 4, replace=False)]
    q = config3_query(terms, names, seed)
    sort = {"sorted_desc": ("ts", False, False), "sorted_asc": ("price", True, False)}.get(form)
    ex = corpus.exact_filtered_topk(terms, K, columns, column_clauses(q), sort=sort,
                                    facet="tag", total="price")
    node = ref_parse_query(q)
    if form == "faceted":
        td, (facets, total) = ref.fast_search_reduce(
            ref.compile_batchable(node), K,
            [{"kind": "ordinal", "field": "tag"}, {"kind": "sum", "field": "price"}])
        assert facets == {names[i]: int(c) for i, c in enumerate(ex["facet"]) if c}
        np.testing.assert_allclose(total, ex["total"], rtol=1e-5)
    elif sort is None:
        td = ref.search(node, K)
    else:
        td = ref.search(node, K, sort=RefSortSpec(sort[0], reverse=not sort[1]))
    assert td.total_hits == ex["hits"] > 0
    docs = np.array([h.global_ord for h in td.hits])
    if sort is not None:
        keys = np.array([h.sort_key for h in td.hits], np.float32)
        np.testing.assert_array_equal(keys, ex["scores"])
        np.testing.assert_array_equal(docs, ex["docs"])
        return
    scores = np.array([h.score for h in td.hits], np.float32)
    np.testing.assert_allclose(scores, ex["scores"], rtol=1e-5)
    for i in np.nonzero(docs != ex["docs"])[0]:
        assert abs(scores[i] - ex["scores"][i]) <= 1e-5 * ex["scores"][i], i
