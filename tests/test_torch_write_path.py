"""The port's write path against the reference's, on the CPU.

Each test builds both packages' writers (or index runtimes) from the same
dict specs and the same numpy-seeded documents, runs the same operations
through both (upserts, deletes by id and by query, doc-value updates,
tiered merges, ``delete_all``, index sorts) and then compares:

- the segment layout: per segment its kind (flushed, ``_m`` merged, ``_dv``
  updated), doc count, deleted count, del_gen, live mask, the ``doc_id`` of
  every local doc id (so an index-sorted segment's doc ids equal the
  reference's) and the price / ts columns with their device precision;
- the writer's id map, with segment ids replaced by segment positions;
- answers through each package's public ``Searcher``: hits, order,
  ``totalHits``, relation, scores and sort keys.

Tolerances: the merge path, the general evaluator and the sorts are exact
(scores bit-equal); the fused path holds docs and hit counts equal and
scores within ``FUSED_REL`` relative (torch and XLA add the f32 head
products in different orders); the bucket path's plain version is held bit
for bit to the reference's bucket path (its kernels in Pallas interpret
mode, as tests/test_torch_bucket.py runs them). JAX runs on the CPU, as the
reference's own tests run it.
"""

import re

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from nrtsearch_tpu.core.searcher import Searcher as RefSearcher, SortSpec as RefSortSpec
from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu.schema.fields import create_field_def as ref_create_field_def
from nrtsearch_tpu.search.query_cache import DEFAULT_QUERY_CACHE as REF_QUERY_CACHE
from nrtsearch_tpu.server.index_runtime import IndexRuntime as RefIndexRuntime
from nrtsearch_tpu.state.index_state import IndexStateInfo as RefIndexStateInfo
from nrtsearch_tpu_torch.core.searcher import Searcher, SortSpec
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def
from nrtsearch_tpu_torch.search.query_cache import DEFAULT_QUERY_CACHE
from nrtsearch_tpu_torch.server.index_runtime import IndexRuntime
from nrtsearch_tpu_torch.state.index_state import IndexStateInfo

FIELD_SPECS = {
    "doc_id": {"type": "_ID", "store": True, "storeDocValues": True},
    "body": {"type": "TEXT", "search": True, "store": True},
    "price": {"type": "FLOAT", "storeDocValues": True, "sort": True},
    "ts": {"type": "LONG", "storeDocValues": True, "sort": True},
    "tag": {"type": "ATOM", "search": True, "storeDocValues": True},
}
REF_FIELDS = {n: ref_create_field_def(n, s) for n, s in FIELD_SPECS.items()}
PORT_FIELDS = {n: create_field_def(n, s) for n, s in FIELD_SPECS.items()}
WORDS = ["common", "alpha", "beta", "gamma", "delta", "needle", "quick", "brown"]
WORD_P = np.array([0.3, 0.15, 0.12, 0.1, 0.1, 0.05, 0.1, 0.08])
FUSED_REL = 1e-6

TEXT_QUERIES = [
    {"matchQuery": {"field": "body", "query": "common alpha"}},
    {"matchQuery": {"field": "body", "query": "needle beta quick"}},
    {"matchQuery": {"field": "body", "query": "common gamma", "operator": "MUST"}},
    {"termQuery": {"field": "body", "textValue": "delta"}},
]
GENERAL_QUERIES = [
    {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "common brown"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "10",
                                                      "upper": "70"}}},
        {"occur": "MUST_NOT", "query": {"termQuery": {"field": "tag", "textValue": "t1"}}}]}},
    {"rangeQuery": {"field": "ts", "lower": "100", "upper": "600"}},
    {"prefixQuery": {"field": "body", "prefix": "al"}},
    {"termInSetQuery": {"field": "tag", "textTerms": {"terms": ["t0", "t2"]}}},
]
SORTS = [("price", True, False), ("ts", False, True)]


def make_docs(ids, seed: int) -> list[dict]:
    """One document per id: a Zipf-ish body, a FLOAT price (missing on every
    7th), a LONG ts below 2^24 and one of 4 tags."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in ids:
        words = rng.choice(WORDS, size=int(rng.integers(2, 7)), p=WORD_P / WORD_P.sum())
        doc = {"doc_id": f"d{i}", "body": " ".join(words),
               "ts": str(int(rng.integers(0, 1000))), "tag": f"t{int(rng.integers(0, 4))}"}
        if i % 7:
            doc["price"] = str(float(np.float32(round(float(rng.uniform(0, 100)), 2))))
        docs.append(doc)
    return docs


class Pair:
    """A reference writer and a port writer (on the CPU) driven in step."""

    def __init__(self, merge_factor: int = 100, index_sort=()):
        self.ref = RefWriter(REF_FIELDS, merge_factor=merge_factor)
        self.port = IndexWriter(PORT_FIELDS, "cpu", merge_factor=merge_factor)
        self.ref.index_sort = self.port.index_sort = list(index_sort)

    def both(self, op: str, *args):
        """Run ``op`` on both writers with copies of the arguments; both
        must return or both raise the same exception type."""
        out = []
        for w in (self.ref, self.port):
            try:
                copied = [[dict(d) if isinstance(d, dict) else d for d in a]
                          if isinstance(a, list) else a for a in args]
                out.append(getattr(w, op)(*copied))
            except Exception as e:  # noqa: BLE001 - compared across packages
                out.append(type(e))
        assert out[0] == out[1], (op, out)
        return out[0]

    def refresh(self) -> tuple:
        self.ref.refresh()
        self.port.refresh()
        return self.searchers()

    def searchers(self) -> tuple:
        return (RefSearcher(list(self.ref.segments), REF_FIELDS),
                Searcher(list(self.port.segments), PORT_FIELDS))


def _seg_kind(seg_id: str) -> str:
    return re.sub(r"^seg_[0-9a-f]+_\d+", "", seg_id)


def layout(segments) -> list:
    """Per segment: kind, doc counts, del_gen, live mask, doc_id per local
    id, price and ts values, presence and device dtype."""
    out = []
    for s in segments:
        cols = {}
        for f in ("price", "ts"):
            dv = s.doc_values.get(f)
            if dv is None:
                continue
            dtype = getattr(dv.values, "dtype", None)
            cols[f] = (dv.host_values[: s.num_docs].tolist(),
                       dv.host_present[: s.num_docs].tolist(),
                       str(dtype).replace("torch.", ""))
        out.append((_seg_kind(s.seg_id), s.num_docs, s.del_count, s.del_gen,
                    np.asarray(s.host_live).tolist(),
                    [row.get("doc_id") for row in s.stored], cols))
    return out


def id_map(writer) -> dict:
    pos = {s.seg_id: i for i, s in enumerate(writer.segments)}
    return {k: (pos[sid], local) for k, (sid, local) in writer._id_map.items()}


def assert_same_state(pair: Pair) -> None:
    assert layout(pair.port.segments) == layout(pair.ref.segments)
    assert id_map(pair.port) == id_map(pair.ref)
    assert pair.port._buffer_ids == pair.ref._buffer_ids
    assert pair.port._buffer_deleted == pair.ref._buffer_deleted


def assert_same_td(want, got, rel: float = 0.0, ctx="") -> None:
    assert [h.global_ord for h in got.hits] == [h.global_ord for h in want.hits], ctx
    assert (got.total_hits, got.relation) == (want.total_hits, want.relation), ctx
    ws = np.array([h.score for h in want.hits], np.float32)
    gs = np.array([h.score for h in got.hits], np.float32)
    if rel == 0.0:
        np.testing.assert_array_equal(gs, ws, err_msg=ctx)
    else:
        np.testing.assert_allclose(gs, ws, rtol=rel, err_msg=ctx)
    assert [h.sort_key for h in got.hits] == [h.sort_key for h in want.hits], ctx


def doc_ids(searcher, td) -> list:
    return [searcher.segments[h.segment_idx].stored[h.local_id]["doc_id"] for h in td.hits]


def assert_same_answers(ref: RefSearcher, port: Searcher, monkeypatch,
                        paths=("merge", "fused"), k: int = 10) -> None:
    """Text queries on each fast path, the general evaluator's kinds, and
    the doc-value sorts (with a range filter), port against reference."""
    for path in paths:
        monkeypatch.setenv("NRT_FAST_PATH", path)
        rel = FUSED_REL if path == "fused" else 0.0
        for q in TEXT_QUERIES:
            assert_same_td(ref.search(ref_parse_query(q), k), port.search(parse_query(q), k),
                           rel, f"{path} {q}")
    monkeypatch.setenv("NRT_FAST_PATH", "merge")
    for q in GENERAL_QUERIES:
        assert_same_td(ref.search(ref_parse_query(q), k), port.search(parse_query(q), k),
                       0.0, f"general {q}")
    text = {"matchQuery": {"field": "body", "query": "common quick"}}
    flt = {"rangeQuery": {"field": "ts", "upper": "800"}}
    for field, reverse, missing_last in SORTS:
        want = ref.search(ref_parse_query(text), k, extra_filter=ref_parse_query(flt),
                          sort=RefSortSpec(field, reverse=reverse, missing_last=missing_last))
        got = port.search(parse_query(text), k, extra_filter=parse_query(flt),
                          sort=SortSpec(field, reverse=reverse, missing_last=missing_last))
        assert_same_td(want, got, 0.0, f"sort {field}")
    q = {"termInSetQuery": {"field": "tag", "textTerms": {"terms": ["t1", "t3"]}}}
    assert port.count(parse_query(q)) == ref.count(ref_parse_query(q))


def live_ids(searcher) -> set:
    return {row["doc_id"] for s in searcher.segments
            for row, live in zip(s.stored, s.host_live) if live}


# ---------------------------------------------------------------------------
# upserts and deletes by id
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["buffer", "flushed"])
def test_upsert(monkeypatch, where):
    """Re-adding an indexed id replaces the doc: delete-then-add, whether
    the first copy is still buffered or already in a flushed segment."""
    pair = Pair()
    docs = make_docs(range(120), seed=1)
    pair.both("add_documents", docs[:80])
    if where == "flushed":
        pair.refresh()
    new = [dict(d, body="needle needle replaced " + d["body"]) for d in docs[10:30]]
    pair.both("add_documents", new)
    pair.both("add_documents", docs[80:])
    ref, port = pair.refresh()
    assert_same_state(pair)
    assert port.num_docs == ref.num_docs == 120
    assert sum(s.del_count for s in pair.port.segments) == 20
    assert_same_answers(ref, port, monkeypatch)
    q = {"termQuery": {"field": "body", "textValue": "replaced"}}
    td = port.search(parse_query(q), 50)
    assert sorted(doc_ids(port, td)) == sorted(d["doc_id"] for d in new)


@pytest.mark.parametrize("where", ["buffer", "flushed"])
def test_delete_by_id(monkeypatch, where):
    """A delete by _ID of a buffered doc and of a flushed one: gone from
    every path after the refresh, counted in BM25's statistics until a
    merge drops it (Lucene's rule, and the reference's)."""
    pair = Pair()
    docs = make_docs(range(150), seed=2)
    pair.both("add_documents", docs[:100])
    if where == "flushed":
        pair.refresh()
    pair.both("add_documents", docs[100:])
    gone = [d["doc_id"] for d in docs if "needle" in d["body"].split()][:6] + ["d140", "nope"]
    pair.both("delete_by_id", gone)
    ref, port = pair.refresh()
    assert_same_state(pair)
    assert not live_ids(port) & set(gone)
    assert port.num_docs == ref.num_docs == 150 - 7
    assert_same_answers(ref, port, monkeypatch)
    needle = {"termQuery": {"field": "body", "textValue": "needle"}}
    for path in ("merge", "fused"):
        monkeypatch.setenv("NRT_FAST_PATH", path)
        assert not set(doc_ids(port, port.search(parse_query(needle), 50))) & set(gone)
    tf = {s.seg_id: s.fields["body"].doc_freq("needle") for s in pair.port.segments}
    rf = {s.seg_id: s.fields["body"].doc_freq("needle") for s in pair.ref.segments}
    assert sorted(tf.values()) == sorted(rf.values())
    assert sum(tf.values()) == sum(1 for d in docs if "needle" in d["body"].split())


def test_delete_by_query_through_index_runtime(tmp_path, monkeypatch):
    """``IndexRuntime.delete_by_query`` (refresh, match masks per segment,
    ``delete_matches``) on both packages' runtimes, then a refresh."""
    ref_rt = RefIndexRuntime(RefIndexStateInfo(index_name="w", index_id="w-1")
                             .with_fields(FIELD_SPECS), tmp_path / "ref", mode="STANDALONE")
    port_rt = IndexRuntime(IndexStateInfo(index_name="w", index_id="w-1")
                           .with_fields(FIELD_SPECS), tmp_path / "port", mode="STANDALONE",
                           device="cpu")
    docs = make_docs(range(240), seed=3)
    for lo, hi in ((0, 100), (100, 200), (200, 240)):
        for rt in (ref_rt, port_rt):
            rt.add_documents([dict(d) for d in docs[lo:hi]])
            if hi < 240:
                rt.refresh()
    queries = [{"termQuery": {"field": "tag", "textValue": "t2"}},
               {"rangeQuery": {"field": "price", "lower": "20", "upper": "25"}}]
    for q in queries:
        ref_rt.delete_by_query(ref_parse_query(q))
        port_rt.delete_by_query(parse_query(q))
    ref_rt.refresh()
    port_rt.refresh()
    assert layout(port_rt.searcher.segments) == layout(ref_rt.searcher.segments)
    assert port_rt.searcher.version == ref_rt.searcher.version
    for q in queries:
        assert port_rt.searcher.count(parse_query(q)) == 0
        assert ref_rt.searcher.count(ref_parse_query(q)) == 0
    assert port_rt.searcher.num_docs == ref_rt.searcher.num_docs < 200
    assert_same_answers(ref_rt.searcher, port_rt.searcher, monkeypatch)


# ---------------------------------------------------------------------------
# doc-value updates
# ---------------------------------------------------------------------------


def test_doc_value_updates(monkeypatch):
    """UPDATE_DOC_VALUES on a LONG (ts) and a FLOAT (price) field, one value
    of each that f32 cannot hold (so the column goes to f64 on the device,
    which changes the leaves the compiled evaluator hands to the eager one),
    and a value on a doc that had none: sorts, filters and counts see the
    new values, the segment takes a ``_dv`` id, and the id map follows."""
    pair = Pair()
    docs = make_docs(range(160), seed=4)
    pair.both("add_documents", docs[:90])
    pair.refresh()
    pair.both("add_documents", docs[90:])
    ref, port = pair.refresh()
    assert {layout(port.segments)[0][6][f][2] for f in ("price", "ts")} == {"float32"}
    pair.both("update_doc_values", [
        {"doc_id": "d3", "price": "250.5", "ts": "5"},
        {"doc_id": "d7", "price": "1"},                      # had no price
        {"doc_id": "d95", "ts": str(2**40 + 1)},             # forces f64
        {"doc_id": "d11", "price": "0.1"},                   # not an f32 number
    ])
    ref, port = pair.refresh()
    assert_same_state(pair)
    kinds = [lay[0] for lay in layout(port.segments)]
    assert kinds == ["_dv", "_dv"]
    dtypes = [{f: lay[6][f][2] for f in ("price", "ts")} for lay in layout(port.segments)]
    assert dtypes == [{"price": "float64", "ts": "float32"},
                      {"price": "float32", "ts": "float64"}]
    assert_same_answers(ref, port, monkeypatch)
    for compiled in ("1", "0"):
        monkeypatch.setenv("NRT_COMPILED_EVAL", compiled)
        for q in ({"rangeQuery": {"field": "price", "lower": "200"}},
                  {"rangeQuery": {"field": "ts", "lower": str(2**40)}},
                  {"rangeQuery": {"field": "price", "upper": "0.1"}}):
            want = ref.search(ref_parse_query(q), 10)
            got = port.search(parse_query(q), 10)
            assert_same_td(want, got, 0.0, q)
            assert got.total_hits >= 1
    top = port.search(parse_query({"matchQuery": {"field": "body", "query": "common"}}), 5,
                      sort=SortSpec("price", reverse=True))
    if "common" in docs[3]["body"].split():
        assert doc_ids(port, top)[0] == "d3"


@pytest.mark.parametrize("case", ["buffered", "non_numeric", "unknown_id"])
def test_doc_value_update_errors(case):
    """The reference's errors: ValueError for a buffered doc (at the call)
    and for a non-numeric field (at the refresh that applies it), KeyError
    for an unknown id."""
    pair = Pair()
    pair.both("add_documents", make_docs(range(20), seed=5))
    if case == "buffered":
        assert pair.both("update_doc_values", [{"doc_id": "d1", "ts": "3"}]) is ValueError
        return
    pair.refresh()
    if case == "unknown_id":
        assert pair.both("update_doc_values", [{"doc_id": "zz", "ts": "3"}]) is KeyError
        return
    pair.both("update_doc_values", [{"doc_id": "d1", "tag": "t9"}])
    assert pair.both("refresh") is ValueError


# ---------------------------------------------------------------------------
# merges, delete_all
# ---------------------------------------------------------------------------


def test_tiered_merge_drops_deleted_then_upsert_of_merged_doc(monkeypatch):
    """segments_per_tier 3: the fourth refresh merges; the merged segment
    drops the deleted docs (BM25 statistics with them), and an upsert of a
    doc that now lives in the merged segment finds it through the remapped
    id map."""
    pair = Pair(merge_factor=3)
    docs = make_docs(range(200), seed=6)
    for r in range(4):
        pair.both("add_documents", docs[r * 50:(r + 1) * 50])
        pair.both("delete_by_id", [f"d{r * 50 + j}" for j in (1, 2, 30)])
        pair.refresh()
    assert pair.port.merge_stats["merges"] == pair.ref.merge_stats["merges"] >= 1
    assert_same_state(pair)
    merged = [s for s in pair.port.segments if _seg_kind(s.seg_id) == "_m"]
    assert merged and all(s.del_count == 0 for s in merged)
    in_merged = next(k for k, (sid, _l) in pair.port._id_map.items()
                     if sid == merged[0].seg_id)
    pair.both("add_documents", [{"doc_id": in_merged, "body": "needle upserted", "ts": "7",
                                 "tag": "t0"}])
    ref, port = pair.refresh()
    assert_same_state(pair)
    assert merged[0].seg_id in {s.seg_id for s in pair.port.segments}
    assert port.num_docs == ref.num_docs == 200 - 12
    assert_same_answers(ref, port, monkeypatch)
    td = port.search(parse_query({"termQuery": {"field": "body", "textValue": "upserted"}}), 5)
    assert doc_ids(port, td) == [in_merged]


def test_delete_all_then_readd(monkeypatch):
    """delete_all clears the segments, the buffer and every pending delete
    and update; the same ids then add as new docs, not as upserts."""
    pair = Pair()
    docs = make_docs(range(100), seed=7)
    pair.both("add_documents", docs[:60])
    pair.refresh()
    pair.both("add_documents", docs[60:])
    pair.both("delete_by_id", ["d5", "d70"])
    pair.both("update_doc_values", [{"doc_id": "d6", "ts": "9"}])
    pair.both("delete_all")
    for w in (pair.ref, pair.port):
        assert (w.segments, w._buffer_ids, w._buffer_deleted, w._pending_deletes,
                w._pending_dv_updates, w._id_map, w.buffered_docs) == ([], {}, set(), {},
                                                                       {}, {}, 0)
    pair.both("add_documents", docs[:50])
    ref, port = pair.refresh()
    assert_same_state(pair)
    assert port.num_docs == ref.num_docs == 50
    assert sum(s.del_count for s in pair.port.segments) == 0
    assert_same_answers(ref, port, monkeypatch)


# ---------------------------------------------------------------------------
# index sorts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index_sort", [
    [("price", False, False)],
    [("tag", False, True), ("price", True, False)],
    [("ts", True, True), ("price", False, True), ("doc_id", False, False)],
], ids=["price", "tag_price_rev", "ts_rev_missing_last"])
def test_index_sort_at_flush_and_merge(monkeypatch, index_sort):
    """Every flushed segment and the merged one lay their docs out in the
    index sort (stable single-key passes, last key first; reverse; missing
    first or last): each local doc id holds the reference's doc, and the
    buffered deletes and id map follow the remap."""
    pair = Pair(merge_factor=2, index_sort=index_sort)
    docs = make_docs(range(150), seed=8)
    for d in docs[::11]:
        d.pop("ts")
    pair.both("add_documents", docs[:60])
    pair.both("delete_by_id", ["d4", "d33"])
    pair.refresh()
    assert_same_state(pair)
    pair.both("add_documents", docs[60:110])
    pair.refresh()
    pair.both("add_documents", docs[110:])
    pair.both("delete_by_id", ["d120", "d61"])
    ref, port = pair.refresh()
    assert pair.port.merge_stats["merges"] >= 1
    assert_same_state(pair)
    field, reverse, missing_last = index_sort[0]
    seg = pair.port.segments[-1]
    dv = seg.doc_values[field]
    present = dv.host_present[: seg.num_docs]
    n_present = int(present.sum())
    assert n_present < seg.num_docs or field != "ts"
    if missing_last:
        assert present[:n_present].all()
    else:
        assert present[seg.num_docs - n_present:].all()
    assert_same_answers(ref, port, monkeypatch)
    pair.both("add_documents", [dict(docs[3], body="needle sorted upsert")])
    ref, port = pair.refresh()
    assert_same_state(pair)


# ---------------------------------------------------------------------------
# the query cache, the bucket path
# ---------------------------------------------------------------------------


def test_cached_range_filter_then_delete(monkeypatch):
    """A range filter cached per seg_id, a delete in that segment (the
    seg_id stays, the del_gen moves), the same filter again: the entry is
    read again, and the deleted doc still never comes back, because the
    root's live mask is applied after the cache (core/searcher.py)."""
    pair = Pair()
    pair.both("add_documents", make_docs(range(120), seed=9))
    ref, port = pair.refresh()
    monkeypatch.setenv("NRT_COMPILED_EVAL", "0")
    monkeypatch.setattr(RefSearcher, "_fast_filtered_text", lambda *a, **k: None)
    monkeypatch.setattr(Searcher, "_fast_filtered_text", lambda *a, **k: None)
    q = {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "common alpha"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "5",
                                                      "upper": "95"}}}]}}
    first = port.search(parse_query(q), 10)
    assert_same_td(ref.search(ref_parse_query(q), 10), first)
    victim = doc_ids(port, first)[0]
    seg_id = pair.port.segments[0].seg_id
    pair.both("delete_by_id", [victim])
    ref, port = pair.refresh()
    assert pair.port.segments[0].seg_id == seg_id and pair.port.segments[0].del_gen == 1
    hits0, ref_hits0 = DEFAULT_QUERY_CACHE.hits, REF_QUERY_CACHE.hits
    again = port.search(parse_query(q), 10)
    assert DEFAULT_QUERY_CACHE.hits > hits0 and REF_QUERY_CACHE.hits == ref_hits0
    want = ref.search(ref_parse_query(q), 10)
    assert REF_QUERY_CACHE.hits > ref_hits0
    assert_same_td(want, again)
    assert victim not in doc_ids(port, again)
    assert again.total_hits == first.total_hits - 1
    masks = port.match_masks(parse_query(q))
    local = [row["doc_id"] for row in pair.port.segments[0].stored].index(victim)
    assert not bool(masks[0][local])


@pytest.mark.parametrize("require_all", [False, True])
def test_bucket_plain_on_deleted_index(require_all):
    """The port's bucket path (its plain version on the CPU) on an index the
    port wrote with deletes and an upsert: bit for bit the reference's
    bucket path on the index the reference wrote."""
    pair = Pair()
    docs = make_docs(range(300), seed=10)
    for lo in (0, 100, 200):
        pair.both("add_documents", docs[lo:lo + 100])
        pair.both("delete_by_id", [f"d{lo + j}" for j in range(0, 100, 9)])
        pair.refresh()
    pair.both("add_documents", [dict(docs[50], body="common alpha needle")])
    ref, port = pair.refresh()
    assert_same_state(pair)
    texts = ["common alpha", "needle beta", "gamma quick brown"] if not require_all else [
        "common alpha", "beta quick"]

    def specs(searcher, parse):
        out = []
        for t in texts:
            node = parse({"matchQuery": {"field": "body", "query": t,
                                         **({"operator": "MUST"} if require_all else {})}})
            out.append(searcher.fast_query_spec(node))
        return out

    r = ref.packed_view("body").bucket_search_batch(specs(ref, ref_parse_query), 10)
    p = port.packed_view("body").bucket_search_batch(specs(port, parse_query), 10)
    assert r is not None and p is not None
    for i, (a, b) in enumerate(zip(p, r)):
        np.testing.assert_array_equal(a.scores.view(np.int32), b.scores.view(np.int32),
                                      err_msg=str(i))
        np.testing.assert_array_equal(a.docs, b.docs, err_msg=str(i))
        assert (a.total_hits, a.pruned) == (b.total_hits, b.pruned), i
    deleted = {int(port.bases[si]) + j for si, s in enumerate(port.segments)
               for j in np.nonzero(~s.host_live)[0]}
    assert all(not set(a.docs[a.scores > 0].tolist()) & deleted for a in p)
    assert any(a.total_hits > 0 for a in p)


# ---------------------------------------------------------------------------
# a random sequence of writes
# ---------------------------------------------------------------------------

OPS = st.lists(st.tuples(st.sampled_from(["add", "upsert", "delete", "update", "refresh",
                                          "merge"]),
                         st.integers(0, 2**31 - 1)), min_size=4, max_size=9)


@settings(max_examples=6, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ops=OPS)
def test_random_write_sequences(monkeypatch, ops):
    """add, upsert, delete, update, refresh and merge in any order over a
    pool of 80 ids: after every refresh the segment layout, the id map and
    the merge path's answers equal the reference's."""
    pair = Pair(merge_factor=4)
    next_id = 0
    for op, seed in ops + [("refresh", 0)]:
        rng = np.random.default_rng(seed)
        if op == "add":
            n = int(rng.integers(5, 30))
            pair.both("add_documents", make_docs(range(next_id, next_id + n), seed))
            next_id += n
        elif op == "upsert" and next_id:
            ids = rng.choice(next_id, size=min(next_id, 6), replace=False)
            pair.both("add_documents", make_docs(ids.tolist(), seed + 1))
        elif op == "delete" and next_id:
            ids = rng.choice(next_id + 3, size=min(next_id, 5), replace=False)
            pair.both("delete_by_id", [f"d{i}" for i in ids])
        elif op == "update":
            flushed = sorted(set(pair.ref._id_map) - set(pair.ref._buffer_ids))
            if flushed:
                pick = rng.choice(len(flushed), size=min(len(flushed), 4), replace=False)
                pair.both("update_doc_values", [
                    {"doc_id": flushed[i], "ts": str(int(rng.integers(0, 2**30))),
                     "price": str(float(np.float32(rng.uniform(0, 100))))} for i in pick])
        elif op in ("refresh", "merge"):
            if op == "merge":
                pair.ref.segments_per_tier = pair.port.segments_per_tier = 2
            ref, port = pair.refresh()
            pair.ref.segments_per_tier = pair.port.segments_per_tier = 4
            assert_same_state(pair)
            if port.segments:
                assert_same_answers(ref, port, monkeypatch, paths=("merge",))


def test_with_deletes_keeps_suggest_entries():
    """A divergence: the reference's ``Segment.with_deletes`` builds its new
    segment without the ``suggest`` entries (nrtsearch_tpu/core/segment.py:
    295-307 passes no ``suggest``), so a delete drops a committed segment's
    completion data; the port's keeps them. Everything else of the segment
    is the same on both sides."""
    import dataclasses

    pair = Pair()
    pair.both("add_documents", make_docs(range(10), seed=11))
    pair.refresh()
    entries = {"title_suggest": [(0, "alpha", 1, []), (3, "beta", 2, ["c"])]}
    ref_seg = dataclasses.replace(pair.ref.segments[0], suggest=entries)
    port_seg = dataclasses.replace(pair.port.segments[0], suggest=entries)
    ref_del, port_del = ref_seg.with_deletes([1, 3]), port_seg.with_deletes([1, 3])
    assert ref_del.suggest == {}
    assert port_del.suggest == entries
    assert layout([port_del]) == layout([ref_del])
    assert port_del.seg_id == port_seg.seg_id and port_del.live.device.type == "cpu"
