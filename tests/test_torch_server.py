"""The port's gRPC server against the reference's, over real gRPC on the CPU.

Both servers start in-process on their own directories: the reference's
with JAX on the CPU, the port's with ``device="cpu"``. The same RPC script
goes through each: create, register (an _ID, a text field, config #3's
price / ts / tag doc values), 12 add/refresh rounds of a few hundred
documents made from a numpy seed with a small ``segmentsPerTier`` (both
sides merge), then searches: match, term, queryText, a config #3 tree, a
price sort, terms facets with flat collectors, ``startHit`` paging,
``searchAfter`` and ``retrieveFields``; then commit, stop and start.

Every answer is compared with ``diagnostics`` and the search-state
timestamp stripped: ``totalHits`` and its relation, ``luceneDocId`` order,
scores, ``sortedFields``, facet and collector results and retrieved fields.
On the CPU both sides serve the exact merge path, and each sequential
search is a batcher group of one query padded to 8 with empty specs, so
scores are bit-equal; a collector's f32 price sum adds in another order and
agrees within ``SUM_REL``. Searches sent by 16 client threads at once must
equal their sequential answers to ``CONCURRENT_REL`` relative (other group
sizes plan other merge widths, which may reorder the adds of one doc).
Shapes that once answered UNIMPLEMENTED (phrase, inner hits, kNN,
rescorers) answer as the reference's. The write RPCs (delete, an upsert, deleteByQuery,
UPDATE_DOC_VALUES, forceMergeDeletes) run on an index of their own on
both servers and answer alike.
"""

import threading

import grpc
import numpy as np
import pytest
from google.protobuf.json_format import MessageToDict

from nrtsearch_tpu.client import NrtsearchClient as RefClient
from nrtsearch_tpu.config import NrtsearchConfig as RefConfig
from nrtsearch_tpu.gen import pb
from nrtsearch_tpu.server.grpc_server import NrtsearchServer as RefServer
from nrtsearch_tpu_torch.client import NrtsearchClient
from nrtsearch_tpu_torch.config import NrtsearchConfig
from nrtsearch_tpu_torch.gen import pb as port_pb
from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer

INDEX = "served"
ROUNDS = 12
DOCS_PER_ROUND = 25
SEED = 11
SUM_REL = 1e-6
CONCURRENT_REL = 1e-6
WORDS = ["common", "alpha", "beta", "gamma", "delta", "needle", "haystack",
         "quick", "brown", "fox", "lazy", "dog", "tensor", "kernel", "merge"]


def test_one_wire_schema():
    """The port's generated messages are the reference's: one request
    object goes to both servers."""
    assert port_pb.SearchRequest is pb.SearchRequest
    assert port_pb.AddDocumentRequest is pb.AddDocumentRequest


def _fields():
    return [
        pb.Field(name="doc_id", type=pb.FieldType._ID, store=True, storeDocValues=True),
        pb.Field(name="body", type=pb.FieldType.TEXT, search=True, store=True),
        pb.Field(name="price", type=pb.FieldType.FLOAT, storeDocValues=True, sort=True),
        pb.Field(name="ts", type=pb.FieldType.FLOAT, storeDocValues=True, sort=True),
        pb.Field(name="tag", type=pb.FieldType.ATOM, storeDocValues=True),
        pb.Field(name="loc", type=pb.FieldType.LAT_LON, storeDocValues=True),
    ]


def _docs() -> list[dict]:
    rng = np.random.default_rng(SEED)
    # a point per doc inside one metro-sized box, from its own stream
    loc_rng = np.random.default_rng(SEED + 1)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    docs = []
    for i in range(ROUNDS * DOCS_PER_ROUND):
        words = rng.choice(WORDS, size=int(rng.integers(2, 9)), p=p)
        doc = {"doc_id": f"d{i}", "body": " ".join(words),
               "ts": str(float(np.float32(rng.uniform(0, 1e6)))),
               "tag": f"t{int(rng.integers(0, 5))}"}
        if i % 17:
            doc["price"] = str(float(np.float32(round(rng.uniform(0, 100), 2))))
        doc["loc"] = [str(round(float(loc_rng.uniform(37.6, 37.9)), 6)),
                      str(round(float(loc_rng.uniform(-122.55, -122.25)), 6))]
        docs.append(doc)
    return docs


def _add_requests(docs):
    for d in docs:
        req = pb.AddDocumentRequest(indexName=INDEX)
        for name, value in d.items():
            req.fields[name].value.extend(value if isinstance(value, list) else [value])
        yield req


def _drive_ingest(client) -> list:
    """createIndex ... 12 add/refresh rounds; returns the stats after each
    round."""
    client.create_index(INDEX)
    client.register_fields(pb.FieldDefRequest(indexName=INDEX, field=_fields()))
    ls = pb.LiveSettingsV2Request(indexName=INDEX)
    ls.liveSettings.segmentsPerTier.value = 3
    # no background refresh: segment boundaries follow the script alone
    ls.liveSettings.maxRefreshSec.value = 3600.0
    client.live_settings_v2(ls)
    client.start_index(pb.StartIndexRequest(indexName=INDEX, mode=pb.Mode.STANDALONE))
    docs = _docs()
    stats = []
    for r in range(ROUNDS):
        client.add_documents(_add_requests(docs[r * DOCS_PER_ROUND:(r + 1) * DOCS_PER_ROUND]))
        client.refresh(INDEX)
        st = client.stats(INDEX)
        stats.append((st.numDocs, st.currentSearcher.numSegments, st.currentSearcher.version))
    return stats


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    out = {}
    for name, server_t, config_t, client_t, kw in (
        ("ref", RefServer, RefConfig, RefClient, {}),
        ("port", NrtsearchServer, NrtsearchConfig, NrtsearchClient, {"device": "cpu"}),
    ):
        root = tmp_path_factory.mktemp(name)
        config = config_t.from_dict({"stateDir": str(root / "state"),
                                     "indexDir": str(root / "index")})
        srv = server_t(config, **kw)
        client = client_t(f"localhost:{srv.start(0)}")
        out[name] = (srv, client)
    try:
        out["stats"] = {name: _drive_ingest(out[name][1]) for name in ("ref", "port")}
        yield out
    finally:
        for name in ("ref", "port"):
            srv, client = out[name]
            client.close()
            srv.stop()


def _match(text: str, operator: str = "SHOULD", **kw) -> pb.SearchRequest:
    req = pb.SearchRequest(indexName=INDEX, **kw)
    req.query.matchQuery.field = "body"
    req.query.matchQuery.query = text
    if operator == "MUST":
        req.query.matchQuery.operator = pb.MatchOperator.MUST
    return req


def _config3_tree(text: str, **kw) -> pb.SearchRequest:
    from google.protobuf.json_format import ParseDict

    req = pb.SearchRequest(indexName=INDEX, **kw)
    ParseDict({"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": text}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "10",
                                                      "upper": "90"}}},
        {"occur": "MUST_NOT", "query": {"termQuery": {"field": "tag", "textValue": "t1"}}},
        {"occur": "MUST", "query": {"boost": 1.5, "termInSetQuery": {
            "field": "tag", "textTerms": {"terms": ["t0", "t2", "t3"]}}}},
    ]}}, req.query)
    return req


def _sorted(req: pb.SearchRequest, field: str, reverse: bool = False) -> pb.SearchRequest:
    sf = req.querySort.fields.sortedFields.add()
    sf.fieldName = field
    sf.reverse = reverse
    return req


def _faceted(req: pb.SearchRequest) -> pb.SearchRequest:
    f = req.facets.add()
    f.dim = "tag"
    f.topN = 10
    req.collectors["price_sum"].sum.field = "price"
    req.collectors["price_max"].max.field = "price"
    req.collectors["hits"].hitCount.SetInParent()
    req.collectors["tags"].terms.field = "tag"
    return req


def _term_req() -> pb.SearchRequest:
    req = pb.SearchRequest(indexName=INDEX, topHits=10, retrieveFields=["doc_id"])
    req.query.termQuery.field = "body"
    req.query.termQuery.textValue = "needle"
    return req


REQUESTS = {
    "match": lambda: _match("alpha needle", topHits=20, retrieveFields=["doc_id", "tag"]),
    "match_must": lambda: _match("common beta", "MUST", topHits=15),
    "term": _term_req,
    "query_text": lambda: pb.SearchRequest(indexName=INDEX, topHits=10,
                                           queryText="body:gamma"),
    "config3_tree": lambda: _config3_tree("common delta kernel", topHits=20,
                                          retrieveFields=["doc_id", "price", "ts"]),
    "price_sort": lambda: _sorted(_match("common quick", topHits=25,
                                         retrieveFields=["price"]), "price"),
    "tree_ts_sorted": lambda: _sorted(_config3_tree("alpha beta gamma", topHits=10),
                                      "ts", reverse=True),
    "faceted": lambda: _faceted(_match("common alpha lazy", topHits=10)),
    "faceted_tree": lambda: _faceted(_config3_tree("common dog", topHits=5)),
    "paged": lambda: _match("common alpha beta", topHits=12, startHit=5,
                            retrieveFields=["doc_id", "body"]),
    "search_v2": lambda: _match("haystack merge", topHits=10),
    # the general evaluator (ROADMAP item 8)
    "geo_radius_bool": lambda: _general({"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "common alpha"}}},
        {"occur": "FILTER", "query": {"geoRadiusQuery": {
            "field": "loc", "center": {"latitude": 37.75, "longitude": -122.4},
            "radius": "8 km"}}}]}}, topHits=15, retrieveFields=["doc_id", "loc"]),
    "function_score_script": lambda: _general({"functionScoreQuery": {
        "query": {"matchQuery": {"field": "body", "query": "common beta"}},
        "script": {"source": "_score * log(price + 1)"}}}, topHits=15),
    "virtual_fields": lambda: _virtual(_match("gamma delta", topHits=10)),
    # a range facet keeps the request off the in-dispatch reduce, so the
    # searcher answers with score-free arrays beside the virtual field
    "virtual_fields_range_facet": lambda: _price_ranges(
        _virtual(_match("common alpha", topHits=10))),
    "two_component_sort": lambda: _sorted(_sorted(_match("common", topHits=20),
                                                  "tag"), "ts"),
    "terminate_after": lambda: _match("common alpha", topHits=10, terminateAfter=7),
    "timeout_sec": lambda: _match("common beta gamma", topHits=10, timeoutSec=1000.0),
    "prefix": lambda: _general({"prefixQuery": {"field": "body", "prefix": "ha"}},
                               topHits=10, retrieveFields=["doc_id"]),
}


def _general(query: dict, **kw) -> pb.SearchRequest:
    from google.protobuf.json_format import ParseDict

    req = pb.SearchRequest(indexName=INDEX, **kw)
    ParseDict(query, req.query)
    return req


def _virtual(req: pb.SearchRequest) -> pb.SearchRequest:
    vf = req.virtualFields.add()
    vf.name = "price_x2"
    vf.script.source = "price * 2 + ts / 1000"
    req.retrieveFields.extend(["doc_id", "price_x2"])
    return req


def _price_ranges(req: pb.SearchRequest) -> pb.SearchRequest:
    facet = req.facets.add()
    facet.dim = "price"
    facet.name = "price_ranges"
    for label, lo, hi in (("low", 0, 40), ("high", 41, 1000)):
        r = facet.numericRange.add()
        r.label, r.min, r.max = label, lo, hi
        r.minInclusive = r.maxInclusive = True
    return req


def _plain(resp: pb.SearchResponse) -> dict:
    resp = type(resp).FromString(resp.SerializeToString())
    resp.ClearField("diagnostics")
    resp.searchState.ClearField("timestamp")
    return MessageToDict(resp)


def _search(client, name: str, req: pb.SearchRequest) -> pb.SearchResponse:
    if name == "search_v2":
        return client.search_v2(req)
    return client.search(req)


def _compare(ref: dict, port: dict, ctx: str) -> None:
    """Equal, but a sum collector within SUM_REL."""
    ref, port = dict(ref), dict(port)
    for res in (ref, port):
        res["collectorResults"] = dict(res.get("collectorResults", {}))
    for cname in ("price_sum",):
        r = ref["collectorResults"].pop(cname, None)
        p = port["collectorResults"].pop(cname, None)
        if r is None:
            assert p is None, ctx
            continue
        rv, pv = float(r["doubleResult"]), float(p["doubleResult"])
        assert abs(rv - pv) <= SUM_REL * abs(rv), (ctx, rv, pv)
    assert port == ref, ctx


def test_ingest_merges_on_both_sides(servers):
    ref, port = servers["stats"]["ref"], servers["stats"]["port"]
    assert port == ref
    segments = [s[1] for s in port]
    # 12 flushes under segmentsPerTier 3: the tiered policy merged
    assert max(segments) <= 3 < ROUNDS
    assert port[-1][0] == ROUNDS * DOCS_PER_ROUND
    st = servers["port"][0].global_state.runtimes[INDEX].stats()
    assert st["merges"] > 0 and st["merged_docs"] > 0


@pytest.mark.parametrize("name", list(REQUESTS))
def test_search_matches_reference(servers, name):
    ref = _search(servers["ref"][1], name, REQUESTS[name]())
    port = _search(servers["port"][1], name, REQUESTS[name]())
    assert port.totalHits.value > 0 and len(port.hits) > 0, name
    _compare(_plain(ref), _plain(port), name)


def test_search_after_matches_reference(servers):
    """A second page through the searchAfter cursor of the first."""
    pages = {}
    for side in ("ref", "port"):
        client = servers[side][1]
        first = client.search(_match("common beta", topHits=8))
        req = _match("common beta", topHits=8)
        req.searchAfter.lastScore = first.searchState.lastScore
        req.searchAfter.lastDocId = first.searchState.lastDocId
        req.searchAfter.lastHitIndex = first.searchState.lastHitInfo.lastHitIndex
        second = client.search(req)
        assert {h.luceneDocId for h in second.hits}.isdisjoint(
            h.luceneDocId for h in first.hits)
        pages[side] = (_plain(first), _plain(second))
    assert pages["port"] == pages["ref"]


def test_concurrent_searches_equal_sequential(servers):
    """16 client threads at once: the batcher groups them; each answer
    equals its sequential one."""
    client = servers["port"][1]
    texts = [f"{WORDS[i % len(WORDS)]} {WORDS[(3 * i + 1) % len(WORDS)]}" for i in range(16)]
    want = [client.search(_match(t, topHits=10)) for t in texts]
    batcher = servers["port"][0].handlers.batcher
    formed0 = batcher.batches_formed
    got = [None] * len(texts)
    barrier = threading.Barrier(len(texts))

    def one(i):
        barrier.wait(timeout=30)
        got[i] = client.search(_match(texts[i], topHits=10))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert batcher.batches_formed - formed0 < len(texts), "the batcher formed no group"
    for w, g, text in zip(want, got, texts):
        assert g.totalHits.value == w.totalHits.value, text
        assert [h.luceneDocId for h in g.hits] == [h.luceneDocId for h in w.hits], text
        ws = np.array([h.score for h in w.hits])
        gs = np.array([h.score for h in g.hits])
        np.testing.assert_allclose(gs, ws, rtol=CONCURRENT_REL, atol=0)


@pytest.fixture(scope="module")
def head_searcher():
    """A 600-doc CPU index whose every doc holds "common" (a head term of
    the fused path: df >= 256) beside the served index's words."""
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.schema import create_field_def

    fds = {"body": create_field_def("body", {"type": "TEXT", "search": True})}
    rng = np.random.default_rng(SEED + 1)
    w = IndexWriter(fds, "cpu")
    w.add_documents([{"body": "common " + " ".join(rng.choice(WORDS, 4))}
                     for _ in range(600)])
    return Searcher(w.refresh(), fds)


@pytest.mark.parametrize("path", ["merge", "fused"])
def test_empty_spec_pads_change_nothing(head_searcher, path, monkeypatch):
    """The batcher pads a group with empty specs (terms=()); on both paths a
    padded batch answers its real specs as the unpadded batch does, and the
    pads match nothing."""
    from nrtsearch_tpu_torch.core.packed_view import QuerySpec
    from nrtsearch_tpu_torch.query import parse_query

    monkeypatch.setenv("NRT_FAST_PATH", path)
    searcher = head_searcher
    specs = [searcher.compile_batchable(parse_query(
        {"matchQuery": {"field": "body", "query": q}}))
        for q in ("common needle", "alpha fox", "common")]
    pad = QuerySpec(field="body", terms=())
    view = searcher.packed_view("body")
    before = dict(view.path_counts)
    plain = searcher.fast_search_batch(specs, 16)
    padded = searcher.fast_search_batch(specs + [pad] * 5, 16)
    assert view.path_counts[path] == before[path] + 2 * len(specs) + 5 * (path == "fused")
    for a, b in zip(plain, padded):
        assert a.total_hits > 0
        assert (a.total_hits, a.relation) == (b.total_hits, b.relation)
        assert [(h.global_ord, h.score) for h in a.hits] == \
            [(h.global_ord, h.score) for h in b.hits]
    assert all(td.total_hits == 0 and not td.hits for td in padded[len(specs):])


def _phrase():
    req = pb.SearchRequest(indexName=INDEX, topHits=5)
    req.query.phraseQuery.field = "body"
    req.query.phraseQuery.terms.extend(["common", "alpha"])
    return req


def _knn():
    req = _match("alpha", topHits=5)
    knn = req.knn.add()
    knn.field = "body"
    knn.k = 5
    knn.query_vector.extend([0.1, 0.2])
    return req


def _rescored():
    req = _match("alpha", topHits=5)
    r = req.rescorers.add()
    r.windowSize = 5
    r.queryRescorer.rescoreQuery.matchQuery.field = "body"
    r.queryRescorer.rescoreQuery.matchQuery.query = "beta"
    return req


def _inner_hits():
    req = _match("alpha", topHits=5)
    req.inner_hits["kids"].query_nested_path = "kids"
    return req


def _outcome(client, req):
    """A search's plain answer, or its status code and the error's type."""
    try:
        return _plain(client.search(req))
    except grpc.RpcError as e:
        return (e.code(), e.details().split(":")[0])


@pytest.mark.parametrize("make", [_phrase, _knn, _rescored, _inner_hits],
                         ids=["phrase", "knn", "rescorer", "inner_hits"])
def test_unported_shapes_answer_unimplemented(servers, make):
    """Shapes that answered UNIMPLEMENTED naming their ROADMAP item until
    the item was ported: a phrase query and inner hits (item 10), a kNN
    clause (item 12) and a rescorer (item 9). Each now answers as the
    reference does (a kNN clause on a text field: NOT_FOUND on both)."""
    ref, port = (_outcome(servers[side][1], make()) for side in ("ref", "port"))
    assert port == ref, (port, ref)
    if make is _phrase:
        assert int(ref["totalHits"]["value"]) > 0


def test_unported_imports_answer_unimplemented(servers):
    """A schema VIRTUAL field reaches fetch's lazy import of the script
    evaluator. Before the general evaluator was ported the port answered
    UNIMPLEMENTED naming item 8; now it answers as the reference does."""
    answers = {}
    for side in ("ref", "port"):
        client = servers[side][1]
        client.create_index("virt")
        client.register_fields(pb.FieldDefRequest(indexName="virt", field=[
            pb.Field(name="body", type=pb.FieldType.TEXT, search=True),
            pb.Field(name="price", type=pb.FieldType.FLOAT, storeDocValues=True),
            pb.Field(name="twice", type=pb.FieldType.VIRTUAL,
                     script=pb.Script(lang="js", source="price * 2"))]))
        client.start_index(pb.StartIndexRequest(indexName="virt", mode=pb.Mode.STANDALONE))
        req = pb.AddDocumentRequest(indexName="virt")
        req.fields["body"].value.append("alpha")
        req.fields["price"].value.append("3")
        client.add_documents(iter([req]))
        client.refresh("virt")
        search = pb.SearchRequest(indexName="virt", topHits=5, retrieveFields=["twice"])
        search.query.matchQuery.field = "body"
        search.query.matchQuery.query = "alpha"
        answers[side] = _plain(client.search(search))
        client.stop_index("virt")
    assert answers["port"] == answers["ref"]
    assert answers["port"]["hits"][0]["fields"]["twice"]["fieldValue"][0]["doubleValue"] == 6.0


WRITES = "writes"


def _write_requests(index: str, docs, request_type=None):
    for d in docs:
        req = pb.AddDocumentRequest(indexName=index)
        if request_type is not None:
            req.requestType = request_type
        for name, value in d.items():
            req.fields[name].value.extend(value if isinstance(value, list) else [value])
        yield req


def test_unported_rpcs_answer_unimplemented(servers):
    """The write RPCs that answered UNIMPLEMENTED before the write path was
    ported, served now on an index of their own, port against reference:
    ``delete`` by id, an upsert of an indexed id, ``deleteByQuery``,
    ``addDocuments`` with UPDATE_DOC_VALUES, ``forceMergeDeletes``. After
    each refresh both servers answer alike, and no deleted or replaced
    version of a doc answers."""
    from google.protobuf.json_format import ParseDict

    docs = _docs()[:120]
    upserts = [dict(d, body="needle upserted " + d["body"]) for d in docs[20:30]]
    updates = [{"doc_id": d["doc_id"], "price": "987.5", "ts": "3"} for d in docs[40:45]]
    deleted = [d["doc_id"] for d in docs[:6]]
    by_query = pb.DeleteByQueryRequest(indexName=WRITES)
    ParseDict({"termQuery": {"field": "tag", "textValue": "t3"}}, by_query.query.add())

    def searches(client) -> list:
        reqs = [_match("common alpha needle", topHits=30, retrieveFields=["doc_id", "body"]),
                _sorted(_match("common", topHits=25, retrieveFields=["doc_id", "price"]),
                        "price", reverse=True),
                _general({"rangeQuery": {"field": "price", "lower": "900"}}, topHits=10,
                         retrieveFields=["doc_id"]),
                _faceted(_match("common beta", topHits=10))]
        for r in reqs:
            r.indexName = WRITES
        return [_plain(client.search(r)) for r in reqs]

    answers = {}
    for side in ("ref", "port"):
        client = servers[side][1]
        client.create_index(WRITES)
        client.register_fields(pb.FieldDefRequest(indexName=WRITES, field=_fields()))
        ls = pb.LiveSettingsV2Request(indexName=WRITES)
        ls.liveSettings.maxRefreshSec.value = 3600.0
        client.live_settings_v2(ls)
        client.start_index(pb.StartIndexRequest(indexName=WRITES, mode=pb.Mode.STANDALONE))
        steps = []
        for lo in (0, 60):
            client.add_documents(_write_requests(WRITES, docs[lo:lo + 60]))
            client.refresh(WRITES)
        for doc_id in deleted:
            req = pb.AddDocumentRequest(indexName=WRITES)
            req.fields["doc_id"].value.append(doc_id)
            client.delete(req)
        client.add_documents(_write_requests(WRITES, upserts))
        client.refresh(WRITES)
        steps.append(searches(client))
        client.delete_by_query(by_query)
        client.add_documents(_write_requests(WRITES, updates,
                                             pb.IndexingRequestType.UPDATE_DOC_VALUES))
        client.refresh(WRITES)
        steps.append(searches(client))
        client.force_merge_deletes(WRITES, do_wait=True)
        steps.append(searches(client))
        st = client.stats(WRITES)
        steps.append((st.numDocs, st.maxDoc, st.currentSearcher.numSegments))
        answers[side] = steps
        client.stop_index(WRITES)
    for i, (r, p) in enumerate(zip(answers["ref"][:-1], answers["port"][:-1])):
        for j, (rr, pp) in enumerate(zip(r, p)):
            _compare(rr, pp, f"step {i} search {j}")
    assert answers["port"][-1] == answers["ref"][-1]
    n_t3 = sum(1 for d in docs[6:] if d["tag"] == "t3")
    assert answers["port"][-1][0] == 120 - 6 - n_t3
    assert answers["port"][-1][0] == answers["port"][-1][1]   # forceMergeDeletes compacted
    t3 = {d["doc_id"] for d in docs if d["tag"] == "t3"}
    for i, step in enumerate(answers["port"][:-1]):
        gone = set(deleted) | (t3 if i else set())
        for resp in step:
            for hit in resp.get("hits", []):
                fields = hit.get("fields", {})
                if "doc_id" in fields:
                    assert fields["doc_id"]["fieldValue"][0]["textValue"] not in gone
                if "body" in fields and fields["doc_id"]["fieldValue"][0]["textValue"] in {
                        d["doc_id"] for d in upserts}:
                    assert "upserted" in fields["body"]["fieldValue"][0]["textValue"]
    updated = answers["port"][2][2]
    assert {h["fields"]["doc_id"]["fieldValue"][0]["textValue"] for h in updated["hits"]} == {
        d["doc_id"] for d in updates if d["doc_id"] not in t3}


def test_commit_stop_start_answers_the_same(servers):
    """commit, stopIndex, startIndex: the committed index opens from disk and
    answers bit for bit as before; so does the reference's."""
    names = ["match", "config3_tree", "price_sort", "faceted"]
    for side in ("ref", "port"):
        client = servers[side][1]
        before = [_plain(client.search(REQUESTS[n]())) for n in names]
        client.commit(INDEX)
        client.stop_index(INDEX)
        client.start_index(pb.StartIndexRequest(indexName=INDEX, mode=pb.Mode.STANDALONE))
        after = [_plain(client.search(REQUESTS[n]())) for n in names]
        for n, b, a in zip(names, before, after):
            b.pop("searchState", None)
            a.pop("searchState", None)
            assert a == b, (side, n)
    ref = [_plain(servers["ref"][1].search(REQUESTS[n]())) for n in names]
    port = [_plain(servers["port"][1].search(REQUESTS[n]())) for n in names]
    for n, r, p in zip(names, ref, port):
        _compare(r, p, n)


# ---------------------------------------------------------------------------
# the two faults a server makes real: first kernel build, first packed view
# ---------------------------------------------------------------------------


def _together(fn, n: int = 8) -> list:
    """``fn()`` in n threads released at once; their results in order."""
    out = [None] * n
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait(timeout=30)
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


def test_kernel_library_builds_once_under_threads(monkeypatch, tmp_path):
    """8 threads that reach their first kernel together build and bind the
    library once."""
    import ctypes
    import time
    from unittest import mock

    from nrtsearch_tpu_torch import kernels

    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return tmp_path / "kernels_fake.so"

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", mock.MagicMock(name="CDLL"))
    libs = _together(kernels._library)
    assert len(calls) == 1
    assert all(lib is libs[0] for lib in libs) and libs[0] is not None


def test_packed_view_built_once_under_threads(head_searcher, monkeypatch):
    """8 threads asking a fresh snapshot for the same field get one view,
    built once."""
    import time

    from nrtsearch_tpu_torch.core import packed_view
    from nrtsearch_tpu_torch.core.searcher import Searcher

    built = []
    real = packed_view.PackedFieldView

    class SlowView(real):
        def __init__(self, *a, **kw):
            built.append(1)
            time.sleep(0.2)
            super().__init__(*a, **kw)

    monkeypatch.setattr(packed_view, "PackedFieldView", SlowView)
    fresh = Searcher(head_searcher.segments, head_searcher.field_defs)
    views = _together(lambda: fresh.packed_view("body"))
    assert len(built) == 1
    assert all(v is views[0] for v in views)


def test_virtual_shards_serve_locally_on_one_device(head_searcher):
    """The runtime sets ``dist_shards`` from liveSettings.virtualShards; with
    one search device (the CPU) a snapshot at 2 shards answers on the local
    path, as the reference does with fewer than two devices, and builds no
    mesh."""
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.query import parse_query

    s = Searcher(head_searcher.segments, head_searcher.field_defs)
    node = parse_query({"matchQuery": {"field": "body", "query": "common"}})
    base = s.search(node, 5)
    assert base.total_hits == 600
    s.dist_shards = 2
    td = s.search(node, 5)
    assert (td.total_hits, td.relation) == (base.total_hits, base.relation)
    assert [(h.global_ord, h.score) for h in td.hits] == \
        [(h.global_ord, h.score) for h in base.hits]
    assert not s._dist_cache


# ---------------------------------------------------------------------------
# vector search and the result tail (ROADMAP items 12 and 9), served
# ---------------------------------------------------------------------------

VEC_INDEX = "vectors"
VDIMS = 12
VEC_DOCS = 180
VEC_DELETED = ("v3", "v77", "v150")
# kNN scores come from products that add in other orders in the two
# packages: tests/test_torch_knn.py holds a score within 4 f32 ulps of its
# scale S (the dot product's magnitude carried through the similarity).
# Here S is bounded once for the index: (|q| + |v|)^2 <= 4 max |x|^2 over
# its rows and queries (l2's S; the dot product's and cosine's are below
# it), times 2 summed clauses and a weight of at most 2; a score is held
# within that or 8 ulps relative, whichever is larger.
KNN_REL = 8 * 2.0 ** -23


def _vector_fields():
    quantized = pb.VectorIndexingOptions(type="hnsw_scalar_quantized")
    return [
        pb.Field(name="doc_id", type=pb.FieldType._ID, store=True, storeDocValues=True),
        pb.Field(name="body", type=pb.FieldType.TEXT, search=True, store=True),
        pb.Field(name="tag", type=pb.FieldType.ATOM, storeDocValues=True, search=True),
        pb.Field(name="price", type=pb.FieldType.FLOAT, storeDocValues=True),
        pb.Field(name="vec", type=pb.FieldType.VECTOR, vectorDimensions=VDIMS,
                 vectorSimilarity="l2_norm", store=True),
        pb.Field(name="vec_i8", type=pb.FieldType.VECTOR, vectorDimensions=VDIMS,
                 vectorSimilarity="dot_product", vectorIndexingOptions=quantized),
        pb.Field(name="vec_cos", type=pb.FieldType.VECTOR, vectorDimensions=VDIMS,
                 vectorSimilarity="cosine"),
    ]


def _vecs() -> np.ndarray:
    return np.random.default_rng(SEED + 7).normal(size=(VEC_DOCS, VDIMS)).astype(np.float32)


def _vector_docs() -> list[dict]:
    rng = np.random.default_rng(SEED + 8)
    vecs = _vecs()
    docs = []
    for i in range(VEC_DOCS):
        words = rng.choice(WORDS, size=int(rng.integers(3, 12)))
        doc = {"doc_id": f"v{i}", "body": " ".join(words), "tag": f"t{i % 5}",
               "price": str(float(np.float32(round(rng.uniform(0, 100), 2))))}
        if i % 13 != 6:                                 # a few docs hold no vectors
            for name, scale in (("vec", 1.0), ("vec_i8", 0.2), ("vec_cos", 3.0)):
                doc[name] = str([float(x) for x in vecs[i] * np.float32(scale)])
        docs.append(doc)
    return docs


@pytest.fixture(scope="module")
def vector_servers(servers):
    """The vector index on both servers: 3 add/refresh rounds of 60 docs,
    then 3 deletes by id and a refresh."""
    docs = _vector_docs()
    for side in ("ref", "port"):
        client = servers[side][1]
        client.create_index(VEC_INDEX)
        client.register_fields(pb.FieldDefRequest(indexName=VEC_INDEX, field=_vector_fields()))
        ls = pb.LiveSettingsV2Request(indexName=VEC_INDEX)
        ls.liveSettings.maxRefreshSec.value = 3600.0
        client.live_settings_v2(ls)
        client.start_index(pb.StartIndexRequest(indexName=VEC_INDEX, mode=pb.Mode.STANDALONE))
        for lo in range(0, VEC_DOCS, 60):
            client.add_documents(_write_requests(VEC_INDEX, docs[lo:lo + 60]))
            client.refresh(VEC_INDEX)
        for doc_id in VEC_DELETED:
            req = pb.AddDocumentRequest(indexName=VEC_INDEX)
            req.fields["doc_id"].value.append(doc_id)
            client.delete(req)
        client.refresh(VEC_INDEX)
    return servers


def _vreq(query: dict | None = None, **kw) -> pb.SearchRequest:
    from google.protobuf.json_format import ParseDict

    req = pb.SearchRequest(indexName=VEC_INDEX, **kw)
    if query is not None:
        ParseDict(query, req.query)
    return req


def _knn_clause(req, field: str, row: int, k: int = 10, filt: dict | None = None,
                boost: float = 0.0, scale: float = 1.0):
    from google.protobuf.json_format import ParseDict

    knn = req.knn.add()
    knn.field = field
    knn.query_vector.extend(float(x) for x in _vecs()[row] * np.float32(scale) + 0.05)
    knn.k = k
    knn.num_candidates = 4 * k
    if boost:
        knn.boost = boost
    if filt is not None:
        ParseDict(filt, knn.filter)
    return req


def _multi(blender: str | None, text: str = "common alpha", row: int = 11):
    req = _vreq(topHits=15, retrieveFields=["doc_id"])
    rt = req.multiRetriever.retrievers.add()
    rt.name = "text"
    rt.textRetriever.query.matchQuery.field = "body"
    rt.textRetriever.query.matchQuery.query = text
    rt.textRetriever.topHits = 30
    rv = req.multiRetriever.retrievers.add()
    rv.name = "vector"
    rv.boost = 2.0
    rv.knnRetriever.knnQuery.field = "vec"
    rv.knnRetriever.knnQuery.query_vector.extend(float(x) for x in _vecs()[row])
    rv.knnRetriever.knnQuery.k = 20
    rv.knnRetriever.knnQuery.num_candidates = 30
    b = req.multiRetriever.blender
    if blender == "rrf":
        b.weightedRrf.rankConstant = 30
    elif blender in ("SUM", "MAX", "AVG"):
        b.weightedScoreOrder.scoreMode = pb.WeightedScoreOrderBlender.ScoreMode.Value(blender)
    elif blender == "raw":
        b.scorelessRawMerge.SetInParent()
    return req


def _rescore(req, kind: str, window: int = 20):
    r = req.rescorers.add()
    r.windowSize = window
    if kind == "query":
        r.queryRescorer.rescoreQuery.matchQuery.field = "body"
        r.queryRescorer.rescoreQuery.matchQuery.query = "beta needle"
        r.queryRescorer.queryWeight = 0.5
        r.queryRescorer.rescoreQueryWeight = 3.0
    else:
        r.scriptRescorer.script.source = "_score * 2 + price / 10"
    return req


def _highlighted(req, phrase: bool = False):
    req.highlight.fields.append("body")
    req.highlight.settings.fragment_size.value = 30
    req.highlight.settings.max_number_of_fragments.value = 3
    if phrase:
        fs = req.highlight.field_settings["body"]
        fs.pre_tags.append("[")
        fs.post_tags.append("]")
        fs.highlight_query.matchPhraseQuery.field = "body"
        fs.highlight_query.matchPhraseQuery.query = "common alpha"
    return req


def _drill_sideways():
    req = _vreq({"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "common"}}},
        {"occur": "FILTER", "query": {"termQuery": {"field": "tag", "textValue": "t2"}}}]}},
        topHits=10, retrieveFields=["doc_id", "tag"])
    f = req.facets.add()
    f.dim = "tag"
    f.topN = 10
    return req


def _facet(req):
    f = req.facets.add()
    f.dim = "tag"
    f.topN = 5
    return req


VECTOR_REQUESTS = {
    "knn_f32": lambda: _knn_clause(_vreq(topHits=10, retrieveFields=[
        "doc_id", "vec", "vec_cos", "vec_i8"]), "vec", 21),
    "knn_i8_filtered": lambda: _knn_clause(
        _vreq(topHits=8, retrieveFields=["doc_id"]), "vec_i8", 40, k=8, scale=0.2,
        filt={"rangeQuery": {"field": "price", "upper": "60"}}),
    "knn_cos_term_filter": lambda: _knn_clause(
        _vreq(topHits=10, retrieveFields=["doc_id"]), "vec_cos", 5, scale=3.0,
        filt={"termQuery": {"field": "tag", "textValue": "t1"}}),
    "knn_two_clauses": lambda: _knn_clause(_knn_clause(
        _vreq(topHits=12), "vec", 60, boost=1.5), "vec_i8", 61, scale=0.2),
    "knn_faceted": lambda: _facet(_knn_clause(_vreq(topHits=10), "vec", 90)),
    "query_plus_knn": lambda: _knn_clause(
        _vreq({"matchQuery": {"field": "body", "query": "alpha needle"}}, topHits=15,
              retrieveFields=["doc_id"]), "vec", 100, k=10),
    "query_plus_knn_faceted": lambda: _facet(_knn_clause(
        _vreq({"matchQuery": {"field": "body", "query": "common"}}, topHits=10), "vec", 7)),
    "exact_vector_query": lambda: _vreq(
        {"exactVectorQuery": {"field": "vec", "queryFloatVector":
                              [float(x) for x in _vecs()[33]]}}, topHits=10),
    "multi_default_rrf": lambda: _multi(None),
    "multi_rrf": lambda: _multi("rrf"),
    "multi_sum": lambda: _multi("SUM"),
    "multi_max": lambda: _multi("MAX"),
    "multi_avg": lambda: _multi("AVG"),
    "multi_raw": lambda: _multi("raw"),
    "query_rescorer": lambda: _rescore(
        _vreq({"matchQuery": {"field": "body", "query": "common gamma"}}, topHits=15), "query"),
    "script_rescorer": lambda: _rescore(
        _vreq({"matchQuery": {"field": "body", "query": "common delta"}}, topHits=15), "script"),
    "knn_rescored": lambda: _rescore(_knn_clause(_vreq(topHits=10), "vec", 120, k=15),
                                     "script", window=10),
    "highlight": lambda: _highlighted(_vreq(
        {"matchQuery": {"field": "body", "query": "alpha needle kernel"}}, topHits=10)),
    "highlight_phrase_override": lambda: _highlighted(_vreq(
        {"matchQuery": {"field": "body", "query": "common"}}, topHits=10), phrase=True),
    "drill_sideways": _drill_sideways,
}


def _knn_abs() -> float:
    x = _vecs().astype(np.float64) + 0.05
    return 4 * 2.0 ** -23 * 4 * float(np.max(np.sum(x * x, axis=1))) * 2 * 2


KNN_ABS = _knn_abs()


def _close_scores(ref, port, ctx: str, path: str = "") -> None:
    """Equal, but scores (and searchState.lastScore) within KNN_ABS or
    KNN_REL relative."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (ctx, path)
        for k in ref:
            if k in ("score", "lastScore") and isinstance(ref[k], float):
                tol = max(KNN_ABS, KNN_REL * abs(ref[k]))
                assert abs(port[k] - ref[k]) <= tol, (ctx, path, k, port[k], ref[k])
            else:
                _close_scores(ref[k], port[k], ctx, f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), (ctx, path)
        for i, (r, p) in enumerate(zip(ref, port)):
            _close_scores(r, p, ctx, f"{path}[{i}]")
    else:
        assert port == ref, (ctx, path, port, ref)


@pytest.mark.parametrize("name", list(VECTOR_REQUESTS))
def test_vector_and_result_tail_match_reference(vector_servers, name):
    """kNN (three formats, filters, several clauses, facets), query + kNN,
    the exact vector query, the multi-retriever blends, the query and
    script rescorers, highlights and a drill-sideways facet, served by both
    servers: the port answers as the reference does."""
    ref = _plain(vector_servers["ref"][1].search(VECTOR_REQUESTS[name]()))
    port = _plain(vector_servers["port"][1].search(VECTOR_REQUESTS[name]()))
    assert port.get("hits"), name
    _close_scores(ref, port, name)
    if name.startswith("highlight"):
        assert any(h.get("highlights") for h in port["hits"]), name
    if name == "drill_sideways":
        counts = {lv["label"]: lv["value"] for lv in port["facetResult"][0]["labelValues"]}
        assert len(counts) > 1, counts          # the tag filter is left out of its own dim
    gone = set(VEC_DELETED)
    for hit in port["hits"]:
        doc = hit.get("fields", {}).get("doc_id")
        assert doc is None or doc["fieldValue"][0]["textValue"] not in gone


def test_vector_fetch_returns_the_stored_vector(vector_servers):
    """retrieveFields of vector fields: a stored one answers its stored
    list (one doubleValue per component, as the reference answers it); an
    unstored one its column's row as a vectorValue, the f32 row exactly and
    the int8 row dequantized, within half a quantization step."""
    resp = vector_servers["port"][1].search(VECTOR_REQUESTS["knn_f32"]())
    vecs = _vecs()
    for hit in resp.hits:
        i = int(hit.fields["doc_id"].fieldValue[0].textValue[1:])
        stored = [fv.doubleValue for fv in hit.fields["vec"].fieldValue]
        np.testing.assert_array_equal(np.float32(stored), vecs[i])
        cos = list(hit.fields["vec_cos"].fieldValue[0].vectorValue.value)
        np.testing.assert_array_equal(np.float32(cos), vecs[i] * np.float32(3.0))
        i8 = np.float32(list(hit.fields["vec_i8"].fieldValue[0].vectorValue.value))
        want = vecs[i] * np.float32(0.2)
        # a segment's step is its quantile scale, at most max |x| / 127
        half_step = float(np.abs(vecs * np.float32(0.2)).max()) / 254
        assert i8.shape == want.shape and np.abs(i8 - want).max() <= half_step * (1 + 1e-6)


def test_hybrid_search_over_grpc_matches_reference(servers):
    """tests/test_knn.py's three-document hybrid case: kNN only, then a
    text query with a kNN clause, on both servers."""
    answers = {}
    for side in ("ref", "port"):
        client = servers[side][1]
        client.create_index("hy")
        client.register_fields(pb.FieldDefRequest(indexName="hy", field=[
            pb.Field(name="id", type=pb.FieldType._ID, store=True),
            pb.Field(name="text", type=pb.FieldType.TEXT, search=True),
            pb.Field(name="v", type=pb.FieldType.VECTOR, vectorDimensions=4,
                     vectorSimilarity="l2_norm")]))
        client.start_index(pb.StartIndexRequest(indexName="hy", mode=pb.Mode.STANDALONE))
        reqs = []
        for i, t, v in (("0", "alpha tpu", [1, 0, 0, 0]), ("1", "beta tpu", [0, 1, 0, 0]),
                        ("2", "gamma other", [0.9, 0.1, 0, 0])):
            r = pb.AddDocumentRequest(indexName="hy")
            r.fields["id"].value.append(i)
            r.fields["text"].value.append(t)
            r.fields["v"].value.append(str(list(map(float, v))))
            reqs.append(r)
        client.add_documents(iter(reqs))
        client.refresh("hy")
        knn_only = pb.SearchRequest(indexName="hy", topHits=2, retrieveFields=["id"])
        knn = knn_only.knn.add()
        knn.field, knn.k = "v", 2
        knn.query_vector.extend([1.0, 0.0, 0.0, 0.0])
        hybrid = pb.SearchRequest(indexName="hy", topHits=3, retrieveFields=["id"])
        hybrid.query.matchQuery.field = "text"
        hybrid.query.matchQuery.query = "tpu"
        hybrid.knn.add().CopyFrom(knn)
        answers[side] = [_plain(client.search(r)) for r in (knn_only, hybrid)]
        client.stop_index("hy")
    ids = [[h["fields"]["id"]["fieldValue"][0]["textValue"] for h in a["hits"]]
           for a in answers["port"]]
    assert ids[0] == ["0", "2"] and ids[1][0] == "0" and set(ids[1]) == {"0", "1", "2"}
    for r, p in zip(answers["ref"], answers["port"]):
        _close_scores(r, p, "hybrid")


def _td_of(mod, *ords, scores=None):
    scores = scores or [1.0] * len(ords)
    return mod.TopDocs([mod.Hit(0, o, o, s) for o, s in zip(ords, scores)], len(ords))


BLENDS = {
    "rrf_ranks": lambda r, s: r.blend_rrf({"text": _td_of(s, 10, 20, 30)}, {"text": 1.0}, 60),
    "rrf_duplicate_sum": lambda r, s: r.blend_rrf({"text": _td_of(s, 5), "knn": _td_of(s, 5)},
                                                  {"text": 1.0, "knn": 1.0}, 60),
    "rrf_rank_constant": lambda r, s: r.blend_rrf({"text": _td_of(s, 1)}, {"text": 1.0}, 10),
    "rrf_boost": lambda r, s: r.blend_rrf({"text": _td_of(s, 1)}, {"text": 2.0}, 60),
    "rrf_empty": lambda r, s: r.blend_rrf({"text": _td_of(s)}, {"text": 1.0}),
    "weighted_sum": lambda r, s: r.blend_weighted_score(
        {"a": _td_of(s, 1, 2, 3, scores=[3.0, 2.0, 1.0]),
         "b": _td_of(s, 3, 4, scores=[5.0, 0.5])}, {"a": 1.0, "b": 0.5}, "SUM"),
    "weighted_max": lambda r, s: r.blend_weighted_score(
        {"a": _td_of(s, 1, 2, scores=[3.0, 2.0]), "b": _td_of(s, 2, 1, scores=[9.0, 1.0])},
        {"a": 2.0, "b": 1.0}, "MAX"),
    "weighted_avg": lambda r, s: r.blend_weighted_score(
        {"a": _td_of(s, 7, 8, scores=[1.5, 1.0]), "b": _td_of(s, 8, scores=[4.0])},
        {"a": 1.0, "b": 1.0}, "AVG"),
    "raw": lambda r, s: r.blend_raw({"a": _td_of(s, 3, 1), "b": _td_of(s, 1, 9, 3)},
                                    ["b", "a"]),
}


@pytest.mark.parametrize("name", list(BLENDS))
def test_blender_goldens_match_reference(name):
    """tests/test_lucene_goldens.py's weighted-RRF cases
    (WeightedRrfBlenderOperationTest) and the score and raw blenders on
    hand-made retriever results: the port's blends equal the reference's."""
    from nrtsearch_tpu.core import searcher as ref_searcher
    from nrtsearch_tpu.search import retrievers as ref_rtr
    from nrtsearch_tpu_torch.core import searcher as port_searcher
    from nrtsearch_tpu_torch.search import retrievers as port_rtr

    ref = BLENDS[name](ref_rtr, ref_searcher)
    port = BLENDS[name](port_rtr, port_searcher)
    assert [(h.global_ord, h.score) for h in port] == [(h.global_ord, h.score) for h in ref]


HIGHLIGHT_CASES = {
    "phrase_whole_span": ("the quick brown fox jumps while a lazy brown dog sleeps quick",
                          {"matchPhraseQuery": {"field": "body", "query": "quick brown"}}, {}),
    "phrase_consecutive": ("quick red brown things",
                           {"matchPhraseQuery": {"field": "body", "query": "quick brown"}}, {}),
    "distinct_terms": ("alpha alpha alpha alpha " + "filler " * 40 + "alpha beta gamma end",
                       {"matchQuery": {"field": "body", "query": "alpha beta gamma"}},
                       {"fragment_size": 40, "max_fragments": 1}),
    "boost_order": ("left part has rare word here " + "x " * 60 + "right part has common word",
                    {"booleanQuery": {"clauses": [
                        {"occur": "SHOULD", "query": {"termQuery": {
                            "field": "body", "textValue": "common"}}},
                        {"occur": "SHOULD", "query": {"termQuery": {
                            "field": "body", "textValue": "rare", "boost": 5.0}}}]}},
                    {"fragment_size": 30, "max_fragments": 2}),
    "prefix_settings": ("searching searches searched elsewhere",
                        {"prefixQuery": {"field": "body", "prefix": "search"}},
                        {"pre_tag": "[", "post_tag": "]", "fragment_size": 200}),
}


@pytest.mark.parametrize("name", list(HIGHLIGHT_CASES))
def test_highlight_cases_match_reference(name):
    """tests/test_highlight_fvh.py's cases through both highlighters."""
    from nrtsearch_tpu.query.plan import parse_query as ref_parse
    from nrtsearch_tpu.search import highlight as ref_hl
    from nrtsearch_tpu_torch.query import parse_query
    from nrtsearch_tpu_torch.search import highlight as port_hl

    text, query, settings = HIGHLIGHT_CASES[name]
    ref = ref_hl.highlight_text(text, ref_hl.build_highlight_query(ref_parse(query), "body"),
                                ref_hl.HighlightSettings(**settings))
    port = port_hl.highlight_text(text, port_hl.build_highlight_query(parse_query(query), "body"),
                                  port_hl.HighlightSettings(**settings))
    assert port == ref
    assert ref or name == "phrase_consecutive"
