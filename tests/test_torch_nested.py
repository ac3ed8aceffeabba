"""Nested documents and the field types that came with term positions, on
the port vs the JAX reference, on the CPU.

One schema holds them all: an _ID, a TEXT ``title`` with a keyword child
field (``title.kw``) and ``indexPrefixes``, a POLYGON ``area`` (squares,
some with a hole), a CONTEXT_SUGGEST ``sugg`` and an OBJECT ``reviews``
with ``nestedDoc`` (0-4 children per parent: TEXT ``text``, INT
``stars``). The same seeded documents go through each package's
``IndexWriter`` (two segments) and, over real gRPC, through each package's
server.

Contract, engine and server alike: the same hits in the same order, the
same totals, and bit-equal scores (nested aggregation, completion weights
and constant scores are host numpy or exact f32 in both). Covered: nested
queries in the five score modes, top-level searches returning parents
only, a deleted parent taking its children, child-field and
indexPrefixes prefix queries, polygon containment (a point in a hole is
out), completion with and without contexts and fuzzy, suggest entries and
polygon columns through a merge, and served inner hits (``start_hit``,
``top_hits``, ``retrieve_fields``), a match-phrase with highlight, and a
delete then a forced merge.
"""

import json

import numpy as np
import pytest
from google.protobuf.json_format import ParseDict

from nrtsearch_tpu.client import NrtsearchClient as RefClient
from nrtsearch_tpu.config import NrtsearchConfig as RefConfig
from nrtsearch_tpu.core.merge import merge_segments as ref_merge
from nrtsearch_tpu.core.searcher import Searcher as RefSearcher
from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
from nrtsearch_tpu.gen import pb
from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu.schema.fields import create_field_def as ref_create_field_def
from nrtsearch_tpu.server.grpc_server import NrtsearchServer as RefServer
from nrtsearch_tpu_torch.client import NrtsearchClient
from nrtsearch_tpu_torch.config import NrtsearchConfig
from nrtsearch_tpu_torch.core.merge import merge_segments
from nrtsearch_tpu_torch.core.searcher import Searcher
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def
from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer
from torch_positional_data import (
    FIELDS, INDEX, NESTED_QUERIES, PARENTS, SERVED, add_requests, nested, nested_docs,
    nested_field_defs, plain, square,
)

@pytest.fixture(scope="module")
def writers():
    docs = nested_docs()
    ref = RefWriter(nested_field_defs(ref_create_field_def), merge_factor=100)
    port = IndexWriter(nested_field_defs(create_field_def), "cpu", merge_factor=100)
    for w in (ref, port):
        for lo, hi in ((0, 50), (50, PARENTS)):
            w.add_documents([dict(d) for d in docs[lo:hi]])
            w.refresh()
    assert len(ref.segments) == len(port.segments) == 2
    return ref, port


def _searchers(ref_segs, port_segs):
    return (RefSearcher(ref_segs, nested_field_defs(ref_create_field_def), version=1),
            Searcher(port_segs, nested_field_defs(create_field_def)))


def assert_same(want, got, ctx=""):
    assert [h.global_ord for h in got.hits] == [h.global_ord for h in want.hits], ctx
    assert (got.total_hits, got.relation) == (want.total_hits, want.relation), ctx
    np.testing.assert_array_equal(np.array([h.score for h in got.hits], np.float32),
                                  np.array([h.score for h in want.hits], np.float32),
                                  err_msg=ctx)


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
@pytest.mark.parametrize("mode", ["SUM", "AVG", "MAX", "MIN", "NONE"])
def test_nested_score_modes(writers, monkeypatch, mode, compiled):
    monkeypatch.setenv("NRT_COMPILED_EVAL", "1" if compiled else "0")
    ref, port = _searchers(writers[0].segments, writers[1].segments)
    q = nested(mode)
    want = ref.search(ref_parse_query(q), 100)
    assert want.total_hits > 0
    assert_same(want, port.search(parse_query(q), 100), mode)


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
@pytest.mark.parametrize("name", sorted(NESTED_QUERIES))
def test_query_matches_reference(writers, monkeypatch, name, compiled):
    monkeypatch.setenv("NRT_COMPILED_EVAL", "1" if compiled else "0")
    ref, port = _searchers(writers[0].segments, writers[1].segments)
    q = NESTED_QUERIES[name]
    want = ref.search(ref_parse_query(q), 100)
    assert want.total_hits > 0, name
    assert_same(want, port.search(parse_query(q), 100), name)


def test_top_level_returns_parents_only(writers):
    _, port = _searchers(writers[0].segments, writers[1].segments)
    td = port.search(parse_query({"matchAllQuery": {}}), 500)
    assert td.total_hits == PARENTS
    assert sum(s.num_docs for s in port.segments) > PARENTS


def test_polygon_hole_excludes_point():
    """A point inside a polygon's hole is not contained; inside the ring
    but outside the hole it is (both packages)."""
    results = []
    for writer, searcher_t, parse, create in (
            (IndexWriter, Searcher, parse_query, create_field_def),
            (RefWriter, RefSearcher, ref_parse_query, ref_create_field_def)):
        fds = {"area": create("area", {"type": "POLYGON", "storeDocValues": True})}
        w = writer(fds, "cpu") if writer is IndexWriter else writer(fds)
        w.add_documents([{"area": square(0.0, 0.0, 8.0, hole=True)},
                         {"area": square(0.0, 0.0, 8.0)}])
        s = searcher_t(w.refresh(), fds)
        for lat, lon in ((4.0, 4.0), (1.0, 1.0), (9.0, 9.0)):
            q = {"geoPointQuery": {"field": "area", "point": {"latitude": lat, "longitude": lon}}}
            results.append(sorted(h.global_ord for h in s.search(parse(q), 5).hits))
    assert results[:3] == [[1], [0, 1], []]
    assert results[:3] == results[3:]


def test_deleted_parent_takes_its_children(writers):
    """Deleting parents by id removes their blocks: the same live masks as
    the reference, and nested queries no longer find them."""
    docs = nested_docs()
    ref = RefWriter(nested_field_defs(ref_create_field_def), merge_factor=100)
    port = IndexWriter(nested_field_defs(create_field_def), "cpu", merge_factor=100)
    gone = [f"b{i}" for i in range(0, PARENTS, 6)]
    for w in (ref, port):
        w.add_documents([dict(d) for d in docs])
        w.refresh()
        w.delete_by_id(gone)
        w.refresh()
    for rs, ps in zip(ref.segments, port.segments):
        np.testing.assert_array_equal(ps.host_live, np.asarray(rs.host_live))
        assert ps.del_count > len(gone)      # children went with their parents
    r, p = _searchers(ref.segments, port.segments)
    for q in (nested("SUM"), {"matchAllQuery": {}}):
        assert_same(r.search(ref_parse_query(q), 100), p.search(parse_query(q), 100))


@pytest.mark.parametrize("flushed", [True, False], ids=["flushed", "buffered"])
def test_upsert_replaces_the_whole_block(flushed):
    """An upsert of a nested parent, of a flushed or of a still-buffered
    version, removes the old block (parent and children) as the
    reference's writer does: the same live masks and nested answers."""
    docs = nested_docs()[:20]
    new_version = dict(docs[3], reviews=[json.dumps({"text": "friendly friendly",
                                                     "stars": "5"})])
    writers = (RefWriter(nested_field_defs(ref_create_field_def), merge_factor=100),
               IndexWriter(nested_field_defs(create_field_def), "cpu", merge_factor=100))
    for w in writers:
        w.add_documents([dict(d) for d in docs])
        if flushed:
            w.refresh()
        w.add_documents([dict(new_version)])
        w.refresh()
    ref, port = writers
    for rs, ps in zip(ref.segments, port.segments):
        np.testing.assert_array_equal(ps.host_live, np.asarray(rs.host_live))
    assert sum(s.del_count for s in port.segments) == 1 + len(docs[3]["reviews"])
    r, p = _searchers(ref.segments, port.segments)
    for q in (nested("MAX", "friendly"), {"matchAllQuery": {}}):
        assert_same(r.search(ref_parse_query(q), 50), p.search(parse_query(q), 50))


def test_merge_with_a_segment_made_from_arrays_keeps_its_docs_roots():
    """A segment made from arrays (``convert.segment_from_numpy``) has no
    ``_nested_path`` column; merged with builder-made segments (which carry
    one) its docs stay top-level hits."""
    from nrtsearch_tpu_torch.convert import segment_from_numpy
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    fds = {"body": create_field_def("body", {"type": "TEXT", "search": True})}
    converted = segment_from_numpy(SyntheticCorpus(300, 50, 8, seed=1).segment_arrays(1)[0],
                                   "cpu")
    w = IndexWriter(fds, "cpu")
    w.add_documents([{"body": "1 2 3"}, {"body": "2 3 4"}])
    built = w.refresh()[0]
    merged, _ = merge_segments([converted, built], fds)
    assert len(merged.parent_positions()) == merged.num_docs == 302
    td = Searcher([merged], fds).search(parse_query({"matchAllQuery": {}}), 5)
    assert td.total_hits == 302


def test_merge_carries_suggest_and_polygons(writers):
    """Suggest entries and polygon columns survive a merge as in the
    reference. With deletes, the port's merge keeps every live doc's
    entries; the reference's ``with_deletes`` drops a segment's entries
    before its merge (ROADMAP §3, recorded), so that case is held to the
    port's own remap."""
    ref, port = writers
    ref_m, _ = ref_merge(ref.segments, nested_field_defs(ref_create_field_def))
    port_m, _ = merge_segments(port.segments, nested_field_defs(create_field_def))
    assert port_m.suggest == ref_m.suggest and port_m.suggest["sugg"]
    rdv, pdv = ref_m.doc_values["area"], port_m.doc_values["area"]
    np.testing.assert_array_equal(pdv.host_values, np.asarray(rdv.host_values))
    np.testing.assert_array_equal(pdv.host_present, np.asarray(rdv.host_present))
    assert pdv.ord_terms == rdv.ord_terms
    r, p = _searchers([ref_m], [port_m])
    for name in ("completion", "completion_contexts", "polygon_in", "prefix_companion",
                 "child_field_term", "phrase"):
        q = NESTED_QUERIES[name]
        assert_same(r.search(ref_parse_query(q), 100), p.search(parse_query(q), 100), name)
    for mode in ("SUM", "MAX"):
        assert_same(r.search(ref_parse_query(nested(mode)), 100),
                    p.search(parse_query(nested(mode)), 100), mode)
    segs = [port.segments[0].with_deletes(np.arange(0, 40, 9)), port.segments[1]]
    merged, remap = merge_segments(segs, nested_field_defs(create_field_def))
    want = [(int(remap[s.seg_id][d]), t, w, list(c)) for s in segs
            for d, t, w, c in s.suggest["sugg"] if remap[s.seg_id][d] >= 0]
    assert merged.suggest["sugg"] == want
    assert len(want) < sum(len(s.suggest["sugg"]) for s in segs)


# -- served: the port's gRPC server against the reference's -------------------


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
    docs = nested_docs()
    try:
        for name in ("ref", "port"):
            client = out[name][1]
            client.create_index(INDEX)
            client.register_fields(ParseDict({"indexName": INDEX, "field": FIELDS},
                                             pb.FieldDefRequest()))
            client.start_index(pb.StartIndexRequest(indexName=INDEX, mode=pb.Mode.STANDALONE))
            for lo, hi in ((0, 50), (50, PARENTS)):
                client.add_documents(add_requests(docs[lo:hi]))
                client.refresh(INDEX)
        yield out
    finally:
        for name in ("ref", "port"):
            srv, client = out[name]
            client.close()
            srv.stop()


def _answers(servers) -> dict:
    return {side: {name: plain(servers[side][1].search(make())) for name, make in SERVED.items()}
            for side in ("ref", "port")}


def test_served_answers_match_reference(servers):
    got = _answers(servers)
    for name in SERVED:
        assert got["port"][name] == got["ref"][name], name
        assert int(got["ref"][name]["totalHits"].get("value", 0)) > 0, name
    hits = got["port"]["inner_hits"]["hits"]
    assert any(h["innerHits"]["good_reviews"].get("hits") for h in hits)
    frag = got["port"]["phrase_highlight"]["hits"][0]["highlights"]["title"]["fragments"][0]
    assert "<b>green</b> <b>garden</b>" in frag or "<b>green garden</b>" in frag, frag


def test_served_delete_then_force_merge(servers):
    """Deleting parents over gRPC, then a forced merge: every answer still
    equals the reference's, and the deleted parents' blocks are gone. The
    completion answers are the recorded divergence (ROADMAP §3): the
    reference's ``with_deletes`` drops a segment's suggest entries, so its
    merged index completes nothing; the port keeps the live docs'."""
    for side in ("ref", "port"):
        client = servers[side][1]
        for i in range(1, PARENTS, 5):
            req = pb.AddDocumentRequest(indexName=INDEX)
            req.fields["biz_id"].value.append(f"b{i}")
            client.delete(req)
        client.refresh(INDEX)
        client.force_merge(INDEX, 1)
        client.refresh(INDEX)
    got = _answers(servers)
    for name in SERVED:
        if name.startswith("completion"):
            assert not got["ref"][name].get("hits") and got["port"][name]["hits"], name
            continue
        assert got["port"][name] == got["ref"][name], name
    ids = {h["fields"]["biz_id"]["fieldValue"][0]["textValue"]
           for h in got["port"]["nested_avg"]["hits"]}
    assert not ids & {f"b{i}" for i in range(1, PARENTS, 5)}
