"""NRT replication in the port, on the CPU: a primary publishes points to
the object store (``LocalFileBackend``), a replica installs them and swaps
its searcher. Mirrors tests/test_replication.py's cases, with port
runtimes on ``"cpu"``.

Every case drives ``sync_from_remote()`` on a replica whose poll thread was
never started; the poll-thread case waits for the poll thread's own
install and never syncs beside it (a test that does both races the two
installs, ROADMAP §3 fault 4).

Across the packages, one object store, one index id: a reference primary
(JAX, CPU) publishes a point that carries a delete and a port replica
installs it; a port primary publishes and a reference replica installs.
Each replica answers as a replica of its own package does: the same docs
in the same order and the same hit counts, the deleted doc gone, scores
bit-equal (both serve the exact merge path on the CPU, as
tests/test_torch_filtered.py holds it). Both directions also carry a point
written by the write path: deletes (a del_gen > 0 live file), an upsert and
a doc-value update (a new ``_dv`` segment).
"""

import time

import numpy as np
import pytest

from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu.remote.backend import LocalFileBackend as RefLocalFileBackend
from nrtsearch_tpu.server.index_runtime import IndexRuntime as RefIndexRuntime
from nrtsearch_tpu.state.index_state import IndexStateInfo as RefIndexStateInfo
from nrtsearch_tpu_torch.nrt.point_state import NrtPointState
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.remote.backend import LocalFileBackend
from nrtsearch_tpu_torch.server.index_runtime import IndexRuntime
from nrtsearch_tpu_torch.state.index_state import IndexStateInfo

FIELD_SPECS = {
    "doc_id": {"type": "_ID", "store": True, "storeDocValues": True},
    "body": {"type": "TEXT", "search": True, "store": True},
    "price": {"type": "INT", "storeDocValues": True},
}
INDEX_ID = "idx-abc123"
DOCS = [
    {"doc_id": "1", "body": "tpu native search engine", "price": "5"},
    {"doc_id": "2", "body": "segment replication over object store", "price": "9"},
    {"doc_id": "3", "body": "replicas never index anything", "price": "7"},
]
WORDS = ["common", "alpha", "beta", "gamma", "needle", "replica", "primary", "segment"]
QUERIES = [
    {"matchQuery": {"field": "body", "query": "alpha needle"}},
    {"matchQuery": {"field": "body", "query": "common replica segment"}},
    {"matchQuery": {"field": "body", "query": "gamma primary", "operator": "MUST"}},
    {"termQuery": {"field": "body", "textValue": "beta"}},
]


def make_info():
    return IndexStateInfo(index_name="idx", index_id=INDEX_ID).with_fields(FIELD_SPECS)


def make_ref_info():
    return RefIndexStateInfo(index_name="idx", index_id=INDEX_ID).with_fields(FIELD_SPECS)


@pytest.fixture()
def remote(tmp_path):
    return LocalFileBackend(tmp_path / "remote")


def make_primary(path, remote, primary_gen=1):
    rt = IndexRuntime(make_info(), path, mode="PRIMARY", remote=remote,
                      service_name="svc", primary_gen=primary_gen, device="cpu")
    return rt


def make_replica(path, remote):
    """A REPLICA runtime with no poll thread: the test drives
    sync_from_remote() itself."""
    return IndexRuntime(make_info(), path, mode="REPLICA", remote=remote,
                        service_name="svc", device="cpu")


def _seeded_docs(n: int, seed: int, start: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"doc_id": str(start + i),
             "body": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 7)))),
             "price": str(int(rng.integers(0, 100)))} for i in range(n)]


def _answers(searcher, parse, k: int = 10) -> list:
    """(hit count, [(global ord, doc_id, score bits)]) per query."""
    out = []
    for q in QUERIES:
        td = searcher.search(parse(q), k)
        hits = [(h.global_ord,
                 searcher.segments[h.segment_idx].stored[h.local_id]["doc_id"],
                 np.float32(h.score).view(np.int32).item()) for h in td.hits]
        out.append((td.total_hits, hits))
    return out


def test_primary_publishes_replica_installs(tmp_path, remote):
    primary = make_primary(tmp_path / "primary", remote)
    replica = make_replica(tmp_path / "replica", remote)
    try:
        primary.start()
        primary.add_documents([dict(d) for d in DOCS])
        primary.refresh()

        assert replica.sync_from_remote() is True
        assert replica.searcher.num_docs == 3
        assert replica.searcher.version == primary.searcher.version
        assert all(s.device.type == "cpu" for s in replica.searcher.segments)

        q = parse_query({"matchQuery": {"field": "body", "query": "replication"}})
        td = replica.searcher.search(q, 10)
        assert td.total_hits == 1
        seg = replica.searcher.segments[td.hits[0].segment_idx]
        assert seg.stored[td.hits[0].local_id]["doc_id"] == "2"

        with pytest.raises(PermissionError):
            replica.add_documents([dict(d) for d in DOCS])
        # no new point -> no-op sync
        assert replica.sync_from_remote() is False
    finally:
        primary.stop()
        replica.stop()


def test_incremental_points(tmp_path, remote):
    primary = make_primary(tmp_path / "primary", remote)
    replica = make_replica(tmp_path / "replica", remote)
    try:
        primary.start()
        primary.add_documents([dict(d) for d in DOCS])
        primary.refresh()
        assert replica.sync_from_remote() is True
        primary.add_documents([{"doc_id": "4", "body": "fresh new segment", "price": "1"}])
        primary.refresh()
        assert replica.sync_from_remote() is True
        assert replica.searcher.num_docs == 4
        assert replica.searcher.version == primary.searcher.version
        assert _answers(replica.searcher, parse_query) == _answers(primary.searcher, parse_query)
    finally:
        primary.stop()
        replica.stop()


def test_new_primary_restores_from_remote(tmp_path, remote):
    primary = make_primary(tmp_path / "primary", remote)
    primary.start()
    primary.add_documents([dict(d) for d in DOCS])
    primary.commit()
    primary.stop()

    # the primary dies; a new one in a fresh directory restores from the
    # object store (reference: RestoreIndex + NrtDataManager.restoreIfNeeded)
    new_primary = make_primary(tmp_path / "primary2", remote, primary_gen=2)
    replica = make_replica(tmp_path / "replica", remote)
    try:
        new_primary.start(restore=True)
        assert new_primary.searcher.num_docs == 3
        new_primary.add_documents([{"doc_id": "9", "body": "post failover doc", "price": "2"}])
        new_primary.refresh()

        assert replica.sync_from_remote() is True
        assert replica.searcher.num_docs == 4
        assert replica.primary_gen == 2
        q = parse_query({"matchQuery": {"field": "body", "query": "failover"}})
        assert replica.searcher.search(q, 10).total_hits == 1
    finally:
        new_primary.stop()
        replica.stop()


def test_replica_poll_thread(tmp_path, remote):
    """The poll thread installs the point on its own; the test only waits
    for it (and never calls sync_from_remote() beside it)."""
    primary = make_primary(tmp_path / "primary", remote)
    replica = make_replica(tmp_path / "replica_poll", remote)
    try:
        primary.start()
        replica._start_replica_poll(interval=0.05)
        primary.add_documents([dict(d) for d in DOCS])
        primary.refresh()
        deadline = time.time() + 10
        while time.time() < deadline and replica.searcher.num_docs != 3:
            time.sleep(0.05)
        assert replica.searcher.num_docs == 3
        assert replica.searcher.version == primary.searcher.version
    finally:
        primary.stop()
        replica.stop()
    assert not replica._poll_thread.is_alive()


def test_point_carries_file_metadata(tmp_path, remote):
    """NrtPointState carries per-file (length, crc32), like the reference's
    NrtFileMetaData in CopyState (luceneserver.proto:1211)."""
    primary = make_primary(tmp_path / "primary", remote)
    try:
        primary.start()
        primary.add_documents([dict(d) for d in DOCS])
        primary.refresh()
        point = primary.current_point()
        assert point.files and set(point.file_meta) == set(point.files)
        for name, (length, _crc) in point.file_meta.items():
            assert length == (tmp_path / "primary" / name).stat().st_size
        again = NrtPointState.from_json(point.to_json())
        assert again.file_meta == point.file_meta
    finally:
        primary.stop()


def test_stale_file_under_reused_name_is_recopied(tmp_path, remote):
    """A local file whose bytes do not match the point's length + crc is
    fetched again, not trusted by its name. The replica has no poll thread:
    its one install is the test's own sync_from_remote()."""
    primary = make_primary(tmp_path / "primary", remote)
    replica = make_replica(tmp_path / "replica", remote)
    try:
        primary.start()
        primary.add_documents([dict(d) for d in DOCS])
        primary.refresh()
        assert replica._poll_thread is None
        assert replica.sync_from_remote() is True

        # truncate one replica-side segment file in place (stale bytes), then
        # force a reinstall of the same point under a new primary gen
        point = primary.current_point()
        victim = next(f for f in point.files if f.endswith(".arrays.npz"))
        path = tmp_path / "replica" / victim
        good = path.read_bytes()
        path.write_bytes(good[: len(good) // 2])

        point.primary_gen += 1
        assert replica.install_point(point)
        assert path.read_bytes() == good
        q = parse_query({"matchQuery": {"field": "body", "query": "replication"}})
        assert replica.searcher.search(q, 5).total_hits == 1
    finally:
        primary.stop()
        replica.stop()


def test_seg_ids_are_process_unique():
    from nrtsearch_tpu_torch.core.segment import new_seg_id

    a, b = new_seg_id(), new_seg_id()
    assert a != b
    # the per-process random token guards against cross-restart collisions
    assert len(a.split("_")[1]) == 8


# ---------------------------------------------------------------------------
# across the packages: one object store, one index id
# ---------------------------------------------------------------------------


def test_port_replica_installs_reference_point_with_delete(tmp_path):
    """A reference primary publishes a point whose live mask drops a doc
    (a del-gen file); a port replica installs it and answers as a
    reference replica of the same point does."""
    ref_remote = RefLocalFileBackend(tmp_path / "remote")
    primary = RefIndexRuntime(make_ref_info(), tmp_path / "primary", mode="PRIMARY",
                              remote=ref_remote, service_name="svc", primary_gen=1)
    ref_replica = RefIndexRuntime(make_ref_info(), tmp_path / "ref_replica",
                                  mode="REPLICA", remote=ref_remote, service_name="svc")
    port_replica = make_replica(tmp_path / "port_replica",
                                LocalFileBackend(tmp_path / "remote"))
    try:
        primary.start()
        docs = _seeded_docs(120, seed=3)
        primary.add_documents(docs[:70])
        primary.refresh()
        primary.add_documents(docs[70:])
        primary.refresh()
        gone = next(d for d in docs if "alpha" in d["body"].split())["doc_id"]
        primary.delete_by_id([gone])
        primary.refresh()
        point = primary.current_point()
        assert any(dg > 0 for _sid, dg in point.segments), point.segments

        assert ref_replica.sync_from_remote() is True
        assert port_replica.sync_from_remote() is True
        assert port_replica.searcher.version == ref_replica.searcher.version
        assert port_replica.searcher.num_docs == ref_replica.searcher.num_docs == 119
        port = _answers(port_replica.searcher, parse_query)
        ref = _answers(ref_replica.searcher, ref_parse_query)
        assert port == ref
        assert all(gone != doc_id for _n, hits in port for _o, doc_id, _s in hits)
        q = {"termQuery": {"field": "doc_id", "textValue": gone}}
        assert port_replica.searcher.search(parse_query(q), 5).total_hits == 0
    finally:
        primary.stop()
        ref_replica.stop()
        port_replica.stop()


def test_reference_replica_installs_port_point(tmp_path):
    """A port primary publishes; a reference replica installs the point
    and answers as a port replica of the same point does."""
    primary = make_primary(tmp_path / "primary", LocalFileBackend(tmp_path / "remote"))
    port_replica = make_replica(tmp_path / "port_replica",
                                LocalFileBackend(tmp_path / "remote"))
    ref_replica = RefIndexRuntime(make_ref_info(), tmp_path / "ref_replica",
                                  mode="REPLICA",
                                  remote=RefLocalFileBackend(tmp_path / "remote"),
                                  service_name="svc")
    try:
        primary.start()
        docs = _seeded_docs(120, seed=5)
        primary.add_documents(docs[:50])
        primary.refresh()
        primary.add_documents(docs[50:])
        primary.refresh()

        assert ref_replica.sync_from_remote() is True
        assert port_replica.sync_from_remote() is True
        assert ref_replica.searcher.version == primary.searcher.version
        assert ref_replica.searcher.num_docs == 120
        port = _answers(port_replica.searcher, parse_query)
        assert _answers(ref_replica.searcher, ref_parse_query) == port
        assert _answers(primary.searcher, parse_query) == port
    finally:
        primary.stop()
        port_replica.stop()
        ref_replica.stop()


PRICE_QUERY = {"rangeQuery": {"field": "price", "lower": "1000"}}


def _write_path_point(primary, seed: int) -> list:
    """Two flushed segments, then a delete by id, an upsert and a price
    update in the first, and a refresh: the point carries a del_gen > 0
    segment and a ``_dv`` segment. Returns the deleted ids."""
    docs = _seeded_docs(120, seed=seed)
    primary.add_documents([dict(d) for d in docs[:70]])
    primary.refresh()
    primary.add_documents([dict(d) for d in docs[70:]])
    primary.refresh()
    gone = [d["doc_id"] for d in docs if "alpha" in d["body"].split()][:2]
    primary.delete_by_id(gone)
    primary.add_documents([{"doc_id": "75", "body": "needle upserted", "price": "3"}])
    primary.update_doc_values([{"doc_id": "4", "price": "1234"}])
    primary.refresh()
    point = primary.current_point()
    assert any(dg > 0 for _sid, dg in point.segments), point.segments
    assert any(sid.endswith("_dv") for sid, _dg in point.segments), point.segments
    return gone


def _price_hits(searcher, parse) -> list:
    td = searcher.search(parse(PRICE_QUERY), 5)
    return [searcher.segments[h.segment_idx].stored[h.local_id]["doc_id"] for h in td.hits]


def test_reference_replica_installs_port_point_with_deletes_and_updates(tmp_path):
    """A port primary deletes, upserts and updates doc values; a reference
    replica installs the point and answers as a port replica does."""
    primary = make_primary(tmp_path / "primary", LocalFileBackend(tmp_path / "remote"))
    port_replica = make_replica(tmp_path / "port_replica",
                                LocalFileBackend(tmp_path / "remote"))
    ref_replica = RefIndexRuntime(make_ref_info(), tmp_path / "ref_replica",
                                  mode="REPLICA",
                                  remote=RefLocalFileBackend(tmp_path / "remote"),
                                  service_name="svc")
    try:
        primary.start()
        gone = _write_path_point(primary, seed=7)
        assert ref_replica.sync_from_remote() is True
        assert port_replica.sync_from_remote() is True
        assert ref_replica.searcher.num_docs == port_replica.searcher.num_docs == 118
        port = _answers(port_replica.searcher, parse_query)
        assert _answers(ref_replica.searcher, ref_parse_query) == port
        assert _answers(primary.searcher, parse_query) == port
        assert all(doc_id not in gone for _n, hits in port for _o, doc_id, _s in hits)
        assert _price_hits(ref_replica.searcher, ref_parse_query) == ["4"]
        assert _price_hits(port_replica.searcher, parse_query) == ["4"]
    finally:
        primary.stop()
        port_replica.stop()
        ref_replica.stop()


def test_port_replica_installs_reference_point_with_deletes_and_updates(tmp_path):
    """The reverse: a reference primary deletes, upserts and updates doc
    values; a port replica installs the point and answers as a reference
    replica does."""
    ref_remote = RefLocalFileBackend(tmp_path / "remote")
    primary = RefIndexRuntime(make_ref_info(), tmp_path / "primary", mode="PRIMARY",
                              remote=ref_remote, service_name="svc", primary_gen=1)
    ref_replica = RefIndexRuntime(make_ref_info(), tmp_path / "ref_replica",
                                  mode="REPLICA", remote=ref_remote, service_name="svc")
    port_replica = make_replica(tmp_path / "port_replica",
                                LocalFileBackend(tmp_path / "remote"))
    try:
        primary.start()
        gone = _write_path_point(primary, seed=9)
        assert ref_replica.sync_from_remote() is True
        assert port_replica.sync_from_remote() is True
        assert port_replica.searcher.num_docs == ref_replica.searcher.num_docs == 118
        port = _answers(port_replica.searcher, parse_query)
        assert _answers(ref_replica.searcher, ref_parse_query) == port
        assert all(doc_id not in gone for _n, hits in port for _o, doc_id, _s in hits)
        assert _price_hits(port_replica.searcher, parse_query) == ["4"]
        # the replica's writer maps ids as the primary's does
        assert port_replica.writer._id_map.keys() == primary.writer._id_map.keys()
    finally:
        primary.stop()
        ref_replica.stop()
        port_replica.stop()


# ---------------------------------------------------------------------------
# vector columns ride the segment files
# ---------------------------------------------------------------------------

VDIMS = 8
VECTOR_SPECS = {
    f"v_{fmt}": {"type": "VECTOR", "vectorDimensions": VDIMS, "vectorSimilarity": sim,
                 "vectorIndexingOptions": fmt}
    for fmt, sim in (("float32", "l2_norm"), ("float16", "cosine"), ("int8", "dot_product"))}
VECTOR_FIELDS = list(VECTOR_SPECS)


def _vector_docs(n: int, seed: int) -> list[dict]:
    docs = _seeded_docs(n, seed)
    vecs = np.random.default_rng(seed + 1).normal(size=(n, VDIMS)).astype(np.float32)
    for d, v in zip(docs, vecs):
        for name in VECTOR_FIELDS:
            d[name] = v.tolist()
    return docs


def _knn_answers(searcher) -> list:
    """(total, [(global ord, doc_id, score)]) of a kNN per vector field,
    filtered and not."""
    q = np.random.default_rng(77).normal(size=VDIMS).astype(np.float32)
    out = []
    for name in VECTOR_FIELDS:
        for filt in (None, {"rangeQuery": {"field": "price", "upper": "60"}}):
            parse = parse_query if "nrtsearch_tpu_torch" in type(searcher).__module__ \
                else ref_parse_query
            td = searcher.knn_search(name, q, 10,
                                     filter_node=parse(filt) if filt else None)
            out.append((td.total_hits, [
                (h.global_ord, searcher.segments[h.segment_idx].stored[h.local_id]["doc_id"],
                 h.score) for h in td.hits]))
    return out


def _close(port: list, ref: list) -> None:
    """Equal hits and totals; scores within 8 f32 ulps (the two packages'
    products add in other orders, tests/test_torch_knn.py)."""
    assert [(t, [h[:2] for h in hits]) for t, hits in port] == \
        [(t, [h[:2] for h in hits]) for t, hits in ref]
    for (_t, ph), (_u, rh) in zip(port, ref):
        np.testing.assert_allclose([h[2] for h in ph], [h[2] for h in rh],
                                   rtol=8 * 2.0 ** -23, atol=0)


def test_replica_syncs_vector_commit_and_answers_knn(tmp_path):
    """A port primary with f32, bf16 and int8 vector fields publishes two
    refreshes and a delete; a port replica installs the point and answers
    kNN bit for bit as the primary does; a reference replica of the same
    point answers alike (scores to 8 ulps). Then a reference primary's
    point reaches a port replica, which answers as a reference replica."""
    primary = IndexRuntime(make_info().with_fields(VECTOR_SPECS), tmp_path / "primary",
                           mode="PRIMARY", remote=LocalFileBackend(tmp_path / "remote"),
                           service_name="svc", primary_gen=1, device="cpu")
    replica = IndexRuntime(make_info().with_fields(VECTOR_SPECS), tmp_path / "replica",
                           mode="REPLICA", remote=LocalFileBackend(tmp_path / "remote"),
                           service_name="svc", device="cpu")
    ref_replica = RefIndexRuntime(make_ref_info().with_fields(VECTOR_SPECS),
                                  tmp_path / "ref_replica", mode="REPLICA",
                                  remote=RefLocalFileBackend(tmp_path / "remote"),
                                  service_name="svc")
    try:
        primary.start()
        docs = _vector_docs(90, seed=12)
        primary.add_documents(docs[:50])
        primary.refresh()
        primary.add_documents(docs[50:])
        primary.refresh()
        primary.delete_by_id(["3", "60"])
        primary.refresh()
        assert replica.sync_from_remote() is True
        assert ref_replica.sync_from_remote() is True
        assert replica.searcher.num_docs == 88
        seg = replica.searcher.segments[0]
        assert {seg.vectors[n].fmt for n in VECTOR_FIELDS} == {"float32", "float16", "int8"}
        port = _knn_answers(replica.searcher)
        assert port == _knn_answers(primary.searcher)
        assert all(doc_id not in ("3", "60") for _t, hits in port for _o, doc_id, _s in hits)
        _close(port, _knn_answers(ref_replica.searcher))
    finally:
        primary.stop()
        replica.stop()
        ref_replica.stop()

    ref_primary = RefIndexRuntime(make_ref_info().with_fields(VECTOR_SPECS),
                                  tmp_path / "ref_primary", mode="PRIMARY",
                                  remote=RefLocalFileBackend(tmp_path / "remote2"),
                                  service_name="svc", primary_gen=1)
    port_replica = IndexRuntime(make_info().with_fields(VECTOR_SPECS), tmp_path / "replica2",
                                mode="REPLICA", remote=LocalFileBackend(tmp_path / "remote2"),
                                service_name="svc", device="cpu")
    try:
        ref_primary.start()
        ref_primary.add_documents(_vector_docs(70, seed=13))
        ref_primary.refresh()
        assert port_replica.sync_from_remote() is True
        _close(_knn_answers(port_replica.searcher), _knn_answers(ref_primary.searcher))
    finally:
        ref_primary.stop()
        port_replica.stop()
