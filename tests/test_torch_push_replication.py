"""Push-model NRT replication between two of the port's servers over real
gRPC, on the CPU (``device="cpu"``). Mirrors tests/test_push_replication.py:
a replica registers with addReplicas, the primary pushes newNRTPoint on
refresh, the replica copies files with recvCopyState / recvRawFile and
swaps its searcher; acked copy, merge pre-copy, bandwidth pacing and
compression. The reference's cases that delete on the primary keep the
shape with adds only that they took before the write path was ported;
tests/test_torch_replication.py carries points with deletes and doc-value
updates in both directions.

The servers of one configuration start once per module (``clusters``) and
each test runs on an index of its own, started PRIMARY on one node and
REPLICA on the other after the replica reloads the shared state.

Also: tests/test_replication_fault_dense.py's fault cases that need no
delete (a replica that misses points while down and re-syncs, and a new
primary incarnation), with the fused path serving; and a port replica
connected to a reference primary's replication port.
"""

import time

import grpc
import pytest

from nrtsearch_tpu_torch.client import NrtsearchClient
from nrtsearch_tpu_torch.config import NrtsearchConfig
from nrtsearch_tpu_torch.gen import pb
from nrtsearch_tpu_torch.remote.backend import LocalFileBackend
from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer
from nrtsearch_tpu_torch.server.replication import ReplicationClient
from nrtsearch_tpu_torch.state.backend import LocalStateBackend
from nrtsearch_tpu_torch.state.global_state import GlobalState

FIELDS = [
    pb.Field(name="doc_id", type=pb.FieldType._ID, store=True),
    pb.Field(name="body", type=pb.FieldType.TEXT, search=True, store=True),
]
CONFIGS = {
    "plain": {},
    "acked": {"FileCopyConfig": {"ackedCopy": True, "ackEvery": 2, "maxInFlight": 4}},
    "paced": {"FileCopyConfig": {"maxCopyMBPerSec": 1.0, "maxConcurrentCopies": 2}},
    "gzip": {"compressionType": "gzip"},
}


def _doc(index, doc_id, body):
    r = pb.AddDocumentRequest(indexName=index)
    r.fields["doc_id"].value.append(doc_id)
    r.fields["body"].value.append(body)
    return r


def _server(root, name, extra, state=None, index_dir=None, remote=None):
    config = NrtsearchConfig.from_dict({
        "stateDir": state or f"{root}/{name}_state",
        "indexDir": index_dir or f"{root}/{name}_index", "nodeName": name, **extra})
    gs = None
    if remote is not None:
        gs = GlobalState(config, LocalStateBackend(config.state_dir), remote=remote,
                         device="cpu")
    server = NrtsearchServer(config, gs, device="cpu")
    return server, NrtsearchClient(f"localhost:{server.start(0)}")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """``get(kind)``: a primary and a replica server sharing one state
    directory, started on first use with CONFIGS[kind] on both (pacing on
    the primary only); all stopped at the module's end."""
    made, started = {}, []

    def get(kind):
        if kind not in made:
            root = tmp_path_factory.mktemp(kind)
            extra = CONFIGS[kind]
            primary, p_client = _server(root, "primary", extra, state=f"{root}/state")
            started.append((primary, p_client))
            replica, r_client = _server(root, "replica", {} if kind == "paced" else extra,
                                        state=f"{root}/state")
            started.append((replica, r_client))
            made[kind] = (primary, p_client, replica, r_client)
        return made[kind]

    yield get
    for server, client in started:
        client.close()
        server.stop()


def _pair(cluster, index):
    """``index`` created and started PRIMARY (primaryGen 1) on the primary,
    REPLICA on the replica, connected to the primary."""
    primary, p_client, replica, r_client = cluster
    p_client.create_index(index)
    p_client.register_fields(pb.FieldDefRequest(indexName=index, field=FIELDS))
    p_client.start_index(pb.StartIndexRequest(indexName=index, mode=pb.Mode.PRIMARY,
                                              primaryGen=1))
    r_client.reload_state()
    r_client.start_index(pb.StartIndexRequest(
        indexName=index, mode=pb.Mode.REPLICA,
        primaryAddress=f"localhost:{primary.replication_port}"))
    return cluster


def _wait_docs(client, index, n, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if client.stats(index).numDocs == n:
            return True
        time.sleep(0.05)
    return client.stats(index).numDocs == n


def _match(index, text, k=10, **kw):
    req = pb.SearchRequest(indexName=index, topHits=k, retrieveFields=["doc_id"], **kw)
    req.query.matchQuery.field = "body"
    req.query.matchQuery.query = text
    return req


def test_push_replication_end_to_end(clusters):
    primary, p_client, replica, r_client = _pair(clusters("plain"), "e2e")
    p_client.add_documents([_doc("e2e", "1", "tpu segment replication works"),
                            _doc("e2e", "2", "replicas never index documents")])
    p_client.refresh("e2e")  # publishes the point and pushes newNRTPoint
    assert _wait_docs(r_client, "e2e", 2)
    resp = r_client.search(_match("e2e", "replication"))
    assert resp.totalHits.value == 1
    assert resp.hits[0].fields["doc_id"].fieldValue[0].textValue == "1"
    rt = replica.global_state.runtimes["e2e"]
    assert rt.mode == "REPLICA" and all(s.device.type == "cpu" for s in rt.searcher.segments)

    # incremental point
    p_client.add_documents([_doc("e2e", "3", "another fresh replication document")])
    p_client.refresh("e2e")
    assert _wait_docs(r_client, "e2e", 3)
    assert r_client.search(_match("e2e", "replication")).totalHits.value == 2

    # the replica rejects writes
    with pytest.raises(grpc.RpcError) as e:
        r_client.add_documents([_doc("e2e", "9", "nope")])
    assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION


def test_replication_service_rpcs(clusters, tmp_path):
    primary, p_client, replica, r_client = _pair(clusters("plain"), "rpcs")
    p_client.add_documents([_doc("rpcs", "1", "hello world")])

    rc = ReplicationClient(f"localhost:{primary.replication_port}")
    try:
        # writeNRTPoint forces a refresh on the primary
        v = rc.write_nrt_point("rpcs")
        assert v.didRefresh
        state = rc.recv_copy_state("rpcs")
        assert state.version == v.version
        files = [fm.fileName for fm in state.filesMetadata.fileMetadata]
        assert len(files) >= 3  # arrays + meta + live per segment
        assert state.filesMetadata.numFiles == len(files)
        # getNodesInfo lists the registered replica
        assert len(rc.get_nodes_info("rpcs").nodes) == 1
        # raw file streaming, with the checksum footer last
        chunks = list(rc.recv_raw_file("rpcs", files[0]))
        assert sum(len(c.content) for c in chunks) > 0 and chunks[-1].ack
    finally:
        rc.close()

    rrc = ReplicationClient(f"localhost:{replica.replication_port}")
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            rv = rrc.replica_current_searching_version("rpcs")
            if rv.version >= v.version:
                break
            time.sleep(0.05)
        assert rv.version >= v.version
        # sendRawFile: a pushed file lands in the replica's index directory
        src = tmp_path / "pushed.bin"
        src.write_bytes(bytes(range(256)) * 300)
        status = rrc.send_raw_file("rpcs", "pushed.bin", src)
        assert status.Code == pb.TransferStatusCode.Done, status.Message
        r_dir = replica.global_state.runtimes["rpcs"].index_dir
        assert (r_dir / "pushed.bin").read_bytes() == src.read_bytes()
    finally:
        rrc.close()


def test_dead_replica_pruned(clusters):
    """A registered replica whose replication port answers nothing is
    pruned at the next publish; the live replica stays registered."""
    primary, p_client, replica, r_client = _pair(clusters("plain"), "dead")
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        dead_port = sock.getsockname()[1]
    rc = ReplicationClient(f"localhost:{primary.replication_port}")
    try:
        index_id = primary.global_state.get_state("dead").index_id
        rc.add_replicas("dead", index_id, "localhost", dead_port, 7)
        assert len(rc.get_nodes_info("dead").nodes) == 2
        svc = primary.replication_service
        deadline = time.time() + 10
        i = 0
        while time.time() < deadline and len(svc.replicas.get("dead", {})) > 1:
            p_client.add_documents([_doc("dead", str(i), "doc after replica death")])
            p_client.refresh("dead")
            i += 1
            time.sleep(0.1)
        nodes = rc.get_nodes_info("dead").nodes
        assert [n.port for n in nodes] == [replica.replication_port]
    finally:
        rc.close()
    assert _wait_docs(r_client, "dead", i)


def test_acked_copy_replication(clusters):
    primary, p_client, replica, r_client = _pair(clusters("acked"), "acked")
    p_client.add_documents([_doc("acked", str(i), f"acked copy doc {i} " + "pad " * 50)
                            for i in range(50)])
    p_client.refresh("acked")
    assert _wait_docs(r_client, "acked", 50)
    assert r_client.search(_match("acked", "acked")).totalHits.value == 50


def test_merge_precopy_warms_replicas(clusters):
    primary, p_client, replica, r_client = _pair(clusters("plain"), "merge")
    primary.handlers.gs.get_runtime("merge").writer.segments_per_tier = 2
    # several refreshes force tiered merges: "_m." files in later points
    for i in range(5):
        p_client.add_documents([_doc("merge", str(i), f"warm doc {i}")])
        p_client.refresh("merge")
    assert _wait_docs(r_client, "merge", 5)
    warmed = primary.replication_service._warmed_files.get("merge", set())
    assert any("_m." in f for f in warmed)  # merged files were pre-copied
    r_dir = replica.handlers.gs.get_runtime("merge").index_dir
    for f in warmed:
        assert (r_dir / f).exists(), f


def test_acked_copy_window_engages(clusters, monkeypatch):
    # small chunks: each file spans many chunks, and the in-flight window
    # (maxInFlight 4, ackEvery 2) throttles the sender
    import nrtsearch_tpu_torch.server.replication as repl

    monkeypatch.setattr(repl, "CHUNK_SIZE", 1024)
    primary, p_client, replica, r_client = _pair(clusters("acked"), "window")
    body = "window " * 400  # ~2.8 KB per doc
    p_client.add_documents([_doc("window", str(i), f"{body} doc {i}") for i in range(60)])
    p_client.refresh("window")
    assert _wait_docs(r_client, "window", 60, timeout=15.0)
    assert r_client.search(_match("window", "window", k=5)).totalHits.value == 60


def test_copy_bandwidth_pacing(clusters):
    # maxCopyMBPerSec paces the outbound stream: a ~0.5 MB copy at 1 MB/s
    # takes >= ~0.3 s (conservative against the 0.5 s floor)
    primary, p_client, replica, r_client = _pair(clusters("paced"), "paced")
    body = "bandwidth " * 120  # ~1.2 KB per doc
    t0 = time.time()
    p_client.add_documents([_doc("paced", str(i), f"{body} {i}") for i in range(400)])
    p_client.refresh("paced")
    assert _wait_docs(r_client, "paced", 400, timeout=30.0)
    elapsed = time.time() - t0
    assert elapsed >= 0.3, f"copy not paced: {elapsed:.2f}s"


def test_compressed_replication(clusters):
    # compressionType gzip on both ends
    primary, p_client, replica, r_client = _pair(clusters("gzip"), "gz")
    p_client.add_documents([_doc("gz", str(i), "compressed " * 30) for i in range(40)])
    p_client.refresh("gz")
    assert _wait_docs(r_client, "gz", 40, timeout=15.0)
    assert r_client.search(_match("gz", "compressed")).totalHits.value == 40


# ---------------------------------------------------------------------------
# faults with the fused path serving (tests/test_replication_fault_dense.py)
# ---------------------------------------------------------------------------

DENSE_FIELDS = [
    pb.Field(name="id", type=pb.FieldType._ID, store=True),
    pb.Field(name="t", type=pb.FieldType.TEXT, search=True, store=True),
]
N_COMMON = 300  # above the dense head's min_df floor of 256: 'common' is a head row


def _add_corpus(client, start, n):
    reqs = []
    for i in range(start, start + n):
        r = pb.AddDocumentRequest(indexName="idx")
        r.fields["id"].value.append(str(i))
        r.fields["t"].value.append(f"common rare{i}")
        reqs.append(r)
    client.add_documents(reqs)
    client.refresh("idx")


def _search_common(client, k=10):
    req = pb.SearchRequest(indexName="idx", topHits=k, retrieveFields=["id"])
    req.query.matchQuery.field = "t"
    req.query.matchQuery.query = "common"
    return client.search(req)


def _search_rare(client, term):
    """The head term AND a sparse-tail term."""
    req = pb.SearchRequest(indexName="idx", topHits=5, retrieveFields=["id"])
    req.query.matchQuery.field = "t"
    req.query.matchQuery.query = f"common {term}"
    req.query.matchQuery.operator = pb.MatchOperator.MUST
    return client.search(req)


def _paths_agree(server, client, monkeypatch, rare="rare1"):
    """The same queries through the merge and the fused path of the live
    server: hit counts and docs equal, and the fused path really served."""
    view = server.global_state.runtimes["idx"].searcher.packed_view("t")
    out = {}
    for path in ("merge", "fused"):
        monkeypatch.setenv("NRT_FAST_PATH", path)
        before = dict(view.path_counts)
        r1, r2 = _search_common(client), _search_rare(client, rare)
        assert view.path_counts[path] > before[path], (path, view.path_counts)
        out[path] = (r1.totalHits.value, [h.luceneDocId for h in r1.hits],
                     r2.totalHits.value, [h.luceneDocId for h in r2.hits])
    monkeypatch.setenv("NRT_FAST_PATH", "fused")
    assert out["merge"] == out["fused"], out
    return out["merge"]


def _start_dense_primary(root, remote, shared, name="p", index_dir=None, gen=1, restore=False):
    p, pc = _server(root, name, {}, state=shared, index_dir=index_dir, remote=remote)
    if not restore:
        pc.create_index("idx")
        pc.register_fields(pb.FieldDefRequest(indexName="idx", field=DENSE_FIELDS))
    req = pb.StartIndexRequest(indexName="idx", mode=pb.Mode.PRIMARY, primaryGen=gen)
    if restore:
        req.restore.resourceName = "idx"
    pc.start_index(req)
    return p, pc


def test_replica_resync_with_dense_head(tmp_path, monkeypatch):
    """A replica misses NRT points while down, re-syncs from the object
    store on restart, and serves the fused path."""
    monkeypatch.setenv("NRT_FAST_PATH", "fused")
    remote = LocalFileBackend(tmp_path / "remote")
    shared = str(tmp_path / "shared_state")
    p, pc = _start_dense_primary(tmp_path, remote, shared)
    r2 = rc2 = None
    try:
        _add_corpus(pc, 0, N_COMMON)
        pc.commit("idx")
        r, rc = _server(tmp_path, "r", {}, state=shared, remote=remote)
        rc.start_index(pb.StartIndexRequest(
            indexName="idx", mode=pb.Mode.REPLICA,
            primaryAddress=f"localhost:{p.replication_port}"))
        assert _wait_docs(rc, "idx", N_COMMON)
        assert _search_common(rc).totalHits.value == N_COMMON
        rc.close()
        r.stop()

        # two more waves while the replica is down (missed points)
        _add_corpus(pc, N_COMMON, 40)
        pc.commit("idx")
        _add_corpus(pc, N_COMMON + 40, 40)
        pc.commit("idx")

        # the node restarts its REPLICA index itself (warm boot, restore)
        r2, rc2 = _server(tmp_path, "r", {}, state=shared, index_dir=str(tmp_path / "r_index"),
                          remote=remote)
        assert _wait_docs(rc2, "idx", N_COMMON + 80)
        assert _search_common(rc2).totalHits.value == N_COMMON + 80
        assert _search_rare(rc2, f"rare{N_COMMON + 79}").totalHits.value >= 1
        _paths_agree(r2, rc2, monkeypatch)
    finally:
        if r2 is not None:
            rc2.close()
            r2.stop()
        pc.close()
        p.stop()


def test_primary_incarnation_change_dense_serving(tmp_path, monkeypatch):
    """The primary dies; a new one (primaryGen 2) restores from the object
    store; a replica follows the new incarnation and the fused path serves
    the same docs and counts as the merge path."""
    monkeypatch.setenv("NRT_FAST_PATH", "fused")
    remote = LocalFileBackend(tmp_path / "remote")
    shared = str(tmp_path / "shared_state")
    p, pc = _start_dense_primary(tmp_path, remote, shared)
    _add_corpus(pc, 0, N_COMMON)
    pc.commit("idx")
    pc.close()
    p.stop()

    p2, pc2 = _start_dense_primary(tmp_path, remote, shared, name="p2", gen=2, restore=True)
    r = rc = None
    try:
        assert _wait_docs(pc2, "idx", N_COMMON)
        _add_corpus(pc2, N_COMMON, 30)
        pc2.commit("idx")
        r, rc = _server(tmp_path, "r", {}, state=shared, remote=remote)
        rc.start_index(pb.StartIndexRequest(
            indexName="idx", mode=pb.Mode.REPLICA,
            primaryAddress=f"localhost:{p2.replication_port}"))
        assert _wait_docs(rc, "idx", N_COMMON + 30)
        assert r.global_state.runtimes["idx"].primary_gen == 2
        total, *_ = _paths_agree(r, rc, monkeypatch)
        assert total == N_COMMON + 30
    finally:
        if r is not None:
            rc.close()
            r.stop()
        pc2.close()
        p2.stop()


# ---------------------------------------------------------------------------
# wire compatibility: a port replica of a reference primary
# ---------------------------------------------------------------------------


def test_port_replica_of_reference_primary(tmp_path):
    """A reference primary (JAX on the CPU) and a port replica share one
    state directory; the port replica registers on the reference's
    replication port, copies its point over recvRawFile, installs it and
    answers as the primary does: hits, docs, order and scores."""
    from nrtsearch_tpu.client import NrtsearchClient as RefClient
    from nrtsearch_tpu.config import NrtsearchConfig as RefConfig
    from nrtsearch_tpu.server.grpc_server import NrtsearchServer as RefServer

    shared = str(tmp_path / "state")
    ref = RefServer(RefConfig.from_dict({"stateDir": shared, "indexDir": str(tmp_path / "p"),
                                         "nodeName": "primary"}))
    pc = RefClient(f"localhost:{ref.start(0)}")
    replica = rc = None
    try:
        pc.create_index("wire")
        pc.register_fields(pb.FieldDefRequest(indexName="wire", field=FIELDS))
        pc.start_index(pb.StartIndexRequest(indexName="wire", mode=pb.Mode.PRIMARY,
                                            primaryGen=1))
        words = ["alpha", "beta", "gamma", "replica", "wire"]
        pc.add_documents([_doc("wire", str(i), " ".join(words[j % 5] for j in range(i % 7 + 1)))
                          for i in range(60)])
        pc.refresh("wire")
        replica, rc = _server(tmp_path, "replica", {}, state=shared)
        rc.start_index(pb.StartIndexRequest(
            indexName="wire", mode=pb.Mode.REPLICA,
            primaryAddress=f"localhost:{ref.replication_port}"))
        assert _wait_docs(rc, "wire", 60)
        pc.add_documents([_doc("wire", str(60 + i), "wire replica fresh") for i in range(5)])
        pc.refresh("wire")
        assert _wait_docs(rc, "wire", 65)
        for text in ("alpha gamma", "wire replica", "beta"):
            want, got = pc.search(_match("wire", text)), rc.search(_match("wire", text))
            assert got.totalHits.value == want.totalHits.value > 0, text
            assert [(h.luceneDocId, h.score, h.fields["doc_id"].fieldValue[0].textValue)
                    for h in got.hits] == \
                [(h.luceneDocId, h.score, h.fields["doc_id"].fieldValue[0].textValue)
                 for h in want.hits], text
    finally:
        if replica is not None:
            rc.close()
            replica.stop()
        pc.close()
        ref.stop()
