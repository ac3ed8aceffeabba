"""The port's object store, its ops tool, its CLI and its REST gateway, on
the CPU.

- tests/test_remote_contract.py's assertions against the port's
  ``LocalFileBackend`` and its ``S3Backend`` / ``S3Client`` over the port's
  ``FakeS3Server`` (a loopback HTTP double; SigV4 over http.client, no
  boto3); an isolated replica that polls S3; a server configured with
  ``bucketName`` that commits to S3 and a fresh node that restores from it.
- tests/test_nrt_utils_full.py's four commands through the port's
  ``nrt_utils`` over both stores.
- One round trip of the port's CLI against the port's server, its
  replication commands included, and tests/test_rest_errors.py's HTTP
  status mapping through the port's gateway in front of the port's server.
"""

import json
import urllib.error
import urllib.request

import pytest

from nrtsearch_tpu_torch.client import NrtsearchClient
from nrtsearch_tpu_torch.config import NrtsearchConfig
from nrtsearch_tpu_torch.gen import pb
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.remote.backend import LocalFileBackend
from nrtsearch_tpu_torch.remote.fake_s3 import FakeS3Server
from nrtsearch_tpu_torch.remote.s3 import S3Backend
from nrtsearch_tpu_torch.remote.s3_client import S3Client
from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer
from nrtsearch_tpu_torch.server.index_runtime import IndexRuntime
from nrtsearch_tpu_torch.state.index_state import IndexStateInfo


@pytest.fixture(scope="module")
def fake_s3():
    server = FakeS3Server()
    endpoint = server.start()
    yield endpoint
    server.stop()


@pytest.fixture(params=["local", "s3"])
def backend(request, tmp_path, fake_s3):
    if request.param == "local":
        return LocalFileBackend(tmp_path / "remote")
    return S3Backend(S3Client(bucket=f"contract-{tmp_path.name}", endpoint=fake_s3,
                              access_key="k", secret_key="s"))


def test_versioned_blob_roundtrip(backend):
    assert backend.current_version("svc", "res") is None
    assert backend.download_current("svc", "res") is None
    assert backend.upload_versioned("svc", "res", b"alpha") == 0
    assert backend.download_current("svc", "res") == b"alpha"
    assert backend.upload_versioned("svc", "res", b"beta") == 1
    assert backend.current_version("svc", "res") == 1
    assert backend.download_current("svc", "res") == b"beta"
    # other resources are independent
    backend.upload_versioned("svc", "other", b"x")
    assert backend.download_current("svc", "res") == b"beta"


def test_index_files_roundtrip(backend, tmp_path):
    src = tmp_path / "src"
    src.mkdir(exist_ok=True)
    (src / "seg.arrays.npz").write_bytes(b"\x00\x01" * 5000)
    (src / "seg.meta").write_bytes(b"meta")
    backend.upload_index_files("svc", "idx-1", src, ["seg.arrays.npz", "seg.meta"])
    assert backend.index_file_exists("svc", "idx-1", "seg.arrays.npz")
    assert not backend.index_file_exists("svc", "idx-1", "missing")
    dst = tmp_path / "dst"
    backend.download_index_files("svc", "idx-1", dst, ["seg.arrays.npz", "seg.meta"])
    assert (dst / "seg.arrays.npz").read_bytes() == b"\x00\x01" * 5000
    assert (dst / "seg.meta").read_bytes() == b"meta"
    backend.delete_index_files("svc", "idx-1", ["seg.meta"])
    assert not backend.index_file_exists("svc", "idx-1", "seg.meta")
    assert backend.index_file_exists("svc", "idx-1", "seg.arrays.npz")


def test_download_missing_file_raises(backend, tmp_path):
    with pytest.raises(FileNotFoundError):
        backend.download_index_files("svc", "idx-1", tmp_path / "d2", ["nope"])


def test_multipart_upload_path(fake_s3, tmp_path, monkeypatch):
    """Files above the multipart threshold upload through initiate, part
    and complete."""
    import nrtsearch_tpu_torch.remote.s3_client as s3c

    monkeypatch.setattr(s3c, "MULTIPART_THRESHOLD", 1024)
    monkeypatch.setattr(s3c, "PART_SIZE", 512)
    client = S3Client(bucket="mp", endpoint=fake_s3, access_key="k", secret_key="s")
    payload = bytes(range(256)) * 20  # 5120 bytes: 10 parts
    src = tmp_path / "big.bin"
    src.write_bytes(payload)
    client.put_file("big/key.bin", src)
    assert client.get_object("big/key.bin") == payload


def test_list_objects(fake_s3):
    client = S3Client(bucket="lst", endpoint=fake_s3, access_key="k", secret_key="s")
    client.put_object("a/1", b"1")
    client.put_object("a/2", b"2")
    client.put_object("b/1", b"3")
    assert sorted(client.list_objects("a/")) == ["a/1", "a/2"]
    assert client.list_objects("") == ["a/1", "a/2", "b/1"]


def test_isolated_replica_over_s3(fake_s3, tmp_path):
    """A primary publishes NRT points to S3; an isolated replica that never
    talks to the primary installs them (RemoteCopyJobManager's flow)."""
    remote = S3Backend(S3Client(bucket="nrt", endpoint=fake_s3, access_key="k",
                                secret_key="s"))
    info = IndexStateInfo(index_name="idx", index_id="idx-s3test").with_fields({
        "doc_id": {"type": "_ID", "store": True},
        "body": {"type": "TEXT", "search": True, "store": True},
    })
    primary = IndexRuntime(info, tmp_path / "primary", mode="PRIMARY", remote=remote,
                           service_name="svc", primary_gen=1, device="cpu")
    replica = IndexRuntime(info, tmp_path / "replica", mode="REPLICA", remote=remote,
                           service_name="svc", device="cpu")
    try:
        primary.start()
        primary.add_documents([{"doc_id": "1", "body": "object store replication"},
                               {"doc_id": "2", "body": "isolated replicas poll s3"}])
        primary.refresh()
        assert replica.sync_from_remote()
        q = parse_query({"matchQuery": {"field": "body", "query": "replication"}})
        assert replica.searcher.search(q, 10).total_hits == 1
        # incremental point
        primary.add_documents([{"doc_id": "3", "body": "more replication data"}])
        primary.refresh()
        assert replica.sync_from_remote()
        assert replica.searcher.search(q, 10).total_hits == 2
    finally:
        primary.stop()
        replica.stop()


def _s3_config(tmp_path, node: str, endpoint: str) -> NrtsearchConfig:
    return NrtsearchConfig.from_dict({
        "stateDir": str(tmp_path / f"{node}/state"),
        "indexDir": str(tmp_path / f"{node}/index"),
        "serviceName": "svc-e2e", "bucketName": "e2e-bucket",
        "stateConfig": {"backendType": "REMOTE"},
        "s3": {"endpoint": endpoint, "accessKey": "k", "secretKey": "s"},
    })


def test_server_boots_with_s3_backend(fake_s3, tmp_path):
    """bucketName builds the port's S3Backend, as the reference's server
    does; commit uploads to S3 and a fresh node restores from it."""
    srv1 = NrtsearchServer(_s3_config(tmp_path, "s1", fake_s3), device="cpu")
    assert isinstance(srv1.global_state.remote, S3Backend)
    c1 = NrtsearchClient(f"localhost:{srv1.start(0)}")
    try:
        c1.create_index("s3idx")
        c1.register_fields(pb.FieldDefRequest(indexName="s3idx", field=[
            pb.Field(name="doc_id", type=pb.FieldType._ID, store=True),
            pb.Field(name="body", type=pb.FieldType.TEXT, search=True, store=True)]))
        c1.start_index(pb.StartIndexRequest(indexName="s3idx", mode=pb.Mode.PRIMARY,
                                            primaryGen=1))
        req = pb.AddDocumentRequest(indexName="s3idx")
        req.fields["doc_id"].value.append("1")
        req.fields["body"].value.append("durable search data")
        c1.add_documents(iter([req]))
        c1.refresh("s3idx")
        c1.commit("s3idx")
        index_id = srv1.global_state.get_state("s3idx").index_id
    finally:
        c1.close()
        srv1.stop()

    # a new node with empty local dirs and the same remote state: schema and
    # index id from the REMOTE state backend, data restored by startIndex
    srv2 = NrtsearchServer(_s3_config(tmp_path, "s2", fake_s3), device="cpu")
    c2 = NrtsearchClient(f"localhost:{srv2.start(0)}")
    try:
        assert srv2.global_state.get_state("s3idx").index_id == index_id
        req = pb.StartIndexRequest(indexName="s3idx", mode=pb.Mode.PRIMARY, primaryGen=2)
        req.restore.serviceName = "svc-e2e"
        req.restore.resourceName = "s3idx"
        c2.start_index(req)
        sreq = pb.SearchRequest(indexName="s3idx", topHits=5)
        sreq.query.matchQuery.field = "body"
        sreq.query.matchQuery.query = "durable"
        assert c2.search(sreq).totalHits.value == 1
    finally:
        c2.close()
        srv2.stop()


def test_remote_backend_per_config(tmp_path, fake_s3):
    """_make_remote_backend builds the reference's backend kind for each
    config: S3 for bucketName, the filesystem double for remoteRoot, none
    otherwise."""
    from nrtsearch_tpu.config import NrtsearchConfig as RefConfig
    from nrtsearch_tpu.server.grpc_server import NrtsearchServer as RefServer

    for raw in ({"bucketName": "b", "s3": {"endpoint": fake_s3}},
                {"remoteRoot": str(tmp_path / "root")}, {}):
        port = NrtsearchServer._make_remote_backend(NrtsearchConfig.from_dict(raw))
        ref = RefServer._make_remote_backend(RefConfig.from_dict(raw))
        assert type(port).__name__ == type(ref).__name__
        assert type(port).__module__.startswith("nrtsearch_tpu_torch.") or port is None


# ---------------------------------------------------------------------------
# nrt_utils over both stores
# ---------------------------------------------------------------------------

NRT_UTILS_FIELDS = {"id": {"type": "_ID"}, "t": {"type": "TEXT", "search": True}}


def _utils(capsys, argv):
    from nrtsearch_tpu_torch.nrt_utils import main as utils_main

    rc = utils_main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(params=["local", "s3"])
def store(request, tmp_path, fake_s3):
    """(backend, argv prefix) for each store kind."""
    if request.param == "local":
        root = tmp_path / "store"
        return LocalFileBackend(root), ["--root", str(root)]
    bucket = f"utils-{tmp_path.name}"
    client = S3Client(bucket=bucket, region="us-east-1", endpoint=fake_s3,
                      access_key="k", secret_key="s")
    return S3Backend(client), ["--bucket", bucket, "--endpoint", fake_s3]


@pytest.fixture()
def primary(store, tmp_path, monkeypatch):
    remote, argv = store
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    info = IndexStateInfo(index_name="i", index_id="i-9").with_fields(NRT_UTILS_FIELDS)
    rt = IndexRuntime(info, tmp_path / "p", mode="PRIMARY", remote=remote,
                      service_name="svc", primary_gen=1, device="cpu")
    rt.start()
    rt.add_documents([{"id": "1", "t": "hello world"}])
    rt.refresh()
    yield remote, argv
    rt.stop()


def test_restore_to_new_service(primary, tmp_path, capsys):
    remote, argv = primary
    rc, _ = _utils(capsys, argv + ["snapshot", "--serviceName", "svc", "--indexId", "i-9",
                                   "--snapshotId", "s1"])
    assert rc == 0
    rc, out = _utils(capsys, argv + [
        "restore", "--serviceName", "svc", "--indexId", "i-9", "--snapshotId", "s1",
        "--restoreServiceName", "svc2", "--restoreIndexId", "i-copy"])
    assert rc == 0
    res = json.loads(out)
    assert res["service"] == "svc2" and res["indexId"] == "i-copy"
    assert res["filesCopied"] >= 1
    # a replica starts the restored index in the new service
    replica = IndexRuntime(
        IndexStateInfo(index_name="i", index_id="i-copy").with_fields(NRT_UTILS_FIELDS),
        tmp_path / "r2", mode="REPLICA", remote=remote, service_name="svc2", device="cpu")
    try:
        assert replica.sync_from_remote()
        assert replica.searcher.num_docs == 1
    finally:
        replica.stop()


def test_cleanup_snapshots_and_data(primary, capsys):
    remote, argv = primary
    for sid in ("100", "200", "300"):
        rc, _ = _utils(capsys, argv + ["snapshot", "--serviceName", "svc", "--indexId",
                                       "i-9", "--snapshotId", sid])
        assert rc == 0
    rc, out = _utils(capsys, argv + ["cleanupSnapshots", "--serviceName", "svc",
                                     "--indexId", "i-9", "--keep", "1"])
    assert rc == 0
    assert sorted(json.loads(out)["removed"]) == ["100", "200"]
    rc, out = _utils(capsys, argv + ["listSnapshots", "--serviceName", "svc",
                                     "--indexId", "i-9"])
    assert [s["snapshotId"] for s in json.loads(out)] == ["300"]
    rc, out = _utils(capsys, argv + ["cleanupData", "--serviceName", "svc",
                                     "--indexId", "i-9", "--dryRun"])
    assert rc == 0
    assert json.loads(out)["kept"] >= 1


def test_resource_version_roundtrip(store, capsys, monkeypatch):
    remote, argv = store
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    remote.upload_versioned("svc", "cfg", b"v0-data")
    remote.upload_versioned("svc", "cfg", b"v1-data")
    rc, out = _utils(capsys, argv + ["listResourceVersions", "--serviceName", "svc",
                                     "--resourceName", "cfg"])
    assert rc == 0
    res = json.loads(out)
    assert res["versions"] == [0, 1] and res["current"] == 1
    rc, out = _utils(capsys, argv + ["getResourceVersion", "--serviceName", "svc",
                                     "--resourceName", "cfg"])
    assert json.loads(out)["version"] == 1
    rc, out = _utils(capsys, argv + ["getRemoteState", "--serviceName", "svc",
                                     "--resourceName", "cfg"])
    assert out == "v1-data"
    # rollback: version 0's blob becomes the new current
    rc, _ = _utils(capsys, argv + ["setResourceVersion", "--serviceName", "svc",
                                   "--resourceName", "cfg", "--version", "0"])
    assert rc == 0
    assert remote.download_current("svc", "cfg") == b"v0-data"


def test_put_remote_state_and_global_update(store, tmp_path, capsys, monkeypatch):
    remote, argv = store
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    f = tmp_path / "gs.json"
    f.write_text(json.dumps({"indices": {"books": "books-id-1"}}))
    rc, _ = _utils(capsys, argv + ["putRemoteState", "--serviceName", "svc",
                                   "--resourceName", "global_state", "--stateFile", str(f)])
    assert rc == 0
    rc, out = _utils(capsys, argv + ["updateGlobalIndexState", "--serviceName", "svc",
                                     "--indexName", "books", "--setIndexId", "books-id-2"])
    assert rc == 0
    assert json.loads(out)["indexId"] == "books-id-2"
    state = json.loads(remote.download_current("svc", "global_state"))
    assert state["indices"]["books"] == "books-id-2"
    rc, _ = _utils(capsys, argv + ["updateGlobalIndexState", "--serviceName", "svc",
                                   "--indexName", "books", "--remove"])
    assert rc == 0
    state = json.loads(remote.download_current("svc", "global_state"))
    assert "books" not in state["indices"]


# ---------------------------------------------------------------------------
# the CLI and the REST gateway in front of the port's server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("front")
    srv = NrtsearchServer(NrtsearchConfig.from_dict(
        {"stateDir": str(tmp / "s"), "indexDir": str(tmp / "i")}), device="cpu")
    port = srv.start(0)
    yield srv, port, tmp
    srv.stop()


def test_cli_round_trip(server, capsys):
    """The index lifecycle through the port's CLI, started PRIMARY, with the
    replication commands on the replication port."""
    from nrtsearch_tpu_torch.cli import main as cli_main

    srv, port, tmp = server

    def run(*argv) -> int:
        return cli_main(["--port", str(port), *argv])

    fields = tmp / "fields.json"
    fields.write_text(json.dumps({"indexName": "cidx", "field": [
        {"name": "id", "type": "_ID", "store": True},
        {"name": "body", "type": "TEXT", "search": True}]}))
    docs = tmp / "docs.json"
    docs.write_text("\n".join(json.dumps({"id": str(i), "body": f"sample text number {i}"})
                              for i in range(6)))
    query = tmp / "query.json"
    query.write_text(json.dumps({
        "indexName": "cidx", "topHits": 3, "retrieveFields": ["id"],
        "query": {"matchQuery": {"field": "body", "query": "sample"}}}))
    rport = str(srv.replication_port)
    assert run("createIndex", "--indexName", "cidx") == 0
    assert run("registerFields", "--fileName", str(fields)) == 0
    assert run("startIndex", "--indexName", "cidx", "--mode", "PRIMARY") == 0
    assert srv.global_state.runtimes["cidx"].mode == "PRIMARY"
    assert run("addDocuments", "--indexName", "cidx", "--fileName", str(docs),
               "--fileType", "json") == 0
    capsys.readouterr()
    assert run("writeNRTPoint", "--indexName", "cidx", "--replicationPort", rport) == 0
    assert json.loads(capsys.readouterr().out)["didRefresh"] is True
    assert run("search", "--fileName", str(query)) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["totalHits"]["value"] == "6" and len(out["hits"]) == 3
    assert run("getNodes", "--indexName", "cidx", "--replicationPort", rport) == 0
    assert run("currentSearcherVersion", "--indexName", "cidx", "--replicationPort", rport) == 0
    for argv in [("stats", "--indexName", "cidx"), ("indices",), ("status",),
                 ("commit", "--indexName", "cidx"), ("stopIndex", "--indexName", "cidx"),
                 ("deleteIndex", "--indexName", "cidx")]:
        assert run(*argv) == 0, argv
    assert run("stats", "--indexName", "cidx") == 1  # gone: an error


@pytest.fixture(scope="module")
def gateway(server):
    from nrtsearch_tpu_torch.server.rest_gateway import RestGateway

    _srv, port, _tmp = server
    c = NrtsearchClient(f"localhost:{port}")
    c.create_index("r")
    c.register_fields(pb.FieldDefRequest(indexName="r", field=[
        pb.Field(name="id", type=pb.FieldType._ID, store=True),
        pb.Field(name="body", type=pb.FieldType.TEXT, search=True)]))
    c.start_index(pb.StartIndexRequest(indexName="r", mode=pb.Mode.STANDALONE))
    gw = RestGateway(f"localhost:{port}")
    gw.start()
    yield gw
    gw.stop()
    c.close()


def _call(gw, path, body=None, method=None, data=None):
    url = f"http://localhost:{gw.port}{path}"
    if data is None and body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        raw = e.read() or b"{}"
        try:
            return e.code, json.loads(raw)
        except ValueError:
            return e.code, {"error": raw.decode(errors="replace")}


@pytest.mark.parametrize("path, body, method, code", [
    ("/v1/nope", {}, None, 404),                                     # unknown route
    ("/v2/search", {}, None, 404),                                   # bad path shape
    ("/v1/createIndex", None, "GET", 405),                           # wrong method
    ("/v1/search", {"indexName": "r", "noSuchField": 1}, None, 400),  # unknown proto field
    ("/v1/search", {"indexName": "ghost", "topHits": 1}, None, 404),  # unknown index
    ("/v1/createIndex", {"indexName": "r"}, None, 409),              # duplicate index
])
def test_rest_status_mapping(gateway, path, body, method, code):
    got, resp = _call(gateway, path, body, method)
    assert got == code and "error" in resp, (got, resp)


def test_rest_malformed_json_400(gateway):
    got, _ = _call(gateway, "/v1/search", data=b"{not json", method="POST")
    assert got == 400


def test_rest_stats_on_stopped_index_412(gateway):
    assert _call(gateway, "/v1/createIndex", {"indexName": "stopped"})[0] == 200
    got, resp = _call(gateway, "/v1/stats", {"indexName": "stopped"})
    assert got == 412 and "error" in resp


def test_rest_search_bad_query_400(gateway):
    got, resp = _call(gateway, "/v1/search", {
        "indexName": "r", "topHits": 1,
        "query": {"matchQuery": {"field": "ghost", "query": "x"}}})
    assert got in (400, 404) and "error" in resp


def test_rest_happy_paths(gateway):
    """addDocuments (a list and a single), refresh, search and a
    liveSettingsV2 wrapper round trip, after the errors above."""
    code, _ = _call(gateway, "/v1/addDocuments", [
        {"indexName": "r", "fields": {"id": {"value": ["10"]},
                                      "body": {"value": ["rest doc ten"]}}},
        {"indexName": "r", "fields": {"id": {"value": ["11"]},
                                      "body": {"value": ["rest doc eleven"]}}}])
    assert code == 200
    code, _ = _call(gateway, "/v1/addDocuments", {
        "indexName": "r", "fields": {"id": {"value": ["12"]},
                                     "body": {"value": ["rest doc twelve"]}}})
    assert code == 200
    assert _call(gateway, "/v1/refresh", {"indexName": "r"})[0] == 200
    code, body = _call(gateway, "/v1/search", {
        "indexName": "r", "topHits": 10, "retrieveFields": ["id"],
        "query": {"matchQuery": {"field": "body", "query": "rest doc"}}})
    assert code == 200 and body["totalHits"]["value"] == "3", body
    code, body = _call(gateway, "/v1/liveSettingsV2", {
        "indexName": "r", "liveSettings": {"sliceMaxDocs": 77}})
    assert code == 200 and body["liveSettings"]["sliceMaxDocs"] == 77, body
