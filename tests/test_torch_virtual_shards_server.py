"""liveSettings.virtualShards served through both packages' Handlers, on the
CPU (the cases of tests/test_virtual_shards_server.py).

The reference re-partitions the postings over its 8 virtual host devices
and serves plain text queries over the (shard, data) mesh. The port serves
them over a grid of ``device.search_devices()``, which these tests replace
with ``[cpu] * 8`` (the port's analogue of the 8 virtual devices). With the
seam left alone the CPU is one device, and a node at ``virtualShards: 4``
serves on the local path, as the reference does with fewer than two
devices: its answers still equal the reference's mesh answers.

Both sides serve the merge path on the CPU (NRT_FAST_PATH unset, the index
not on CUDA), whose f32 additions keep the reference's order: the two mesh
nodes' hits, ids and scores are compared exactly. A mesh node against a
local one: ids and hits equal, scores within the reference's 2e-5.
"""

import random

import pytest
import torch
from google.protobuf import json_format

from nrtsearch_tpu.config import NrtsearchConfig as RefConfig
from nrtsearch_tpu.gen import pb
from nrtsearch_tpu.server.handlers import Handlers as RefHandlers
from nrtsearch_tpu.state.backend import LocalStateBackend as RefBackend
from nrtsearch_tpu.state.global_state import GlobalState as RefGlobalState
from nrtsearch_tpu_torch import device as port_device
from nrtsearch_tpu_torch.config import NrtsearchConfig
from nrtsearch_tpu_torch.server.handlers import Handlers
from nrtsearch_tpu_torch.state.backend import LocalStateBackend
from nrtsearch_tpu_torch.state.global_state import GlobalState

DOCS = 400
QUERIES = ["common alpha", "rare", "beta gamma delta", "epsilon common rare",
           "nosuchterm", "zeta"]


def _handlers(work, port: bool):
    spec = {"stateDir": str(work / "state"), "indexDir": str(work / "index")}
    if port:
        cfg = NrtsearchConfig.from_dict(spec)
        return Handlers(GlobalState(cfg, LocalStateBackend(cfg.state_dir), device="cpu"))
    cfg = RefConfig.from_dict(spec)
    return RefHandlers(RefGlobalState(cfg, RefBackend(cfg.state_dir)))


def _mk_server(root, name: str, port: bool, shards: int = 1):
    """tests/test_virtual_shards_server.py's index: 400 docs of a small
    vocabulary, 'rare' in every 41st."""
    h = _handlers(root / name, port)
    h.createIndex(pb.CreateIndexRequest(indexName="idx"))
    h.registerFields(json_format.ParseDict({"indexName": "idx", "field": [
        {"name": "id", "type": "_ID", "store": True},
        {"name": "body", "type": "TEXT", "search": True, "storeDocValues": True},
        {"name": "rank", "type": "INT", "storeDocValues": True},
    ]}, pb.FieldDefRequest()))
    h.startIndex(pb.StartIndexRequest(indexName="idx"))
    rng = random.Random(29)
    vocab = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "common", "rare"]
    reqs = []
    for i in range(DOCS):
        words = ["common"] * (1 + rng.randint(0, 2))
        words += [rng.choice(vocab[:6]) for _ in range(rng.randint(2, 6))]
        if i % 41 == 0:
            words.append("rare")
        r = pb.AddDocumentRequest(indexName="idx")
        r.fields["id"].value.append(str(i))
        r.fields["body"].value.append(" ".join(words))
        r.fields["rank"].value.append(str(i % 7))
        reqs.append(r)
    h.addDocuments(iter(reqs))
    h.refresh(pb.RefreshRequest(indexName="idx"))
    if shards > 1:
        h.liveSettings(json_format.ParseDict({"indexName": "idx", "virtualShards": shards},
                                             pb.LiveSettingsRequest()))
    return h


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("vshards")
    return {
        "ref_base": _mk_server(root, "ref_base", False),
        "ref_sharded": _mk_server(root, "ref_sharded", False, 4),
        "port_base": _mk_server(root, "port_base", True),
        "port_sharded": _mk_server(root, "port_sharded", True, 4),
    }


@pytest.fixture()
def eight_cpus(monkeypatch):
    monkeypatch.setattr(port_device, "search_devices", lambda: [torch.device("cpu")] * 8)


def _search(h, req: dict):
    return h.search(json_format.ParseDict(dict(req), pb.SearchRequest()))


def _match(text: str) -> dict:
    return {"indexName": "idx", "topHits": 10,
            "query": {"matchQuery": {"field": "body", "query": text}},
            "retrieveFields": ["id"]}


def _answer(resp) -> tuple:
    return (resp.totalHits.value, resp.totalHits.relation,
            [(h.fields["id"].fieldValue[0].textValue, h.score) for h in resp.hits])


def _assert_close(got, want):
    """Hits, relation and ids equal, scores within 2e-5 relative (the
    reference's bound between its mesh and its local path: the mesh's
    impacts and run layout add in another order)."""
    (n0, r0, h0), (n1, r1, h1) = _answer(got), _answer(want)
    assert (n0, r0, [i for i, _ in h0]) == (n1, r1, [i for i, _ in h1])
    assert [s for _, s in h0] == pytest.approx([s for _, s in h1], rel=2e-5)


def _searcher(h):
    return h.gs.runtimes["idx"].searcher


def test_live_setting_reaches_searcher(servers):
    assert _searcher(servers["port_sharded"]).dist_shards == 4
    assert _searcher(servers["port_base"]).dist_shards == 1
    assert _searcher(servers["ref_sharded"]).dist_shards == 4


@pytest.mark.parametrize("query", QUERIES)
def test_sharded_search_matches_reference(servers, eight_cpus, query):
    """The port's mesh node answers as the reference's mesh node and as
    the port's unsharded node."""
    got = _search(servers["port_sharded"], _match(query))
    assert _answer(got) == _answer(_search(servers["ref_sharded"], _match(query)))
    _assert_close(got, _search(servers["port_base"], _match(query)))
    if query != "nosuchterm":
        assert ("body", 4) in _searcher(servers["port_sharded"])._dist_cache


@pytest.mark.parametrize("query", QUERIES[:3])
def test_one_device_node_serves_locally(servers, query):
    """With one search device the port's virtualShards=4 node takes the
    local path and answers as the reference's mesh node."""
    s = _searcher(servers["port_sharded"])
    s.release_device_caches()
    got = _search(servers["port_sharded"], _match(query))
    _assert_close(got, _search(servers["ref_sharded"], _match(query)))
    assert _answer(got) == _answer(_search(servers["port_base"], _match(query)))
    assert not s._dist_cache


def test_sharded_general_path_falls_back(servers, eight_cpus):
    """A filtered query keeps the local path on both packages."""
    req = {"indexName": "idx", "topHits": 10, "retrieveFields": ["id"], "query": {
        "booleanQuery": {"clauses": [
            {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "common"}}},
            {"occur": "FILTER", "query": {"rangeQuery": {"field": "rank", "lower": "2",
                                                         "upper": "5"}}}]}}}
    got = _search(servers["port_sharded"], req)
    assert _answer(got) == _answer(_search(servers["ref_sharded"], req))
    assert _answer(got) == _answer(_search(servers["port_base"], req))


def test_shards_cap_at_device_count(servers, eight_cpus):
    st = _searcher(servers["port_sharded"])._distributed_state("body")
    ref = _searcher(servers["ref_sharded"])._distributed_state("body")
    assert st.mesh.shape == dict(ref.mesh.shape) == {"shard": 4, "data": 2}


def test_live_change_drops_the_old_mesh(servers, eight_cpus):
    """A new virtualShards value serves on a mesh of its own and drops the
    old one; a released snapshot holds no mesh."""
    h = servers["port_sharded"]
    s = _searcher(h)
    _search(h, _match("common alpha"))
    assert ("body", 4) in s._dist_cache
    try:
        h.liveSettings(json_format.ParseDict({"indexName": "idx", "virtualShards": 2},
                                             pb.LiveSettingsRequest()))
        assert not s._dist_cache
        got = _search(h, _match("common alpha"))
        assert list(s._dist_cache) == [("body", 2)]
        assert s._dist_cache[("body", 2)].mesh.shape == {"shard": 2, "data": 4}
        _assert_close(got, _search(servers["port_base"], _match("common alpha")))
        s.release_device_caches()
        assert not s._dist_cache
    finally:
        h.liveSettings(json_format.ParseDict({"indexName": "idx", "virtualShards": 4},
                                             pb.LiveSettingsRequest()))


def test_live_change_during_mesh_build(servers, eight_cpus, monkeypatch):
    """A live change of virtualShards while a mesh is being built neither
    waits for the build nor lets the old count's mesh into the cache: the
    build serves its own call and is dropped."""
    import threading

    from nrtsearch_tpu_torch.parallel import distributed

    h = servers["port_sharded"]
    s = _searcher(h)
    s.release_device_caches()
    build = distributed.DistributedBM25.from_searcher.__func__
    changed = []

    def racing_build(cls, searcher, field, mesh):
        setter = threading.Thread(target=setattr, args=(searcher, "dist_shards", 2))
        setter.start()
        setter.join(timeout=10)
        changed.append(not setter.is_alive())
        return build(cls, searcher, field, mesh)

    monkeypatch.setattr(distributed.DistributedBM25, "from_searcher",
                        classmethod(racing_build))
    try:
        dist = s._distributed_state("body")
        assert changed == [True]
        assert dist.mesh.shape == {"shard": 4, "data": 2}
        assert s.dist_shards == 2 and not s._dist_cache
    finally:
        s.dist_shards = 4
        s.release_device_caches()


def test_superseded_snapshot_drops_its_mesh(tmp_path, eight_cpus):
    """Two refreshes later the runtime releases a snapshot's device caches:
    its mesh goes with its packed views."""
    h = _mk_server(tmp_path, "released", True, 4)
    old = _searcher(h)
    _search(h, _match("common alpha"))
    assert ("body", 4) in old._dist_cache
    for i in range(2):
        r = pb.AddDocumentRequest(indexName="idx")
        r.fields["id"].value.append(f"extra{i}")
        r.fields["body"].value.append("common alpha")
        h.addDocuments(iter([r]))
        h.refresh(pb.RefreshRequest(indexName="idx"))
    assert _searcher(h) is not old
    assert not old._dist_cache and not old._packed_views
    assert _searcher(h).dist_shards == 4
    h.gs.runtimes["idx"].stop()
