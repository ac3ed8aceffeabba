"""The port stands alone: without JAX, the server's packages and the JAX
package itself.

In a fresh interpreter where jax, jaxlib, msgpack, yaml, grpc,
google.protobuf and nrtsearch_tpu cannot be imported, every engine module of
nrtsearch_tpu_torch imports and a 300-document index answers a text search
and the filtered, sorted and faceted forms on the CPU (only
core/directory.py reads msgpack, inside its functions). The wire modules
(``gen/``, ``config.py``, ``client.py``, ``cli.py``, ``server/``,
``state/``) are the only ones that import grpc, google.protobuf or yaml: with only jax, jaxlib
and nrtsearch_tpu blocked, every module imports and the port's server
answers over gRPC on the CPU. A source scan checks that no port file and no
line of chip_smoke.py imports jax or nrtsearch_tpu, and that no engine
module imports the wire packages.

The port's copies of the reference's modules are held to the originals:
the whole copies by their text (import lines pointed at the port, and each
copy's listed exceptions), the backend-free modules (analysis, schema,
query plan, smallfloat) also by what they compute, and so are the doc-value
masks (ops/masks.py), the eager leaf evaluators of query/eval.py, the
segment merge (core/merge.py, with the writer's tiered policy) and the
collectors (search/collectors.py), on the same inputs.
"""

import dataclasses
import enum
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import nrtsearch_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "nrtsearch_tpu_torch"

BLOCKED = ("jax", "jaxlib", "msgpack", "yaml", "grpc", "google.protobuf", "nrtsearch_tpu")
JAX_ONLY = ("jax", "jaxlib", "nrtsearch_tpu")
# the port's modules that may import grpc, google.protobuf and yaml
WIRE = ("nrtsearch_tpu_torch.gen", "nrtsearch_tpu_torch.config",
        "nrtsearch_tpu_torch.client", "nrtsearch_tpu_torch.server",
        "nrtsearch_tpu_torch.state", "nrtsearch_tpu_torch.cli")


def _is_wire(module: str) -> bool:
    return any(module == w or module.startswith(w + ".") for w in WIRE)


def _port_modules() -> list[str]:
    """Every module of the port but ``server.__main__``, whose import starts
    a server."""
    return [m.name for m in pkgutil.walk_packages(
        nrtsearch_tpu_torch.__path__, "nrtsearch_tpu_torch.")
        if not m.name.endswith(".__main__")]

SCRIPT = r"""
import sys
for name in %(blocked)r:
    sys.modules[name] = None
import importlib
mods = %(mods)r
for m in mods:
    importlib.import_module(m)
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def
from nrtsearch_tpu_torch.core.searcher import Searcher
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.core.searcher import SortSpec
fds = {"id": create_field_def("id", {"type": "_ID", "store": True}),
       "body": create_field_def("body", {"type": "TEXT", "search": True}),
       "price": create_field_def("price", {"type": "FLOAT", "storeDocValues": True}),
       "tag": create_field_def("tag", {"type": "ATOM", "storeDocValues": True})}
w = IndexWriter(fds, "cpu")
words = ["common", "alpha", "beta", "gamma", "needle"]
w.add_documents([{"id": str(i), "body": " ".join(words[: 1 + i %% 5]),
                  "price": str(i %% 50), "tag": "t%%d" %% (i %% 3)} for i in range(300)])
s = Searcher(w.refresh(), fds)
td = s.search(parse_query({"matchQuery": {"field": "body", "query": "gamma needle"}}), 10)
assert td.total_hits == 120, td.total_hits
assert len(td.hits) == 10 and td.hits[0].score > 0
# the config-#3 forms: filtered, sorted and faceted, with msgpack blocked
q = parse_query({"booleanQuery": {"clauses": [
    {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "gamma"}}},
    {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "10"}}},
    {"occur": "MUST_NOT", "query": {"termQuery": {"field": "tag", "textValue": "t1"}}}]}})
assert 0 < s.search(q, 5).total_hits < 180
assert s.search(q, 5, sort=SortSpec("price", reverse=True)).hits[0].sort_key == 49.0
_td, (facets,) = s.fast_search_reduce(s.compile_batchable(q), 5,
                                      [{"kind": "ordinal", "field": "tag"}])
assert set(facets) == {"t0", "t2"}
# the general evaluator: script.expr, the query cache and the compiled program
import os
for flag in ("1", "0"):
    os.environ["NRT_COMPILED_EVAL"] = flag
    fs = s.search(parse_query({"functionScoreQuery": {
        "query": {"prefixQuery": {"field": "body", "prefix": "ga"}},
        "script": {"source": "_score * log(price + 2)"}}}), 5)
    assert fs.total_hits == 120 and fs.hits[0].score > 1.0, fs.total_hits
    assert s.search(parse_query({"booleanQuery": {"clauses": [
        {"occur": "SHOULD", "query": {"matchQuery": {"field": "body", "query": "beta"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "upper": "9"}}}]}}),
        5, sort=SortSpec("tag", rest=(SortSpec("price").components[0],))).total_hits > 0
# the eager run put its prefix mask in the query cache; a second run hits it
from nrtsearch_tpu_torch.search.query_cache import DEFAULT_QUERY_CACHE
hits = DEFAULT_QUERY_CACHE.hits
assert s.search(parse_query({"prefixQuery": {"field": "body", "prefix": "ga"}}), 5).total_hits == 120
assert DEFAULT_QUERY_CACHE.hits == hits + 1
# vector search: an int8 column, kNN, a hybrid blend and a rescore
import numpy as np
vfds = dict(fds, vec=create_field_def("vec", {"type": "VECTOR", "vectorDimensions": 8,
                                             "vectorSimilarity": "l2_norm",
                                             "vectorIndexingOptions": "int8"}))
vw = IndexWriter(vfds, "cpu")
vecs = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
vw.add_documents([{"id": str(i), "body": words[i %% 5], "vec": vecs[i].tolist()}
                  for i in range(50)])
vs = Searcher(vw.refresh(), vfds)
assert vs.knn_search("vec", vecs[7], 3).hits[0].global_ord == 7
from nrtsearch_tpu_torch.search import retrievers as rtr
from nrtsearch_tpu_torch.search.rescore import script_rescore
res = rtr.run_retrievers(vs, [
    rtr.RetrieverSpec("text", query=parse_query({"matchQuery": {"field": "body",
                                                                "query": "needle"}})),
    rtr.RetrieverSpec("knn", knn_field="vec", knn_vector=vecs[9], window_size=5)])
blended = rtr.blend_rrf(res, {"text": 1.0, "knn": 2.0})
assert blended[0].global_ord == 9, blended[:3]
assert len(script_rescore(vs, blended, 5, "_score * 2")) == len(blended)
# virtual shards on a (2, 2) grid of the CPU, the merge path's index, the
# standalone bucket API
import torch
from nrtsearch_tpu_torch import device as _device
from nrtsearch_tpu_torch.parallel import DistributedBM25, make_search_mesh
_device.search_devices = lambda: [torch.device("cpu")] * 4
dist = DistributedBM25.from_searcher(s, "body", make_search_mesh())
sc, ids, hits = dist.search(*dist.compile_text_queries([["gamma", "needle"], ["beta"]])[:4],
                            run_len=1024, k=5)
assert hits.tolist() == [120, 180], hits
s.dist_shards = 4
assert s.search(parse_query({"matchQuery": {"field": "body", "query": "gamma needle"}}),
                10).total_hits == 120 and s._dist_cache
from nrtsearch_tpu_torch.core import maxscore
full = s.packed_view("body").index.search(
    [{"entries": [(0.5, [1]), (2.0, [4])], "require_all": False, "n_terms": 1}], 5)
assert full[0][2] > 0
from nrtsearch_tpu_torch.ops import bucket_retrieval as br
bidx = br.BucketIndex.build(np.arange(8, dtype=np.int32), np.ones(8, np.float32),
                            np.array([0, 4]), np.array([4, 4], np.int32), capacity=8,
                            bucket_docs=4)
bplan = br.plan_bucket_batch(bidx, [[(0, 1.0), (1, 2.0)]], np.array([0, 4]), max_terms=2)
assert br.reference_bucket_search(np.arange(8), np.ones(8), bidx, bplan, 3)[2][0] == 8
# the flagship model's five routes on a small corpus, and the native
# postings accumulator under the builder above
from nrtsearch_tpu_torch import native_ext
from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus
from nrtsearch_tpu_torch.ops import dense_head
assert native_ext.get() is not None and w._builder._native is not None
corpus = SyntheticCorpus(3000, 300, 12, seed=1)
model = corpus.to_model("cpu")
fq = corpus.sample_queries(4, 3)
fh = model.search(model.compile_queries(fq), 5)[2]
model.attach_bucket(1024)
model.attach_dense(max_rows=4, min_df=100, bucket_docs=1024, residual=True)
assert model.serve_bucket_batch(model.plan_bucket(fq), 5)[2].tolist() == fh.tolist()
assert dense_head.decode_packed(model.serve_dense_batch(model.plan_dense(fq), 5), 5)[2].tolist() \
    == fh.tolist()
mplan = model.plan_dense_merge(fq)
assert dense_head.decode_packed2(model.serve_dense_merge(mplan, 5, exact_counts=True),
                                 5)[2].tolist() == fh.tolist()
assert dense_head.decode_packed2(model.serve_dense_fused(mplan, 5, exact_counts=True),
                                 5)[2].tolist() == fh.tolist()
loaded = [k for k, v in sys.modules.items() if v is not None]
assert not any(k == "jax" or k.startswith("jax.") for k in loaded)
assert not any(k == "nrtsearch_tpu" or k.startswith("nrtsearch_tpu.") for k in loaded)
print("OK", len(mods))
"""

# the modules of the vector and result-tail slice, each imported above
VECTOR_SLICE = ("nrtsearch_tpu_torch.ops.knn", "nrtsearch_tpu_torch.search.retrievers",
                "nrtsearch_tpu_torch.search.rescore", "nrtsearch_tpu_torch.search.highlight")


# the modules of the virtual-shard, merge-index and standalone-bucket slice
MESH_SLICE = ("nrtsearch_tpu_torch.parallel", "nrtsearch_tpu_torch.parallel.distributed",
              "nrtsearch_tpu_torch.core.maxscore", "nrtsearch_tpu_torch.ops.bucket_retrieval")
# the modules of the flagship slice: the model, the dense head's routes,
# the native postings accumulator
FLAGSHIP_SLICE = ("nrtsearch_tpu_torch.models.flagship", "nrtsearch_tpu_torch.ops.dense_head",
                  "nrtsearch_tpu_torch.ops.dense_fused", "nrtsearch_tpu_torch.native_ext",
                  "nrtsearch_tpu_torch.convert")


def test_port_imports_and_searches_without_jax():
    mods = [m for m in _port_modules() if not _is_wire(m)]
    assert set(VECTOR_SLICE) <= set(mods)
    assert set(MESH_SLICE) <= set(mods)
    assert set(FLAGSHIP_SLICE) <= set(mods)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT % {"blocked": BLOCKED, "mods": mods}],
        capture_output=True, text=True, cwd=str(REPO), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_mods = int(proc.stdout.split()[-1])
    assert n_mods == len(mods) > 10


SERVER_SCRIPT = r"""
import sys, tempfile
for name in %(blocked)r:
    sys.modules[name] = None
import importlib
mods = %(mods)r
for m in mods:
    importlib.import_module(m)
from nrtsearch_tpu_torch.client import NrtsearchClient
from nrtsearch_tpu_torch.config import NrtsearchConfig
from nrtsearch_tpu_torch.gen import pb
from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer
with tempfile.TemporaryDirectory() as tmp:
    srv = NrtsearchServer(NrtsearchConfig.from_dict(
        {"stateDir": tmp + "/state", "indexDir": tmp + "/index"}), device="cpu")
    client = NrtsearchClient("localhost:%%d" %% srv.start(0))
    assert client.status().health == pb.TransferStatusCode.Done
    client.close()
    srv.stop()
loaded = [k for k, v in sys.modules.items() if v is not None]
assert not any(k.split(".")[0] in ("jax", "jaxlib", "nrtsearch_tpu") for k in loaded)
print("OK", len(mods))
"""


def test_server_modules_import_without_jax():
    """Every port module, the wire modules included, imports with jax,
    jaxlib and nrtsearch_tpu blocked, and the port's server answers."""
    mods = _port_modules()
    assert any(_is_wire(m) for m in mods)
    proc = subprocess.run(
        [sys.executable, "-c", SERVER_SCRIPT % {"blocked": JAX_ONLY, "mods": mods}],
        capture_output=True, text=True, cwd=str(REPO), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) == len(mods)


def test_no_port_file_imports_jax():
    jax = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    ref = re.compile(r"^\s*(import|from)\s+nrtsearch_tpu(?!\w)", re.MULTILINE)
    files = [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [
        str(p.relative_to(REPO)) for p in files
        if jax.search(p.read_text()) or ref.search(p.read_text())
    ]
    assert not offenders, offenders


def test_wire_packages_only_in_wire_modules():
    wire = re.compile(r"^\s*(import|from)\s+(grpc|google\.(protobuf|api|type)|yaml)\b",
                      re.MULTILINE)
    offenders = []
    for p in PKG.rglob("*.py"):
        rel = p.relative_to(REPO).with_suffix("")
        module = ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)
        if not _is_wire(module) and wire.search(p.read_text()):
            offenders.append(module)
    assert not offenders, offenders


# ---------------------------------------------------------------------------
# the port's copies against the reference's originals
# ---------------------------------------------------------------------------

ANALYZER_SAMPLE = (
    "The Quick-Brown fox's jumps, running & connected 3.14 e-mail@example.com "
    "L'école des enfants était fermée. Die Häuser wurden schnell gebaut. "
    "Los niños estaban jugando en las calles. Все книги лежали на столах. "
    "I bambini giocavano. De kinderen speelden buiten. Søstrene løp hjem. "
    "Väderleken i Göteborg. Talot ja kaupungit. <b>café</b> naïve"
)
FIELD_SPECS = {
    "body": {"type": "TEXT", "search": True, "store": True},
    "en": {"type": "TEXT", "search": True, "analyzer": "english"},
    "fr": {"type": "TEXT", "search": True, "indexAnalyzer": "fr.French",
           "searchAnalyzer": "standard"},
    "id": {"type": "_ID", "store": True},
    "tag": {"type": "ATOM", "search": True, "storeDocValues": True, "multiValued": True},
    "n": {"type": "INT", "storeDocValues": True, "sort": True},
    "big": {"type": "LONG", "storeDocValues": True},
    "price": {"type": "DOUBLE", "storeDocValues": True},
    "flag": {"type": "BOOLEAN", "storeDocValues": True},
    "when": {"type": "DATE_TIME", "storeDocValues": True,
             "dateTimeFormat": "yyyy-MM-dd"},
    "loc": {"type": "LAT_LON", "storeDocValues": True},
    "vec": {"type": "VECTOR", "vectorDimensions": 4, "vectorSimilarity": "cosine"},
}


def _plain(x):
    """Enums by value, dataclasses as dicts, callables by qualified name:
    objects of the two packages compared by what they hold."""
    if isinstance(x, enum.Enum):
        return x.value
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if callable(x):
        return getattr(x, "__qualname__", type(x).__qualname__)
    return x


def _check_analyzers():
    from nrtsearch_tpu.analysis.analyzers import _DEFAULT_REGISTRY as ref_reg
    from nrtsearch_tpu_torch.analysis.analyzers import _DEFAULT_REGISTRY as port_reg

    names = sorted(ref_reg._analyzers)
    assert names == sorted(port_reg._analyzers) and len(names) > 20
    for name in names:
        ref = [dataclasses.astuple(t) for t in ref_reg.get(name).analyze(ANALYZER_SAMPLE)]
        port = [dataclasses.astuple(t) for t in port_reg.get(name).analyze(ANALYZER_SAMPLE)]
        assert port == ref and ref, name


def _check_field_defs():
    from nrtsearch_tpu.schema.fields import create_field_def as ref_create
    from nrtsearch_tpu_torch.schema import create_field_def

    for name, spec in FIELD_SPECS.items():
        ref, port = ref_create(name, spec), create_field_def(name, spec)
        assert type(port).__module__.startswith("nrtsearch_tpu_torch.")
        assert _plain(port) == _plain(ref), name
        assert port.type.value == ref.type.value == spec["type"]


def _check_query_plans():
    from nrtsearch_tpu.query.plan import parse_query as ref_parse
    from nrtsearch_tpu_torch.query import parse_query
    from tests.test_torch_slice import QUERIES

    queries = [*QUERIES.values(),
               {"booleanQuery": {"clauses": [{"occur": "MUST", "query": QUERIES["or_head"]},
                                             {"occur": "MUST_NOT", "query": QUERIES["term"]}]}},
               {"phraseQuery": {"field": "body", "terms": ["common", "alpha"], "slop": 1}},
               {"rangeQuery": {"field": "n", "lower": "3", "upper": "9"}}]
    for q in queries:
        ref, port = ref_parse(q), parse_query(q)
        assert type(port).__name__ == type(ref).__name__
        assert _plain(dataclasses.asdict(port)) == _plain(dataclasses.asdict(ref)), q


def _check_smallfloat():
    from nrtsearch_tpu.utils.smallfloat import quantize_length as ref_q
    from nrtsearch_tpu_torch.utils.smallfloat import quantize_length

    lengths = np.arange(1 << 20, dtype=np.int64)
    np.testing.assert_array_equal(quantize_length(lengths), ref_q(lengths))


def _check_masks():
    import jax.numpy as jnp
    import torch

    from nrtsearch_tpu.ops import masks as ref_masks
    from nrtsearch_tpu_torch.ops import masks

    rng = np.random.default_rng(4)
    present = rng.random(1000) < 0.9
    for values in (rng.integers(-3, 12, 1000).astype(np.float32),
                   rng.integers(-1, 9, 1000).astype(np.int32)):
        v, p = torch.from_numpy(values), torch.from_numpy(present)
        jv, jp = jnp.asarray(values), jnp.asarray(present)
        lo, hi = values.dtype.type(2), values.dtype.type(7)
        for inc in ((True, True), (False, True), (True, False), (False, False)):
            np.testing.assert_array_equal(
                masks.range_mask(v, p, torch.tensor(lo), torch.tensor(hi), *inc).numpy(),
                np.asarray(ref_masks.range_mask(jv, jp, lo, hi, *map(jnp.asarray, inc))))
        np.testing.assert_array_equal(masks.eq_mask(v, p, torch.tensor(lo)).numpy(),
                                      np.asarray(ref_masks.eq_mask(jv, jp, lo)))
        targets = np.array([0, 3, 5, -1], values.dtype)
        np.testing.assert_array_equal(
            masks.in_set_mask(v, p, torch.from_numpy(targets)).numpy(),
            np.asarray(ref_masks.in_set_mask(jv, jp, jnp.asarray(targets))))
        np.testing.assert_array_equal(masks.exists_mask(p).numpy(),
                                      np.asarray(ref_masks.exists_mask(jp)))


LEAF_QUERIES = [
    {"termQuery": {"field": "tag", "textValue": "t2"}},
    {"termQuery": {"field": "n", "intValue": 4}},
    {"termQuery": {"field": "big", "longValue": 33554439}},
    {"termQuery": {"field": "flag", "booleanValue": True}},
    {"termQuery": {"field": "mtag", "textValue": "m1"}},
    {"termInSetQuery": {"field": "tag", "textTerms": {"terms": ["t1", "t4", "zz"]}}},
    {"termInSetQuery": {"field": "mnum", "intTerms": {"terms": [3, 9]}}},
    {"termInSetQuery": {"field": "d", "doubleTerms": {"terms": [0.5]}}},
    {"rangeQuery": {"field": "d", "lower": "0.25", "upper": "0.75", "upperExclusive": True}},
    {"rangeQuery": {"field": "big", "lower": "33554440"}},
    {"rangeQuery": {"field": "mnum", "upper": "4", "lowerExclusive": True, "lower": "1"}},
    {"boost": 2.5, "existsQuery": {"field": "n"}},
    {"boost": 0.5, "booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"boost": 3.0, "rangeQuery": {"field": "n", "upper": "6"}}},
        {"occur": "SHOULD", "query": {"termQuery": {"field": "tag", "textValue": "t0"}}},
        {"occur": "MUST_NOT", "query": {"termQuery": {"field": "mtag", "textValue": "m2"}}}]}},
]


def _check_leaf_evaluators():
    """query/eval.py's leaves on single- and multi-valued, f32 and f64
    columns, against the reference's eval_node on the same documents."""
    from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
    from nrtsearch_tpu.query import eval as ref_eval
    from nrtsearch_tpu.query.plan import parse_query as ref_parse
    from nrtsearch_tpu.schema.fields import create_field_def as ref_create
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.query import eval as port_eval
    from nrtsearch_tpu_torch.query import parse_query
    from nrtsearch_tpu_torch.schema import create_field_def

    specs = {"tag": {"type": "ATOM", "storeDocValues": True},
             "mtag": {"type": "ATOM", "storeDocValues": True, "multiValued": True},
             "n": {"type": "INT", "storeDocValues": True},
             "big": {"type": "LONG", "storeDocValues": True},
             "flag": {"type": "BOOLEAN", "storeDocValues": True},
             "d": {"type": "DOUBLE", "storeDocValues": True},
             "mnum": {"type": "LONG", "storeDocValues": True, "multiValued": True}}
    rng = np.random.default_rng(8)
    docs = []
    for i in range(200):
        doc = {"tag": f"t{i % 5}", "big": str((1 << 25) + i),
               "d": str([0.25, 0.5, 0.75, 0.1 * (i % 7)][i % 4])}
        if i % 3:
            doc.update(n=str(i % 9), flag=str(i % 2 == 0).lower(),
                       mtag=[f"m{j}" for j in rng.integers(0, 4, 1 + i % 3)],
                       mnum=[str(j) for j in rng.integers(0, 12, 1 + i % 2)])
        docs.append(doc)
    ref_w = RefWriter({n: ref_create(n, s) for n, s in specs.items()})
    ref_w.add_documents([dict(d) for d in docs])
    ref_seg = ref_w.refresh()[0]
    fds = {n: create_field_def(n, s) for n, s in specs.items()}
    port_w = IndexWriter(fds, "cpu")
    port_w.add_documents([dict(d) for d in docs])
    port_seg = port_w.refresh()[0]
    ref_ctx = ref_eval.EvalContext(ref_seg, ref_w.field_defs,
                                   ref_eval.CollectionStats([ref_seg]))
    ctx = port_eval.EvalContext(port_seg, fds, port_eval.CollectionStats([port_seg]))
    for q in LEAF_QUERIES:
        rs, rm = ref_eval.eval_node(ref_parse(q), ref_ctx)
        ps, pm = port_eval.eval_node(parse_query(q), ctx)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(rm), err_msg=str(q))
        np.testing.assert_array_equal(ps.numpy().view(np.int32),
                                      np.asarray(rs).view(np.int32), err_msg=str(q))
        assert np.asarray(rm)[:200].any(), q


MERGE_SPECS = {
    "id": {"type": "_ID", "store": True, "storeDocValues": True},
    "body": {"type": "TEXT", "search": True, "store": True},
    "tag": {"type": "ATOM", "storeDocValues": True},
    "mtag": {"type": "ATOM", "storeDocValues": True, "multiValued": True},
    "cat": {"type": "ATOM", "storeDocValues": True, "multiValued": True},
    "n": {"type": "INT", "storeDocValues": True},
    "d": {"type": "DOUBLE", "storeDocValues": True},
    "big": {"type": "LONG", "storeDocValues": True},
    "mnum": {"type": "LONG", "storeDocValues": True, "multiValued": True},
}
CATS = ["a/b", "a/c", "a/b/x", "d", "d/e"]


def _merge_docs(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    words = ["common", "alpha", "beta", "gamma", "needle", "delta"]
    docs = []
    for i in range(n):
        doc = {"id": f"{seed}-{i}", "body": " ".join(rng.choice(words, 1 + i % 6)),
               "tag": f"t{i % 5}", "big": str((1 << 25) + 7 * i),
               "cat": [CATS[j] for j in rng.integers(0, len(CATS), 1 + i % 2)]}
        if i % 4:
            doc.update(n=str(i % 11), d=str([0.25, 0.5, 1.75][i % 3]),
                       mtag=[f"m{j}" for j in rng.integers(0, 4, 1 + i % 3)],
                       mnum=[str(j) for j in rng.integers(0, 9, 1 + i % 2)])
        docs.append(doc)
    return docs


def _np(x) -> np.ndarray:
    import torch

    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _segment_plain(seg) -> dict:
    """What a segment holds, by value, for either package."""
    fields = {}
    for name, tfi in seg.fields.items():
        n = tfi.postings_len
        fields[name] = {
            "terms": dict(tfi.terms), "offsets": tfi.offsets.tolist(),
            "lengths": tfi.lengths.tolist(), "doc_ids": _np(tfi.doc_ids)[:n].tolist(),
            "freqs": _np(tfi.freqs)[:n].tolist(),
            "doc_lens": _np(tfi.doc_lens)[: seg.capacity].tolist(),
            "sum_doc_lens": tfi.sum_doc_lens, "doc_count": tfi.doc_count,
        }
    dvs = {}
    for name, dv in seg.doc_values.items():
        if name == "_nested_path":
            continue   # the reference marks every flat doc _root; the port keeps none
        dvs[name] = {
            "kind": dv.kind.value, "values": _np(dv.values).tolist(),
            "present": _np(dv.present).tolist(), "host": dv.host_values.tolist(),
            "ord_terms": dv.ord_terms,
            "mv": None if dv.mv_offsets is None else
            (dv.mv_offsets.tolist(), dv.mv_values.tolist()),
        }
    return {"num_docs": seg.num_docs, "capacity": seg.capacity, "stored": seg.stored,
            "live": _np(seg.live).tolist(), "fields": fields, "doc_values": dvs}


def _two_writers(merge_factor: int):
    from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
    from nrtsearch_tpu.schema.fields import create_field_def as ref_create
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.schema import create_field_def

    ref = RefWriter({n: ref_create(n, sp) for n, sp in MERGE_SPECS.items()},
                    merge_factor=merge_factor)
    port = IndexWriter({n: create_field_def(n, sp) for n, sp in MERGE_SPECS.items()},
                       "cpu", merge_factor=merge_factor)
    return ref, port


def _check_merge_segments():
    """merge_segments on the same three segments, then the writer's tiered
    policy over 7 refreshes under segments_per_tier 3 and max_merged_docs:
    the same groups merge into the same segments."""
    from nrtsearch_tpu.core.merge import merge_segments as ref_merge
    from nrtsearch_tpu_torch.core.merge import merge_segments

    ref_w, port_w = _two_writers(merge_factor=100)
    for chunk in range(3):
        docs = _merge_docs(40 + 30 * chunk, seed=chunk)
        ref_w.add_documents([dict(d) for d in docs])
        port_w.add_documents([dict(d) for d in docs])
        ref_segs, port_segs = ref_w.refresh(), port_w.refresh()
    assert len(port_segs) == len(ref_segs) == 3
    ref_m, ref_remap = ref_merge(ref_segs, ref_w.field_defs)
    port_m, port_remap = merge_segments(port_segs, port_w.field_defs)
    assert _segment_plain(port_m) == _segment_plain(ref_m)
    assert [m.tolist() for m in port_remap.values()] == \
        [m.tolist() for m in ref_remap.values()]

    ref_w, port_w = _two_writers(merge_factor=10)
    for w in (ref_w, port_w):
        w.segments_per_tier, w.max_merged_docs = 3, 150
    layouts = []
    for chunk in range(7):
        docs = _merge_docs(20 + 15 * (chunk % 3), seed=10 + chunk)
        ref_w.add_documents([dict(d) for d in docs])
        port_w.add_documents([dict(d) for d in docs])
        ref_segs, port_segs = ref_w.refresh(), port_w.refresh()
        layouts.append([s.num_docs for s in port_segs])
        assert layouts[-1] == [s.num_docs for s in ref_segs]
        for p, r in zip(port_segs, ref_segs):
            assert _segment_plain(p) == _segment_plain(r)
    assert port_w.merge_stats["merges"] == ref_w.merge_stats["merges"] > 1
    assert port_w.merge_stats["merged_docs"] == ref_w.merge_stats["merged_docs"]
    assert max(len(x) for x in layouts) <= 3


def _check_collectors():
    """search/collectors.py function by function against the reference's,
    on the same segments and masks: counts, minima and maxima equal; f32
    sums within 1e-6 relative (another addition order)."""
    import types

    import jax.numpy as jnp
    import torch

    from nrtsearch_tpu.search import collectors as ref_c
    from nrtsearch_tpu_torch.search import collectors as port_c

    ref_w, port_w = _two_writers(merge_factor=100)
    for chunk in range(2):
        docs = _merge_docs(150 + 60 * chunk, seed=20 + chunk)
        ref_w.add_documents([dict(d) for d in docs])
        port_w.add_documents([dict(d) for d in docs])
    ref_segs, port_segs = ref_w.refresh(), port_w.refresh()
    rng = np.random.default_rng(9)
    masks = []
    for seg in port_segs:
        m = np.zeros(seg.capacity, bool)
        m[: seg.num_docs] = rng.random(seg.num_docs) < 0.4
        masks.append(m)
    ref_m = ref_c.SegmentMatches(types.SimpleNamespace(segments=ref_segs),
                                 [jnp.asarray(m) for m in masks])
    port_m = port_c.SegmentMatches(types.SimpleNamespace(segments=port_segs),
                                   [torch.from_numpy(m) for m in masks])

    def close(a, b):
        assert abs(a - b) <= 1e-6 * max(abs(a), 1e-30), (a, b)

    for field in ("tag", "mtag", "n", "big", "mnum", "d"):
        assert port_c.terms_counts(port_m, field) == ref_c.terms_counts(ref_m, field), field
    for r_seg, p_seg, m in zip(ref_segs, port_segs, masks):
        np.testing.assert_array_equal(
            port_c._device_ordinal_counts(torch.from_numpy(m), p_seg.doc_values["tag"]),
            ref_c._device_ordinal_counts(jnp.asarray(m), r_seg.doc_values["tag"]))
    plan = [{"kind": "ordinal", "field": "tag"}, {"kind": "stat", "field": "n", "op": "sum"},
            {"kind": "stat", "field": "d", "op": "min"},
            {"kind": "stat", "field": "n", "op": "max"}, {"kind": "count"},
            {"kind": "ordinal", "field": "mtag"}, {"kind": "stat", "field": "big", "op": "sum"}]
    ref_f, port_f = ref_c.fused_flat_reductions(ref_m, plan), \
        port_c.fused_flat_reductions(port_m, plan)
    assert ref_f[5] is None and ref_f[6] is None
    for p, r in zip(port_f, ref_f):
        if isinstance(r, float):
            close(p, r)
        else:
            assert p == r
    for field in ("n", "d", "big", "mnum"):
        for op in ("sum", "min", "max"):
            close(port_c.numeric_stat(port_m, field, op), ref_c.numeric_stat(ref_m, field, op))
    assert port_c.hit_count(port_m) == ref_c.hit_count(ref_m) > 0
    ranges = [{"label": "low", "min": 0, "max": 4}, {"label": "mid", "min": 4, "max": 9,
                                                     "maxInclusive": True},
              {"label": "open", "min": 0.5, "minInclusive": False}]
    for field in ("n", "mnum", "big", "d"):
        assert port_c.numeric_range_counts(port_m, field, ranges) == \
            ref_c.numeric_range_counts(ref_m, field, ranges), field
    for path in ([], ["a"], ["d"], ["a", "b"]):
        assert port_c.hierarchy_counts(port_m, "cat", path) == \
            ref_c.hierarchy_counts(ref_m, "cat", path), path
    for v in (np.float32(3.0), np.float64(2.5), np.int64(7), 4.0, "x"):
        assert port_c._fmt_num(v) == ref_c._fmt_num(v)
    sub = [rng.random(len(m)) < 0.5 for m in masks]
    assert port_c.hit_count(port_m.and_mask([torch.from_numpy(s) for s in sub])) == \
        ref_c.hit_count(ref_m.and_mask([jnp.asarray(s) for s in sub]))


@pytest.mark.parametrize("check", [_check_analyzers, _check_field_defs,
                                   _check_query_plans, _check_smallfloat,
                                   _check_masks, _check_leaf_evaluators,
                                   _check_merge_segments, _check_collectors],
                         ids=["analyzers", "field_defs", "query_plans", "smallfloat",
                              "masks", "leaf_evaluators", "merge_segments",
                              "collectors"])
def test_copies_equal_reference(check):
    check()


# ---------------------------------------------------------------------------
# the whole copies, by their text
# ---------------------------------------------------------------------------

# each copy's lines that differ from its original (after the copy's header
# and its import lines are normalized): (removed, added), stripped
COPY_EXCEPTIONS = {
    # the serving path's gauge takes its route from core/packed_view.py's
    # fast_path on the device the node's indexes live on; the batcher's
    # group sizes and waits have histograms of their own
    "server/monitoring.py": (
        ["import os as _os", "", "from nrtsearch_tpu.core.maxscore import _on_tpu",
         'active = _os.environ.get("NRT_FAST_PATH", "") or (',
         '"dense" if _on_tpu() else "merge"', ")",
         'if active == "fused":   # round-5 alias: the fused dense path', 'active = "dense"'],
        ["from nrtsearch_tpu.core.packed_view import fast_path", "",
         'on_cuda = getattr(getattr(self.global_state, "device", None), "type", "") == "cuda"',
         "active = fast_path(on_cuda)",
         "# the micro-batcher (server/batcher.py): queries per dispatched",
         "# group, and each query's wait from its enqueue to its group's", "# dispatch",
         "self.batcher_group_size = Histogram(", '"nrt_batcher_group_size",',
         '"queries per micro-batcher group",', "registry=self.registry,",
         "buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),", ")",
         "self.batcher_wait = Histogram(", '"nrt_batcher_wait_seconds",',
         '"per query, from the batcher\'s enqueue to its group\'s dispatch",',
         "buckets=_BUCKETS,"]),
    # the batcher observes its group sizes and waits in the server's Metrics
    # (the original observed a histogram its Metrics lacks and hid the
    # AttributeError); its unread stats() and counters are gone
    "server/batcher.py": (
        ["self.queries_batched = 0", "self.batch_size_hist: dict[int, int] = {}", "",
         "def stats(self) -> dict:",
         '"""Formed-batch counters (avg size = coalescing actually happening)."""',
         "n = self.batches_formed", "return {", '"batches_formed": n,',
         '"queries_batched": self.queries_batched,',
         '"avg_batch_size": round(self.queries_batched / n, 2) if n else 0.0,',
         '"batch_size_hist": {',
         "str(k): v for k, v in sorted(self.batch_size_hist.items())", "},", "}",
         "self.queries_batched += len(group)", "g = len(group)",
         "self.batch_size_hist[g] = self.batch_size_hist.get(g, 0) + 1",
         "if self.metrics is not None:", "try:",
         "self.metrics.micro_batch_size.observe(len(group))", "except Exception:", "pass",
         "key = (id(head.searcher), head.spec.field)",
         "if (id(p.searcher), p.spec.field) == key"],
        ["enqueued: float = field(default_factory=time.perf_counter)",
         "if self.metrics is not None:", "now = time.perf_counter()",
         "self.metrics.batcher_group_size.observe(len(group))", "for p in group:",
         "self.metrics.batcher_wait.observe(now - p.enqueued)",
         # kNN-only requests group by (snapshot, field, k, boost) and take one
         # Searcher.knn_search_batch call per group
         "import numpy as np", "", "@dataclass(frozen=True)", "class KnnSpec:",
         '"""A kNN-only request: its field, f32 [dims] query vector and boost."""',
         "field: str", "vector: object", "boost: float = 1.0",
         "def _group_key(p: _Pending) -> tuple:",
         '"""What one dispatch answers together: text queries of one snapshot and',
         'field; kNN requests of one snapshot, field, k and boost."""',
         "if isinstance(p.spec, KnnSpec):",
         'return (id(p.searcher), p.spec.field, "knn", p.k, p.spec.boost)',
         "return (id(p.searcher), p.spec.field)",
         "def knn_search(self, searcher, field: str, vector, k: int, boost: float = 1.0):",
         '"""Submit one kNN-only request (``KnnSpec``); blocks until its',
         "group's ``Searcher.knn_search_batch`` call completes.\"\"\"",
         "return self.search(searcher, KnnSpec(field, vector, boost), k)",
         "key = _group_key(head)", "if _group_key(p) == key",
         "if isinstance(group[0].spec, KnnSpec):", "return self._run_knn_group(group)",
         "def _run_knn_group(self, group: list[_Pending]) -> None:", "spec = group[0].spec",
         "results = group[0].searcher.knn_search_batch(",
         "spec.field, np.stack([p.spec.vector for p in group]), group[0].k,",
         "boost=spec.boost)", "self.batches_formed += 1", "for p, td in zip(group, results):",
         "p.result = td", "p.done.set()"]),
    # a vector fetch reads the hit's presence bit and copies its row alone
    "search/fetch.py": (
        ["if not np.asarray(vc.present)[local]:",
         "return [vc.host_float()[local].tolist()]"],
        ["if not bool(vc.present[local]):",
         "return [vc.host_row(local).tolist()]"]),
    # the rescore query's tensors come to the host through .cpu()
    "search/rescore.py": (
        ["seg_arrays[h.segment_idx] = (np.asarray(scores), np.asarray(match))"],
        ["seg_arrays[h.segment_idx] = (scores.cpu().numpy(), match.cpu().numpy())"]),
    "state/global_state.py": (
        [],
        ["import torch", "", "*,", "device: str | torch.device,",
         "from nrtsearch_tpu.device import resolve_device",
         "self.device = resolve_device(device)", "device=self.device,"]),
    "server/index_runtime.py": (
        ["self.writer = IndexWriter(self.field_defs, merge_factor=merge_factor)",
         "manifest, segments = open_commit(self.index_dir)",
         "load_segment(sid, self.index_dir, del_gen)",
         "load_segment(sid, self.index_dir, dg) for sid, dg in manifest.segments",
         "ids = np.nonzero(np.asarray(mask)[: seg.num_docs])[0]"],
        ["import torch", "*,", "device: str | torch.device,",
         "self.writer = IndexWriter(self.field_defs, device, merge_factor=merge_factor)",
         "self.device = self.writer.device",
         "manifest, segments = open_commit(self.index_dir, self.device)",
         "load_segment(sid, self.index_dir, self.device, del_gen)",
         "load_segment(sid, self.index_dir, self.device, dg)",
         "for sid, dg in manifest.segments",
         "ids = np.nonzero(np.asarray(mask[: seg.num_docs].cpu()))[0]"]),
    # the usage lines name the port's entry points
    "cli.py": (
        ["Usage: python -m nrtsearch_tpu.cli --host localhost --port 8000 <command> ..."],
        ["Usage: python -m nrtsearch_tpu_torch.cli --host localhost --port 8000 <command> ..."]),
    "nrt_utils.py": (
        ["Usage: python -m nrtsearch_tpu.nrt_utils [--root DIR | --bucket B] <cmd> ..."],
        ["Usage: python -m nrtsearch_tpu_torch.nrt_utils [--root DIR | --bucket B] <cmd> ..."]),
    # a virtual field's scores come from device tensors (None on a
    # score-free answer, which passes through as in the original); a kNN
    # hit's query score and match bit are read through .item() (from a
    # device tensor or a numpy array), the drill-sideways masks and the
    # inner hits' child answer through .cpu(): np.asarray refuses a CUDA
    # tensor
    "server/handlers.py": (
        ["score_arr = np.asarray(arrays[idx][0])",
         "if bool(np.asarray(m_arr[h.local_id])):",
         "qs = float(np.asarray(s_arr[h.local_id]))",
         "matches.searcher, [np.asarray(m) for m in masks]",
         "inner_cache[cache_key] = (np.asarray(scores), np.asarray(match))",
         # a kNN-only request without a filter, sort, facets, collectors or
         # rescorers goes to the batcher
         "td = self._knn_only(searcher, req.knn, fetch_n)",
         "def _exec_knn(self, searcher, knn_req, fetch_n: int):",
         "def _knn_only(self, searcher, knn_reqs, fetch_n: int):",
         "td = self._exec_knn(searcher, knn_req, fetch_n)"],
        ["score_arr = arrays[idx][0]",
         "score_arr = np.asarray(score_arr if score_arr is None else score_arr.cpu())",
         "if bool(m_arr[h.local_id].item()):",
         "qs = float(s_arr[h.local_id].item())",
         "matches.searcher, [np.asarray(m.cpu()) for m in masks]",
         "inner_cache[cache_key] = (np.asarray(scores.cpu()), np.asarray(match.cpu()))",
         "td = self._knn_only(searcher, req.knn, fetch_n, batchable=(",
         "sort is None and not req.facets and not req.collectors",
         "and not req.rescorers))",
         "def _exec_knn(self, searcher, knn_req, fetch_n: int, batchable: bool = False):",
         "fd = searcher.field_defs.get(knn_req.field)",
         'if (batchable and self.batcher is not None and not knn_req.HasField("filter")',
         "and fd is not None and fd.vector_queryable",
         "and len(knn_req.query_vector) == fd.dims):",
         "return self.batcher.knn_search(",
         "searcher, knn_req.field, np.asarray(list(knn_req.query_vector), np.float32),",
         "max(knn_req.k or 10, fetch_n), boost=knn_req.boost or 1.0)",
         "def _knn_only(self, searcher, knn_reqs, fetch_n: int, batchable: bool = False):",
         "td = self._exec_knn(searcher, knn_req, fetch_n, batchable and len(knn_reqs) == 1)"]),
    # entries are keyed by the segment's device as well as its id
    "search/query_cache.py": (
        ["def get(self, seg_id: str, node: qp.QueryNode) -> Optional[Any]:",
         "key = (seg_id, node)",
         "def put(self, seg_id: str, node: qp.QueryNode, value: Any) -> None:"],
        ["def get(self, seg_id: str, node: qp.QueryNode, device=None) -> Optional[Any]:",
         "key = (seg_id, str(device), node)",
         "def put(self, seg_id: str, node: qp.QueryNode, value: Any, device=None) -> None:"]),
}
WHOLE_COPIES = [
    "gen/__init__.py", "gen/yelp/__init__.py", "gen/yelp/nrtsearch/__init__.py",
    "gen/yelp/nrtsearch/analysis_pb2.py", "gen/yelp/nrtsearch/search_pb2.py",
    "gen/yelp/nrtsearch/luceneserver_pb2.py", "version.py", "config.py",
    "client.py", "query/text_parser.py", "state/__init__.py",
    "state/index_state.py", "state/backend.py", "nrt/__init__.py",
    "nrt/point_state.py", "remote/__init__.py", "remote/backend.py",
    "search/__init__.py", "search/retrievers.py", "search/highlight.py",
    "server/__init__.py", "server/__main__.py",
    "server/concurrent.py", "server/warming.py",
    "server/plugins.py", "server/replication.py",
    "server/rest_gateway.py", "remote/s3.py", "remote/s3_client.py",
    "remote/fake_s3.py",
    *COPY_EXCEPTIONS,
]
_COPY_HEADER = re.compile(r" ?Copy of ``nrtsearch_tpu/[^`]+``.*?(?=\"\"\"|\n\n)", re.S)
_PORT_IMPORT = re.compile(r"^(\s*(?:from|import) )nrtsearch_tpu_torch(?=[.\s])", re.M)


@pytest.mark.parametrize("rel", WHOLE_COPIES)
def test_whole_copy_holds_original_text(rel):
    """The copy names its original in its docstring's first line and, with
    that line dropped and its imports pointed back, is the original's text
    but for its listed exceptions."""
    import difflib

    text = (PKG / rel).read_text()
    assert f"Copy of ``nrtsearch_tpu/{rel}``" in text
    text = _COPY_HEADER.sub("", text, count=1)
    text = text.replace('"""\n\n', '"""', 1) if text.startswith('"""\n\n') else text
    text = _PORT_IMPORT.sub(lambda m: m.group(1) + "nrtsearch_tpu", text)
    lines = [ln for ln in text.splitlines() if ln != '""""""']
    original = (REPO / "nrtsearch_tpu" / rel).read_text().splitlines()
    removed, added = [], []
    for ln in difflib.unified_diff(original, lines, lineterm="", n=0):
        if ln.startswith(("---", "+++", "@@")):
            continue
        (removed if ln[0] == "-" else added).append(ln[1:].strip())
    allowed_removed, allowed_added = COPY_EXCEPTIONS.get(rel, ([], []))
    assert set(removed) <= set(allowed_removed), removed
    assert set(added) <= set(allowed_added), added
