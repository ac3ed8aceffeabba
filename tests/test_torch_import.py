"""The port stands alone: without JAX, the server's packages and the JAX
package itself.

In a fresh interpreter where jax, jaxlib, msgpack, yaml, grpc,
google.protobuf and nrtsearch_tpu cannot be imported, every module of
nrtsearch_tpu_torch imports and a 300-document index answers a text search
and the filtered, sorted and faceted forms on the CPU (only
core/directory.py reads msgpack, inside its functions). A source scan checks that no port file and no line of
chip_smoke.py imports jax or nrtsearch_tpu. The port's copies of the
reference's backend-free modules (analysis, schema, query plan, smallfloat)
are held to the originals, and so are the doc-value masks (ops/masks.py) and
the eager leaf evaluators of query/eval.py, on the same inputs.
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

SCRIPT = r"""
import sys
for name in %(blocked)r:
    sys.modules[name] = None
import importlib, pkgutil
import nrtsearch_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    nrtsearch_tpu_torch.__path__, "nrtsearch_tpu_torch.")]
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
loaded = [k for k, v in sys.modules.items() if v is not None]
assert not any(k == "jax" or k.startswith("jax.") for k in loaded)
assert not any(k == "nrtsearch_tpu" or k.startswith("nrtsearch_tpu.") for k in loaded)
print("OK", len(mods))
"""


def test_port_imports_and_searches_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT % {"blocked": BLOCKED}],
        capture_output=True, text=True, cwd=str(REPO), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_mods = int(proc.stdout.split()[-1])
    expected = len(list(pkgutil.walk_packages(
        nrtsearch_tpu_torch.__path__, "nrtsearch_tpu_torch.")))
    assert n_mods == expected > 10


def test_no_port_file_imports_jax():
    jax = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    ref = re.compile(r"^\s*(import|from)\s+nrtsearch_tpu(?!\w)", re.MULTILINE)
    files = [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [
        str(p.relative_to(REPO)) for p in files
        if jax.search(p.read_text()) or ref.search(p.read_text())
    ]
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


@pytest.mark.parametrize("check", [_check_analyzers, _check_field_defs,
                                   _check_query_plans, _check_smallfloat,
                                   _check_masks, _check_leaf_evaluators],
                         ids=["analyzers", "field_defs", "query_plans", "smallfloat",
                              "masks", "leaf_evaluators"])
def test_copies_equal_reference(check):
    check()
