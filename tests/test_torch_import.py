"""The port stands alone: without JAX, the server's packages and the JAX
package itself.

In a fresh interpreter where jax, jaxlib, msgpack, yaml, grpc,
google.protobuf and nrtsearch_tpu cannot be imported, every module of
nrtsearch_tpu_torch imports and a 300-document index answers a search on
the CPU. A source scan checks that no port file and no line of
chip_smoke.py imports jax or nrtsearch_tpu. The port's copies of the
reference's backend-free modules (analysis, schema, query plan, smallfloat)
are held to the originals.
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
fds = {"id": create_field_def("id", {"type": "_ID", "store": True}),
       "body": create_field_def("body", {"type": "TEXT", "search": True})}
w = IndexWriter(fds, "cpu")
words = ["common", "alpha", "beta", "gamma", "needle"]
w.add_documents([{"id": str(i), "body": " ".join(words[: 1 + i %% 5])}
                 for i in range(300)])
s = Searcher(w.refresh(), fds)
td = s.search(parse_query({"matchQuery": {"field": "body", "query": "gamma needle"}}), 10)
assert td.total_hits == 120, td.total_hits
assert len(td.hits) == 10 and td.hits[0].score > 0
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


@pytest.mark.parametrize("check", [_check_analyzers, _check_field_defs,
                                   _check_query_plans, _check_smallfloat],
                         ids=["analyzers", "field_defs", "query_plans", "smallfloat"])
def test_copies_equal_reference(check):
    check()
