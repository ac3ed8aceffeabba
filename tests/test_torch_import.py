"""The port stands without JAX and the server's packages.

In a fresh interpreter where jax, jaxlib, msgpack, yaml, grpc and
google.protobuf cannot be imported, every module of nrtsearch_tpu_torch
imports and a 300-document index answers a search on the CPU. A source scan
checks that no port file imports jax.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import nrtsearch_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "nrtsearch_tpu_torch"

BLOCKED = ("jax", "jaxlib", "msgpack", "yaml", "grpc", "google.protobuf")

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
from nrtsearch_tpu.query.plan import parse_query
from nrtsearch_tpu.schema.fields import create_field_def
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
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
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
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    offenders = [
        str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert not offenders, offenders
    assert not pattern.search((REPO / "chip_smoke.py").read_text())
