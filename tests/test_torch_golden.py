"""The JSON golden suites (tests/resources/golden/*.json, 52 cases in 9
suites) through the port, on the CPU.

Each suite declares a schema, documents and cases of {query -> expected hit
ids (+ total)}, as tests/test_golden_queries.py runs them through the
reference. Here the port's own IndexWriter builds each suite's index and
its ``Searcher.search`` answers every case, the positional ones (phrase,
match-phrase, phrase-prefix and span queries) included.
"""

import json
from pathlib import Path

import pytest

from nrtsearch_tpu_torch.core.searcher import Searcher, SortSpec
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def

GOLDEN_DIR = Path(__file__).parent / "resources" / "golden"
SUITES = sorted(GOLDEN_DIR.glob("*.json"))

_CACHE: dict = {}


def _suite(path: Path):
    if path not in _CACHE:
        spec = json.loads(path.read_text())
        fields = {name: create_field_def(name, f) for name, f in spec["fields"].items()}
        w = IndexWriter(fields, "cpu", merge_factor=100)
        w.add_documents([dict(d) for d in spec["docs"]])
        _CACHE[path] = (Searcher(w.refresh(), fields, version=1),
                        [d["doc_id"] for d in spec["docs"]], spec["cases"])
    return _CACHE[path]


def _cases():
    out = []
    for path in SUITES:
        for i, case in enumerate(json.loads(path.read_text())["cases"]):
            out.append(pytest.param(path, i, id=f"{path.stem}:{case.get('name', i)}"))
    return out


def test_all_cases_present():
    assert len(SUITES) == 9 and len(_cases()) == 52


@pytest.mark.parametrize("path,case_idx", _cases())
def test_golden(path, case_idx):
    searcher, ids, cases = _suite(path)
    case = cases[case_idx]
    q = parse_query(case["query"])
    sort = None
    if "sort" in case:
        sort = SortSpec(case["sort"]["field"], case["sort"].get("reverse", False))
    td = searcher.search(q, top_hits=case.get("topHits", 10), sort=sort)
    got_ids = [ids[h.global_ord] for h in td.hits]
    if case.get("ordered", True):
        assert got_ids == case["expectIds"], got_ids
    else:
        assert sorted(got_ids) == sorted(case["expectIds"]), got_ids
    if "expectTotal" in case:
        assert td.total_hits == case["expectTotal"]
