"""The batched text route on the CPU: ``core/packed_view.fast_path`` is the
one reader of ``NRT_FAST_PATH``, and the path ``search_batch`` serves, the
dense rows ``Searcher.warm`` builds and the ``nrt_search_fast_path`` gauge
all follow it, on a CPU index and on one marked as on the device. Settings
the port does not read change neither answers nor paths.
"""

import types

import numpy as np
import pytest
import torch

from nrtsearch_tpu_torch.convert import segment_from_numpy
from nrtsearch_tpu_torch.core import packed_view
from nrtsearch_tpu_torch.core import searcher as searcher_mod
from nrtsearch_tpu_torch.core.searcher import Searcher
from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def
from nrtsearch_tpu_torch.server.monitoring import Metrics

K = 10
# the path_counts key of each route
SERVED = {"dense": "fused", "bucket": "bucket", "merge": "merge"}
# settings of the MaxScore route, the second spelling of the bucket route
# and the fused path's shapes: each changed the answers or the path served
RETIRED = {"NRT_MAXSCORE": "1", "NRT_BUCKET": "1", "NRT_DENSE_R": "2", "NRT_DENSE_U": "1",
           "NRT_DENSE_RL": "1", "NRT_DENSE_RESIDUAL": "0"}


@pytest.fixture(scope="module")
def corpus():
    """A 2-segment corpus and one batch of 3-term OR queries, each
    eligible for every path."""
    c = SyntheticCorpus(3000, 300, 12, seed=1)
    return c.segment_arrays(2), c.sample_queries(6, 3)


def _served(corpus):
    """A fresh snapshot of the corpus, its view of ``body`` and the batch's
    specs."""
    arrays, queries = corpus
    fds = {"body": create_field_def("body", {"type": "TEXT", "search": True})}
    s = Searcher([segment_from_numpy(a, "cpu") for a in arrays], fds)
    specs = [s.fast_query_spec(parse_query({"matchQuery": {"field": "body",
                                                           "query": " ".join(q)}}))
             for q in queries]
    return s, s.packed_view("body"), specs


def _gauge(on_device: bool) -> dict:
    """The scraped ``nrt_search_fast_path`` value of each path label."""
    node = types.SimpleNamespace(device=torch.device("cuda" if on_device else "cpu"),
                                 runtimes={})
    text = Metrics(node).scrape()
    return {p: f'nrt_search_fast_path{{path="{p}"}} 1.0' in text
            for p in ("dense", "merge", "bucket")}


@pytest.mark.parametrize("on_device", [False, True], ids=["cpu", "device"])
@pytest.mark.parametrize("value", [None, "dense", "fused", "merge", "bucket"])
def test_one_function_picks_the_route(corpus, monkeypatch, value, on_device):
    """Unset: dense on the device, merge on the CPU; ``fused`` is dense. The
    route, warm's build of the dense rows, the path served and the gauge
    agree for each value."""
    if value is None:
        monkeypatch.delenv("NRT_FAST_PATH", raising=False)
    else:
        monkeypatch.setenv("NRT_FAST_PATH", value)
    want = {None: "dense" if on_device else "merge", "fused": "dense"}.get(value, value)
    assert packed_view.fast_path(on_device) == want
    for mod in (packed_view, searcher_mod):
        monkeypatch.setattr(mod, "on_cuda", lambda _t: on_device)
    s, view, specs = _served(corpus)
    s.warm(["body"])
    assert (view._dense_st is not None) == (want == "dense")
    view.search_batch(specs, K)
    assert view.path_counts == {p: len(specs) if p == SERVED[want] else 0
                                for p in view.path_counts}
    assert _gauge(on_device) == {p: p == want for p in ("dense", "merge", "bucket")}


@pytest.mark.parametrize("route", ["merge", "dense", "bucket"])
def test_retired_settings_change_nothing(corpus, monkeypatch, route):
    """``NRT_MAXSCORE=1``, ``NRT_BUCKET=1`` and the fused path's old shape
    settings leave ``search_batch``'s answers and ``path_counts`` as they
    are without them."""
    monkeypatch.setenv("NRT_FAST_PATH", route)
    _s, base_view, specs = _served(corpus)
    base = base_view.search_batch(specs, K)
    assert base_view.path_counts[SERVED[route]] == len(specs)
    for name, value in RETIRED.items():
        monkeypatch.setenv(name, value)
    _s, view, specs = _served(corpus)
    got = view.search_batch(specs, K)
    assert view.path_counts == base_view.path_counts
    for i, (g, b) in enumerate(zip(got, base)):
        np.testing.assert_array_equal(g.scores.view(np.int32), b.scores.view(np.int32),
                                      err_msg=str(i))
        np.testing.assert_array_equal(g.docs, b.docs, err_msg=str(i))
        assert (g.total_hits, g.pruned) == (b.total_hits, b.pruned), i
