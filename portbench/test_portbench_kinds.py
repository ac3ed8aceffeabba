"""A configuration of a second kind runs through the harness with no file of
the benchmark changed: exact top k of seeded f32 vectors [D, 16] against
queries [B, 16], its kind (data, queries, plain torch reference, check,
least bytes) and its engine defined here and registered as modules, its
configuration, traffic and ``BENCHMARK.json`` written into a temporary
root. A sound engine reads ``correct`` true; one that drops an answer of
each query, and the control (the reference in bf16), read it false."""

import json
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import compare, generate, harness, kinds, peaks, trace
from portbench.control import control_numbers
from portbench.metrics import merge_roofline_pct

CELL = "toy-1k.vec-b8"
CONFIG = {"name": "toy-1k", "kind": "toy", "engine": "toy", "reduced": {},
          "vectors": {"num_docs": 1000, "dims": 16}}
TRAFFIC = {"batch": 8, "k": 10, "warmup_batches": 2, "max_batches": 20000,
           "check": {"control": {"dtype": "bfloat16"}, "mode": "relative", "sample": 64,
                     "limits": {"score_gap": 1e-4, "hits_wrong": 0, "short_lists": 0,
                                "order_faults": 0}}}
BENCH = {
    "command": ["python3", "-m", "portbench"], "paths": ["portbench"], "run_seconds": 10,
    "configs": [{"name": "toy-1k", "source": "a test", "file": "portbench/configs/toy-1k.json",
                 "reduced": [], "why": "a second kind"}],
    "workloads": [{"name": CELL, "config": "toy-1k", "traffic": "vec-b8", "chips": 1,
                   "why": "exact top 10 of 8 queries"}],
    "end_to_end": [
        {"name": "qps.toy", "unit": "queries/s", "better": "higher", "bound": 0.1,
         "source": "host_clock", "workloads": [CELL]},
        {"name": "p95_ms.toy", "unit": "ms", "better": "lower", "bound": 0.1,
         "source": "host_clock", "workloads": [CELL]},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}],
    "per_layer": [],
}


# -- the toy kind -------------------------------------------------------------

def make_data(cfg, seed, device):
    v = cfg["vectors"]
    g = generate.generator(seed, "corpus", device)
    return torch.randn(int(v["num_docs"]), int(v["dims"]), generator=g, device=device), {}


class QueryStream:
    def __init__(self, cfg, traffic, seed, stream, n_batches, device):
        g = generate.generator(seed, stream, device)
        self.q = torch.randn(n_batches, int(traffic["batch"]), int(cfg["vectors"]["dims"]),
                             generator=g, device=device).cpu().numpy()

    def __len__(self):
        return len(self.q)

    def batch(self, i):
        return self.q[i]


class Reference:
    def __init__(self, data, cfg, control=None):
        self.dtype = getattr(torch, (control or {}).get("dtype", "float64"))
        self.x = data.to(self.dtype)

    def dense(self, queries):
        s = torch.as_tensor(queries).to(self.dtype) @ self.x.T
        return s, torch.ones_like(s, dtype=torch.bool)

    def topk(self, scores, matched, k):
        vals, idx = torch.sort(scores.to(torch.float64), dim=1, descending=True, stable=True)
        return (vals[:, :k].numpy(), idx[:, :k].numpy(),
                matched.sum(dim=1).numpy().astype(np.int64))


def check(ref, queries, prog, k, chk):
    p_scores, p_docs, p_hits = prog
    dense, matched = ref.dense(queries)
    r_scores, _r_docs, r_hits = ref.topk(dense, matched, k)
    dense = dense.to(torch.float64).numpy()
    out = {"score_gap": 0.0, "hits_wrong": compare.hits_wrong(p_hits, r_hits),
           "short_lists": compare.short_lists(p_scores, r_hits, k), "order_faults": 0}
    for j in range(len(queries)):
        n = int(np.isfinite(p_scores[j]).sum())
        d = p_docs[j, :n]
        out["order_faults"] += compare.order_faults(p_scores[j], p_docs[j], n) + int(
            np.count_nonzero((d < 0) | (d >= dense.shape[1])))
        p = p_scores[j, :n].astype(np.float64)
        doc_ref = dense[j, np.clip(d, 0, dense.shape[1] - 1)]
        gaps = np.concatenate([np.abs(p - r_scores[j, :n]) / np.abs(r_scores[j, :n]),
                               np.abs(p - doc_ref) / np.abs(doc_ref)])
        out["score_gap"] = max(out["score_gap"], float(gaps.max(initial=0.0)))
    return out


def least_bytes(data, batch, k):
    return data.numel() * 4 + batch.nbytes + batch.shape[0] * (k * 8 + 4)


TINY = {}


# -- its engine ---------------------------------------------------------------

class Engine:
    drop = False   # drop the last of each query's k answers

    def __init__(self, cfg, traffic, data, columns, device):
        self.x, self.k, self.setup_split = data, int(traffic["k"]), {}

    def run_batch(self, queries):
        s = torch.as_tensor(queries, device=self.x.device) @ self.x.T
        vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :self.k].clone(), idx[:, :self.k]
        if self.drop:
            vals[:, -1] = float("-inf")
        return vals.cpu().numpy(), idx.cpu().numpy(), len(self.x)

    def answers(self, raw):
        scores, docs, n = raw
        docs = np.where(np.isfinite(scores), docs, -1).astype(np.int32)
        return scores.astype(np.float32), docs, np.full(len(scores), n, np.int64)

    def describe(self):
        return "toy"

    def close(self):
        self.x = None


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """The toy kind and engine registered, and a root that holds its
    configuration, traffic and BENCHMARK.json."""
    for sub, name in (("configs", "toy-1k"), ("traffic", "vec-b8")):
        (tmp_path / "portbench" / sub).mkdir(parents=True)
        (tmp_path / "portbench" / sub / f"{name}.json").write_text(
            json.dumps(CONFIG if sub == "configs" else TRAFFIC))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setitem(sys.modules, "portbench.kinds.toy", _module(
        "portbench.kinds.toy", make_data=make_data, QueryStream=QueryStream,
        Reference=Reference, check=check, least_bytes=least_bytes, TINY=TINY))
    monkeypatch.setitem(sys.modules, "portbench.engines.toy",
                        _module("portbench.engines.toy", Engine=Engine))
    return tmp_path


def test_a_sound_engine_of_another_kind_is_correct(toy_root, cpu):
    result, lines = harness.run_cell(CELL, 2**31 + 21, 0.2, False, cpu)
    assert result["correct"] is True, lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"qps.toy", "p95_ms.toy", "setup_s"}
    assert result["check"]["score_gap"]["value"] < 1e-5


def test_an_engine_that_drops_an_answer_is_not_correct(toy_root, cpu, monkeypatch):
    monkeypatch.setattr(Engine, "drop", True)
    result, lines = harness.run_cell(CELL, 2**31 + 22, 0.2, False, cpu)
    assert result["correct"] is False, lines
    assert result["check"]["short_lists"]["value"] == TRAFFIC["check"]["sample"]


def test_the_control_of_another_kind_is_not_correct(toy_root, cpu):
    out = control_numbers(CELL, 2**31 + 23, cpu)
    assert out["correct"] is False
    assert out["numbers"]["score_gap"] > 3 * TRAFFIC["check"]["limits"]["score_gap"]


def test_roofline_readers_count_the_kinds_bytes(toy_root, cpu):
    kind = kinds.load("toy")
    data = make_data(CONFIG, 5, cpu)[0]
    batch = QueryStream(CONFIG, TRAFFIC, 5, "queries", 1, cpu).batch(0)
    least = least_bytes(data, batch, 10) / peaks.HBM_BYTES_PER_S
    run = SimpleNamespace(kind=kind, data=data, batches=[batch, batch], k=10,
                          summary=trace.Summary(window_s=1.0, busy_s=0.5,
                                                layer_s={merge_roofline_pct.LAYER: 8 * least}))
    assert merge_roofline_pct.read(run) == pytest.approx(25.0)
