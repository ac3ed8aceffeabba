"""The readers of the program's own spans and counters, on made-up runs:
what each counter sums, the reading per batch, and what each reads where
nothing ran and where the program has no spans."""

import pytest

from portbench import harness, metrics, spans
from portbench.trace import Summary

SPAN_READERS = {   # reader: the spans its counter sums
    "host_plan_ms": {"plan", "plan.terms", "plan.runs"},
    "fused_attempt_ms": {"fused"},
    "host_results_ms": {"results"},
    "device_wait_ms": {"sync", "readback"},
    "gc_ms": {"gc"},
}
ALL_SPANS = ["plan", "plan.terms", "plan.runs", "fused", "results", "sync", "readback",
             "gc", "topk.fallback", "planner"]


def _run(counters: dict, batches: int = 4, busy_s: float = 1.0, layer_s=None):
    run = harness.Run(batch=32, k=100)
    run.batches = [None] * batches
    run.counters = counters
    run.summary = Summary(window_s=2.0, busy_s=busy_s, layer_s=layer_s or {})
    return run


@pytest.fixture
def span_ns(monkeypatch):
    """The program's SPAN_NS replaced by a dict of the test's own: span i
    of ALL_SPANS holds 10 ** i ns."""
    from nrtsearch_tpu_torch import tracing

    fake = {name: 10 ** i for i, name in enumerate(ALL_SPANS)}
    monkeypatch.setattr(tracing, "SPAN_NS", fake)
    return fake


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_counter_sums_its_spans(name, span_ns):
    reader = metrics.load(name)
    assert reader.counter() == sum(span_ns[s] for s in SPAN_READERS[name])


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader_gives_ms_per_batch(name):
    reader = metrics.load(name)
    assert reader.read(_run({reader.__name__: 6_000_000})) == pytest.approx(1.5)
    assert reader.read(_run({reader.__name__: 6_000_000}, batches=0)) is None


@pytest.mark.parametrize("name,want", [("host_plan_ms", None), ("fused_attempt_ms", None),
                                       ("host_results_ms", None), ("device_wait_ms", None),
                                       ("gc_ms", 0.0)])
def test_a_span_that_never_ran(name, want):
    """A span renamed or gone reads None (the run fails); a window without
    a collection reads 0.0."""
    reader = metrics.load(name)
    assert reader.read(_run({reader.__name__: 0})) == want


def test_no_device_no_wait():
    from portbench.metrics import device_wait_ms

    assert device_wait_ms.read(_run({device_wait_ms.__name__: 0}, busy_s=0.0)) == 0.0


def test_a_program_without_spans_reads_zero(monkeypatch):
    """The program before its spans and counters: every new reader reads
    0.0, and no call is wrapped for the fallback's layer."""
    from portbench.metrics import (fused_refusals_per_batch, topk_fallback_ms)

    real = spans.program_has
    monkeypatch.setattr(spans, "program_has", lambda module, attr: False)
    monkeypatch.setattr(topk_fallback_ms, "program_has", spans.program_has)
    assert spans.span_ns("plan") == 0
    for name in SPAN_READERS:
        reader = metrics.load(name)
        assert reader.read(_run({reader.__name__: reader.counter()})) == 0.0
    assert topk_fallback_ms.SPANS == []
    assert topk_fallback_ms.read(_run({topk_fallback_ms.__name__: 3})) == 0.0
    monkeypatch.setattr(spans, "program_has", real)
    from nrtsearch_tpu_torch.core import packed_view

    monkeypatch.delattr(packed_view, "FUSED_REFUSALS")
    assert fused_refusals_per_batch.counter() == 0


def test_fused_refusals_per_batch(monkeypatch):
    from nrtsearch_tpu_torch.core import packed_view
    from portbench.metrics import fused_refusals_per_batch as r

    monkeypatch.setattr(packed_view, "FUSED_REFUSALS", {"empty": 1, "tail_runs": 6})
    assert r.counter() == 7
    assert r.read(_run({r.__name__: 4})) == 1.0
    assert r.read(_run({r.__name__: 0})) == 0.0


def test_topk_fallback_ms():
    from portbench.metrics import topk_fallback_ms as r

    assert r.SPANS == [("nrtsearch_tpu_torch.ops.merge_scoring", "_topk_fallback")]
    assert r.read(_run({r.__name__: 3}, layer_s={r.LAYER: 0.02})) == pytest.approx(5.0)
    assert r.read(_run({r.__name__: 0})) == 0.0
    # fallbacks counted but no device time under the range: the range was lost
    assert r.read(_run({r.__name__: 3})) is None
    with pytest.raises(AttributeError):
        r.NO_SUCH_NAME
