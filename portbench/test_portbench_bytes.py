"""The yardstick's arithmetic on hand-worked shapes: the least bytes of a
batch, and the trace's reduction to busy time, layer time and idle gaps."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import peaks, trace
from portbench.kinds import bm25
from portbench.metrics import bucket_roofline_pct, device_idle_pct, merge_roofline_pct
from portbench.trace import Ev


def _run(df, batches, k, **kw):
    """A run of the bm25 kind over a corpus whose terms have ``df`` entries."""
    return SimpleNamespace(kind=bm25, data=SimpleNamespace(term_lengths=df), batches=batches,
                           k=k, **kw)


def test_least_bytes_by_hand():
    df = np.array([1000, 10, 7, 0])
    data = SimpleNamespace(term_lengths=df)
    # 2 queries, k = 5: terms {0, 1} and {0, 0}: term 0 read once for the batch
    batch = np.array([[0, 1], [0, 0]])
    assert bm25.least_bytes(data, batch, 5) == (1000 + 10) * 8 + 2 * (5 * 8 + 4)
    assert bm25.least_bytes(data, np.array([[3, 3]]), 1) == 12
    assert peaks.least_seconds(_run(df, [batch, batch], 5)) == pytest.approx(
        2 * bm25.least_bytes(data, batch, 5) / peaks.HBM_BYTES_PER_S)


@pytest.mark.parametrize("mod", [merge_roofline_pct, bucket_roofline_pct])
def test_roofline_share_by_hand(mod):
    df = np.array([1000, 10])
    batch = np.array([[0, 1]])
    least = bm25.least_bytes(SimpleNamespace(term_lengths=df), batch, 5) / peaks.HBM_BYTES_PER_S
    summary = trace.Summary(window_s=1.0, busy_s=0.5, layer_s={mod.LAYER: 4 * least})
    run = _run(df, [batch, batch], 5, summary=summary)
    assert mod.read(run) == pytest.approx(50.0)
    assert device_idle_pct.read(run) == pytest.approx(50.0)
    # no time in the layer: the reader finds nothing (and the harness fails the run)
    run.summary = trace.Summary(window_s=1.0, busy_s=0.5, layer_s={mod.LAYER: 0.0})
    assert mod.read(run) is None


def _events():
    us = 1000
    return [
        Ev("range", trace.WINDOW, 0, 100 * us),
        Ev("range", "portbench.search", 5 * us, 75 * us),
        Ev("range", "portbench.merge", 10 * us, 50 * us),
        Ev("op", "aten::sort", 12 * us, 14 * us),
        Ev("launch", "cudaLaunchKernel", 12 * us, 13 * us, corr=1),
        Ev("launch", "cuLaunchKernel", 20 * us, 21 * us, corr=2),
        Ev("launch", "cudaLaunchKernel", 70 * us, 71 * us, corr=3),   # outside the range
        Ev("device", "far_pair_stage_kernel", 20 * us, 30 * us, corr=1),
        Ev("device", "radixSort", 25 * us, 40 * us, corr=2),           # overlaps: union
        Ev("device", "Memcpy DtoH (Device -> Pinned)", 40 * us, 45 * us, corr=9),
        Ev("device", "other_kernel", 80 * us, 90 * us, corr=3),
        Ev("op", "aten::item", 60 * us, 79 * us),
    ]


def test_summary_by_hand():
    s = trace.summarize(_events(), ["merge"])
    assert s.window_s == pytest.approx(100e-6)
    # device union: [20, 45] and [80, 90] us
    assert s.busy_s == pytest.approx(35e-6)
    # kernels launched inside the merge range: 10 + 15 us; the copy is no kernel
    assert s.layer_s["merge"] == pytest.approx(25e-6)
    assert s.kernel_items["far_pair_stage_kernel"] == 1
    assert s.device_ops[0] == ["radixSort", pytest.approx(15e-6)]
    gaps = dict((n, v) for n, v in s.idle_gaps)
    # [0, 20]: the merge range at its middle (10 us; no host op there)
    assert gaps["portbench.merge/-"] == pytest.approx(20e-6)
    # [45, 80]: at 62.5 us the host waits in aten::item inside search
    assert gaps["portbench.search/aten::item"] == pytest.approx(35e-6)
    assert gaps["-/-"] == pytest.approx(10e-6)


def test_union_and_lost_kernels():
    assert trace.union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
    items = {"far_pair_stage_kernel(int*)": 3, "finish_mask_wide_kernel": 1, "x": 4}
    assert trace.lost_kernels({"far_pair_stage": 3, "finish_mask": 1, "near_stages": 0}, items) == []
    assert trace.lost_kernels({"far_pair_stage": 4, "gather_runs": 1}, items) == [
        "far_pair_stage", "gather_runs"]


def test_summary_needs_the_window():
    with pytest.raises(RuntimeError, match="window"):
        trace.summarize([Ev("device", "k", 0, 1)], [])
