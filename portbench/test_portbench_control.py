"""The check's control and faults, at a size a CPU test holds: the
reference in the program's place at a lower precision, and whole runs with
the timed path broken underneath, each come out as not correct; the same
run unbroken comes out correct."""

import importlib

import pytest
import torch

from portbench import engines, harness, metrics
from portbench.conftest import CELLS
from portbench.control import control_numbers

I32_MIN = -(2**31)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cpu, tiny):
    out = control_numbers(cell, 9, cpu, tiny(cell))
    assert out["correct"] is False
    # the control reads a gap (score_gap, quanta_gap, ...) well past its limit
    gaps = [n for n in out["numbers"] if n.endswith("_gap")]
    assert gaps and any(out["numbers"][n] > 3 * out["limits"][n] for n in gaps)


def _half_out(out):
    a, docs, hits = (t.clone() for t in out[:3])
    half = a.shape[0] // 2
    a[half:] = I32_MIN if a.dtype == torch.int32 else float("-inf")
    hits[half:] = 0
    return (a, docs, hits, *out[3:])


def _altered(out):
    a, docs, hits = (t.clone() for t in out[:3])
    docs[0, 0] = (docs[0, 0] + 1) % 20000
    return (a, docs, hits, *out[3:])


def _roofline_readers(cell: str) -> list:
    """The readers of the cell's roofline shares: their ``SPANS`` are the
    calls into its timed layer."""
    bench, w, _cfg, _traffic = harness.load_cell(cell)
    return [metrics.load(m["name"]) for m in harness.cell_metrics(bench, w, True)
            if "_roofline" in m["name"]]


def _break(monkeypatch, cell: str, fault):
    """Wrap the calls into the cell's timed layer (the roofline readers'
    ``SPANS``) so that their outputs carry ``fault``."""
    readers = _roofline_readers(cell)
    assert readers, cell
    for reader in readers:
        for mod_name, attr in reader.SPANS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            monkeypatch.setattr(mod, attr, lambda *a, _fn=fn, **kw: fault(_fn(*a, **kw)))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_half_out, _altered], ids=["half_batch_out", "answer_altered"])
def test_broken_timed_path_is_not_correct(cell, fault, cpu, tiny, monkeypatch):
    _break(monkeypatch, cell, fault)
    result, lines = harness.run_cell(cell, 31, 0.3, False, cpu, tiny(cell))
    assert result["correct"] is False, lines


@pytest.mark.parametrize("name", ["merge_roofline_pct", "bucket_roofline_pct"])
def test_spans_name_calls_of_the_program(name):
    reader = metrics.load(name)
    for mod_name, attr in reader.SPANS:
        assert callable(getattr(importlib.import_module(mod_name), attr))
    assert engines.load("node").Engine and engines.load("flagship").Engine
