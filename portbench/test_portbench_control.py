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
    out = control_numbers(cell, 9, cpu, tiny)
    assert out["correct"] is False
    gap = out["numbers"].get("score_gap", out["numbers"].get("quanta_gap"))
    limit = out["limits"].get("score_gap", out["limits"].get("quanta_gap"))
    assert gap > 3 * limit


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


def _break(monkeypatch, cell: str, fault):
    """Wrap the calls into the cell's timed layer (the roofline reader's
    ``SPANS``) so that their outputs carry ``fault``."""
    reader = metrics.load("bucket_roofline_pct" if cell.endswith("bucket-b32")
                          else "merge_roofline_pct")
    for mod_name, attr in reader.SPANS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _fn=fn, **kw: fault(_fn(*a, **kw)))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_half_out, _altered], ids=["half_batch_out", "answer_altered"])
def test_broken_timed_path_is_not_correct(cell, fault, cpu, tiny, monkeypatch):
    _break(monkeypatch, cell, fault)
    result, lines = harness.run_cell(cell, 31, 0.3, False, cpu, tiny)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("name", ["merge_roofline_pct", "bucket_roofline_pct"])
def test_spans_name_calls_of_the_program(name):
    reader = metrics.load(name)
    for mod_name, attr in reader.SPANS:
        assert callable(getattr(importlib.import_module(mod_name), attr))
    assert engines.load("node").Engine and engines.load("flagship").Engine
