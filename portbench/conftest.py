"""Shared fixtures of the benchmark's own tests: a CPU device, the cells of
``BENCHMARK.json``, and each cell cut to a size a CPU test can hold (the
harness's ``overrides``, its kind's ``TINY``)."""

import json

import pytest
import torch

from portbench import harness, kinds

CELLS = tuple(w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"])


def tiny_overrides(cell: str) -> dict:
    """The overrides that cut ``cell`` to a CPU test's size."""
    return kinds.load(harness.load_cell(cell)[2]["kind"]).TINY


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def tiny():
    return tiny_overrides


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
