"""Shared fixtures of the benchmark's own tests: a CPU device and the cells
cut to a size a CPU test can hold (the harness's ``overrides``)."""

import pytest
import torch

TINY = {
    "config": {"corpus": {"num_docs": 20000, "vocab_size": 2000}},
    "traffic": {"max_batches": 4096, "warmup_batches": 1, "check": {"sample": 96}},
}
CELLS = ("node-8m.text-b32", "batch-8m.search-b32", "batch-8m.bucket-b32")


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
