"""Filter masks over columnar doc values (counterpart:
nrtsearch_tpu/ops/masks.py ``range_mask``, ``eq_mask``, ``in_set_mask``,
``exists_mask``).

Elementwise compares over a segment's [capacity] column give bool masks that
AND/OR/NOT together. Columns are f32, f64 or int32 ordinals; bounds and
targets are 0-d tensors or Python numbers of the column's precision (the
callers round f32 bounds through ``np.float32`` first, as the reference
does). The geo masks wait for the rest of ROADMAP item 8.
"""

from __future__ import annotations

from typing import Sequence

import torch


def range_mask(values: torch.Tensor, present: torch.Tensor, lower, upper,
               lower_inclusive: bool, upper_inclusive: bool) -> torch.Tensor:
    lo_ok = values >= lower if lower_inclusive else values > lower
    hi_ok = values <= upper if upper_inclusive else values < upper
    return lo_ok & hi_ok & present


def eq_mask(values: torch.Tensor, present: torch.Tensor, target) -> torch.Tensor:
    return (values == target) & present


def in_set_mask(values: torch.Tensor, present: torch.Tensor,
                targets: Sequence) -> torch.Tensor:
    """Docs whose value is any of ``targets`` (a short sequence of numbers
    or a 1-d tensor), and present."""
    hit = torch.zeros_like(present)
    for t in targets:
        hit |= values == t
    return hit & present


def exists_mask(present: torch.Tensor) -> torch.Tensor:
    return present
