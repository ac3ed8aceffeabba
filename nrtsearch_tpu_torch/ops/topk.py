"""Top-k with the reference's tie rule.

The JAX package relies on ``lax.top_k`` preferring the LOWER index among
equal values: over a doc-sorted stream that is Lucene's (score desc, docid
asc) contract. ``torch.topk`` promises no tie order, so the port takes every
``lax.top_k`` through ``topk_lowest_index``: a stable descending sort keeps
equal values in index order.
"""

from __future__ import annotations

import torch


def topk_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim; ties go to
    the lower index, as ``jax.lax.top_k``. Indices are int64."""
    if k > x.shape[-1]:
        raise ValueError(f"k={k} exceeds the last dim {x.shape[-1]}")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
