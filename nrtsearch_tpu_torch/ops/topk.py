"""Top-k with the reference's tie rule.

The JAX package relies on ``lax.top_k`` preferring the LOWER index among
equal values: over a doc-sorted stream that is Lucene's (score desc, docid
asc) contract. ``torch.topk`` promises no tie order, so the port takes every
``lax.top_k`` through ``topk_lowest_index``: a stable descending sort keeps
equal values in index order. Over int32 keys ``topk_i32_lowest_index`` gets
the same order from one ``torch.topk`` of unique int64 keys, without the
full sort.
"""

from __future__ import annotations

import torch

_LOW32 = (1 << 32) - 1


def topk_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim; ties go to
    the lower index, as ``jax.lax.top_k``. Indices are int64."""
    if k > x.shape[-1]:
        raise ValueError(f"k={k} exceeds the last dim {x.shape[-1]}")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_i32_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of int32 [B, N] keys with ties to the lower index, as
    ``lax.top_k``: one ``torch.topk`` over the unique int64 keys
    ``(x << 32) | (2^32 - 1 - index)``, built in place (one int64 copy of
    x beside x). No host sync. Returns (int32 values, int64 indices)."""
    N = x.shape[-1]
    if k > N or N > _LOW32:
        raise ValueError(f"k={k} must not exceed the width {N} (< 2^32)")
    idx = torch.arange(N, device=x.device, dtype=torch.int64)
    composite = x.to(torch.int64, copy=True).mul_(1 << 32).add_(_LOW32 - idx)
    top = torch.topk(composite, k, dim=-1).values
    return (top >> 32).to(torch.int32), _LOW32 - (top & _LOW32)
