"""Top-k with the reference's tie rule.

The JAX package relies on ``lax.top_k`` preferring the LOWER index among
equal values: over a doc-sorted stream that is Lucene's (score desc, docid
asc) contract. ``torch.topk`` promises no tie order, so the port takes every
``lax.top_k`` through ``topk_lowest_index``: a stable descending sort keeps
equal values in index order. Over int32 keys ``topk_i32_lowest_index`` gets
the same order from one ``torch.topk`` of unique int64 keys, without the
full sort (``lowest_index_keys``, which also orders candidates that carry
their own indices). Over f32, ``topk_f32_total_order`` ranks by the IEEE total
order as ``lax.top_k`` does (+0.0 above -0.0), through the same int64
keys; ``masked_top_k`` and ``masked_top_k_by_key`` (the reference's masked
selections) are built on it.
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


def lowest_index_keys(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The unique int64 keys ``(x << 32) | (2^32 - 1 - idx)`` of int32
    values ``x`` at indices ``idx`` (0 <= idx < 2^32, broadcast against
    x): their order is (x desc, idx asc). Built in place, one int64 copy of
    x beside x."""
    return x.to(torch.int64, copy=True).mul_(1 << 32).add_(_LOW32 - idx)


def top_lowest_index_keys(keys: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of ``lowest_index_keys`` along the last dim, split:
    (int32 values, int64 indices), ordered (value desc, index asc)."""
    top = torch.topk(keys, k, dim=-1).values
    return (top >> 32).to(torch.int32), _LOW32 - (top & _LOW32)


def topk_i32_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of int32 [B, N] keys with ties to the lower index, as
    ``lax.top_k``: one ``torch.topk`` over ``lowest_index_keys``. No host
    sync. Returns (int32 values, int64 indices)."""
    N = x.shape[-1]
    if k > N or N > _LOW32:
        raise ValueError(f"k={k} must not exceed the width {N} (< 2^32)")
    idx = torch.arange(N, device=x.device, dtype=torch.int64)
    return top_lowest_index_keys(lowest_index_keys(x, idx), k)


def f32_order_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the IEEE total order of the f32
    values ``x`` (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN):
    the order ``lax.top_k`` ranks f32 by, where ``torch.topk`` and
    ``torch.sort`` take -0.0 and +0.0 as equal."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def f32_from_order_keys(keys: torch.Tensor) -> torch.Tensor:
    """The inverse of ``f32_order_keys``."""
    return (keys ^ ((keys >> 31) & 0x7FFFFFFF)).view(torch.float32)


def topk_f32_total_order(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of f32 [B, N] in the total order, ties to the lower index:
    ``lax.top_k`` bit for bit, signed zeros and NaNs included. One
    ``torch.topk`` over int64 keys (``topk_i32_lowest_index``), no sort
    and no host sync. Returns (f32 values, int64 indices)."""
    keys, idx = topk_i32_lowest_index(f32_order_keys(x), k)
    return f32_from_order_keys(keys), idx


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """(top_scores [B, k], top_ids [B, k], total_hits [B] int32) of f32
    [B, D] scores where ``mask`` holds (counterpart:
    nrtsearch_tpu/ops/topk.py ``masked_top_k``)."""
    neg = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    top_s, top_i = topk_f32_total_order(torch.where(mask, scores, neg), k)
    return top_s, top_i, mask.sum(dim=-1, dtype=torch.int32)


def masked_top_k_by_key(keys: torch.Tensor, mask: torch.Tensor, k: int, ascending: bool):
    """Top k by a sort key (counterpart: nrtsearch_tpu/ops/topk.py
    ``masked_top_k_by_key``): an ascending key is negated, masked docs
    rank last, ties go to the lower doc id. An ascending key of +0.0 turns
    into -0.0 and ranks after a key of -0.0 (+0.0 negated), as in the
    reference's total order; the ±1e38 missing sentinels are plain f32
    values. Returns (keys [B, k], ids [B, k], total_hits [B])."""
    sortable = -keys if ascending else keys
    neg = torch.full((), float("-inf"), dtype=sortable.dtype, device=sortable.device)
    top_k, top_i = topk_f32_total_order(torch.where(mask, sortable, neg), k)
    real = -top_k if ascending else top_k
    return real, top_i, mask.sum(dim=-1, dtype=torch.int32)
