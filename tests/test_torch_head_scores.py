"""The port's head scores (ops/dense_fused.head_scores) against the JAX
package's, on the CPU.

The reference computes them inline in ``dense_fused_topk``
(nrtsearch_tpu/ops/dense_fused.py:181-221): ``_gather_rows_scan``, then
``lax.dot_general`` with ``preferred_element_type=f32`` on the values upcast
to f32 (its CPU formulation). ``reference_head_scores`` below repeats those
lines. The port runs ``head_scores_plain`` for CPU tensors, which the CUDA
kernel (csrc/head_scores.cu) is held to on the card.

Tolerance: both sides sum exact f32 products of bf16 values in f32, in
orders of their own, so |dS| <= 2 * (4U) * 2^-24 * sum|products| per
element (the f32 summation bound of each order, over the 4U products of the
Dekker form). C counts small integers: equal. S > 0 equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrtsearch_tpu.ops import dense_fused as ref_fused
from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.ops import dense_fused as port_fused


def to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def reference_head_scores(rows, rows_lo, row_idx, W, require_all):
    """The head-score lines of the reference's dense_fused_topk, as it runs
    them off the TPU (f32 dot of the upcast bf16 values)."""
    def mm(a, b):
        return jax.lax.dot_general(
            a.astype(jnp.float32), b.astype(jnp.float32),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)

    rows_used = ref_fused._gather_rows_scan(rows, row_idx)
    W_hi = W.astype(jnp.bfloat16)
    S = mm(W_hi, rows_used)
    if rows_lo is not None:
        lo_used = ref_fused._gather_rows_scan(rows_lo, row_idx)
        W_lo = (W - W_hi.astype(jnp.float32)).astype(jnp.bfloat16)
        S = S + mm(W_hi, lo_used) + mm(W_lo, rows_used) + mm(W_lo, lo_used)
    C = None
    if require_all:
        ind = (rows_used > 0).astype(jnp.float32)
        Wind = (W != 0.0).astype(jnp.float32)
        C = jax.lax.dot_general(Wind, ind, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
    return np.asarray(S), None if C is None else np.asarray(C)


def head_inputs(seed, B, U, D, Hp=40, residual=True):
    """Sparse impact rows (a third of the docs per row, the first 64 docs in
    none) split into bf16 head and Dekker residual rows, U slots whose last
    two are pads repeating row 0 at weight 0, weights in (0, 4) with one
    zero and one negative weight."""
    rng = np.random.default_rng(seed)
    f = np.where(rng.random((Hp, D)) < 0.3, rng.random((Hp, D)) * 3, 0).astype(np.float32)
    f[:, :64] = 0.0
    rows = jnp.asarray(f).astype(jnp.bfloat16)
    rows_lo = (jnp.asarray(f) - rows.astype(jnp.float32)).astype(jnp.bfloat16) if residual else None
    row_idx = rng.permutation(Hp)[:U].astype(np.int32) if U <= Hp else \
        rng.integers(0, Hp, U).astype(np.int32)
    row_idx[-2:] = 0
    W = (rng.random((B, U)) * 4).astype(np.float32)
    W[:, -2:] = 0.0
    W[0, 0] = 0.0
    W[-1, 1] = -1.5
    return rows, rows_lo, row_idx, W


def abs_products(rows, rows_lo, row_idx, W):
    """sum|products| per element, in f64: the scale of the summation bound."""
    W_hi = np.asarray(jnp.asarray(W).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    R = np.asarray(rows.astype(jnp.float32), np.float64)[row_idx]
    out = np.abs(W_hi) @ np.abs(R)
    if rows_lo is not None:
        L = np.asarray(rows_lo.astype(jnp.float32), np.float64)[row_idx]
        W_lo = W.astype(np.float64) - W_hi
        W_lo = np.asarray(jnp.asarray(W_lo, jnp.float32).astype(jnp.bfloat16)
                          .astype(jnp.float32), np.float64)
        out += np.abs(W_hi) @ np.abs(L) + np.abs(W_lo) @ np.abs(R) + np.abs(W_lo) @ np.abs(L)
    return out


@pytest.mark.parametrize("U", [8, 32, 128])
@pytest.mark.parametrize("B", [1, 3, 32])
@pytest.mark.parametrize("residual,require_all", [(True, False), (False, False), (True, True)])
def test_head_scores_match_reference(B, U, residual, require_all):
    rows, rows_lo, row_idx, W = head_inputs(B * 1000 + U, B, U, 1024, residual=residual)
    ref_s, ref_c = reference_head_scores(rows, rows_lo, jnp.asarray(row_idx),
                                         jnp.asarray(W), require_all)
    before = dict(kernels.LAUNCHES)
    S, C = port_fused.head_scores(to_torch(rows), None if rows_lo is None else to_torch(rows_lo),
                                  to_torch(row_idx), to_torch(W), require_all)
    assert kernels.LAUNCHES == before            # CPU tensors: the plain version
    S = S.numpy()
    assert S.shape == (B, 1024) and S.dtype == np.float32
    bound = 2 * (4 * U) * 2.0**-24 * abs_products(rows, rows_lo, row_idx, W)
    assert (np.abs(S.astype(np.float64) - ref_s) <= bound).all()
    np.testing.assert_array_equal(S > 0, ref_s > 0)
    assert (S > 0).any() and not (S > 0).all()
    if require_all:
        np.testing.assert_array_equal(C.numpy(), ref_c)
        assert C.numpy().max() >= 2
    else:
        assert C is None and ref_c is None


def test_head_scores_wrappers_refuse_bad_devices():
    rows, rows_lo, row_idx, W = head_inputs(5, 2, 8, 64)
    t_rows, t_lo, t_idx, t_w = map(to_torch, (rows, rows_lo, row_idx, W))
    with pytest.raises(ValueError, match="CUDA"):       # the kernel takes CUDA tensors only
        kernels.head_scores(t_rows, t_lo, t_idx, t_w.to(torch.bfloat16),
                            t_w.to(torch.bfloat16), False)
    with pytest.raises(ValueError, match="several devices"):
        port_fused.head_scores(t_rows, t_lo, t_idx, t_w.to("meta"), False)
    with pytest.raises(ValueError, match="several devices"):
        port_fused.head_scores(t_rows, t_lo.to("meta"), t_idx, t_w, True)


def one_weight_inputs(seed, B, U, D, Hp=40):
    """Dekker head and residual rows, and one nonzero weight per query at a
    random slot: each S element is one weight times one row, so the four
    Dekker products are exact in f32 and only their three adds round."""
    rows, rows_lo, row_idx, _ = head_inputs(seed, B, U, D, Hp)
    rng = np.random.default_rng(seed + 1)
    W = np.zeros((B, U), np.float32)
    W[np.arange(B), rng.integers(0, U - 2, B)] = one_weights(rng.random((2, B)))
    return rows, rows_lo, row_idx, W


def one_weights(u):
    """f32 weights: a bf16 value in [0.25, 4.25) plus 0.5-0.95 of half its
    ulp, so that W_lo is at least 2^-10 of W."""
    w_hi = torch.from_numpy(0.25 + 4 * u[0]).float().to(torch.bfloat16).float().numpy()
    return (w_hi + (0.5 + 0.45 * u[1]) * np.exp2(np.floor(np.log2(w_hi)) - 8)).astype(np.float32)


def exact_dekker_sum(rows, rows_lo, row_idx, W):
    """f64 S of the four Dekker products (exact: one product per element),
    sum|products|, and |W_lo·L| alone, per element."""
    w_hi = torch.from_numpy(W).to(torch.bfloat16)
    w_lo = (torch.from_numpy(W) - w_hi.float()).to(torch.bfloat16)
    Wh, Wl = w_hi.double().numpy(), w_lo.double().numpy()
    R = np.asarray(rows.astype(jnp.float32), np.float64)[row_idx]
    L = np.asarray(rows_lo.astype(jnp.float32), np.float64)[row_idx]
    exact = (Wh + Wl) @ (R + L)
    scale = (np.abs(Wh) + np.abs(Wl)) @ (np.abs(R) + np.abs(L))
    return exact, scale, np.abs(Wl) @ np.abs(L)


# the three f32 adds of an exact product each round by at most 2^-23 of
# sum|products| (tensor cores may truncate), plus one for slack
EXACT_ULPS = 4 * 2.0**-23


@pytest.mark.parametrize("U", [8, 32, 128])
@pytest.mark.parametrize("B", [1, 32])
def test_head_scores_keep_every_dekker_term(B, U):
    """One weight per query: S equals the f64 sum of all four Dekker
    products to a few f32 ulps, for the port and the reference alike; the
    W_lo·rows_lo term alone is far above that tolerance, so a version that
    dropped it fails."""
    rows, rows_lo, row_idx, W = one_weight_inputs(B * 100 + U, B, U, 512)
    exact, scale, lolo = exact_dekker_sum(rows, rows_lo, row_idx, W)
    tol = EXACT_ULPS * scale
    assert (lolo > 4 * tol).sum() > 8
    ref_s, _ = reference_head_scores(rows, rows_lo, jnp.asarray(row_idx), jnp.asarray(W), False)
    S, _ = port_fused.head_scores(to_torch(rows), to_torch(rows_lo), to_torch(row_idx),
                                  to_torch(W), False)
    assert (np.abs(ref_s.astype(np.float64) - exact) <= tol).all()
    assert (np.abs(S.numpy().astype(np.float64) - exact) <= tol).all()
