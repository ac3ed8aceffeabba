"""ops/dense_head.py of the port against the reference's, on the CPU.

The cases of tests/test_dense_head.py:129-299 (mixed, head-only and
tail-only queries, a doc in both head and tail, deleted docs, empty and
unknown terms, duplicate terms merging their weights) on the same seeded
numpy corpora. Each case builds the reference's ``DenseHeadIndex`` and the
port's from the same arrays (the rows, residual rows, row maxima and tail
bounds must be equal, and ``convert.dense_head_from_numpy`` must carry the
reference's across unchanged), plans the same queries, and holds the port's
bucket-tail route to the reference's numpy oracle ``reference_dense_search``
(whose port must give the same arrays) and, on two cases, to the
reference's own jitted route with its bucket kernels in Pallas interpret
mode. The merge-tail route (``dense_merge_topk``) runs beside the
reference's on the same cases.

Tolerances: the bucket-tail route's hits equal, its docs equal but at
near-ties, its scores within 8 f32 ulps of the largest score the query can
reach (XLA and torch add the head's bf16 products in different orders, and
the oracle adds in f64), plus, against the oracle, one quantum (1 / scale)
per tail term; head terms are never quantized. The
merge-tail route: docs, hits and exact flags equal, scores within 1e-6
relative (the fused contract of tests/test_torch_ops.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrtsearch_tpu.ops import dense_head as ref_dh
from nrtsearch_tpu_torch import convert
from nrtsearch_tpu_torch.ops import dense_head as port_dh
from nrtsearch_tpu_torch.ops.bucket_retrieval import QMAX
from tests.test_bucket_retrieval import build_corpus
from tests.test_dense_head import build_zipf_corpus, run_kernel, zipf_queries


def _both_indexes(pd, pi, to, tl, **kw):
    """The reference's and the port's index over the same arrays; the port
    builds its own and it must equal the reference's carried across."""
    ref = ref_dh.DenseHeadIndex.build(pd, pi, to, tl, residual=True, **kw)
    port = port_dh.DenseHeadIndex.build(pd, pi, to, tl, residual=True, device="cpu", **kw)
    carried = convert.dense_head_from_numpy(
        rows=np.asarray(ref.rows), rows_lo=np.asarray(ref.rows_lo),
        row_max=np.asarray(ref.row_max), head_ids=ref.head_ids,
        tail_bounds=ref.tail.bounds, tail_max_impact=ref.tail.max_impact,
        bucket_bits=ref.tail.bucket_bits, capacity=ref.capacity,
        min_df=ref.min_df, device="cpu")
    for a in (port, carried):
        assert torch.equal(a.rows.view(torch.int16), carried.rows.view(torch.int16))
        assert torch.equal(a.rows_lo.view(torch.int16), carried.rows_lo.view(torch.int16))
        assert torch.equal(a.row_max, carried.row_max)
        np.testing.assert_array_equal(a.head_ids, ref.head_ids)
        np.testing.assert_array_equal(a.tail.bounds, ref.tail.bounds)
        np.testing.assert_array_equal(a.tail.max_impact, ref.tail.max_impact)
        assert (a.capacity, a.min_df, a.tail.bucket_bits, a.tail.n_buckets) == (
            ref.capacity, ref.min_df, ref.tail.bucket_bits, ref.tail.n_buckets)
        assert a.head_pos == ref.head_pos
    return ref, port


def _tolerance(port_idx, plan, quanta: bool = True) -> np.ndarray:
    """Per query: 8 f32 ulps of the largest score the plan can reach (the
    head's bf16 products summed in another order, the tail share added),
    and with ``quanta`` one quantum (1 / scale) per tail term. Head terms
    carry no quantum: their products are never quantized."""
    top = np.abs(plan.W.astype(np.float64)) @ port_idx.row_max.double().numpy()
    q = 0.0
    if plan.tail is not None:
        top = top + np.where(plan.tail.n_terms > 0, QMAX / plan.tail.scales, 0.0)
        q = plan.tail.n_terms / plan.tail.scales
    return 8 * 2.0**-23 * top + (q if quanta else 0.0)


def _assert_close(got, want, tol, k):
    s, d, h = got
    ws, wd, wh = want
    np.testing.assert_array_equal(h, wh)
    for qi in range(len(h)):
        n = int(min(wh[qi], k))
        assert (d[qi, n:] == -1).all() and np.isneginf(s[qi, n:]).all()
        assert np.abs(s[qi, :n] - ws[qi, :n]).max(initial=0) <= tol[qi], qi
        # docs differ only where the two scores at that rank are that close
        for j in np.nonzero(d[qi, :n] != wd[qi, :n])[0]:
            assert abs(s[qi, j] - ws[qi, j]) <= tol[qi], (qi, j)


def _check_case(pd, pi, to, tl, queries, k, *, jitted: bool, **kw):
    ref_idx, port_idx = _both_indexes(pd, pi, to, tl, **kw)
    plan = port_dh.plan_dense_batch(port_idx, queries, to)
    ref_plan = ref_dh.plan_dense_batch(ref_idx, queries, to)
    np.testing.assert_array_equal(plan.W, ref_plan.W)
    assert (plan.tail is None) == (ref_plan.tail is None)
    got = port_dh.decode_packed(port_dh.dispatch(
        port_idx, plan, torch.from_numpy(pd), torch.from_numpy(pi), k), k)
    oracle = port_dh.reference_dense_search(pd, pi, port_idx, queries, to, tl, k)
    ref_oracle = ref_dh.reference_dense_search(pd, pi, ref_idx, queries, to, tl, k)
    for a, b in zip(oracle, ref_oracle):
        np.testing.assert_array_equal(a, b)
    _assert_close(got, oracle, _tolerance(port_idx, plan), k)
    if jitted:
        # the same 15-bit keys: only the head's sums differ
        _assert_close(got, run_kernel(pd, pi, ref_idx, ref_plan, k),
                      _tolerance(port_idx, plan, quanta=False), k)
    _check_merge_tail(pd, pi, to, tl, queries, k, ref_idx, port_idx)
    return plan, got


def _check_merge_tail(pd, pi, to, tl, queries, k, ref_idx, port_idx):
    """dense_merge_topk over the same index and queries, both packages."""
    plan = port_dh.plan_dense_merge(port_idx, queries, to, tl)
    ref_plan = ref_dh.plan_dense_merge(ref_idx, queries, to, tl)
    for f in ("W", "row_idx", "run_offs", "run_lens", "run_weights"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(ref_plan, f))
    got = port_dh.decode_packed2(port_dh.dispatch_merge(
        port_idx, plan, torch.from_numpy(pd), torch.from_numpy(pi), k), k)
    want = ref_dh.decode_packed2(ref_dh.dispatch_merge(
        ref_idx, ref_plan, jnp.asarray(pd), jnp.asarray(pi), k), k)
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def test_mixed_head_tail_parity():
    rng = np.random.default_rng(11)
    pd, pi, to, tl, _ = build_zipf_corpus(rng, 40, 2048)
    queries = zipf_queries(rng, 40, 6)
    queries.append([(0, 1.0), (39, 1.5)])
    plan, _got = _check_case(pd, pi, to, tl, queries, 10, jitted=True, capacity=2048,
                             max_rows=6, min_df=64, bucket_docs=512)
    assert plan.has_head and plan.tail is not None


def test_head_only_queries():
    rng = np.random.default_rng(12)
    pd, pi, to, tl, _ = build_zipf_corpus(rng, 20, 1024)
    idx = port_dh.DenseHeadIndex.build(pd, pi, to, tl, capacity=1024, max_rows=4,
                                       min_df=32, bucket_docs=512, device="cpu")
    queries = [[(int(t), float(rng.uniform(0.5, 2.0))) for t in idx.head_ids[:3]],
               [(int(idx.head_ids[0]), 2.0)]]
    plan, _got = _check_case(pd, pi, to, tl, queries, 8, jitted=False, capacity=1024,
                             max_rows=4, min_df=32, bucket_docs=512)
    assert plan.tail is None


def test_tail_only_queries():
    rng = np.random.default_rng(13)
    pd, pi, to, tl, _ = build_corpus(rng, 30, 1500, max_df=60)
    queries = [[(int(t), 1.0) for t in rng.choice(30, size=3, replace=False)]
               for _ in range(4)]
    plan, _got = _check_case(pd, pi, to, tl, queries, 10, jitted=False, capacity=2048,
                             max_rows=4, min_df=500, bucket_docs=1024)
    assert not plan.has_head and plan.tail is not None


def test_doc_in_both_head_and_tail_not_duplicated():
    """Docs 5 and 9 hold the dense term and the sparse one: each appears
    once, with the summed score, and is counted once."""
    D = 512
    to = np.array([0, D], np.int64)
    tl = np.array([D, 2], np.int32)
    P = ((D + 2 + 8192 + 127) // 128) * 128
    pd = np.zeros(P, np.int32)
    pi = np.zeros(P, np.float32)
    pd[:D] = np.arange(D)
    pd[D : D + 2] = [5, 9]
    pi[:D] = 0.5
    pi[D : D + 2] = 1.0
    _plan, (s, d, h) = _check_case(pd, pi, to, tl, [[(0, 1.0), (1, 2.0)]], 5, jitted=True,
                                   capacity=512, max_rows=2, min_df=256, bucket_docs=256)
    assert h[0] == D
    assert set(d[0, :2].tolist()) == {5, 9}
    assert len(set(d[0].tolist())) == 5


def test_deletions_never_match():
    rng = np.random.default_rng(14)
    pd, pi, to, tl, pv = build_zipf_corpus(rng, 30, 1024)
    deleted = rng.random(1024) < 0.3
    pi[:pv] = np.where(deleted[pd[:pv]], 0.0, pi[:pv])
    queries = zipf_queries(rng, 30, 4)
    _plan, (_s, d, _h) = _check_case(pd, pi, to, tl, queries, 12, jitted=False,
                                     capacity=1024, max_rows=4, min_df=64, bucket_docs=512)
    assert all(x == -1 or not deleted[x] for x in d.ravel())


def test_empty_and_unknown_term_queries():
    rng = np.random.default_rng(15)
    pd, pi, to, tl, _ = build_zipf_corpus(rng, 20, 1024)
    idx = port_dh.DenseHeadIndex.build(pd, pi, to, tl, capacity=1024, max_rows=4,
                                       min_df=64, bucket_docs=512, device="cpu")
    queries = [[], [(3, 0.0)], [(int(idx.head_ids[0]), 1.0)]]
    _plan, (_s, d, h) = _check_case(pd, pi, to, tl, queries, 5, jitted=False,
                                    capacity=1024, max_rows=4, min_df=64, bucket_docs=512)
    assert h[0] == 0 and h[1] == 0
    assert (d[0] == -1).all() and (d[1] == -1).all()
    assert h[2] == tl[idx.head_ids[0]]


def test_duplicate_terms_merge_weights():
    rng = np.random.default_rng(16)
    pd, pi, to, tl, _ = build_zipf_corpus(rng, 20, 1024)
    idx = port_dh.DenseHeadIndex.build(pd, pi, to, tl, capacity=1024, max_rows=4,
                                       min_df=64, bucket_docs=512, device="cpu")
    h = int(idx.head_ids[0])
    t = int(next(i for i in range(20) if i not in idx.head_pos and tl[i] > 0))
    plan, _got = _check_case(pd, pi, to, tl, [[(h, 1.0), (h, 0.5), (t, 2.0), (t, 0.25)]],
                             8, jitted=False, capacity=1024, max_rows=4, min_df=64,
                             bucket_docs=512)
    assert plan.tail.n_terms[0] == 1 and plan.W[0, 0] == 1.5


def _strong_head_corpus():
    """A head term in every doc at one impact and a tail term over 1,000
    docs at distinct impacts: the top k are the tail's best docs, and the
    M-th tail sum plus the head's bound falls below the k-th score, so the
    window certifies (after tests/test_dense_merge.py:134-180)."""
    D, n_tail = 4096, 1000
    to = np.array([0, D], np.int64)
    tl = np.array([D, n_tail], np.int32)
    P = ((D + n_tail + 8192 + 127) // 128) * 128
    pd = np.zeros(P, np.int32)
    pi = np.zeros(P, np.float32)
    pd[:D] = np.arange(D)
    pi[:D] = 1.0
    pd[D : D + n_tail] = np.arange(n_tail)
    pi[D : D + n_tail] = 0.5 + np.arange(n_tail, dtype=np.float32) / n_tail
    return pd, pi, to, tl, [[(0, 1.0), (1, 1.0)], [(0, 2.0), (1, 0.5)]]


@pytest.mark.parametrize("case,k,branch", [("mixed", 10, "full"),
                                           ("strong_head", 40, "window")])
def test_merge_tail_window_and_full_branches(case, k, branch):
    """dense_merge_topk at two candidate windows (M = pow2(4k, 128): 128 at
    k = 10, 256 at k = 40): a Zipf batch whose certificate fails and the
    strong-head case whose certificate holds. The port takes the branch the
    reference's lax.cond takes (the exact flags equal), counted in
    WINDOW_BRANCH."""
    if case == "mixed":
        rng = np.random.default_rng(17)
        pd, pi, to, tl, _ = build_zipf_corpus(rng, 50, 4096)
        kw = dict(max_rows=8, min_df=256)
    else:
        pd, pi, to, tl, queries = _strong_head_corpus()
        kw = dict(max_rows=2, min_df=2048)
    ref_idx, port_idx = _both_indexes(pd, pi, to, tl, capacity=4096, bucket_docs=1024, **kw)
    if case == "mixed":
        head = [int(t) for t in port_idx.head_ids]
        queries = [[(head[0], 2.0), (45, 1.0), (48, 1.0)], [(head[1], 1.0), (30, 0.5)]]
    plan = port_dh.plan_dense_merge(port_idx, queries, to, tl)
    args = [torch.from_numpy(x) for x in (plan.W, plan.row_idx, plan.run_offs,
                                          plan.run_lens, plan.run_weights)]
    static = dict(k=k, has_head=plan.has_head, has_tail=plan.has_tail,
                  run_len=plan.run_len)
    before = dict(port_dh.WINDOW_BRANCH)
    got = port_dh.decode_packed2(port_dh.dense_merge_topk(
        port_idx.rows, port_idx.row_max, torch.from_numpy(pd), torch.from_numpy(pi),
        *args, **static), k)
    want = ref_dh.decode_packed2(ref_dh.dense_merge_topk(
        ref_idx.rows, ref_idx.row_max, jnp.asarray(pd), jnp.asarray(pi),
        *[jnp.asarray(a.numpy()) for a in args], **static), k)
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    taken = {b: port_dh.WINDOW_BRANCH[b] - before[b] for b in before}
    assert taken == {b: int(b == branch) for b in before}
