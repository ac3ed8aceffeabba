"""Port ops vs the JAX reference on the CPU, module by module.

Every input is made with numpy from a seed and handed to both packages. The
reference runs its own XLA formulations here (``use_pallas=False``,
``gather_rows`` -> ``_gather_rows_scan``); the port runs its plain torch
twins, which is what its kernels are held to on the card. Each check states
its tolerance and why.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrtsearch_tpu.ops import bm25 as ref_bm25
from nrtsearch_tpu.ops import dense_fused as ref_fused
from nrtsearch_tpu.ops import merge_scoring as ref_ms
from nrtsearch_tpu_torch.ops import bitonic_merge as bm
from nrtsearch_tpu_torch.ops import bm25 as port_bm25
from nrtsearch_tpu_torch.ops import dense_fused as port_fused
from nrtsearch_tpu_torch.ops import dense_head as port_dh
from nrtsearch_tpu_torch.ops import merge_scoring as port_ms
from nrtsearch_tpu_torch.ops.topk import topk_lowest_index

HIGH, LOW = int(ref_ms.DOC_SENTINEL), int(ref_ms.DOC_SENTINEL_LOW)


def to_torch(x) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (bf16 through its bit pattern)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _runs(rng, B, R, L, pad_row=True):
    """[B, R, L] doc-sorted runs with duplicate docs across runs, LOW front
    padding, HIGH back padding and (optionally) one all-pad row."""
    docs = np.full((B, R, L), HIGH, np.int32)
    contribs = np.zeros((B, R, L), np.float32)
    for b in range(B):
        for r in range(R):
            n = int(rng.integers(0, L + 1))
            lo = int(rng.integers(0, min(n, L // 8) + 1))
            vals = np.sort(rng.integers(0, 3 * L, size=n - lo)).astype(np.int32)
            docs[b, r, :lo] = LOW
            docs[b, r, lo:n] = vals
            contribs[b, r, lo:n] = rng.random(n - lo, dtype=np.float32)
    if pad_row:
        docs[-1] = HIGH
        contribs[-1] = 0.0
    return docs, contribs


def test_precompute_impacts_bit_equal():
    """Same f32 formula in the same order: bit-equal."""
    rng = np.random.default_rng(1)
    D, P = 2048, 20000
    docs = rng.integers(0, D, size=P).astype(np.int32)
    freqs = rng.integers(1, 9, size=P).astype(np.float32)
    lens = rng.integers(1, 300, size=D).astype(np.float32)
    live = rng.random(D) < 0.9
    k1, b, avgdl = 1.2, 0.75, float(lens.mean())
    ref = np.asarray(ref_bm25.precompute_impacts(
        jnp.asarray(docs), jnp.asarray(freqs), jnp.asarray(lens),
        jnp.asarray(live), jnp.float32(k1), jnp.float32(b), jnp.float32(avgdl),
    ))
    out = port_bm25.precompute_impacts(
        to_torch(docs), to_torch(freqs), to_torch(lens), to_torch(live), k1, b, avgdl
    ).numpy()
    np.testing.assert_array_equal(out, ref)
    assert port_bm25.lucene_idf(1000, 17) == ref_bm25.lucene_idf(1000, 17)


@pytest.mark.parametrize("R", [2, 8])
@pytest.mark.parametrize("L", [128, 4096])
def test_merge_sorted_runs_bit_equal(R, L):
    """Same network, same strict tie rule: docs AND contribs bit-equal, so
    equal docs keep the reference's stream order."""
    rng = np.random.default_rng(R * 1000 + L)
    docs, contribs = _runs(rng, 3, R, L)
    rd, rc = ref_ms.merge_sorted_runs(jnp.asarray(docs), jnp.asarray(contribs))
    pd, pc = port_ms.merge_sorted_runs(to_torch(docs), to_torch(contribs))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    assert (np.diff(pd.numpy().astype(np.int64), axis=1) >= 0).all()
    assert (pd.numpy()[-1] == HIGH).all()


@pytest.mark.parametrize("d", [1, 4, 64, 512, 4096])
def test_far_stage_twin_matches_compare_exchange(d):
    """One stage of the port's far twin == the reference's
    ``_compare_exchange`` at the same distance: bit-equal."""
    rng = np.random.default_rng(d)
    N = 16384
    docs = rng.integers(0, 200, size=(3, N)).astype(np.int32)
    docs[1, ::7] = HIGH
    docs[2, ::5] = LOW
    contribs = rng.random((3, N), dtype=np.float32)
    rd, (rc,) = ref_ms._compare_exchange(jnp.asarray(docs), [jnp.asarray(contribs)], d)
    pd, pc = bm.far_stage_twin(to_torch(docs), to_torch(contribs), d)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))


@pytest.mark.parametrize("d0", [1, 16, 4096])
def test_near_stages_twin_matches_compare_exchange_sequence(d0):
    """The near twin (stages d0..1 in one call) == the reference's
    ``_compare_exchange`` sequence d0, d0/2, ..., 1: bit-equal."""
    rng = np.random.default_rng(100 + d0)
    N = 8192
    docs = rng.integers(0, 300, size=(2, N)).astype(np.int32)
    contribs = rng.random((2, N), dtype=np.float32)
    rd, rp = jnp.asarray(docs), [jnp.asarray(contribs)]
    d = d0
    while d >= 1:
        rd, rp = ref_ms._compare_exchange(rd, rp, d)
        d //= 2
    pd, pc = bm.near_stages(to_torch(docs), to_torch(contribs), d0)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rp[0]))


def test_merge_level_far_then_near_sorts_bitonic_rows():
    """merge_level on a width above NEAR_TILE runs far stages then one near
    pass; on CPU tensors the twins, equal to the plain level."""
    rng = np.random.default_rng(7)
    run_len = 2 * bm.NEAR_TILE
    a = np.sort(rng.integers(0, 10**6, size=(2, run_len)), axis=1)
    b = np.sort(rng.integers(0, 10**6, size=(2, run_len)), axis=1)[:, ::-1]
    docs = np.concatenate([a, b], axis=1).astype(np.int32)
    contribs = rng.random(docs.shape, dtype=np.float32)
    pd, pc = bm.merge_level(to_torch(docs), to_torch(contribs), run_len)
    rd, rp = jnp.asarray(docs), [jnp.asarray(contribs)]
    d = run_len
    while d >= 1:
        rd, rp = ref_ms._compare_exchange(rd, rp, d)
        d //= 2
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rp[0]))


def test_alternating_mode_sorts_blocks_by_parity():
    """Alternating mode (m): merging bitonic m-blocks sorts even blocks
    ascending and odd blocks descending, as the Pallas kernels' m mode."""
    rng = np.random.default_rng(9)
    m, N = 64, 1024
    runs = np.sort(rng.integers(0, 50, size=(1, N // 32, 32)), axis=2)
    runs[:, 1::2] = runs[:, 1::2, ::-1]
    docs = runs.reshape(1, N).astype(np.int32)
    contribs = docs.astype(np.float32) * 0.5
    pd, pc = bm.near_stages_twin(to_torch(docs), to_torch(contribs), m // 2, m)
    blocks = pd.numpy().reshape(N // m, m)
    for i, blk in enumerate(blocks):
        step = np.diff(blk)
        assert (step >= 0).all() if i % 2 == 0 else (step <= 0).all()
    np.testing.assert_array_equal(pc.numpy(), pd.numpy().astype(np.float32) * 0.5)


@pytest.mark.parametrize("R", [2, 8])
def test_segmented_scores_bit_equal(R):
    """The bounded-distance scan keeps the reference's addition order:
    sums, counts and masks bit-equal."""
    rng = np.random.default_rng(11 + R)
    docs, contribs = _runs(rng, 4, R, 256)
    md, mc = ref_ms.merge_sorted_runs(jnp.asarray(docs), jnp.asarray(contribs))
    ref = ref_ms.segmented_scores(md, mc, max_seg=R)
    out = port_ms.segmented_scores(to_torch(md), to_torch(mc), max_seg=R)
    for name, r, o in zip(("scores", "counts", "tail", "valid"), ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)


def test_topk_lowest_index_matches_lax_top_k():
    """Tie-heavy input: identical values AND indices (lowest index wins)."""
    import jax

    rng = np.random.default_rng(3)
    x = rng.integers(0, 6, size=(5, 3000)).astype(np.float32)
    x[0, :100] = -np.inf
    x[1] = 2.0
    rv, ri = jax.lax.top_k(jnp.asarray(x), 64)
    pv, pi = topk_lowest_index(to_torch(x), 64)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("k", [10, 300])
def test_hierarchical_topk_matches_reference(k):
    """Both branches (row-max thresholding, and the full fallback on tie
    plateaus) return lax.top_k's exact (values, lowest-index) answer."""
    rng = np.random.default_rng(k)
    n = 1 << 18
    x = np.round(rng.random((3, n)) * 50).astype(np.float32)
    x[1, : n // 2] = 7.0
    x[2] = np.where(rng.random(n) < 0.99, -np.inf, x[2])
    rv, ri = ref_ms._hierarchical_topk(jnp.asarray(x), k)
    before = port_ms.HOST_SYNCS["hierarchical_topk"]
    pv, pi = port_ms._hierarchical_topk(to_torch(x), k)
    assert port_ms.HOST_SYNCS["hierarchical_topk"] == before + 1
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def test_gather_rows_twin_matches_scan():
    """Twin row gather == the reference's scan gather: bit-equal (bf16)."""
    rng = np.random.default_rng(0)
    rows = jnp.asarray(rng.random((64, 512)).astype(np.float32)).astype(jnp.bfloat16)
    idx = np.array([5, 0, 63, 7, 7, 0, 12, 31], np.int32)
    ref = ref_fused._gather_rows_scan(rows, jnp.asarray(idx))
    out = port_fused.gather_rows(to_torch(rows), to_torch(idx))
    np.testing.assert_array_equal(
        out.view(torch.int16).numpy(), np.asarray(ref).view(np.int16)
    )


def test_topk_docid_lexicographic():
    """(score desc, docid asc) over an unordered candidate set, pads last."""
    s = np.array([[1.0, 3.0, 3.0, -np.inf, 2.0, 3.0]], np.float32)
    d = np.array([[9, 7, 2, 0, 4, 5]], np.int32)
    from nrtsearch_tpu.ops.dense_head import _topk_docid as ref_topk_docid

    rs, rd = ref_topk_docid(jnp.asarray(s), jnp.asarray(d), 5)
    ps, pd = port_dh._topk_docid(to_torch(s), to_torch(d), 5)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert pd.numpy().tolist() == [[2, 5, 7, 4, 9]]


# ---------------------------------------------------------------------------
# dense_fused_topk: the cases of tests/test_dense_fused.py
# ---------------------------------------------------------------------------

K = 10


@pytest.fixture(scope="module")
def fused_model():
    from nrtsearch_tpu.models.flagship import SyntheticCorpus

    corpus = SyntheticCorpus(16_000, 3_000, 24, seed=11)
    model = corpus.to_model()
    model.attach_dense(max_rows=40, min_df=600, bucket_docs=8_192, residual=True)
    return corpus, model


def _both(model, qs, **kw):
    """Reference and port fused results for one planned batch."""
    from nrtsearch_tpu.ops.dense_head import decode_packed2

    plan = model.plan_dense_merge(qs)
    idx = model.dense_idx
    B = plan.W.shape[0]
    n_req = kw.pop("n_req", np.ones(B, np.int32))
    args = (
        idx.rows, idx.row_max, model.doc_ids, model.impacts, plan.W,
        plan.row_idx, n_req, plan.run_offs, plan.run_lens, plan.run_weights,
    )
    static = dict(k=K, has_head=plan.has_head, has_tail=plan.has_tail,
                  run_len=plan.run_len, **kw)
    ref = ref_fused.dense_fused_topk(
        *[jnp.asarray(a) for a in args], None, None, None, idx.rows_lo, **static
    )
    out = port_fused.dense_fused_topk(
        *[to_torch(a) for a in args], None, None, None, to_torch(idx.rows_lo),
        **static,
    )
    return plan, decode_packed2(np.asarray(ref), K), port_dh.decode_packed2(out, K)


def _assert_fused_equal(ref, out):
    """Docs, hits and the exact flag equal; scores within 1e-6 relative
    (the f32 products of XLA and torch sum in different orders)."""
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-6)


def _head_terms(model, n):
    return [str(int(t)) for t in model.dense_idx.head_ids[:n]]


def _tail_terms(model, lo, hi):
    head = set(int(t) for t in model.dense_idx.head_ids)
    return [str(t) for t in range(3_000)
            if t not in head and lo <= model.lengths[t] < hi]


def test_fused_head_only(fused_model):
    _corpus, model = fused_model
    h = _head_terms(model, 12)
    plan, ref, out = _both(model, [h[i : i + 3] for i in range(0, 12, 3)])
    assert not plan.has_tail
    _assert_fused_equal(ref, out)


def test_fused_head_and_tail(fused_model):
    corpus, model = fused_model
    plan, ref, out = _both(model, corpus.sample_queries(12, 4))
    assert plan.has_head and plan.has_tail
    _assert_fused_equal(ref, out)


def test_fused_tail_only(fused_model):
    _corpus, model = fused_model
    t = _tail_terms(model, 1, 600)
    plan, ref, out = _both(model, [t[i * 4 : i * 4 + 4] for i in range(6)])
    assert not plan.has_head
    _assert_fused_equal(ref, out)


def test_fused_all_head_conjunction(fused_model):
    _corpus, model = fused_model
    h = _head_terms(model, 8)
    qs = [h[i : i + 2] for i in range(0, 8, 2)]
    n_req = np.array([len(set(q)) for q in qs], np.int32)
    plan, ref, out = _both(model, qs, require_all=True, n_req=n_req)
    assert not plan.has_tail
    _assert_fused_equal(ref, out)


def test_fused_window_certified(fused_model):
    """One head term + rare tail terms: every tail doc fits the window, the
    certificate holds and the pruned branch answers (one host sync)."""
    _corpus, model = fused_model
    h, t = _head_terms(model, 4), _tail_terms(model, 1, 12)
    qs = [[h[i], t[2 * i], t[2 * i + 1]] for i in range(4)]
    before = dict(port_fused.WINDOW_BRANCH)
    syncs = port_fused.HOST_SYNCS["window_certificate"]
    _plan, ref, out = _both(model, qs)
    assert port_fused.WINDOW_BRANCH["window"] == before["window"] + 1
    assert port_fused.HOST_SYNCS["window_certificate"] == syncs + 1
    _assert_fused_equal(ref, out)


def test_fused_window_escalated(fused_model):
    """A heavy head term over frequent tail terms: the 128th tail sum plus
    the head bound reaches theta, so the batch escalates to the full
    combine, as the reference's lax.cond does."""
    _corpus, model = fused_model
    h, t = _head_terms(model, 40), _tail_terms(model, 300, 600)
    qs = [[h[20], t[0], t[1]], [h[39], t[2]]]
    before = dict(port_fused.WINDOW_BRANCH)
    _plan, ref, out = _both(model, qs)
    assert port_fused.WINDOW_BRANCH["full"] == before["full"] + 1
    _assert_fused_equal(ref, out)


@pytest.mark.parametrize("prune", [True, False])
def test_fused_exact_counts(fused_model, prune):
    corpus, model = fused_model
    _plan, ref, out = _both(
        model, corpus.sample_queries(8, 4), exact_counts=True, prune=prune
    )
    assert out[3].all()
    _assert_fused_equal(ref, out)


def test_fused_filter_additive_sort(fused_model):
    """The full combine's [D] columns: filter, additive score and a
    doc-value sort ride the same gathers as in the reference."""
    corpus, model = fused_model
    rng = np.random.default_rng(5)
    D = model.dense_idx.capacity
    filt = rng.random(D) < 0.5
    add = (rng.random(D) * 3.0).astype(np.float32)
    keys = rng.permutation(D).astype(np.float32)
    qs = corpus.sample_queries(6, 4)
    for cols in ((filt, None, None), (None, add, None), (filt, None, keys)):
        plan = model.plan_dense_merge(qs)
        idx = model.dense_idx
        args = (idx.rows, idx.row_max, model.doc_ids, model.impacts, plan.W,
                plan.row_idx, np.ones(len(qs), np.int32), plan.run_offs,
                plan.run_lens, plan.run_weights)
        static = dict(k=K, has_head=plan.has_head, has_tail=plan.has_tail,
                      run_len=plan.run_len)
        from nrtsearch_tpu.ops.dense_head import decode_packed2

        ref = decode_packed2(np.asarray(ref_fused.dense_fused_topk(
            *[jnp.asarray(a) for a in args],
            *[None if c is None else jnp.asarray(c) for c in cols],
            idx.rows_lo, **static)), K)
        out = port_dh.decode_packed2(port_fused.dense_fused_topk(
            *[to_torch(a) for a in args],
            *[None if c is None else to_torch(c) for c in cols],
            to_torch(idx.rows_lo), **static), K)
        _assert_fused_equal(ref, out)
