"""The port's CUDA kernels against their plain torch twins, on the card.

Marked ``cuda``: each test asks for the ``cuda_device`` fixture, which skips
when torch sees no CUDA card (the CPU tier-1 run). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Kernel outputs must be bit-equal to the twins: the network and the tie rule
are the same arithmetic-free operations on both, the gather's one multiply
and the finish scan's adds run in the twins' order. The head scores are the
exception: tensor-core products sum in another order than cuBLAS, so S is
held to the f32 summation bound and its count C (small integers) bit-equal.
"""

import numpy as np
import pytest
import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.ops import bitonic_merge as bm
from nrtsearch_tpu_torch.ops import bucket_retrieval as br
from nrtsearch_tpu_torch.ops import dense_fused
from nrtsearch_tpu_torch.ops import merge_scoring as ms

pytestmark = pytest.mark.cuda

HIGH, LOW = int(ms.DOC_SENTINEL), int(ms.DOC_SENTINEL_LOW)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _runs(rng, B, R, L):
    docs = np.full((B, R, L), HIGH, np.int32)
    contribs = np.zeros((B, R, L), np.float32)
    for b in range(B - 1):          # the last row stays all padding
        for r in range(R):
            n = int(rng.integers(0, L + 1))
            lo = int(rng.integers(0, min(n, L // 8) + 1))
            docs[b, r, :lo] = LOW
            docs[b, r, lo:n] = np.sort(rng.integers(0, 2 * L, size=n - lo))
            contribs[b, r, lo:n] = rng.random(n - lo, dtype=np.float32)
    return torch.from_numpy(docs), torch.from_numpy(contribs)


@pytest.mark.parametrize("R,L", [(2, 128), (8, 128), (2, 4096), (8, 4096), (4, 16384)])
def test_merge_sorted_runs_kernels_equal_twins(cuda_device, R, L):
    docs, contribs = _runs(np.random.default_rng(R * L), 5, R, L)
    kernels.reset_launch_counts()
    gd, gc = ms.merge_sorted_runs(docs.to(cuda_device), contribs.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["near_stages"] > 0
    cd, cc = ms.merge_sorted_runs(docs, contribs)
    assert torch.equal(gd.cpu(), cd)
    assert torch.equal(gc.cpu().view(torch.int32), cc.view(torch.int32))


# (N, m): m = 0 ascending; m >= the tile (one direction per block); m < the
# tile (short runs: a direction per pair); N up to the merge batch's width
NEAR_CASES = [(1 << 15, 64), (1 << 15, 1 << 14), (1 << 13, 0), (1 << 13, 1024),
              (1 << 16, 0), (1 << 16, 1 << 15), (1 << 16, 256), (1 << 21, 0),
              (1 << 21, 1 << 16), (1 << 21, 2048)]


@pytest.mark.parametrize("N,m", NEAR_CASES)
def test_alternating_mode_equals_twin(cuda_device, N, m):
    """Far stages down to the tile, then near_stages, against the twins:
    duplicate docs, both sentinels and an all-pad row."""
    rng = np.random.default_rng(m + N)
    docs = torch.from_numpy(rng.integers(0, 500, size=(3, N)).astype(np.int32))
    docs[0, ::7] = HIGH
    docs[1, ::5] = LOW
    docs[2] = HIGH
    contribs = torch.from_numpy(rng.random((3, N), dtype=np.float32))
    gd, gc = docs.to(cuda_device), contribs.to(cuda_device)
    d = (m or N) // 2
    while d >= bm.near_tile(N):
        bm.far_stage(gd, gc, d, m)
        bm.far_stage_twin(docs, contribs, d, m)
        d //= 2
    kernels.reset_launch_counts()
    bm.near_stages(gd, gc, d, m)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["near_stages"] == 1
    bm.near_stages_twin(docs, contribs, d, m)
    assert torch.equal(gd.cpu(), docs)
    assert torch.equal(gc.cpu().view(torch.int32), contribs.view(torch.int32))


def _head_inputs(seed, B, U, D, Hp=48, residual=True):
    """Sparse impact rows (the first 64 docs in none) split into bf16 head
    and Dekker residual rows; U slots, the last two pads repeating row 0 at
    weight 0; weights in (0, 4) with one zero and one negative weight."""
    rng = np.random.default_rng(seed)
    f = np.where(rng.random((Hp, D)) < 0.3, rng.random((Hp, D)) * 3, 0).astype(np.float32)
    f[:, :64] = 0.0
    rows = torch.from_numpy(f).to(torch.bfloat16)
    rows_lo = (torch.from_numpy(f) - rows.float()).to(torch.bfloat16) if residual else None
    idx = rng.integers(0, Hp, U).astype(np.int32)
    idx[-2:] = 0
    W = (rng.random((B, U)) * 4).astype(np.float32)
    W[:, -2:] = 0.0
    W[0, 0] = 0.0
    W[-1, min(1, U - 3)] = -1.5
    return rows, rows_lo, torch.from_numpy(idx), torch.from_numpy(W)


def _head_bound(rows, rows_lo, idx, W):
    """2 * (4U) * 2^-24 * sum|products| per element: the f32 summation bound
    of the kernel's order plus the plain version's."""
    W_hi = W.to(torch.bfloat16).double()
    R = rows.double()[idx.long()]
    P = W_hi.abs() @ R.abs()
    if rows_lo is not None:
        W_lo = (W - W_hi.float()).to(torch.bfloat16).double()
        L = rows_lo.double()[idx.long()]
        P += W_hi.abs() @ L.abs() + W_lo.abs() @ R.abs() + W_lo.abs() @ L.abs()
    return 2 * (4 * idx.shape[0]) * 2.0**-24 * P


# (residual rows, require_all)
HEAD_MODES = [(True, False), (False, False), (True, True), (False, True)]


@pytest.mark.parametrize("residual,require_all", HEAD_MODES)
@pytest.mark.parametrize("D", [128, 4096, 40_064])
@pytest.mark.parametrize("U", [8, 32, 40, 128])
@pytest.mark.parametrize("B", [1, 3, 8, 17, 32])
def test_head_scores_kernel_equals_plain(cuda_device, B, U, D, residual, require_all):
    """The head-scores kernel against head_scores_plain on the same card:
    S within the summation bound (tensor-core and cuBLAS orders differ),
    S > 0 equal wherever the bound decides the sign, C bit-equal, and a
    second launch bit-equal to the first (no atomics)."""
    rows, rows_lo, idx, W = _head_inputs(B * 7 + U * 3 + D, B, U, D, residual=residual)
    g = [None if t is None else t.to(cuda_device) for t in (rows, rows_lo, idx, W)]
    kernels.reset_launch_counts()
    S, C = dense_fused.head_scores(*g, require_all)
    S2, C2 = dense_fused.head_scores(*g, require_all)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["head_scores"] == 2
    ref_s, ref_c = dense_fused.head_scores_plain(*g, require_all)
    bound = _head_bound(rows, rows_lo, idx, W)
    err = (S.cpu().double() - ref_s.cpu().double()).abs()
    assert bool((err <= bound).all()), float((err / bound.clamp_min(1e-30)).max())
    decided = ref_s.cpu().double().abs() > bound
    assert torch.equal((S.cpu() > 0)[decided], (ref_s.cpu() > 0)[decided])
    assert bool((S.cpu() > 0).any()) and bool((S.cpu()[:, :64] == 0).all())
    assert torch.equal(S.view(torch.int32), S2.view(torch.int32))
    if require_all:
        assert torch.equal(C.cpu(), ref_c.cpu()) and torch.equal(C, C2)
    else:
        assert C is None and C2 is None


@pytest.mark.parametrize("B", [33, 70])
def test_head_scores_kernel_query_chunks(cuda_device, B):
    """More than 32 queries: one launch, a grid row per 32 queries."""
    rows, rows_lo, idx, W = _head_inputs(B, B, 40, 4096)
    g = [t.to(cuda_device) for t in (rows, rows_lo, idx, W)]
    kernels.reset_launch_counts()
    S, C = dense_fused.head_scores(*g, True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["head_scores"] == 1
    ref_s, ref_c = dense_fused.head_scores_plain(*g, True)
    err = (S.cpu().double() - ref_s.cpu().double()).abs()
    assert bool((err <= _head_bound(rows, rows_lo, idx, W)).all())
    assert torch.equal(C, ref_c)


@pytest.mark.parametrize("U", [513, 1100, 2048])
@pytest.mark.parametrize("B", [8, 32])
def test_head_scores_kernel_wide_u(cuda_device, B, U):
    """U past the kernel's 512-column weight window (any U that
    the kernel may be handed): the window reloads as each tile's k-steps reach it;
    S within the bound, C bit-equal."""
    rows, rows_lo, idx, W = _head_inputs(B + U, B, U, 4096)
    g = [t.to(cuda_device) for t in (rows, rows_lo, idx, W)]
    kernels.reset_launch_counts()
    S, C = dense_fused.head_scores(*g, True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["head_scores"] == 1
    ref_s, ref_c = dense_fused.head_scores_plain(*g, True)
    err = (S.cpu().double() - ref_s.cpu().double()).abs()
    assert bool((err <= _head_bound(rows, rows_lo, idx, W)).all())
    assert torch.equal(C, ref_c)


@pytest.mark.parametrize("U", [32, 128, 1100])
@pytest.mark.parametrize("B", [1, 17, 32])
def test_head_scores_kernel_keeps_every_dekker_term(cuda_device, B, U):
    """One weight per query: each S element is one weight times one row, so
    the four Dekker products are exact and S must equal their f64 sum within
    4 * 2^-23 * sum|products| (three rounded adds); W_lo * rows_lo alone is
    far above that at many elements, so a kernel that dropped any of the
    four terms fails."""
    rows, rows_lo, idx, W = _head_inputs(B * 11 + U, B, U, 4096)
    rng = np.random.default_rng(B + U)
    W = torch.zeros((B, U))
    w_hi = torch.from_numpy(0.25 + 4 * rng.random(B)).float().to(torch.bfloat16).float()
    W[torch.arange(B), torch.from_numpy(rng.integers(0, U - 2, B))] = \
        w_hi + torch.from_numpy(0.5 + 0.45 * rng.random(B)).float() * \
        torch.exp2(torch.floor(torch.log2(w_hi)) - 8)      # W_lo >= 2^-10 W
    w_hi = W.to(torch.bfloat16)
    w_lo = (W - w_hi.float()).to(torch.bfloat16)
    Wh, Wl = w_hi.double(), w_lo.double()
    R, L = rows.double()[idx.long()], rows_lo.double()[idx.long()]
    exact = (Wh + Wl) @ (R + L)
    tol = 4 * 2.0**-23 * ((Wh.abs() + Wl.abs()) @ (R.abs() + L.abs()))
    assert int(((Wl.abs() @ L.abs()) > 4 * tol).sum()) > 8
    S, _ = dense_fused.head_scores(rows.to(cuda_device), rows_lo.to(cuda_device),
                                   idx.to(cuda_device), W.to(cuda_device), False)
    err = (S.cpu().double() - exact).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp_min(1e-30)).max())


def test_kernel_wrappers_refuse_bad_inputs(cuda_device):
    rows = torch.zeros((4, 12), dtype=torch.bfloat16, device=cuda_device)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    w = torch.zeros((3, 2), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.head_scores(rows, None, idx, w, None, False)          # D % 8 != 0
    rows = rows[:, :8].contiguous()
    with pytest.raises(TypeError):
        kernels.head_scores(rows.float(), None, idx, w, None, False)
    with pytest.raises(TypeError):
        kernels.head_scores(rows, None, idx, w.float(), None, False)
    with pytest.raises(ValueError):                                   # idx [U]
        kernels.head_scores(rows, None, idx[:1], w, None, False)
    with pytest.raises(ValueError):                                   # w_lo [B, U]
        kernels.head_scores(rows, rows, idx, w, w[:2], False)
    with pytest.raises(ValueError):                                   # rows_lo with w_lo
        kernels.head_scores(rows, rows, idx, w, None, False)
    with pytest.raises(RuntimeError, match="invalid argument"):       # > 65535 grid rows
        kernels.head_scores(rows, None, idx, w.new_zeros((32 * 65535 + 1, 2)), None, False)
    docs = torch.zeros((2, 1024), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.far_stage(docs, docs, 512)                   # contribs not f32
    with pytest.raises(ValueError):
        kernels.far_stage(docs[:, ::2], torch.zeros((2, 512), device=cuda_device), 128)
    with pytest.raises(ValueError):
        bm.near_stages(docs, docs.float(), 1024)             # 2*d0 > tile


def test_dense_fused_cuda_matches_cpu(cuda_device):
    """The fused search on the card (kernels, the head scores in one
    head_scores launch) against the same inputs on the CPU (plain versions,
    f32 products): docs and hits equal, scores within 1e-6 relative (the
    products sum in another order)."""
    from nrtsearch_tpu_torch.ops.dense_head import decode_packed2

    rng = np.random.default_rng(4)
    Hp, D, B, U, P = 16, 4096, 4, 8, 20_000
    rows_f = np.where(rng.random((Hp, D)) < 0.3, rng.random((Hp, D)), 0).astype(np.float32)
    rows = torch.from_numpy(rows_f).to(torch.bfloat16)
    rows_lo = (torch.from_numpy(rows_f) - rows.float()).to(torch.bfloat16)
    row_max = rows.float().amax(dim=1)
    post_docs = torch.from_numpy(np.sort(rng.integers(0, D, size=P)).astype(np.int32))
    post_imps = torch.from_numpy(rng.random(P, dtype=np.float32))
    W = torch.from_numpy((rng.random((B, U)) * (rng.random((B, U)) < 0.5)).astype(np.float32))
    row_idx = torch.from_numpy(rng.permutation(Hp)[:U].astype(np.int32))
    n_req = torch.ones(B, dtype=torch.int32)
    offs = torch.from_numpy(rng.integers(0, P - 600, size=(B, 4)).astype(np.int32))
    lens = torch.from_numpy(rng.integers(1, 500, size=(B, 4)).astype(np.int32))
    wts = torch.from_numpy(rng.random((B, 4), dtype=np.float32))
    args = [rows, row_max, post_docs, post_imps, W, row_idx, n_req, offs, lens, wts]
    kw = dict(k=10, has_head=True, has_tail=True, run_len=512)
    cpu = decode_packed2(dense_fused.dense_fused_topk(*args, None, None, None, rows_lo, **kw), 10)
    kernels.reset_launch_counts()
    gpu = decode_packed2(dense_fused.dense_fused_topk(
        *[a.to(cuda_device) for a in args], None, None, None, rows_lo.to(cuda_device), **kw), 10)
    assert kernels.LAUNCHES["head_scores"] == 1
    np.testing.assert_array_equal(gpu[1], cpu[1])
    np.testing.assert_array_equal(gpu[2], cpu[2])
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-6)


def test_dense_fused_head_is_one_kernel_launch(cuda_device, monkeypatch):
    """On the card the head scores come from the kernel alone: the plain
    gather and products are never called, one head_scores launch per fused
    dispatch (an all-head conjunction, so the count C rides it too)."""
    from nrtsearch_tpu_torch.ops.dense_head import decode_packed2

    def refuse(*_a, **_k):
        raise AssertionError("the plain head path ran on CUDA tensors")

    rows, rows_lo, idx, W = _head_inputs(11, 4, 32, 4096)
    row_max = rows.float().amax(dim=1)
    empty_i = torch.zeros((4, 1), dtype=torch.int32)
    args = [rows, row_max, torch.zeros(16, dtype=torch.int32), torch.zeros(16), W, idx,
            torch.full((4,), 2, dtype=torch.int32), empty_i, empty_i, torch.zeros((4, 1))]
    kw = dict(k=10, has_head=True, has_tail=False, run_len=0, require_all=True)
    cpu = decode_packed2(dense_fused.dense_fused_topk(*args, None, None, None, rows_lo, **kw), 10)
    monkeypatch.setattr(dense_fused, "_gather_rows_scan", refuse)
    monkeypatch.setattr(dense_fused, "_mm", refuse)
    kernels.reset_launch_counts()
    gpu = decode_packed2(dense_fused.dense_fused_topk(
        *[a.to(cuda_device) for a in args], None, None, None, rows_lo.to(cuda_device), **kw), 10)
    assert kernels.LAUNCHES["head_scores"] == 1
    np.testing.assert_array_equal(gpu[2], cpu[2])
    assert int(cpu[2].min()) > 0
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-6)


def _postings(rng, P, max_doc):
    docs = np.zeros(P + 16384, np.int32)
    docs[:P] = np.sort(rng.integers(0, max_doc, P))
    imps = np.zeros(P + 16384, np.float32)
    imps[:P] = rng.random(P, dtype=np.float32)
    return torch.from_numpy(docs), torch.from_numpy(imps)


def _tables(rng, B, R, run_len, P):
    offs = rng.integers(0, P - run_len, (B, R)).astype(np.int32)
    lens = rng.integers(0, run_len + 1, (B, R)).astype(np.int32)
    w = rng.random((B, R), dtype=np.float32) + 0.5
    w[0, 1] = 0.0
    w[B - 1] = 0.0          # a row with no runs
    return [torch.from_numpy(a) for a in (offs, lens, w)]


@pytest.mark.parametrize("run_len", [1024, 65536])
@pytest.mark.parametrize("alternating", [False, True])
def test_gather_runs_kernel_equals_twin(cuda_device, run_len, alternating):
    rng = np.random.default_rng(run_len + alternating)
    P = 4 * run_len
    docs, imps = _postings(rng, P, 10 * P)
    tabs = _tables(rng, 5, 8, run_len, P)
    kernels.reset_launch_counts()
    gd, gc = ms.gather_runs_accel(docs.to(cuda_device), imps.to(cuda_device),
                                  *[t.to(cuda_device) for t in tabs], run_len, alternating)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather_runs"] == 1
    cd, cc = ms.gather_runs_twin(docs, imps, *tabs, run_len, alternating)
    assert torch.equal(gd.cpu(), cd)
    assert torch.equal(gc.cpu().view(torch.int32), cc.view(torch.int32))


@pytest.mark.parametrize("m", [0, 1 << 16, 1 << 17])
def test_far_pair_stage_kernel_equals_twin(cuda_device, m):
    rng = np.random.default_rng(m + 1)
    N = 1 << 18
    docs = torch.from_numpy(rng.integers(0, 300, size=(3, N)).astype(np.int32))
    docs[1, ::3] = HIGH
    contribs = torch.from_numpy(rng.random((3, N), dtype=np.float32))
    d = m // 2 if m else N // 2
    gd, gc = docs.to(cuda_device), contribs.to(cuda_device)
    bm.far_pair_stage(gd, gc, d, m)
    bm.far_pair_stage_twin(docs, contribs, d, m)
    assert torch.equal(gd.cpu(), docs)
    assert torch.equal(gc.cpu(), contribs)


@pytest.mark.parametrize("R,L", [(2, 1 << 16), (8, 1 << 14), (4, 1 << 17), (32, 4096),
                                 (128, 16384)])
def test_merge_sorted_runs_alt_kernels_equal_twin(cuda_device, R, L):
    rng = np.random.default_rng(R * L + 3)
    docs, contribs = _runs(rng, 3, R, L)
    docs[:, 1::2] = torch.flip(docs[:, 1::2], dims=(-1,))
    contribs[:, 1::2] = torch.flip(contribs[:, 1::2], dims=(-1,))
    kernels.reset_launch_counts()
    gd, gc = bm.merge_sorted_runs_alt(docs.to(cuda_device), contribs.to(cuda_device))
    torch.cuda.synchronize()
    if R * L >= 4 * bm.NEAR_TILE:
        assert kernels.LAUNCHES["far_pair_stage"] > 0
    cd, cc = bm.merge_sorted_runs_alt(docs.clone(), contribs.clone())
    assert torch.equal(gd.cpu(), cd)
    assert torch.equal(gc.cpu().view(torch.int32), cc.view(torch.int32))
    assert bool((cd[:, 1:] >= cd[:, :-1]).all())


# (R, N, max_seg): R runs merged into N entries, the scan bounded by max_seg;
# N = 2^17 clips the first window's halo at the row start, 2^21 is the
# merge batch's width, max_seg = 4096 doubles the block's window, 8192 and
# 16384 take the wide kernel (16384 with require_all is refused)
FINISH_CASES = [(2, 1024, 2), (8, 1024, 8), (64, 1024, 64), (2, 1 << 17, 2),
                (8, 1 << 17, 8), (64, 1 << 17, 64), (1024, 1 << 17, 1024),
                (1, 1 << 17, 1), (32, 1 << 17, 33), (128, 1 << 17, 128),
                (1, 1 << 21, 1), (2, 1 << 21, 2), (32, 1 << 21, 33), (128, 1 << 21, 128),
                (4096, 1 << 17, 4096), (8192, 1 << 17, 8192), (16384, 1 << 17, 16384)]


@pytest.mark.parametrize("R,N,max_seg", FINISH_CASES)
@pytest.mark.parametrize("require_all", [False, True])
def test_finish_mask_kernel_equals_twin(cuda_device, R, require_all, N, max_seg):
    docs, contribs = _runs(np.random.default_rng(R + N), 4, R, N // R)
    md, mc = ms.merge_sorted_runs(docs.to(cuda_device), contribs.to(cuda_device))
    n_terms = torch.tensor([2, 1, 3, 1], dtype=torch.int32)
    if max_seg > 8192 and require_all:
        with pytest.raises(ValueError, match="shared memory"):
            ms.finish_mask(md, mc, n_terms.to(cuda_device), max_seg, require_all)
        return
    kernels.reset_launch_counts()
    out = ms.finish_mask(md, mc, n_terms.to(cuda_device), max_seg, require_all)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["finish_mask"] == 1
    ref = ms.finish_mask_twin(md.cpu(), mc.cpu(), n_terms, max_seg, require_all)
    assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))
    assert bool(torch.isfinite(ref).any())


@pytest.mark.parametrize("run_len", [4096, 65536])
@pytest.mark.parametrize("require_all", [False, True])
def test_merge_score_topk_cuda_equals_cpu_accel_branch(cuda_device, run_len, require_all,
                                                       monkeypatch):
    """The accelerator branch on the card (its default for CUDA postings)
    against the same branch on the CPU (twins): widths 8 x 4096 (plain
    network) and 8 x 65536 (alternating), bit-equal."""
    rng = np.random.default_rng(run_len + require_all)
    P = 3 * run_len
    docs, imps = _postings(rng, P, P // 2)
    tabs = _tables(rng, 4, 8, run_len, P)
    n_terms = torch.tensor([2, 3, 1, 1], dtype=torch.int32)
    kw = dict(run_len=run_len, k=100, require_all_terms=require_all)
    alt_calls = []
    real_alt = bm.merge_sorted_runs_alt
    monkeypatch.setattr(bm, "merge_sorted_runs_alt",
                        lambda *a: alt_calls.append(1) or real_alt(*a))
    kernels.reset_launch_counts()
    g = ms.merge_score_topk(docs.to(cuda_device), imps.to(cuda_device),
                            *[t.to(cuda_device) for t in tabs], n_terms.to(cuda_device), **kw)
    torch.cuda.synchronize()
    alt = 8 * run_len >= ms.ALT_MIN_WIDTH
    assert len(alt_calls) == (1 if alt else 0)
    assert kernels.LAUNCHES["gather_runs"] == 1
    assert kernels.LAUNCHES["finish_mask"] == (1 if alt else 0)
    c = ms.merge_score_topk(docs, imps, *tabs, n_terms, use_pallas=True, **kw)
    assert torch.equal(g[0].cpu().view(torch.int32), c[0].view(torch.int32))
    assert torch.equal(g[2].cpu(), c[2])
    fin = torch.isfinite(c[0])
    assert torch.equal(g[1].cpu()[fin], c[1][fin])


# each column case keeps the seed it has always drawn from
_COLUMN_SEEDS = {"filter_additive": 21, "sort_desc_reduce": 16, "sort_asc": 8}


def _column_args(case, rng, D, dev):
    """merge_score_topk column arguments: a filter with an additive column;
    a filter with a descending sort (keys with long
    tie plateaus and a missing sentinel) and every reduction kind; an
    ascending sort."""
    def t(x):
        return torch.from_numpy(x).to(dev)

    filt = rng.random(D) < 0.7
    keys = rng.integers(0, 50, D).astype(np.float32)
    keys[rng.random(D) < 0.01] = np.float32(-1e38)
    if case == "filter_additive":
        additive = np.where(rng.random(D) < 0.5, 1.5, 0.0).astype(np.float32)
        return dict(filter_mask=t(filt), additive=t(additive))
    if case == "sort_asc":
        return dict(sort_keys=t(keys), sort_ascending=True)
    tags = rng.integers(-1, 12, D).astype(np.int32)
    vals = (rng.random(D) * 100).astype(np.float32)
    present = t(tags >= 0)
    return dict(filter_mask=t(filt), sort_keys=t(keys), sort_ascending=False,
                reduce_cols=((t(tags), present), (t(vals), None),
                             (t(np.zeros(1, np.float32)), None), (t(vals), present),
                             (t(vals), None)),
                reduce_kinds=(("ordinal", 12), ("sum",), ("count",), ("min",), ("max",)))


@pytest.mark.parametrize("run_len", [4096, 65536])
@pytest.mark.parametrize("case", ["filter_additive", "sort_desc_reduce", "sort_asc"])
def test_merge_score_topk_columns_cuda_equals_cpu(cuda_device, case, run_len):
    """The column arguments on the card's accelerator branch against the
    same call on the CPU (twins): bit-equal scores, keys, hits and counts;
    reduction counts equal, the f32 sum within 1e-6 relative."""
    rng = np.random.default_rng(run_len + _COLUMN_SEEDS[case])
    P = 3 * run_len
    docs, imps = _postings(rng, P, P // 2)
    tabs = _tables(rng, 4, 8, run_len, P)
    n_terms = torch.tensor([2, 3, 1, 1], dtype=torch.int32)
    kw = dict(run_len=run_len, k=100, require_all_terms=case == "sort_asc")
    cpu_cols = _column_args(case, np.random.default_rng(7), P // 2, "cpu")
    gpu_cols = _column_args(case, np.random.default_rng(7), P // 2, cuda_device)
    g = ms.merge_score_topk(docs.to(cuda_device), imps.to(cuda_device),
                            *[x.to(cuda_device) for x in tabs], n_terms.to(cuda_device),
                            **kw, **gpu_cols)
    c = ms.merge_score_topk(docs, imps, *tabs, n_terms, use_pallas=True, **kw, **cpu_cols)
    assert torch.equal(g[0].cpu().view(torch.int32), c[0].view(torch.int32))
    assert torch.equal(g[2].cpu(), c[2]) and int(c[2][:-1].min()) > 0   # row 3: no runs
    fin = torch.isfinite(c[0])
    assert torch.equal(g[1].cpu()[fin], c[1][fin])
    if case == "sort_desc_reduce":
        for i, (a, b) in enumerate(zip(g[3], c[3])):
            if i == 1:
                torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)
            else:
                assert torch.equal(a.cpu(), b), i


def test_accel_wrappers_refuse_bad_inputs(cuda_device):
    docs = torch.zeros((2, 1 << 16), dtype=torch.int32, device=cuda_device)
    contribs = torch.zeros((2, 1 << 16), device=cuda_device)
    n_terms = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.finish_mask(docs, contribs, n_terms, 1 << 15, True)
    with pytest.raises(TypeError):
        kernels.finish_mask(docs, contribs, n_terms.long(), 8, True)
    with pytest.raises(ValueError):
        bm.far_pair_stage(docs, contribs, 1024)               # d/2 < tile
    offs = torch.zeros((2, 4), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.gather_runs(docs[0], contribs[0], offs, offs.int(), contribs[:, :4], 1024)


def _bucket_inputs(seed, B, T, m, bits, density, shift=0):
    """Bucket plan tables over B * T doc-sorted runs in [0, m << bits),
    behind ``shift`` leading postings: a tenth of the postings deleted
    (impact 0), slot 1 of query 0 at weight 0, and the last query all
    weight 0 (its rank rows are all ``I32_MIN``). Weights reach past
    QMAX / T, so sums clamp at QMAX. Returns the tables and the tile the
    plain version needs."""
    rng = np.random.default_rng(seed)
    bd, D = 1 << bits, m << bits
    runs = [np.sort(rng.choice(D, size=int(density * D), replace=False)).astype(np.int32)
            for _ in range(B * T)]
    docs = np.concatenate([np.zeros(shift, np.int32)] + runs)
    imps = rng.random(len(docs), dtype=np.float32)
    imps[rng.random(len(docs)) < 0.1] = 0.0
    lens = np.array([len(r) for r in runs], np.int64)
    toffs = (shift + np.cumsum(lens) - lens).astype(np.int32).reshape(B, T)
    bounds = np.stack([np.searchsorted(r, np.arange(m + 1) * bd) for r in runs])
    bounds = bounds.astype(np.int32).reshape(B, T, m + 1)
    wts = rng.uniform(100.0, 9000.0, (B, T)).astype(np.float32)
    wts[0, 1] = 0.0
    wts[B - 1] = 0.0
    live = np.where((wts != 0)[..., None], bounds[..., 1:] - bounds[..., :-1], 0)
    tile = 1024
    while tile < live.sum(axis=1).max():
        tile *= 2
    tabs = [torch.from_numpy(a) for a in (docs, imps, toffs, bounds, wts)]
    return tabs, tile


def _slices(tabs):
    """(start, length) of every live (query, slot, bucket) slice."""
    _docs, _imps, toffs, bounds, wts = tabs
    starts = (toffs[..., None] + bounds[..., :-1]).numpy()
    lens = (bounds[..., 1:] - bounds[..., :-1]).numpy()
    live = (wts.numpy() != 0)[..., None] & (lens > 0)
    return starts[live], lens[live]


# (B, T, m, bits, density, shift): T = 16 slots, the largest bucket (15
# bits), four near-full runs per bucket (a plain tile of 2^16 keys), slices
# shorter than one 4-posting vector, and slices behind 3 leading postings
BUCKET_SHAPES = [(4, 3, 8, 10, 0.05, 0), (3, 16, 4, 12, 0.3, 0), (2, 2, 2, 15, 0.5, 0),
                 (2, 4, 2, 14, 0.97, 0), (3, 5, 8, 12, 0.0005, 0), (3, 6, 4, 13, 0.2, 3)]


@pytest.mark.parametrize("B,T,m,bits,density,shift", BUCKET_SHAPES)
@pytest.mark.parametrize("require_all", [False, True])
def test_bucket_rank_kernel_equals_plain(cuda_device, B, T, m, bits, density, shift,
                                         require_all):
    tabs, tile = _bucket_inputs(B * T + bits + shift, B, T, m, bits, density, shift)
    starts, lens = _slices(tabs)
    if density > 0.9:
        assert tile == 1 << 16
    if density < 0.001:
        assert (lens < 4).mean() > 0.5                   # mostly scalar ends
    if shift:
        assert (starts % 4 != 0).mean() > 0.5            # unaligned vectors
    n_terms = torch.from_numpy(np.arange(B, dtype=np.int32) % T + 1)
    kernels.reset_launch_counts()
    out = kernels.bucket_rank(*[t.to(cuda_device) for t in tabs], n_terms.to(cuda_device),
                              bits, require_all)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucket_rank"] == 1
    ref = br.bucket_rank_plain(*tabs, n_terms, tile=tile, bucket_bits=bits,
                               require_all=require_all)
    assert torch.equal(out.cpu(), ref)
    hit = ref != int(br.I32_MIN)
    assert bool(hit.any()) and not bool(hit[-1].any())
    if T == 16:
        assert bool((ref == br.QMAX).any())       # a clamped sum


# ---------------------------------------------------------------------------
# the write path: a deleted doc reaches every kernel as a zero impact (the
# rebuilt view folds the live mask into the impacts and the head rows)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("require_all", [False, True])
@pytest.mark.parametrize("B,U", [(1, 32), (8, 32), (32, 128)])
def test_head_scores_kernel_zero_columns(cuda_device, B, U, require_all):
    """Head rows with a third of their columns zeroed, head and residual
    rows alike, as deleted docs leave them: the kernel against the plain
    version (S within the summation bound, C bit-equal), and S and C exactly
    0 in every zeroed column."""
    rows, rows_lo, idx, W = _head_inputs(B * 11 + U, B, U, 4096)
    dead = torch.from_numpy(np.random.default_rng(U + B).random(4096) < 1 / 3)
    rows[:, dead] = 0
    rows_lo[:, dead] = 0
    g = [t.to(cuda_device) for t in (rows, rows_lo, idx, W)]
    kernels.reset_launch_counts()
    S, C = dense_fused.head_scores(*g, require_all)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["head_scores"] == 1
    ref_s, ref_c = dense_fused.head_scores_plain(*g, require_all)
    err = (S.cpu().double() - ref_s.cpu().double()).abs()
    assert bool((err <= _head_bound(rows, rows_lo, idx, W)).all())
    assert bool((S.cpu()[:, dead] == 0).all()) and bool((S.cpu()[:, ~dead] > 0).any())
    if require_all:
        assert torch.equal(C.cpu(), ref_c.cpu())
        assert bool((C.cpu()[:, dead] == 0).all())


def _deleted_postings(rng, P, max_doc, frac):
    """Doc-sorted postings over few docs (each doc in many runs) whose
    deleted docs carry impact 0 in every posting; returns the deleted set."""
    docs, imps = _postings(rng, P, max_doc)
    deleted = rng.random(max_doc) < frac
    imps[:P][torch.from_numpy(deleted)[docs[:P].long()]] = 0.0
    return docs, imps, torch.from_numpy(deleted)


@pytest.mark.parametrize("R,run_len", [(32, 4096), (8, 16384)])
@pytest.mark.parametrize("require_all", [False, True])
def test_gather_and_finish_on_zero_contributions(cuda_device, R, run_len, require_all):
    """Runs that hold zero contributions: gather_runs (alternating), the
    alternating network and finish_mask on the card, each bit-equal to its
    twin; a deleted doc's sum is 0, so finish_mask never emits it."""
    rng = np.random.default_rng(R + run_len + require_all)
    P = 4 * run_len
    docs, imps, deleted = _deleted_postings(rng, P, P // 8, 0.25)
    tabs = _tables(rng, 4, R, run_len, P)
    n_terms = torch.tensor([2, 1, 3, 1], dtype=torch.int32)
    kernels.reset_launch_counts()
    gd, gc = ms.gather_runs_accel(docs.to(cuda_device), imps.to(cuda_device),
                                  *[t.to(cuda_device) for t in tabs], run_len, True)
    cd, cc = ms.gather_runs_twin(docs, imps, *tabs, run_len, True)
    assert torch.equal(gd.cpu(), cd) and torch.equal(gc.cpu().view(torch.int32),
                                                     cc.view(torch.int32))
    md, mc = bm.merge_sorted_runs_alt(gd, gc)
    hd, hc = bm.merge_sorted_runs_alt_twin(cd, cc)
    assert torch.equal(md.cpu(), hd) and torch.equal(mc.cpu().view(torch.int32),
                                                     hc.view(torch.int32))
    out = ms.finish_mask(md, mc, n_terms.to(cuda_device), R, require_all)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] >= 1 for k in ("gather_runs", "finish_mask"))
    ref = ms.finish_mask_twin(hd, hc, n_terms, R, require_all)
    assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))
    real = (hd >= 0) & (hd < P // 8)
    dead = torch.zeros_like(real)
    dead[real] = deleted[hd[real].long()]
    assert bool(dead.any()) and bool(torch.isfinite(ref).any())
    assert not bool(torch.isfinite(ref[dead]).any())


@pytest.mark.parametrize("require_all", [False, True])
@pytest.mark.parametrize("B,T,m,bits,density", [(4, 3, 8, 10, 0.05), (3, 16, 4, 12, 0.3)])
def test_bucket_rank_on_deleted_postings(cuda_device, B, T, m, bits, density, require_all):
    """bucket_rank over postings where every fifth doc is deleted (impact 0
    in all its postings): equal to the plain version, and no deleted doc
    holds a rank."""
    tabs, tile = _bucket_inputs(B * T + bits + 1, B, T, m, bits, density)
    docs, imps = tabs[0], tabs[1]
    imps[docs % 5 == 0] = 0.0
    n_terms = torch.from_numpy(np.arange(B, dtype=np.int32) % T + 1)
    kernels.reset_launch_counts()
    out = kernels.bucket_rank(*[t.to(cuda_device) for t in tabs], n_terms.to(cuda_device),
                              bits, require_all)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucket_rank"] == 1
    ref = br.bucket_rank_plain(*tabs, n_terms, tile=tile, bucket_bits=bits,
                               require_all=require_all)
    assert torch.equal(out.cpu(), ref)
    ranked = ref != int(br.I32_MIN)
    assert bool(ranked.any())
    assert not bool(ranked[:, ::5].any())


def test_bucket_search_topk_cuda_equals_cpu(cuda_device):
    tabs, tile = _bucket_inputs(7, 3, 16, 4, 12, 0.3)
    n_terms = torch.tensor([2, 5, 1], dtype=torch.int32)
    for require_all in (False, True):
        kw = dict(tile=tile, bucket_bits=12, k=100, require_all=require_all)
        kernels.reset_launch_counts()
        g = br.bucket_search_topk(*[t.to(cuda_device) for t in tabs],
                                  n_terms.to(cuda_device), **kw)
        assert kernels.LAUNCHES["bucket_rank_topk"] == 1
        c = br.bucket_search_topk(*tabs, n_terms, **kw)
        for a, b in zip(g, c):
            assert torch.equal(a.cpu(), b)
        assert int(c[2][0]) > 100 and int(c[2][2]) == 0


def _sorted_rows(cands, kk):
    """Each (query, bucket) row's kk candidates in descending order."""
    rows = torch.sort(cands.cpu().reshape(-1, kk), dim=-1, descending=True).values
    return rows.reshape(cands.shape)


@pytest.mark.parametrize("B,T,m,bits,density,shift", BUCKET_SHAPES)
@pytest.mark.parametrize("require_all", [False, True])
@pytest.mark.parametrize("k", [1, 100, 40000])
def test_bucket_rank_topk_kernel_equals_plain(cuda_device, B, T, m, bits, density, shift,
                                              require_all, k):
    """The fused entry's candidates (each row's top min(k, bucket_docs), in
    no order within the row) equal the plain version's as sets, its hits
    equal, and the dense entry does not launch; k = 40000 passes every
    bucket size."""
    tabs, tile = _bucket_inputs(B * T + bits + shift, B, T, m, bits, density, shift)
    n_terms = torch.from_numpy(np.arange(B, dtype=np.int32) % T + 1)
    kernels.reset_launch_counts()
    cands, hits = kernels.bucket_rank_topk(*[t.to(cuda_device) for t in tabs],
                                           n_terms.to(cuda_device), bits, require_all, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucket_rank_topk"] == 1 and kernels.LAUNCHES["bucket_rank"] == 0
    ref_c, ref_h = br.bucket_rank_topk_plain(*tabs, n_terms, tile=tile, bucket_bits=bits,
                                             require_all=require_all, k=k)
    assert cands.shape == ref_c.shape == (B, m * min(k, 1 << bits))
    assert torch.equal(_sorted_rows(cands, min(k, 1 << bits)), ref_c)
    assert torch.equal(hits.cpu(), ref_h)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("require_all", [False, True])
def test_bucket_search_topk_at_the_cell_shape(cuda_device, ties, require_all):
    """At the bucket cell's shape (B = 32, T = 4, m = 1024 buckets of 2^14
    docs, k = 100): ``bucket_search_topk`` (the fused entry and its final
    top k) equals the dense route, the dense kernel's keys through
    ``topk_i32_lowest_index``, bit for bit (keys, docs, hits), on drawn
    scores and on a tie-heavy batch; the fused candidates equal the plain
    version's; some rows prune and some pass whole."""
    from torch_bucket_data import CELL, bucket_tables

    from nrtsearch_tpu_torch.ops.topk import topk_i32_lowest_index

    tabs, n_terms, tile = bucket_tables(cuda_device, 19 + ties + 2 * require_all, ties=ties)
    bits, k, kk = CELL["bits"], 100, 100
    if require_all:   # 1 to T required terms, so that some rows still prune
        need = torch.arange(len(n_terms), device=cuda_device, dtype=torch.int32) // 2
        n_terms = torch.minimum(n_terms, need % CELL["T"] + 1)
    kernels.reset_launch_counts()
    keys, docs, hits = br.bucket_search_topk(*tabs, n_terms, tile=tile, bucket_bits=bits,
                                             k=k, require_all=require_all)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucket_rank_topk"] == 1 and kernels.LAUNCHES["bucket_rank"] == 0
    rank = kernels.bucket_rank(*tabs, n_terms, bits, require_all)
    want_k, want_d = topk_i32_lowest_index(rank, k)
    assert torch.equal(keys, want_k) and torch.equal(docs, want_d.to(torch.int32))
    row_hits = (rank != int(br.I32_MIN)).reshape(CELL["B"] * CELL["m"], -1).sum(dim=1)
    assert torch.equal(hits, row_hits.reshape(CELL["B"], -1).sum(dim=1, dtype=torch.int32))
    assert bool((row_hits > kk).any()) and bool(((row_hits > 0) & (row_hits <= kk)).any())
    del rank
    cands, _ = kernels.bucket_rank_topk(*tabs, n_terms, bits, require_all, k)
    ref_c, ref_h = br.bucket_rank_topk_plain(*tabs, n_terms, tile=tile, bucket_bits=bits,
                                             require_all=require_all, k=k)
    assert torch.equal(_sorted_rows(cands, kk), ref_c.cpu()) and torch.equal(hits, ref_h)
    if ties:          # some query's k-th key is shared by docs of several buckets
        tied = (keys == keys[:, -1:]) & (keys != int(br.I32_MIN))
        spread = [len(set((docs[q][tied[q]] >> bits).tolist())) for q in range(len(keys))]
        assert max(spread) > 1


def test_bucket_wrappers_refuse_bad_inputs(cuda_device):
    tabs, _tile = _bucket_inputs(3, 2, 2, 2, 10, 0.1)
    docs, imps, toffs, bounds, wts = [t.to(cuda_device) for t in tabs]
    n_terms = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.bucket_rank(docs, imps, toffs.long(), bounds, wts, n_terms, 10, False)
    with pytest.raises(TypeError):
        kernels.bucket_rank(docs, imps, toffs, bounds, wts, n_terms.long(), 10, False)
    for bits in (1, 16):                                             # 2..15 bits
        with pytest.raises(ValueError):
            kernels.bucket_rank(docs, imps, toffs, bounds, wts, n_terms, bits, False)
    wide = torch.zeros((2, 17), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):                                  # T = 17
        kernels.bucket_rank(docs, imps, wide, bounds.new_zeros((2, 17, 3)),
                            wide.float(), n_terms, 10, False)
    with pytest.raises(ValueError):                                  # n_terms [B]
        kernels.bucket_rank(docs, imps, toffs, bounds, wts, n_terms[:1], 10, False)
    with pytest.raises(ValueError):                                  # 16-byte aligned
        kernels.bucket_rank(docs[1:], imps[1:], toffs, bounds, wts, n_terms, 10, False)
    with pytest.raises(ValueError):
        kernels.bucket_rank(docs, imps, toffs, bounds, wts, n_terms.cpu(), 10, False)
    with pytest.raises(ValueError):                                  # k >= 1
        kernels.bucket_rank_topk(docs, imps, toffs, bounds, wts, n_terms, 10, False, 0)
    with pytest.raises(TypeError):
        kernels.bucket_rank_topk(docs, imps, toffs.long(), bounds, wts, n_terms, 10, False, 5)


# ---------------------------------------------------------------------------
# the served path: the port's gRPC server with its index on the card
# ---------------------------------------------------------------------------


def _served_answers(device, root, requests):
    """Start the port's server on ``device``, ingest 800 docs in 4
    add/refresh rounds (merging under segmentsPerTier 2), answer
    ``requests``; returns the answers without diagnostics and timestamps."""
    from google.protobuf.json_format import MessageToDict

    from nrtsearch_tpu_torch.client import NrtsearchClient
    from nrtsearch_tpu_torch.config import NrtsearchConfig
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer

    srv = NrtsearchServer(NrtsearchConfig.from_dict(
        {"stateDir": str(root / "state"), "indexDir": str(root / "index")}), device=device)
    client = NrtsearchClient(f"localhost:{srv.start(0)}")
    try:
        client.create_index("i")
        client.register_fields(pb.FieldDefRequest(indexName="i", field=[
            pb.Field(name="body", type=pb.FieldType.TEXT, search=True, store=True),
            pb.Field(name="price", type=pb.FieldType.FLOAT, storeDocValues=True),
            pb.Field(name="tag", type=pb.FieldType.ATOM, storeDocValues=True)]))
        ls = pb.LiveSettingsV2Request(indexName="i")
        ls.liveSettings.segmentsPerTier.value = 2
        ls.liveSettings.maxRefreshSec.value = 3600.0
        client.live_settings_v2(ls)
        client.start_index(pb.StartIndexRequest(indexName="i", mode=pb.Mode.STANDALONE))
        rng = np.random.default_rng(5)
        words = ["alpha", "beta", "gamma", "delta", "needle"]
        for r in range(4):
            reqs = []
            for i in range(200):
                req = pb.AddDocumentRequest(indexName="i")
                req.fields["body"].value.append(
                    "common " + " ".join(rng.choice(words, 1 + (i % 4))))
                req.fields["price"].value.append(str(float(rng.integers(0, 100))))
                req.fields["tag"].value.append(f"t{i % 4}")
                reqs.append(req)
            client.add_documents(iter(reqs))
            client.refresh("i")
        out = []
        for req in requests(pb):
            resp = client.search(req)
            resp.ClearField("diagnostics")
            resp.searchState.ClearField("timestamp")
            out.append(MessageToDict(resp))
        stats = srv.global_state.runtimes["i"].stats()
        return out, stats
    finally:
        client.close()
        srv.stop()


def _served_requests(pb):
    from google.protobuf.json_format import ParseDict

    out = []
    for text in ("alpha needle", "common gamma", "delta"):
        req = pb.SearchRequest(indexName="i", topHits=20, retrieveFields=["price", "tag"])
        req.query.matchQuery.field = "body"
        req.query.matchQuery.query = text
        out.append(req)
    tree = pb.SearchRequest(indexName="i", topHits=10)
    ParseDict({"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "beta needle"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "20"}}}]}},
        tree.query)
    f = tree.facets.add()
    f.dim = "tag"
    out.append(tree)
    return out


def test_served_path_cuda_equals_cpu(cuda_device, tmp_path, monkeypatch):
    """The same RPC script through the port's server on the card and on the
    CPU, both on the merge path: the card's merge kernels launch behind the
    gRPC front-end and every answer (hits, order, scores, retrieved fields,
    facets) is bit-equal (widths below 2^17: both run the plain network)."""
    monkeypatch.setenv("NRT_FAST_PATH", "merge")
    kernels.reset_launch_counts()
    gpu, gpu_stats = _served_answers("cuda", tmp_path / "gpu", _served_requests)
    torch.cuda.synchronize()
    launched = dict(kernels.LAUNCHES)
    cpu, cpu_stats = _served_answers("cpu", tmp_path / "cpu", _served_requests)
    assert launched["near_stages"] > 0, launched
    assert gpu_stats["merges"] == cpu_stats["merges"] > 0
    assert all(a.get("hits") for a in gpu)
    assert gpu == cpu


# ---------------------------------------------------------------------------
# replication: a REPLICA runtime with its index on the card
# ---------------------------------------------------------------------------

REPLICA_WORDS = ["common", "alpha", "beta", "gamma", "delta", "needle", "haystack",
                 "quick", "brown", "fox"]
REPLICA_QUERIES = ["alpha needle", "common gamma", "delta fox brown", "beta",
                   "quick haystack alpha"]


def _replica_docs(n: int, seed: int) -> list[dict]:
    """Zipf-weighted words: the first few terms pass the dense head's
    min_df floor, so the fused path serves from head rows."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(REPLICA_WORDS) + 1)
    p /= p.sum()
    return [{"body": " ".join(rng.choice(REPLICA_WORDS, int(rng.integers(2, 9)), p=p))}
            for _ in range(n)]


def _single_answers(searcher) -> list:
    from nrtsearch_tpu_torch.query import parse_query

    out = []
    for text in REPLICA_QUERIES:
        td = searcher.search(parse_query({"matchQuery": {"field": "body", "query": text}}), 20)
        out.append((td.total_hits, [(h.global_ord, np.float32(h.score).view(np.int32).item())
                                    for h in td.hits]))
    return out


def test_replica_on_card_answers_as_primary(cuda_device, tmp_path):
    """A REPLICA runtime on the card installs a primary's point from the
    object store and answers each single bit-equal to the primary (same
    card, code and segments). A searcher held at version v while v + 1
    installs on another thread keeps v's answers."""
    import threading

    from nrtsearch_tpu_torch.remote.backend import LocalFileBackend
    from nrtsearch_tpu_torch.server.index_runtime import IndexRuntime
    from nrtsearch_tpu_torch.state.index_state import IndexStateInfo

    info = IndexStateInfo(index_name="r", index_id="r-cuda").with_fields(
        {"body": {"type": "TEXT", "search": True}})
    remote = LocalFileBackend(tmp_path / "remote")
    primary = IndexRuntime(info, tmp_path / "p", mode="PRIMARY", remote=remote,
                           service_name="svc", primary_gen=1, device=cuda_device)
    replica = IndexRuntime(info, tmp_path / "r", mode="REPLICA", remote=remote,
                           service_name="svc", device=cuda_device)
    try:
        primary.start()
        docs = _replica_docs(3000, seed=9)
        primary.add_documents(docs[:2000])
        primary.refresh()
        assert replica.sync_from_remote()
        assert all(s.device.type == "cuda" for s in replica.searcher.segments)
        kernels.reset_launch_counts()
        held = replica.acquire()
        want = _single_answers(primary.searcher)
        assert _single_answers(held) == want
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["head_scores"] > 0, dict(kernels.LAUNCHES)

        primary.add_documents(docs[2000:])
        primary.refresh()
        done = threading.Event()
        errors = []

        def install():
            try:
                assert replica.sync_from_remote()
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
            finally:
                done.set()

        t = threading.Thread(target=install)
        t.start()
        during = []
        while not done.is_set():
            during.append(_single_answers(held))
        t.join(timeout=60)
        assert not t.is_alive() and not errors, errors
        assert during and all(a == want for a in during)
        assert replica.searcher.version == primary.searcher.version == held.version + 1
        assert _single_answers(held) == want
        newer = _single_answers(replica.searcher)
        assert newer == _single_answers(primary.searcher) and newer != want
    finally:
        primary.stop()
        replica.stop()


# ---------------------------------------------------------------------------
# the general evaluator (ROADMAP item 8) on the card against its CPU run
# ---------------------------------------------------------------------------


def compiled_eval_surface() -> dict:
    """tests/test_compiled_eval.py's field specs, documents and queries,
    read from its source: that module imports the JAX package, which a
    machine with the card need not have."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "test_compiled_eval.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") in (
                "FIELDS", "DOCS", "QUERIES"):
            name = node.targets[0].id
            if name == "FIELDS":   # {name: create_field_def(name, spec)}
                out[name] = {ast.literal_eval(k): ast.literal_eval(v.args[1])
                             for k, v in zip(node.value.keys, node.value.values)}
            else:
                out[name] = ast.literal_eval(node.value)
    return out


@pytest.fixture(scope="module")
def general_pair(cuda_device, tmp_path_factory):
    """tests/test_compiled_eval.py's documents, committed by the port on the
    CPU and opened on the card and on the CPU."""
    from nrtsearch_tpu_torch.core.directory import commit_segments, open_commit
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.schema import create_field_def

    surface = compiled_eval_surface()
    DOCS = surface["DOCS"]
    fds = {n: create_field_def(n, spec) for n, spec in surface["FIELDS"].items()}
    w = IndexWriter(fds, "cpu", merge_factor=100)
    w.add_documents([dict(d) for d in DOCS[:3]])
    w.refresh()
    w.add_documents([dict(d) for d in DOCS[3:]])
    path = tmp_path_factory.mktemp("general_cuda")
    commit_segments(w.refresh(), path, gen=1, version=1)
    return (Searcher(open_commit(path, cuda_device)[1], fds),
            Searcher(open_commit(path, "cpu")[1], fds))


@pytest.mark.parametrize("compiled", ["1", "0"])
def test_general_evaluator_cuda_matches_cpu(general_pair, monkeypatch, compiled):
    """Every query of the compiled-eval surface (but the phrase query): the
    same hits, order, totals and relation on the card as on the CPU, scores
    bit-equal, or within 4 f32 ulps where the score holds a transcendental
    function (the function score's log)."""
    from nrtsearch_tpu_torch.query import parse_query

    QUERIES = compiled_eval_surface()["QUERIES"]
    card, cpu = general_pair
    monkeypatch.setenv("NRT_COMPILED_EVAL", compiled)
    for qjson in QUERIES:
        name = next(iter(qjson))
        if name == "phraseQuery":
            continue
        got = card.search(parse_query(qjson), 10)
        want = cpu.search(parse_query(qjson), 10)
        assert [h.global_ord for h in got.hits] == [h.global_ord for h in want.hits], name
        assert (got.total_hits, got.relation) == (want.total_hits, want.relation), name
        gs = np.array([h.score for h in got.hits], np.float32)
        ws = np.array([h.score for h in want.hits], np.float32)
        if name == "functionScoreQuery":
            np.testing.assert_allclose(gs, ws, rtol=4 * 2.0**-23, err_msg=name)
        else:
            np.testing.assert_array_equal(gs, ws, err_msg=name)


def test_text_scatter_is_deterministic(cuda_device):
    """score_text_clause adds one term at a time: 10 runs give the same
    bits, equal to the CPU run's, on a many-term clause whose docs repeat
    across terms."""
    from nrtsearch_tpu_torch.ops.bm25 import score_text_clause

    rng = np.random.default_rng(5)
    D, Q = 1 << 16, 64
    runs = [np.sort(rng.choice(D, int(rng.integers(100, 20_000)), replace=False))
            for _ in range(Q)]
    lens = np.array([len(r) for r in runs])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    docs = np.concatenate(runs).astype(np.int32)
    freqs = rng.integers(1, 6, len(docs)).astype(np.float32)
    dl = rng.integers(1, 40, D).astype(np.float32)
    w = rng.uniform(0.5, 5.0, Q).astype(np.float32)
    args = (offs, lens, w, 1.2, 0.75, 17.5)
    cpu_s, cpu_c = score_text_clause(torch.from_numpy(docs), torch.from_numpy(freqs),
                                     torch.from_numpy(dl), *args, num_docs=D)
    g = [torch.from_numpy(x).to(cuda_device) for x in (docs, freqs, dl)]
    for _ in range(10):
        s, c = score_text_clause(*g, *args, num_docs=D)
        assert torch.equal(s.cpu().view(torch.int32), cpu_s.view(torch.int32))
        assert torch.equal(c.cpu(), cpu_c)


def test_text_scatter_waits_for_no_copy(cuda_device):
    """score_text_clause makes its per-term constants on the card (a fill,
    not a copy from host memory): with torch's sync debug mode set to
    raise, a many-term clause runs through without one host wait."""
    from nrtsearch_tpu_torch.device import scalar_f32
    from nrtsearch_tpu_torch.ops.bm25 import score_text_clause

    rng = np.random.default_rng(6)
    D, Q = 1 << 14, 32
    runs = [np.sort(rng.choice(D, 500, replace=False)) for _ in range(Q)]
    lens = np.array([len(r) for r in runs])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    docs = torch.from_numpy(np.concatenate(runs).astype(np.int32)).to(cuda_device)
    freqs = torch.ones(len(docs), dtype=torch.float32, device=cuda_device)
    dl = torch.full((D,), 10.0, device=cuda_device)
    w = rng.uniform(0.5, 5.0, Q).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert scalar_f32(0.1, cuda_device).dtype == torch.float32
        score_text_clause(docs, freqs, dl, offs, lens, w, 1.2, 0.75, 10.0, num_docs=D)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert scalar_f32(0.1, cuda_device).item() == float(np.float32(0.1))


def _drill_sideways_requests(pb):
    """A facet on ``tag`` beside a FILTER clause on ``tag``: the handler
    re-matches the query without that clause for the facet's counts (drill
    sideways) and reads each segment's mask on the host."""
    from google.protobuf.json_format import ParseDict

    out = []
    for tag in ("t1", "t3"):
        req = pb.SearchRequest(indexName="i", topHits=10, retrieveFields=["tag"])
        ParseDict({"booleanQuery": {"clauses": [
            {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "alpha"}}},
            {"occur": "FILTER", "query": {"termQuery": {"field": "tag", "textValue": tag}}}]}},
            req.query)
        f = req.facets.add()
        f.dim = "tag"
        f.topN = 10
        out.append(req)
    return out


def test_drill_sideways_facet_cuda_equals_cpu(cuda_device, tmp_path, monkeypatch):
    """A served drill-sideways facet with a FILTER on its own dimension
    answers on the card (the handler copies each segment's match mask to
    the host before numpy reads it) and equals the CPU's answer, both on
    the merge path (bit-equal below 2^17, as test_served_path_cuda_equals_cpu
    holds it)."""
    monkeypatch.setenv("NRT_FAST_PATH", "merge")
    gpu, _ = _served_answers(cuda_device, tmp_path / "gpu", _drill_sideways_requests)
    cpu, _ = _served_answers("cpu", tmp_path / "cpu", _drill_sideways_requests)
    for answer in gpu:
        counts = {lv["label"] for lv in answer["facetResult"][0]["labelValues"]}
        assert len(counts) > 1, counts
    assert gpu == cpu


# ---------------------------------------------------------------------------
# vector search on the card (ops/knn.py, Searcher.knn_search, served)
# ---------------------------------------------------------------------------

KNN_ULPS = 4


def _knn_scale(Q, V, sim, score) -> np.ndarray:
    """The magnitude a score is computed from (tests/test_torch_knn.py's S):
    the dot product's sum of |q_i v_i| carried through the similarity."""
    Q, V = np.asarray(Q, np.float64), np.asarray(V, np.float64)
    A = np.abs(Q) @ np.abs(V).T
    qn = np.linalg.norm(Q, axis=1)[:, None]
    vn = np.linalg.norm(V, axis=1)[None, :]
    s = np.asarray(score, np.float64)
    if sim == "l2_norm":
        S = s * s * (qn ** 2 + vn ** 2 + 2 * A)
    elif sim == "dot_product":
        S = (A + 1) / 2
    elif sim in ("cosine", "normalized_cosine"):
        S = (A / np.maximum(qn * vn, 1e-30) + 1) / 2
    else:
        S = np.where(s >= 1, A + 1, s * s * (A + 1))
    return np.maximum(S, np.abs(s))


@pytest.mark.parametrize("B", [1, 5, 20])
@pytest.mark.parametrize("fmt", ["float32", "float16", "int8"])
@pytest.mark.parametrize("dims", [16, 100, 128])
def test_knn_ops_cuda_equal_cpu(cuda_device, dims, fmt, B):
    """Scores of the five similarities and knn_search / knn_search_quantized
    on the card against the same inputs on the CPU: scores within 4 f32
    ulps of their scale (cuBLAS adds in another order than the CPU), top-k
    ids equal but at near-ties; int8 dots exact (torch._int_mm with query
    rows padded to 32 and dims to a multiple of 8: 100 is not one, and B = 1
    and 5 are under _int_mm's 17 rows)."""
    from nrtsearch_tpu_torch.core.segment import vector_column
    from nrtsearch_tpu_torch.ops import knn

    rng = np.random.default_rng(dims * 7 + B)
    V = rng.normal(size=(4096, dims)).astype(np.float32)
    Q = rng.normal(size=(B, dims)).astype(np.float32)
    Q[0] = V[11] + 0.02
    mask = rng.random(4096) < 0.8
    present = np.ones(4096, bool)
    cols = [vector_column(V, present, fmt, d) for d in (cuda_device, torch.device("cpu"))]
    seen_v = cols[1].host_float()
    seen_q = Q if fmt != "float16" else torch.from_numpy(Q).to(torch.bfloat16).float().numpy()
    if fmt == "int8":
        qq = torch.from_numpy(rng.integers(-127, 128, size=(B, dims)).astype(np.int8))
        dots = knn._int8_dots(qq.to(cuda_device), cols[0].values)
        torch.cuda.synchronize()
        assert torch.equal(dots.cpu(), knn._int8_dots(qq, cols[1].values))
    for sim in knn.SIMILARITIES:
        out = []
        for col in cols:
            qt = torch.from_numpy(Q).to(col.values.device)
            mt = torch.from_numpy(mask).to(col.values.device)
            if fmt == "int8":
                full = knn._quantized_scores(qt, col.values, col.scale, col.score_sq_norms, sim)
                top = knn.knn_search_quantized(col.values, col.scale, col.score_sq_norms, mt,
                                               qt, similarity=sim, k=10)
            else:
                full = knn._scores(qt, col.values, col.score_sq_norms, sim)
                top = knn.knn_search(col.values, col.score_sq_norms, mt, qt,
                                     similarity=sim, k=10)
            out.append((full.cpu().numpy(), top[0].cpu().numpy(), top[1].cpu().numpy()))
        (gf, gs, gi), (cf, cs, ci) = out
        tol = KNN_ULPS * 2.0 ** -23 * _knn_scale(seen_q, seen_v, sim, cf)
        assert (np.abs(gf.astype(np.float64) - cf) <= tol).all(), (sim, fmt)
        for b in range(B):
            for r in np.nonzero(gi[b] != ci[b])[0]:
                assert abs(cf[b, gi[b, r]] - cs[b, r]) <= 2 * tol[b, ci[b, r]], (sim, b, r)
            assert mask[gi[b]].all()


def _knn_writers(device):
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.schema import create_field_def

    specs = {"id": {"type": "_ID", "store": True},
             "price": {"type": "INT", "storeDocValues": True}}
    for fmt, sim in (("float32", "l2_norm"), ("float16", "cosine"), ("int8", "dot_product")):
        specs[f"v_{fmt}"] = {"type": "VECTOR", "vectorDimensions": 24, "vectorSimilarity": sim,
                             "vectorIndexingOptions": fmt}
    fds = {n: create_field_def(n, s) for n, s in specs.items()}
    w = IndexWriter(fds, device, merge_factor=100)
    vecs = np.random.default_rng(8).normal(size=(3000, 24)).astype(np.float32)
    for lo in range(0, 3000, 1000):
        w.add_documents([{"id": str(i), "price": str(i % 97),
                          **{f: (vecs[i] * 0.3).tolist() for f in specs if f.startswith("v_")}}
                         for i in range(lo, lo + 1000)])
        w.refresh()
    w.delete_by_id([str(i) for i in range(0, 3000, 37)])
    w.refresh()
    return Searcher(w.segments, fds), vecs * np.float32(0.3)


def test_knn_searcher_cuda_equals_cpu(cuda_device):
    """Searcher.knn_search over 3 segments with deletes, filtered and not,
    k = 10 and 100, on the card and on the CPU: the same hits and totals,
    scores within 4 f32 ulps of (|q| + |v|)^2 (the largest scale of the
    three similarities here); no deleted doc answers."""
    from nrtsearch_tpu_torch.query import parse_query

    gpu, vecs = _knn_writers(cuda_device)
    cpu, _ = _knn_writers("cpu")
    q = vecs[5] + 0.01
    tol = KNN_ULPS * 2.0 ** -23 * 4 * float(np.max(np.sum(vecs.astype(np.float64) ** 2, 1)))
    for field in ("v_float32", "v_float16", "v_int8"):
        for filt in (None, {"rangeQuery": {"field": "price", "upper": "40"}}):
            for k in (10, 100):
                node = parse_query(filt) if filt else None
                g = gpu.knn_search(field, q, k, filter_node=node)
                c = cpu.knn_search(field, q, k, filter_node=node)
                assert g.total_hits == c.total_hits > 0
                assert [h.global_ord for h in g.hits] == [h.global_ord for h in c.hits], field
                np.testing.assert_allclose([h.score for h in g.hits], [h.score for h in c.hits],
                                           rtol=0, atol=tol)
                assert all(h.global_ord % 37 for h in g.hits)


def _vector_served(device, root):
    """The port's server on ``device`` over a 600-doc index with an f32 and
    an int8 vector field: kNN, query + kNN, multiRetriever, rescorers and
    highlights; answers without diagnostics and timestamps."""
    from google.protobuf.json_format import MessageToDict, ParseDict

    from nrtsearch_tpu_torch.client import NrtsearchClient
    from nrtsearch_tpu_torch.config import NrtsearchConfig
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer

    srv = NrtsearchServer(NrtsearchConfig.from_dict(
        {"stateDir": str(root / "state"), "indexDir": str(root / "index")}), device=device)
    client = NrtsearchClient(f"localhost:{srv.start(0)}")
    rng = np.random.default_rng(17)
    vecs = rng.normal(size=(600, 16)).astype(np.float32)
    words = ["alpha", "beta", "gamma", "delta", "needle", "common"]
    try:
        client.create_index("v")
        client.register_fields(pb.FieldDefRequest(indexName="v", field=[
            pb.Field(name="body", type=pb.FieldType.TEXT, search=True, store=True),
            pb.Field(name="price", type=pb.FieldType.FLOAT, storeDocValues=True),
            pb.Field(name="tag", type=pb.FieldType.ATOM, storeDocValues=True),
            pb.Field(name="vec", type=pb.FieldType.VECTOR, vectorDimensions=16,
                     vectorSimilarity="l2_norm"),
            pb.Field(name="vec_i8", type=pb.FieldType.VECTOR, vectorDimensions=16,
                     vectorSimilarity="dot_product",
                     vectorIndexingOptions=pb.VectorIndexingOptions(
                         type="hnsw_scalar_quantized"))]))
        ls = pb.LiveSettingsV2Request(indexName="v")
        ls.liveSettings.maxRefreshSec.value = 3600.0
        client.live_settings_v2(ls)
        client.start_index(pb.StartIndexRequest(indexName="v", mode=pb.Mode.STANDALONE))
        for lo in range(0, 600, 200):
            reqs = []
            for i in range(lo, lo + 200):
                req = pb.AddDocumentRequest(indexName="v")
                req.fields["body"].value.append(" ".join(rng.choice(words, 2 + i % 5)))
                req.fields["price"].value.append(str(float(i % 50)))
                req.fields["tag"].value.append(f"t{i % 4}")
                req.fields["vec"].value.append(str(vecs[i].tolist()))
                req.fields["vec_i8"].value.append(str((vecs[i] * 0.25).tolist()))
                reqs.append(req)
            client.add_documents(iter(reqs))
            client.refresh("v")
        q = [float(x) for x in vecs[42] + 0.03]
        reqs = []
        for query in (None, {"matchQuery": {"field": "body", "query": "alpha needle"}}):
            req = pb.SearchRequest(indexName="v", topHits=12, retrieveFields=["body", "vec_i8"])
            if query:
                ParseDict(query, req.query)
            for field in ("vec", "vec_i8"):
                knn = req.knn.add()
                knn.field, knn.k, knn.num_candidates = field, 10, 40
                knn.query_vector.extend(q)
            f = req.facets.add()
            f.dim = "tag"
            reqs.append(req)
        multi = pb.SearchRequest(indexName="v", topHits=10)
        rt = multi.multiRetriever.retrievers.add()
        rt.name = "text"
        rt.textRetriever.query.matchQuery.field = "body"
        rt.textRetriever.query.matchQuery.query = "common gamma"
        rv = multi.multiRetriever.retrievers.add()
        rv.name = "knn"
        rv.knnRetriever.knnQuery.field = "vec"
        rv.knnRetriever.knnQuery.k = 20
        rv.knnRetriever.knnQuery.query_vector.extend(q)
        for blender in ("rrf", "SUM", "MAX"):
            m = pb.SearchRequest()
            m.CopyFrom(multi)
            if blender != "rrf":
                m.multiRetriever.blender.weightedScoreOrder.scoreMode = \
                    pb.WeightedScoreOrderBlender.ScoreMode.Value(blender)
            reqs.append(m)
        for kind in ("query", "script"):
            req = pb.SearchRequest(indexName="v", topHits=10)
            req.query.matchQuery.field = "body"
            req.query.matchQuery.query = "beta delta"
            r = req.rescorers.add()
            r.windowSize = 30
            if kind == "query":
                r.queryRescorer.rescoreQuery.matchQuery.field = "body"
                r.queryRescorer.rescoreQuery.matchQuery.query = "needle"
            else:
                r.scriptRescorer.script.source = "_score + price / 100"
            req.highlight.fields.append("body")
            reqs.append(req)
        out = []
        for req in reqs:
            resp = client.search(req)
            resp.ClearField("diagnostics")
            resp.searchState.ClearField("timestamp")
            out.append(MessageToDict(resp))
        return out, vecs
    finally:
        client.close()
        srv.stop()


def _close_answers(gpu, cpu, tol: float, path: str = "") -> None:
    if isinstance(cpu, dict):
        assert set(gpu) == set(cpu), path
        for k in cpu:
            if k in ("score", "lastScore") and isinstance(cpu[k], float):
                assert abs(gpu[k] - cpu[k]) <= tol, (path, k, gpu[k], cpu[k])
            else:
                _close_answers(gpu[k], cpu[k], tol, f"{path}.{k}")
    elif isinstance(cpu, list):
        assert len(gpu) == len(cpu), path
        for i, (g, c) in enumerate(zip(gpu, cpu)):
            _close_answers(g, c, tol, f"{path}[{i}]")
    else:
        assert gpu == cpu, (path, gpu, cpu)


def test_served_knn_hybrid_rescore_highlight_cuda_equals_cpu(cuda_device, tmp_path):
    """kNN-only and query + kNN requests with two kNN clauses and a facet,
    the multi-retriever blends, the query and script rescorers and a
    highlight, served on the card and on the CPU: equal answers, scores
    within 4 f32 ulps of 4 (|q| + |v|)^2 (two clauses, weights up to 2)."""
    gpu, vecs = _vector_served(cuda_device, tmp_path / "gpu")
    cpu, _ = _vector_served("cpu", tmp_path / "cpu")
    x = vecs.astype(np.float64) + 0.03
    tol = KNN_ULPS * 2.0 ** -23 * 4 * 4 * float(np.max(np.sum(x * x, 1)))
    assert all(a.get("hits") for a in gpu)
    assert any(h.get("highlights") for h in gpu[-1]["hits"])
    _close_answers(gpu, cpu, tol)


# ---------------------------------------------------------------------------
# term positions, nested documents and the new field types on the card
# ---------------------------------------------------------------------------

PHRASE_ULPS = 2


def _positional_writers(device, specs_or_defs, docs, waves):
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from torch_positional_data import build

    w = IndexWriter(specs_or_defs, device, merge_factor=100)
    build(w, docs, waves)
    return w.segments


def _phrase_fields():
    from nrtsearch_tpu_torch.schema import create_field_def
    from torch_positional_data import SPECS

    return {n: create_field_def(n, s) for n, s in SPECS.items()}


def _assert_close(want, got, ctx, max_ulps=PHRASE_ULPS):
    from torch_positional_data import ulps

    assert [h.global_ord for h in got.hits] == [h.global_ord for h in want.hits], ctx
    assert (got.total_hits, got.relation) == (want.total_hits, want.relation), ctx
    diff = ulps([h.score for h in got.hits], [h.score for h in want.hits])
    assert diff.max(initial=0) <= max_ulps, (ctx, diff)


def test_phrase_ops_cuda_equal_cpu(cuda_device):
    """ops.phrase on the card against the same calls on the CPU: freqs,
    padded candidates and matches equal, scores within 2 f32 ulps."""
    from nrtsearch_tpu_torch.ops import phrase as phrase_ops
    from torch_positional_data import OPS_CASES, candidates, phrase_docs, ulps

    docs = phrase_docs()
    cpu = _positional_writers("cpu", _phrase_fields(), docs, 3)
    gpu = _positional_writers(cuda_device, _phrase_fields(), docs, 3)
    for case, (terms, req, slop, exp, exp_req) in OPS_CASES.items():
        for kind in ("all", "doc0_and_pads"):
            for cs, gs in zip(cpu, gpu):
                cand_ids = candidates(cs, kind)
                want = phrase_ops.run_phrase(cs.fields["t"], cand_ids, terms, req, slop,
                                             expansions=list(exp), exp_req=exp_req)
                got = phrase_ops.run_phrase(gs.fields["t"], cand_ids, terms, req, slop,
                                            expansions=list(exp), exp_req=exp_req)
                assert torch.equal(got[0].cpu(), want[0]), (case, kind)
                assert torch.equal(got[1].cpu(), want[1]), (case, kind)
                args = (1.7, 1.25, 1.2, 0.75, 13.37)
                ws, wm = phrase_ops.phrase_scatter(*want, cs.fields["t"].doc_lens, *args)
                gsc, gm = phrase_ops.phrase_scatter(*got, gs.fields["t"].doc_lens, *args)
                assert torch.equal(gm.cpu(), wm), (case, kind)
                assert ulps(gsc.cpu().numpy(), ws.numpy()).max() <= PHRASE_ULPS, (case, kind)


def test_positional_queries_cuda_equal_cpu(cuda_device):
    """Every positional query of tests/test_torch_phrase.py through
    ``Searcher.search`` on the card against the CPU; the phrase and
    phrase-prefix queries with a fixed term are verified by ops.phrase on
    the card (the host loop's counter does not move), the span-near ones
    by the host loop over candidates read with .cpu()."""
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.query import eval as qeval
    from nrtsearch_tpu_torch.query import parse_query
    from torch_positional_data import PHRASE_QUERIES, phrase_docs

    docs = phrase_docs()
    fds = _phrase_fields()
    cpu = Searcher(_positional_writers("cpu", fds, docs, 3), fds)
    gpu = Searcher(_positional_writers(cuda_device, fds, docs, 3), fds)
    for name, q in sorted(PHRASE_QUERIES.items()):
        before = dict(qeval.PHRASE_PATHS)
        got = gpu.search(parse_query(q), 50)
        if name.startswith(("phrase", "match_phrase")) and name != "phrase_prefix_one":
            assert qeval.PHRASE_PATHS["host"] == before["host"], name
        _assert_close(cpu.search(parse_query(q), 50), got, name)


def test_nested_and_field_types_cuda_equal_cpu(cuda_device):
    """Nested queries in the five score modes (their child answers come to
    the host with .cpu()), child and prefix fields, polygon containment and
    completion on a CUDA index against the CPU."""
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.query import parse_query
    from nrtsearch_tpu_torch.schema import create_field_def
    from torch_positional_data import NESTED_QUERIES, nested, nested_docs, nested_field_defs

    docs = nested_docs()
    fds = nested_field_defs(create_field_def)
    cpu = Searcher(_positional_writers("cpu", fds, docs, 2), fds)
    gpu = Searcher(_positional_writers(cuda_device, fds, docs, 2), fds)
    queries = dict(NESTED_QUERIES, **{f"nested_{m}": nested(m)
                                      for m in ("SUM", "AVG", "MAX", "MIN", "NONE")})
    for name, q in sorted(queries.items()):
        want = cpu.search(parse_query(q), 100)
        assert want.total_hits > 0, name
        _assert_close(want, gpu.search(parse_query(q), 100), name)


def _nested_served(device, root):
    """The port's server on ``device`` over tests/test_torch_nested.py's
    schema and documents; the SERVED requests' answers."""
    from google.protobuf.json_format import ParseDict

    from nrtsearch_tpu_torch.client import NrtsearchClient
    from nrtsearch_tpu_torch.config import NrtsearchConfig
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer
    from torch_positional_data import (
        FIELDS, INDEX, PARENTS, SERVED, add_requests, nested_docs, plain,
    )

    srv = NrtsearchServer(NrtsearchConfig.from_dict(
        {"stateDir": str(root / "state"), "indexDir": str(root / "index")}), device=device)
    client = NrtsearchClient(f"localhost:{srv.start(0)}")
    try:
        client.create_index(INDEX)
        client.register_fields(ParseDict({"indexName": INDEX, "field": FIELDS},
                                         pb.FieldDefRequest()))
        client.start_index(pb.StartIndexRequest(indexName=INDEX, mode=pb.Mode.STANDALONE))
        docs = nested_docs()
        for lo, hi in ((0, 50), (50, PARENTS)):
            client.add_documents(add_requests(docs[lo:hi]))
            client.refresh(INDEX)
        return {name: plain(client.search(make())) for name, make in SERVED.items()}
    finally:
        client.close()
        srv.stop()


def test_inner_hits_cuda_equals_cpu(cuda_device, tmp_path):
    """Served inner hits, nested, polygon, completion, prefix, child-field
    and highlighted match-phrase requests on a node whose index lives on
    the card: the inner hits' child answer is read with .cpu() (the
    reference's np.asarray of it answered INTERNAL on the card), and every
    answer equals the CPU node's."""
    gpu = _nested_served(cuda_device, tmp_path / "gpu")
    cpu = _nested_served("cpu", tmp_path / "cpu")
    assert any(h["innerHits"]["good_reviews"].get("hits") for h in gpu["inner_hits"]["hits"])
    assert gpu == cpu


# ---------------------------------------------------------------------------
# virtual shards and the standalone bucket API on the card
# ---------------------------------------------------------------------------


def _mesh_pair(cuda_device):
    """The port's DistributedBM25 on [cuda:0] * 4 and on [cpu] * 4, one
    corpus."""
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus
    from nrtsearch_tpu_torch.parallel import DistributedBM25, make_search_mesh

    corpus = SyntheticCorpus(num_docs=20_000, vocab_size=2000, avg_doc_len=24, seed=7)
    gpu = DistributedBM25.build(corpus, make_search_mesh(4, 1, [cuda_device] * 4))
    cpu = DistributedBM25.build(corpus, make_search_mesh(4, 1, [torch.device("cpu")] * 4))
    qs = [[int(t) for t in q] for q in corpus.sample_queries(8, 4)]
    return gpu, cpu, qs


def test_mesh_on_card_equals_cpu(cuda_device):
    """The merge mesh and the fused mesh over four shards on one card
    against the same meshes on the CPU: hits and docs equal, scores within
    1e-6 relative (the card's merge takes the accelerator branch, the CPU's
    the plain one); every shard launches its kernels."""
    gpu, cpu, qs = _mesh_pair(cuda_device)
    offs, lens, w, n_terms, run_len = gpu.compile_queries(qs, max_terms=4)
    kernels.reset_launch_counts()
    g = [t.cpu().numpy() for t in gpu.search(offs, lens, w, n_terms, run_len=run_len, k=50)]
    assert kernels.LAUNCHES["gather_runs"] == 4 and kernels.LAUNCHES["near_stages"] >= 4
    c = [t.numpy() for t in cpu.search(offs, lens, w, n_terms, run_len=run_len, k=50)]
    np.testing.assert_array_equal(g[2], c[2])
    np.testing.assert_array_equal(g[1], c[1])
    np.testing.assert_allclose(g[0], c[0], rtol=1e-6)
    for d in (gpu, cpu):
        assert d.attach_dense(max_rows=64, min_df=400) > 0
    args = gpu.compile_dense_queries(qs, max_terms=4)
    kw = dict(run_len=args[6], k=50, has_head=args[7], has_tail=args[8])
    kernels.reset_launch_counts()
    g = [t.cpu().numpy() for t in gpu.search_dense(*args[:6], **kw)]
    assert kernels.LAUNCHES["head_scores"] == 4
    c = [t.numpy() for t in cpu.search_dense(*args[:6], **kw)]
    np.testing.assert_array_equal(g[2], c[2])
    np.testing.assert_allclose(g[0], c[0], rtol=1e-6)
    swap = g[1] != c[1]
    assert (np.abs(g[0] - c[0])[swap] <= 2e-6 * np.abs(c[0])[swap]).all()


def test_standalone_bucket_search_on_card(cuda_device):
    """BucketIndex.build and plan_bucket_batch drive bucket_search_topk
    (kernel #7/#8) as they are: decoded scores, docs and hits equal to
    reference_bucket_search on the host, bit for bit."""
    rng = np.random.default_rng(13)
    V, D = 60, 60_000
    runs = [np.sort(rng.choice(D, size=int(rng.integers(50, 5000)), replace=False))
            for _ in range(V)]
    lens = np.array([len(r) for r in runs], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    P = int(lens.sum()) + 8192
    docs = np.zeros(P, np.int32)
    imps = np.zeros(P, np.float32)
    docs[: lens.sum()] = np.concatenate(runs)
    imps[: lens.sum()] = rng.uniform(0.05, 1.0, lens.sum()).astype(np.float32)
    imps[: lens.sum()][rng.random(lens.sum()) < 0.05] = 0.0
    idx = br.BucketIndex.build(docs, imps, offs, lens, capacity=65536, bucket_docs=16384)
    qs = [[(int(t), float(rng.uniform(0.5, 3.0))) for t in rng.choice(V, 4, replace=False)]
          for _ in range(16)]
    plan = br.plan_bucket_batch(idx, qs, offs, max_terms=8)
    dev = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in
           (docs, imps, plan.term_offs, plan.bounds, plan.weights, plan.n_terms)]
    for require_all in (False, True):
        kernels.reset_launch_counts()
        keys, top_docs, hits = br.bucket_search_topk(
            *dev, tile=plan.tile, bucket_bits=idx.bucket_bits, k=100, require_all=require_all)
        assert kernels.LAUNCHES["bucket_rank_topk"] == 1
        s, d = br.decode_topk(keys.cpu().numpy(), top_docs.cpu().numpy(), plan.scales)
        ws, wd, wh = br.reference_bucket_search(docs, imps, idx, plan, 100,
                                                require_all=require_all)
        np.testing.assert_array_equal(s.view(np.int32), ws.view(np.int32))
        np.testing.assert_array_equal(d, wd)
        np.testing.assert_array_equal(hits.cpu().numpy(), wh)


# ---------------------------------------------------------------------------
# the flagship model's routes (models/flagship.py) on the card against a
# CPU copy of the same model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship_pair(cuda_device):
    """The same corpus as a model on the card and on the CPU, with the same
    bucket and dense-head indexes (the CPU copy takes the card's
    head rows, so both score the same bf16 rows)."""
    import dataclasses

    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    corpus = SyntheticCorpus(40_000, 3_000, 24, seed=7)
    card, cpu = corpus.to_model(cuda_device), corpus.to_model("cpu")
    card.attach_bucket(4096)
    card.attach_dense(max_rows=32, min_df=400, residual=True)
    idx = card.dense_idx
    cpu.bucket_idx = card.bucket_idx
    cpu.dense_idx = dataclasses.replace(idx, rows=idx.rows.cpu(), rows_lo=idx.rows_lo.cpu(),
                                        row_max=idx.row_max.cpu())
    return card, cpu, corpus.sample_queries(24, 4) + [[], ["no-such-term"]]


def test_flagship_search_on_card_equals_cpu(flagship_pair):
    """search on the card (kernels #2-#6) bit-equal to the CPU copy's
    accelerator branch (its plain versions)."""
    from nrtsearch_tpu_torch.models.flagship import bm25_search_step

    card, cpu, qs = flagship_pair
    qb = card.compile_queries(qs)
    kernels.reset_launch_counts()
    got = [x.cpu() for x in card.search(qb, 50)]
    assert kernels.LAUNCHES["gather_runs"] == 1
    want = bm25_search_step(cpu.doc_ids, cpu.impacts, *(torch.from_numpy(a) for a in (
        qb.term_offsets, qb.term_lengths, qb.term_weights, qb.n_terms)),
        run_len=qb.run_len, k=50, use_pallas=True)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)


def test_flagship_bucket_and_dense_tail_on_card_equal_cpu(flagship_pair):
    """The bucket route bit-equal; the dense head + bucket tail with equal
    hits, scores within 8 f32 ulps of the largest score the query can reach
    (the rank keys are bit-equal; cuBLAS sums the head products in another
    order), docs equal but at such near-ties."""
    from nrtsearch_tpu_torch.ops import dense_head

    card, cpu, qs = flagship_pair
    plan = card.plan_bucket(qs)
    kernels.reset_launch_counts()
    got = [x.cpu() for x in card.serve_bucket_batch(plan, 50)]
    assert kernels.LAUNCHES["bucket_rank_topk"] == 1
    want = cpu.serve_bucket_batch(plan, 50)
    filled = got[0] != int(br.I32_MIN)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1][filled], want[1][filled])
    dp = card.plan_dense(qs)
    kernels.reset_launch_counts()
    s, d, h = dense_head.decode_packed(card.serve_dense_batch(dp, 50), 50)
    assert kernels.LAUNCHES["bucket_rank"] == 1
    ws, wd, wh = dense_head.decode_packed(cpu.serve_dense_batch(dp, 50), 50)
    np.testing.assert_array_equal(h, wh)
    top = np.abs(dp.W.astype(np.float64)) @ card.dense_idx.row_max.double().cpu().numpy()
    top = top + np.where(dp.tail.n_terms > 0, br.QMAX / dp.tail.scales, 0.0)
    tol = 8 * 2.0**-23 * top
    for qi in range(len(qs)):
        fin = np.isfinite(ws[qi])
        assert np.array_equal(np.isfinite(s[qi]), fin)
        assert np.abs(s[qi][fin] - ws[qi][fin]).max(initial=0) <= tol[qi]
        for j in np.nonzero(d[qi][fin] != wd[qi][fin])[0]:
            assert abs(s[qi][fin][j] - ws[qi][fin][j]) <= tol[qi], (qi, j)


def test_flagship_dense_merge_and_fused_on_card_equal_cpu(flagship_pair):
    """Dense head + merge tail (kernels #2/#4 in the tail merge) and the
    fused path (kernel #1): docs, hits and exact flags equal to the CPU
    copy, scores within 1e-6 relative (the fused contract)."""
    from nrtsearch_tpu_torch.ops import dense_head

    card, cpu, qs = flagship_pair
    plan = card.plan_dense_merge(qs)
    for fn in ("serve_dense_merge", "serve_dense_fused"):
        for kw in ({}, {"exact_counts": True}):
            kernels.reset_launch_counts()
            got = dense_head.decode_packed2(getattr(card, fn)(plan, 50, **kw), 50)
            if fn == "serve_dense_fused":
                assert kernels.LAUNCHES["head_scores"] == 1
            assert kernels.LAUNCHES["near_stages"] > 0
            want = dense_head.decode_packed2(getattr(cpu, fn)(plan, 50, **kw), 50)
            for i in (1, 2, 3):
                np.testing.assert_array_equal(got[i], want[i])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def test_native_builder_segments_on_card(cuda_device, monkeypatch):
    """The builder's native accumulator loads on the card's machine and
    packs, onto the card, the segment its Python path packs."""
    from nrtsearch_tpu_torch import native_ext
    from nrtsearch_tpu_torch.core.segment import SegmentBuilder
    from nrtsearch_tpu_torch.schema import create_field_def

    fds = {"body": create_field_def("body", {"type": "TEXT", "search": True})}
    rng = np.random.default_rng(3)
    words = ["alpha", "beta", "gamma", "délta", "can't", "x86"]
    docs = [{"body": " ".join(rng.choice(words, 8))} for _ in range(2000)]
    segs = []
    for flag in ("1", "0"):
        monkeypatch.setattr(native_ext, "_module", None)
        monkeypatch.setattr(native_ext, "_tried", False)
        monkeypatch.setenv("NRT_NATIVE", flag)
        b = SegmentBuilder(fds, cuda_device)
        assert (b._native is not None) == (flag == "1")
        for d in docs:
            b.add_document(d)
        segs.append(b.flush().fields["body"])
    a, p = segs
    assert a.terms == p.terms and a.doc_ids.is_cuda
    for f in ("doc_ids", "freqs", "doc_lens"):
        assert torch.equal(getattr(a, f), getattr(p, f))
    for f in ("offsets", "lengths", "positions", "position_offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(p, f))
