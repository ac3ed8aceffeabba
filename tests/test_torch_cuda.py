"""The port's CUDA kernels against their plain torch twins, on the card.

Marked ``cuda``: each test asks for the ``cuda_device`` fixture, which skips
when torch sees no CUDA card (the CPU tier-1 run). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Kernel outputs must be bit-equal to the twins: the network, the tie rule
and the copy are the same arithmetic-free operations on both, the gather's
one multiply and the finish scan's adds run in the twins' order.
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


@pytest.mark.parametrize("D", [8, 1024, 40_064])
def test_gather_rows_equals_twin(cuda_device, D):
    rng = np.random.default_rng(D)
    rows = torch.from_numpy(rng.random((40, D), dtype=np.float32)).to(torch.bfloat16)
    idx = torch.tensor([3, 0, 39, 3, 0, 0], dtype=torch.int32)
    out = dense_fused.gather_rows(rows.to(cuda_device), idx.to(cuda_device))
    assert torch.equal(out.cpu().view(torch.int16), rows[idx.long()].view(torch.int16))


def test_kernel_wrappers_refuse_bad_inputs(cuda_device):
    rows = torch.zeros((4, 12), dtype=torch.bfloat16, device=cuda_device)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.gather_rows(rows, idx)                       # D % 8 != 0
    with pytest.raises(TypeError):
        kernels.gather_rows(rows[:, :8].float().contiguous(), idx)
    docs = torch.zeros((2, 1024), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.far_stage(docs, docs, 512)                   # contribs not f32
    with pytest.raises(ValueError):
        kernels.far_stage(docs[:, ::2], torch.zeros((2, 512), device=cuda_device), 128)
    with pytest.raises(ValueError):
        bm.near_stages(docs, docs.float(), 1024)             # 2*d0 > tile


def test_dense_fused_cuda_matches_cpu(cuda_device):
    """The fused search on the card (kernels + bf16 products with f32 out)
    against the same inputs on the CPU (twins + f32 products): docs and
    hits equal, scores within 1e-6 relative (the products sum in another
    order)."""
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
    gpu = decode_packed2(dense_fused.dense_fused_topk(
        *[a.to(cuda_device) for a in args], None, None, None, rows_lo.to(cuda_device), **kw), 10)
    np.testing.assert_array_equal(gpu[1], cpu[1])
    np.testing.assert_array_equal(gpu[2], cpu[2])
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
def test_merge_score_topk_cuda_equals_cpu_accel_branch(cuda_device, run_len, require_all):
    """The accelerator branch on the card (its default for CUDA postings)
    against the same branch on the CPU (twins): widths 8 x 4096 (plain
    network) and 8 x 65536 (alternating), bit-equal."""
    rng = np.random.default_rng(run_len + require_all)
    P = 3 * run_len
    docs, imps = _postings(rng, P, P // 2)
    tabs = _tables(rng, 4, 8, run_len, P)
    n_terms = torch.tensor([2, 3, 1, 1], dtype=torch.int32)
    kw = dict(run_len=run_len, k=100, require_all_terms=require_all)
    before = dict(ms.MERGE_BRANCH)
    kernels.reset_launch_counts()
    g = ms.merge_score_topk(docs.to(cuda_device), imps.to(cuda_device),
                            *[t.to(cuda_device) for t in tabs], n_terms.to(cuda_device), **kw)
    torch.cuda.synchronize()
    alt = 8 * run_len >= ms.ALT_MIN_WIDTH
    assert ms.MERGE_BRANCH["alt" if alt else "plain"] == before["alt" if alt else "plain"] + 1
    assert kernels.LAUNCHES["gather_runs"] == 1
    assert kernels.LAUNCHES["finish_mask"] == (1 if alt else 0)
    c = ms.merge_score_topk(docs, imps, *tabs, n_terms, use_pallas=True, **kw)
    assert torch.equal(g[0].cpu().view(torch.int32), c[0].view(torch.int32))
    assert torch.equal(g[2].cpu(), c[2])
    fin = torch.isfinite(c[0])
    assert torch.equal(g[1].cpu()[fin], c[1][fin])


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


def test_bucket_search_topk_cuda_equals_cpu(cuda_device):
    tabs, tile = _bucket_inputs(7, 3, 16, 4, 12, 0.3)
    n_terms = torch.tensor([2, 5, 1], dtype=torch.int32)
    for require_all in (False, True):
        kw = dict(tile=tile, bucket_bits=12, k=100, require_all=require_all)
        kernels.reset_launch_counts()
        g = br.bucket_search_topk(*[t.to(cuda_device) for t in tabs],
                                  n_terms.to(cuda_device), **kw)
        assert kernels.LAUNCHES["bucket_rank"] == 1
        c = br.bucket_search_topk(*tabs, n_terms, **kw)
        for a, b in zip(g, c):
            assert torch.equal(a.cpu(), b)
        assert int(c[2][0]) > 100 and int(c[2][2]) == 0


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
