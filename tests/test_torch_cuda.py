"""The port's CUDA kernels against their plain torch twins, on the card.

Marked ``cuda``: each test asks for the ``cuda_device`` fixture, which skips
when torch sees no CUDA card (the CPU tier-1 run). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Kernel outputs must be bit-equal to the twins: the network, the tie rule
and the copy are the same arithmetic-free operations on both.
"""

import numpy as np
import pytest
import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.ops import bitonic_merge as bm
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


@pytest.mark.parametrize("m", [64, 1 << 14])
def test_alternating_mode_equals_twin(cuda_device, m):
    rng = np.random.default_rng(m)
    N = 1 << 15
    docs = torch.from_numpy(rng.integers(0, 500, size=(3, N)).astype(np.int32))
    contribs = torch.from_numpy(rng.random((3, N), dtype=np.float32))
    gd, gc = docs.to(cuda_device), contribs.to(cuda_device)
    d = m // 2
    while d >= bm.near_tile(N):
        bm.far_stage(gd, gc, d, m)
        bm.far_stage_twin(docs, contribs, d, m)
        d //= 2
    bm.near_stages(gd, gc, d, m)
    bm.near_stages_twin(docs, contribs, d, m)
    assert torch.equal(gd.cpu(), docs)
    assert torch.equal(gc.cpu(), contribs)


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
