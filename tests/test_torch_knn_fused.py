"""The kNN path's kernel (``kernels.knn_topk``, csrc/knn_topk.cu): one pass
per segment computes the f32 products, the score, the mask and each query's
top k of an f32 column on the card.

On the CPU: the route rule (``ops/knn.py`` ``fused_route``: f32 rows on
CUDA take the kernel, bf16, int8 and CPU tensors the plain version, counted
in ``KNN_SEGMENTS``), and ``fused_segment_top_k`` (the candidates' merge
and the passes past ``kernels.KNN_MAX_K``) over a model of the kernel's
launch (``_kernel_model``: its tiles, buffers, cuts and ceiling) against
``masked_top_k``.

Marked ``cuda`` (``cuda_device`` skips without a card), the kernel against
the plain version on the same tensors: bit for bit on small-integer
vectors, whose dots are exact in any order of summation, and at one
segment of the vec cell's shape within ``test_torch_knn_batch.py``'s
``_tolerance`` of an f64 reference. On a machine with an H100:

    python -m pytest tests/test_torch_knn_fused.py -m cuda -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.ops import knn
from nrtsearch_tpu_torch.ops.topk import f32_order_keys, lowest_index_keys, masked_top_k


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _segments() -> dict:
    return dict(knn.KNN_SEGMENTS)


def _moved(before: dict) -> dict:
    return {r: knn.KNN_SEGMENTS[r] - before[r] for r in before}


def _column(rng, fmt: str, rows: int = 300, dims: int = 24):
    v = rng.normal(size=(rows, dims)).astype(np.float32)
    if fmt == "int8":
        q8, scale = knn.quantize_int8(v)
        values = torch.from_numpy(q8)
        return values, knn.quantized_sq_norms(values, scale), scale
    values = torch.from_numpy(v)
    if fmt == "float16":
        values = values.to(torch.bfloat16)
        return values, knn.rounded_sq_norms(values), None
    return values, (values * values).sum(1), None


# ---------------------------------------------------------------------------
# CPU: the route rule, and the merge and passes over a model of the kernel
# ---------------------------------------------------------------------------

_NO_KEY = -(1 << 63)


def _select_tile(buf: list, thr: int, keys: list, k: int) -> int:
    """One query's pass over one tile (csrc/knn_topk.cu ``select_tile``):
    every key above ``thr`` joins ``buf`` in row order; when they do not
    fit, ``buf`` is first cut to its top k and ``thr`` raised to the k-th,
    and when they still do not fit, the first ones fill it and the cut
    repeats. Returns the threshold."""
    pending = keys
    while True:
        kept = [x for x in pending if x > thr]
        room = kernels.KNN_CAP - len(buf)
        if len(kept) > room and len(buf) > k:
            buf.sort(reverse=True)
            del buf[k:]
            thr = max(thr, buf[-1])
            continue
        buf.extend(kept[:room])
        if len(kept) <= room:
            return thr
        pending = kept[room:]


def _kernel_model(scores: torch.Tensor, blocks: int, launches: list):
    """A stand-in for ``kernels.knn_topk`` that takes f32 [B, rows] scores
    for the products: ``blocks`` blocks walk tiles of
    ``kernels.KNN_TILE_ROWS`` rows round robin, each query's keys below its
    ceiling through a buffer of ``kernels.KNN_CAP`` a tile at a time, and
    return (each block's sorted top k, INT64_MIN past its keys, [B, G, k];
    each block's eligible rows [G]). The thresholds the kernel's blocks
    publish to each other change which keys reach the buffers, not the
    lists' top k, and are left out. Appends each launch's k to
    ``launches``."""
    def launch(values, v_sq, mask, q, q_sq, similarity, k, ceiling=None):
        assert 1 <= k <= kernels.KNN_MAX_K
        B, rows = scores.shape
        neg = torch.full((), float("-inf"), dtype=torch.float32)
        order = f32_order_keys(torch.where(mask[None, :rows], scores, neg))
        keys = lowest_index_keys(order, torch.arange(rows, dtype=torch.int64)).tolist()
        tile = kernels.KNN_TILE_ROWS
        n_tiles = -(-rows // tile)
        G = max(1, min(blocks, n_tiles))
        cands = torch.full((B, G, k), _NO_KEY, dtype=torch.int64)
        for b, row in enumerate(keys):
            top = (1 << 63) if ceiling is None else int(ceiling[b])
            for x in range(G):
                buf, thr = [], _NO_KEY
                for t in range(x, n_tiles, G):
                    thr = _select_tile(buf, thr, [y for y in row[t * tile:(t + 1) * tile]
                                                  if y < top], k)
                got = sorted(buf, reverse=True)[:k]
                cands[b, x, :len(got)] = torch.tensor(got, dtype=torch.int64)
        part = torch.tensor([sum(int(mask[t * tile:min((t + 1) * tile, rows)].sum())
                                 for t in range(x, n_tiles, G)) for x in range(G)],
                            dtype=torch.int32)
        launches.append(k)
        return cands, part
    return launch


@pytest.mark.parametrize("fmt", ["float32", "float16", "int8"])
def test_cpu_tensors_take_the_plain_version(fmt):
    rng = np.random.default_rng(3)
    values, sq, scale = _column(rng, fmt)
    mask = torch.from_numpy(rng.random(320) < 0.8)
    q = torch.from_numpy(rng.normal(size=(4, 24)).astype(np.float32))
    before = _segments()
    got = knn.segment_top_k(values, sq, mask, q, similarity="dot_product", k=20, scale=scale)
    assert _moved(before) == {"fused": 0, "plain": 1}
    want = knn.segment_top_k_plain(values, sq, mask, q, similarity="dot_product", k=20,
                                   scale=scale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sim", knn.SIMILARITIES)
def test_f32_on_cuda_takes_the_kernel(monkeypatch, sim):
    """With the device check answering CUDA, an f32 column goes to
    ``kernels.knn_topk`` with its first ``rows`` mask entries and, for
    l2_norm and cosine, the queries' squared sums as ``_scores`` takes
    them; counted once as fused."""
    rng = np.random.default_rng(5)
    values, sq, _ = _column(rng, "float32")
    mask = torch.from_numpy(rng.random(512) < 0.8)        # a [capacity] mask
    q = torch.from_numpy(rng.normal(size=(3, 24)).astype(np.float32))
    seen = {}

    def fake(v, v_sq, m, qq, q_sq, similarity, k, ceiling=None):
        seen.update(v=v, v_sq=v_sq, m=m, q=qq, q_sq=q_sq, similarity=similarity, k=k)
        return _kernel_model(knn._scores(qq, v, v_sq, similarity), 2, [])(
            v, v_sq, m, qq, q_sq, similarity, k, ceiling)

    monkeypatch.setattr(knn, "on_cuda", lambda t: True)
    monkeypatch.setattr(kernels, "knn_topk", fake)
    before = _segments()
    got = knn.segment_top_k(values, sq, mask, q, similarity=sim, k=30)
    assert _moved(before) == {"fused": 1, "plain": 0}
    assert seen["k"] == 30 and seen["similarity"] == sim
    assert torch.equal(seen["m"], mask[:300]) and seen["v"] is values
    if sim in ("l2_norm", "cosine", "normalized_cosine"):
        assert torch.equal(seen["q_sq"], torch.sum(q * q, dim=1))
    else:
        assert seen["q_sq"] is None
    want = knn.segment_top_k_plain(values, sq, mask, q, similarity=sim, k=30)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_route_rule(monkeypatch):
    """On CUDA: f32 takes the kernel, whatever k (``segment_top_k`` has no
    k past which it leaves the kernel); bf16 and int8 (a scale) the plain
    version. On the CPU the plain version always."""
    f32 = torch.zeros((8, 4))
    bf16 = f32.to(torch.bfloat16)
    i8 = f32.to(torch.int8)
    assert not knn.fused_route(f32)
    monkeypatch.setattr(knn, "on_cuda", lambda t: True)
    assert knn.fused_route(f32)
    assert not knn.fused_route(bf16)
    assert not knn.fused_route(i8, scale=0.5)
    values = torch.from_numpy(np.random.default_rng(2).normal(size=(600, 4)).astype(np.float32))
    mask = torch.ones(600, dtype=torch.bool)
    q = torch.ones((2, 4))
    launches = []
    monkeypatch.setattr(kernels, "knn_topk", _kernel_model(
        knn._scores(q, values, (values * values).sum(1), "dot_product"), 2, launches))
    before = _segments()
    knn.segment_top_k(values, (values * values).sum(1), mask, q, similarity="dot_product",
                      k=kernels.KNN_MAX_K + 1)
    assert _moved(before) == {"fused": 1, "plain": 0}
    assert launches == [kernels.KNN_MAX_K, 1]


def _twin_case(case: str, rng):
    """(scores [B, rows], mask [>= rows], k, blocks) of a twin case."""
    B = 3
    if case == "ties":                     # four values: ties across tiles and blocks
        s = rng.integers(0, 4, size=(B, 3000)).astype(np.float32)
        return s, rng.random(3000) < 0.7, 100, 5
    if case == "under_k":                  # 40 eligible rows for k = 100
        m = np.zeros(3000, bool)
        m[rng.choice(3000, 40, replace=False)] = True
        return rng.normal(size=(B, 3000)).astype(np.float32), m, 100, 3
    if case == "all_masked":               # fillers: -inf at the lowest rows
        return rng.normal(size=(B, 1000)).astype(np.float32), np.zeros(1000, bool), 50, 4
    if case == "k_is_rows":
        return rng.normal(size=(B, 100)).astype(np.float32), rng.random(100) < 0.5, 100, 1
    if case == "largest_k":                # k = KNN_MAX_K: a cut every few steps
        s = rng.normal(size=(B, 2000)).astype(np.float32)
        return s, rng.random(2000) < 0.9, kernels.KNN_MAX_K, 2
    if case == "k_one_many_blocks":        # more blocks than merge warps
        s = rng.integers(0, 3, size=(B, 9000)).astype(np.float32)
        return s, rng.random(9000) < 0.9, 1, 40
    if case == "signed_zeros_and_inf":     # -0.0 below +0.0, -inf and +inf scores
        s = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, 1.0], np.float32), size=(B, 1500))
        return s, np.pad(rng.random(1500) < 0.8, (0, 548)), 120, 3
    if case == "one_past_a_pass":          # k = KNN_MAX_K + 1: a second pass of one
        s = rng.integers(0, 5, size=(B, 3000)).astype(np.float32)
        return s, rng.random(3000) < 0.9, kernels.KNN_MAX_K + 1, 3
    if case == "many_passes_under_k":      # k = 1000 in 5 passes, 600 eligible rows
        m = np.zeros(2500, bool)
        m[rng.choice(2500, 600, replace=False)] = True
        s = rng.integers(0, 7, size=(B, 2500)).astype(np.float32)
        return s, m, 1000, 4
    raise ValueError(case)


@pytest.mark.parametrize("case", ["ties", "under_k", "all_masked", "k_is_rows", "largest_k",
                                  "k_one_many_blocks", "signed_zeros_and_inf",
                                  "one_past_a_pass", "many_passes_under_k"])
def test_twin_equals_masked_top_k(monkeypatch, case):
    """``fused_segment_top_k`` over the kernel's model (its buffers, cuts,
    per-block lists and ceilings), with its merge of the blocks' lists and
    its passes, gives ``masked_top_k``'s answer bit for bit: scores (as
    bits), ids, and the eligible-row count."""
    s, m, k, blocks = _twin_case(case, np.random.default_rng(len(case)))
    scores, mask = torch.from_numpy(s), torch.from_numpy(m)
    B, rows = s.shape
    launches = []
    monkeypatch.setattr(kernels, "knn_topk", _kernel_model(scores, blocks, launches))
    got = knn.fused_segment_top_k(torch.zeros((rows, 1)), torch.zeros(rows), mask,
                                  torch.zeros((B, 1)), similarity="dot_product", k=k)
    assert len(launches) == -(-k // kernels.KNN_MAX_K), case
    want = masked_top_k(scores, mask[None, :rows], k)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), case
    assert torch.equal(got[1], want[1]), case
    assert (got[2] == want[2]).all() and got[2].shape == (s.shape[0],), case


# ---------------------------------------------------------------------------
# the card: kernel against the plain version
# ---------------------------------------------------------------------------


def _exact_inputs(dev, rows: int, dims: int, B: int, seed: int, eligible: float = 0.8,
                  cap: int = 0):
    """Small-integer rows and queries (every dot exact in f32 in any order),
    rows repeating row 3 at tile and block edges, a mask over ``rows + cap``
    entries."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2, 3, size=(rows, dims)).astype(np.float32)
    for r in (255, 256, 511, 512, rows - 1, rows // 2):
        if r < rows:
            v[r] = v[3]
    q = rng.integers(-2, 3, size=(B, dims)).astype(np.float32)
    q[0] = v[3]
    m = rng.random(rows + cap) < eligible
    values = torch.from_numpy(v).to(dev)
    return (values, (values * values).sum(1), torch.from_numpy(m).to(dev),
            torch.from_numpy(q).to(dev))


def _same(got, want, ctx) -> None:
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), ctx
    assert torch.equal(got[1], want[1]), ctx
    assert (got[2].cpu() == want[2].cpu()[0]).all() and got[2].shape[0] == want[0].shape[0], ctx


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 100])
@pytest.mark.parametrize("B", [1, 5, 32, 33])
@pytest.mark.parametrize("sim", knn.SIMILARITIES)
def test_kernel_bit_equal_on_exact_data(cuda_device, sim, B, k):
    """70,001 rows (274 tiles, none a multiple of 256 at the end) of 64
    dims in [-2, 2]: ties everywhere, repeated rows across tile and block
    edges; a mask with a fifth of the rows out. Bit for bit the plain
    version, through ``segment_top_k``'s kernel route."""
    values, sq, mask, q = _exact_inputs(cuda_device, 70_001, 64, B, seed=B * 7 + k)
    before = _segments()
    got = knn.segment_top_k(values, sq, mask, q, similarity=sim, k=k)
    assert _moved(before) == {"fused": 1, "plain": 0}
    _same(got, knn.segment_top_k_plain(values, sq, mask, q, similarity=sim, k=k),
          (sim, B, k))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["under_k", "all_masked", "k_is_rows", "few_rows",
                                  "tail_dims", "unaligned_strided", "capacity_mask",
                                  "largest_k", "many_query_tiles", "one_past_a_pass",
                                  "many_passes", "many_passes_under_k"])
def test_kernel_bit_equal_edges(cuda_device, case):
    """Fewer eligible rows than k (fillers: -inf at the lowest masked
    rows), none, k equal to the rows, fewer rows than a tile, dims not a
    multiple of 4 (4-byte copies), a column view 4 bytes off alignment with
    a row stride past its dims, a [capacity] mask, k = KNN_MAX_K, 70
    queries (three query tiles), and k past one launch's KNN_MAX_K: 225
    (a second pass of one), 1000 (five passes), and 1000 over about 250
    eligible rows."""
    rows, dims, B, k, eligible, cap = 5000, 64, 8, 100, 0.8, 0
    if case == "under_k":
        eligible = 0.005
    elif case == "all_masked":
        eligible = 0.0
    elif case == "k_is_rows":
        rows, k = 100, 100
    elif case == "few_rows":
        rows, k = 150, 40
    elif case == "tail_dims":
        dims = 30
    elif case == "capacity_mask":
        cap = 3192
    elif case == "largest_k":
        k = kernels.KNN_MAX_K
    elif case == "many_query_tiles":
        B = 70
    elif case == "one_past_a_pass":
        k = kernels.KNN_MAX_K + 1
    elif case == "many_passes":
        k = 1000
    elif case == "many_passes_under_k":
        k, eligible = 1000, 0.05
    values, sq, mask, q = _exact_inputs(cuda_device, rows, dims, B, seed=len(case),
                                        eligible=eligible, cap=cap)
    if case == "unaligned_strided":
        wide = torch.zeros((rows, dims + 4), device=cuda_device)
        wide[:, 1:dims + 1] = values
        values = wide[:, 1:dims + 1]
        assert values.data_ptr() % 16 and values.stride(0) == dims + 4
    for sim in ("l2_norm", "dot_product", "cosine", "max_inner_product"):
        kernels.reset_launch_counts()
        got = knn.segment_top_k(values, sq, mask, q, similarity=sim, k=k)
        assert kernels.LAUNCHES["knn_topk"] == -(-k // kernels.KNN_MAX_K), (case, sim)
        _same(got, knn.segment_top_k_plain(values, sq, mask, q, similarity=sim, k=k),
              (case, sim))


@pytest.mark.cuda
def test_kernel_refuses_what_the_plain_version_refuses(cuda_device):
    values, sq, mask, q = _exact_inputs(cuda_device, 150, 16, 2, seed=1)
    with pytest.raises(ValueError):
        knn.segment_top_k_plain(values, sq, mask, q, similarity="dot_product", k=200)
    with pytest.raises(ValueError):
        knn.fused_segment_top_k(values, sq, mask, q, similarity="dot_product", k=200)
    with pytest.raises(ValueError):
        knn.fused_segment_top_k(values, sq, mask, q, similarity="hamming", k=10)


@pytest.mark.cuda
def test_kernel_at_the_cell_segment_shape(cuda_device):
    """One segment of the vec cell: 1,105,228 normalised rows of 768 dims,
    B = 32, k = 100, dot_product. Within ``_tolerance`` of an f64
    reference (scores at each rank and for each doc; other docs only at
    near-ties), identical rows score identically and answer in doc order,
    and a second run is bit-identical."""
    from test_torch_knn_batch import _tolerance

    rows, dims, B, k = 1_105_228, 768, 32, 100
    g = torch.Generator(device=cuda_device).manual_seed(11)
    values = torch.randn(rows, dims, generator=g, device=cuda_device)
    values /= torch.linalg.vector_norm(values, dim=1, keepdim=True)
    dups = [7, 255, 256, 300_001, 1_000_003, rows - 1]
    values[dups] = values[7].clone()
    q = values[torch.randint(0, rows, (B,), generator=g, device=cuda_device)]
    q[0] = values[7]
    q = q + 0.02 * torch.randn(B, dims, generator=g, device=cuda_device)
    sq = (values * values).sum(1)
    mask = torch.ones(rows, dtype=torch.bool, device=cuda_device)
    mask[::1013] = False
    mask[dups] = True
    kernels.reset_launch_counts()
    s, ids, hits = knn.segment_top_k(values, sq, mask, q, similarity="dot_product", k=k)
    s2, ids2, hits2 = knn.segment_top_k(values, sq, mask, q, similarity="dot_product", k=k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["knn_topk"] == 2
    assert torch.equal(s.view(torch.int32), s2.view(torch.int32)) and torch.equal(ids, ids2)
    assert (hits == int(mask.sum())).all() and torch.equal(hits, hits2)

    # the f64 reference: (1 + q.v) / 2, masked, top k + 16 by score, then
    # (score desc, doc asc)
    q64 = q.double()
    ref = torch.empty((B, rows), dtype=torch.float64, device=cuda_device)
    for lo in range(0, rows, 1 << 17):
        ref[:, lo:lo + (1 << 17)] = (1 + q64 @ values[lo:lo + (1 << 17)].double().T) / 2
    ref[:, ~mask] = float("-inf")
    cand = torch.topk(ref, k + 16, dim=1).indices.cpu().numpy()
    ref_np = {b: ref[b, torch.as_tensor(cand[b], device=cuda_device)].cpu().numpy()
              for b in range(B)}
    s, ids = s.cpu().numpy().astype(np.float64), ids.cpu().numpy()
    q_np = q64.cpu().numpy()
    for b in range(B):
        order = np.lexsort((cand[b], -ref_np[b]))[:k]
        r_d, r_s = cand[b][order], ref_np[b][order]
        docs = np.union1d(r_d, ids[b])
        full = (1 + q_np[b:b + 1] @ values[torch.as_tensor(docs, device=cuda_device)]
                .double().cpu().numpy().T) / 2
        tol = _tolerance(q_np[b:b + 1], values[torch.as_tensor(docs, device=cuda_device)]
                         .double().cpu().numpy(), "dot_product", full)[0]
        at = {d: i for i, d in enumerate(docs.tolist())}
        t_got = np.array([tol[at[d]] for d in ids[b]])
        t_ref = np.array([tol[at[d]] for d in r_d])
        f_got = np.array([full[0, at[d]] for d in ids[b]])
        assert (np.abs(s[b] - f_got) <= t_got).all(), b
        assert (np.abs(s[b] - r_s) <= np.maximum(t_got, t_ref)).all(), b
        for r in np.flatnonzero(ids[b] != r_d):
            assert abs(f_got[r] - r_s[r]) <= 2 * t_ref[r], (b, r)
    # query 0 sits by row 7, which five other rows repeat
    pos = [int(np.flatnonzero(ids[0] == d)[0]) for d in dups]
    assert pos == list(range(pos[0], pos[0] + len(dups)))
    assert len({s[0, p] for p in pos}) == 1
