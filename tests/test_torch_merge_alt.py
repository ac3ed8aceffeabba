"""The merge path's accelerator branch: the port's twins against the
reference's Pallas kernels, on the CPU.

The reference's kernels (nrtsearch_tpu/ops/pallas_merge.py) run here in
Pallas's TPU interpret mode: the ``interpret`` fixture wraps
``pl.pallas_call`` with ``interpret=pltpu.InterpretParams()`` through
pytest's ``monkeypatch``; the JAX package itself is not changed. The port
runs the plain torch twins its CUDA kernels are held to on the card
(tests/test_torch_cuda.py).

Everything is compared bit for bit (scores as int32 bits): the twins use the
reference's network, tie rule and scan order. The alternating branch is
compared only with the alternating branch and the plain one with the plain
one: the two networks put equal docs in another stream order, so their sums
may differ in the last bit. Widths that reach the reference's finish kernel
are at least 2^18: at N = 2^17 that kernel reads 16 rows before its row
(pallas_merge.py:420, ROADMAP §3).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nrtsearch_tpu.ops import merge_scoring as ref_ms
from nrtsearch_tpu.ops import pallas_merge as ref_pm
from nrtsearch_tpu_torch.ops import bitonic_merge as bm
from nrtsearch_tpu_torch.ops import merge_scoring as port_ms

HIGH, LOW = int(ref_ms.DOC_SENTINEL), int(ref_ms.DOC_SENTINEL_LOW)
SLACK = 16384   # postings slack past the last run, as the packed views carry


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call",
        functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()),
    )


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)).copy())


def assert_bits_equal(port: torch.Tensor, ref, what: str) -> None:
    p = port.numpy()
    r = np.asarray(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, what
    np.testing.assert_array_equal(p.view(np.int32), r.view(np.int32), err_msg=what)


def _postings(rng, P: int, max_doc: int):
    """Flat doc-sorted postings (one long ascending list is enough for a
    gather) and impacts in (0, 1), with at least SLACK entries of zero
    padding, to a multiple of 128 (the Pallas gather's row view)."""
    total = -(-(P + SLACK) // 128) * 128
    docs = np.zeros(total, np.int32)
    docs[:P] = np.sort(rng.integers(0, max_doc, P))
    imps = np.zeros(total, np.float32)
    imps[:P] = rng.random(P, dtype=np.float32) * 0.9 + 0.05
    return docs, imps


def _run_tables(rng, B: int, R: int, run_len: int, P: int):
    """[B, R] tables: runs shorter than run_len, empty runs, zero-weight
    slots and (row B-1) a row with no runs."""
    offs = rng.integers(0, P - run_len, (B, R)).astype(np.int32)
    lens = rng.integers(1, run_len + 1, (B, R)).astype(np.int32)
    lens[0, 0] = run_len
    lens[:, -1] = 0
    w = (rng.random((B, R), dtype=np.float32) * 3 + 0.5).astype(np.float32)
    w[0, 1] = 0.0
    w[B - 1] = 0.0
    return offs, lens, w


def _merged_stream(rng, B: int, N: int, R: int):
    """A doc-sorted [B, N] stream with at most R entries per doc, zero
    contribs for some entries, HIGH padding at the end and (row B-1) all
    HIGH padding."""
    docs = np.full((B, N), HIGH, np.int32)
    contribs = np.zeros((B, N), np.float32)
    per = (N - N // 16) // R
    for b in range(B - 1):
        # R runs of distinct docs: every doc has at most R entries
        d = np.sort(np.concatenate(
            [rng.choice(2 * per, per, replace=False) for _ in range(R)]))
        docs[b, : R * per] = d
        c = rng.random(R * per, dtype=np.float32)
        c[rng.random(R * per) < 0.05] = 0.0
        contribs[b, : R * per] = c
    return docs, contribs


@pytest.mark.parametrize("run_len", [2048, 16384])
@pytest.mark.parametrize("alternating", [False, True])
def test_gather_runs_twin_matches_pallas(interpret, run_len, alternating):
    """The twin of the accelerator gather == ``gather_runs_pallas``: HIGH
    sentinel past each run's length and in zero-weight slots, no LOW
    padding, odd runs reversed whole when alternating (run_len 16384 spans
    two of the kernel's 8192-entry chunks)."""
    rng = np.random.default_rng(run_len + alternating)
    P = 3 * run_len + 4096
    docs, imps = _postings(rng, P, 10 * P)
    offs, lens, w = _run_tables(rng, 2, 4, run_len, P)
    rd, rc = ref_pm.gather_runs_pallas(
        jnp.asarray(docs), jnp.asarray(imps), jnp.asarray(offs),
        jnp.asarray(lens), jnp.asarray(w), run_len, alternating=alternating)
    pd, pc = port_ms.gather_runs_twin(
        to_torch(docs), to_torch(imps), to_torch(offs), to_torch(lens),
        to_torch(w), run_len, alternating)
    assert_bits_equal(pd, rd, "docs")
    assert_bits_equal(pc, rc, "contribs")
    assert (pd.numpy() != LOW).all()
    if alternating:   # odd runs descending, HIGH padding first
        assert (np.diff(pd.numpy()[0, 1].astype(np.int64)) <= 0).all()


def test_plain_gather_twin_equals_gather_runs_where_no_run_clamps():
    """Where every run fits (off + run_len <= P) the unclamped gather equals
    the clamping ``gather_runs`` of the CPU branch bit for bit; a run that
    clamps gets LOW front padding there and none here. This is why a CUDA
    merge (accelerator branch) and a CPU merge (plain branch) are compared
    only where no run clamps."""
    rng = np.random.default_rng(5)
    run_len, P = 4096, 40_000
    docs, imps = _postings(rng, P, 10**6)
    docs, imps = to_torch(docs[:P]), to_torch(imps[:P])
    offs, lens, w = (to_torch(a) for a in _run_tables(rng, 3, 8, run_len, P))
    a = port_ms.gather_runs(docs, imps, offs, lens, w, run_len)
    b = port_ms.gather_runs_twin(docs, imps, offs, lens, w, run_len)
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
    offs[0, 0] = P - run_len // 2          # this run clamps
    lens[0, 0] = run_len // 4
    a = port_ms.gather_runs(docs, imps, offs, lens, w, run_len)
    b = port_ms.gather_runs_twin(docs, imps, offs, lens, w, run_len)
    assert (a[0][0, 0] == LOW).sum() == run_len // 2
    assert (b[0][0, 0] != LOW).all()
    assert torch.equal(a[0][0, 0, run_len // 2 : 3 * run_len // 4], b[0][0, 0, : run_len // 4])


@pytest.mark.parametrize("N,d,m", [(1 << 18, 1 << 17, 0), (1 << 19, 1 << 17, 1 << 18)])
def test_far_pair_stage_twin_matches_pallas(interpret, N, d, m):
    """Stages d and d/2 in one pass, ascending (m = 0) and alternating
    (m < N: the second 2d block compares descending)."""
    rng = np.random.default_rng(N + m)
    docs = rng.integers(0, 400, (2, N)).astype(np.int32)
    docs[0, ::7] = HIGH
    docs[1, ::5] = LOW
    contribs = rng.random((2, N), dtype=np.float32)
    rd, rc = ref_pm.far_pair_stage(jnp.asarray(docs), jnp.asarray(contribs), d, m)
    pd, pc = bm.far_pair_stage_twin(to_torch(docs), to_torch(contribs), d, m)
    assert_bits_equal(pd, rd, "docs")
    assert_bits_equal(pc, rc, "contribs")


def test_merge_sorted_runs_alt_matches_pallas(interpret):
    """The alternating-direction network over [1, 4, 2^17] runs (even
    ascending, odd descending, duplicate docs, HIGH padding) == the
    reference's ``merge_sorted_runs_alt``, whose far_pair_stage, far_stage
    and near_stages all run at this width. The port cuts the stages
    differently (its tile is 8192), in the same order."""
    rng = np.random.default_rng(17)
    R, L = 4, 1 << 17
    docs = np.full((1, R, L), HIGH, np.int32)
    contribs = np.zeros((1, R, L), np.float32)
    for r in range(R):
        n = int(rng.integers(L // 2, L + 1))
        docs[0, r, :n] = np.sort(rng.integers(0, 3 * L, n))
        contribs[0, r, :n] = rng.random(n, dtype=np.float32)
    docs[0, 1::2] = docs[0, 1::2, ::-1]
    contribs[0, 1::2] = contribs[0, 1::2, ::-1]
    rd, rc = ref_pm.merge_sorted_runs_alt(jnp.asarray(docs), jnp.asarray(contribs))
    pd, pc = bm.merge_sorted_runs_alt(to_torch(docs), to_torch(contribs))
    assert_bits_equal(pd, rd, "docs")
    assert_bits_equal(pc, rc, "contribs")
    assert (np.diff(pd.numpy().astype(np.int64), axis=1) >= 0).all()
    td, tc = bm.merge_sorted_runs_alt_twin(to_torch(docs), to_torch(contribs))
    assert torch.equal(td, pd) and torch.equal(tc, pc)


@pytest.mark.parametrize("R", [4, 16])
@pytest.mark.parametrize("require_all", [False, True])
def test_finish_mask_twin_matches_pallas(interpret, R, require_all):
    """The one-pass finish at N = 2^18: masked per-doc sums bit-equal to
    ``finish_mask_pallas`` (the twin is ``segmented_scores`` plus the
    mask), with docs of up to R entries, zero contribs and an all-pad
    row."""
    rng = np.random.default_rng(R * 2 + require_all)
    N = 1 << 18
    docs, contribs = _merged_stream(rng, 2, N, R)
    n_terms = np.array([2, 1], np.int32)
    ref = ref_pm.finish_mask_pallas(jnp.asarray(docs), jnp.asarray(contribs),
                                    jnp.asarray(n_terms), R, require_all)
    out = port_ms.finish_mask(to_torch(docs), to_torch(contribs), to_torch(n_terms),
                              R, require_all)
    assert_bits_equal(out, ref, "masked")
    assert np.isfinite(out.numpy()[0]).sum() > 1000
    assert not np.isfinite(out.numpy()[1]).any()


@pytest.mark.parametrize("require_all", [False, True])
def test_finish_plan_range(require_all):
    """finish_mask's block plan on the card (the plan is host arithmetic):
    max_seg up to 4096 in a register window of at most 512 threads x 16
    entries that holds the halo twice; longer scans up to 16384 (8192 with
    require_all) in the wide kernel's tile of 2048 plus halo; refused only
    beyond, where a block would need more shared memory than Hopper has."""
    from nrtsearch_tpu_torch import kernels

    largest = 1 << (13 if require_all else 14)
    for max_seg in [1 << p for p in range(17)] + [33, 4097]:
        if max_seg > largest:
            with pytest.raises(ValueError, match="shared memory"):
                kernels.finish_plan(max_seg, require_all)
            continue
        tile, halo, smem = kernels.finish_plan(max_seg, require_all)
        window = tile + halo
        assert halo == kernels.scan_halo(max_seg) and 0 < smem <= kernels.MAX_SHARED_BYTES
        if max_seg <= 4096:
            assert window % 512 == 0 and window <= kernels.FINISH_MAX_WINDOW == 8192
            assert tile >= halo
        else:
            assert window > kernels.FINISH_MAX_WINDOW and tile == kernels.FINISH_WIDE_TILE


def test_merge_score_topk_plain_accel_branch_matches_reference(interpret):
    """Below ALT_MIN_WIDTH the accelerator branch is the unclamped gather,
    the plain network and ``_finish``: bit-equal to the reference's
    ``use_pallas=True`` call at the same width, and counted as "plain"."""
    rng = np.random.default_rng(23)
    run_len, P = 4096, 60_000
    docs, imps = _postings(rng, P, 50_000)
    offs, lens, w = _run_tables(rng, 4, 8, run_len, P)
    n_terms = np.ones(4, np.int32)
    args = [docs, imps, offs, lens, w, n_terms]
    ref = ref_ms.merge_score_topk(*map(jnp.asarray, args), run_len=run_len, k=50,
                                  use_pallas=True)
    before = dict(port_ms.MERGE_BRANCH)
    out = port_ms.merge_score_topk(*map(to_torch, args), run_len=run_len, k=50,
                                   use_pallas=True)
    assert port_ms.MERGE_BRANCH["plain"] == before["plain"] + 1
    assert port_ms.MERGE_BRANCH["alt"] == before["alt"]
    _assert_topk_equal(out, ref)


def _assert_topk_equal(out, ref) -> None:
    """Scores and hits bit for bit; docs at the finite-score slots (with
    fewer than k hits the -inf slots point at arbitrary stream positions,
    which the two networks fill differently)."""
    (ps, pdocs, ph), (rs, rdocs, rh) = out, ref
    assert_bits_equal(ps, rs, "scores")
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
    fin = np.isfinite(np.asarray(rs))
    np.testing.assert_array_equal(pdocs.numpy()[fin], np.asarray(rdocs)[fin])


# ---------------------------------------------------------------------------
# the slice: PrunedIndex.search on the accelerator branch
# ---------------------------------------------------------------------------


def _index(rng, n_terms: int = 6, max_doc: int = 300_000):
    """A packed postings array of n_terms terms (one run each, doc-sorted,
    the first four 40k-65k long) and its run tables, as numpy."""
    dfs = [int(rng.integers(40_000, 65_537)) for _ in range(4)]
    dfs += [int(rng.integers(2_000, 9_000)) for _ in range(n_terms - 4)]
    docs, imps, offs = [], [], []
    cur = 0
    for df in dfs:
        docs.append(np.sort(rng.choice(max_doc, df, replace=False)).astype(np.int32))
        imps.append((rng.random(df, dtype=np.float32) * 0.9 + 0.05).astype(np.float32))
        offs.append(cur)
        cur += df
    P = -(-(cur + SLACK) // 128) * 128
    post_docs = np.zeros(P, np.int32)
    post_imps = np.zeros(P, np.float32)
    post_docs[:cur] = np.concatenate(docs)
    post_imps[:cur] = np.concatenate(imps)
    return post_docs, post_imps, np.array(offs, np.int64), np.array(dfs, np.int32), max_doc


@pytest.mark.parametrize("require_all", [False, True])
def test_pruned_index_accel_branch_matches_reference(interpret, require_all):
    """The port's PrunedIndex with ``use_pallas = True`` on the CPU (twins)
    against the reference's with the same setting (Pallas kernels in
    interpret mode), through ``search(..., prune=False)`` on the same
    postings: 4 runs of 65536 = width 2^18, so both take the alternating
    branch. The OR batch has 3 queries, padded to 4 rows with an all-pad
    row; the AND batch has 2."""
    from nrtsearch_tpu.core.maxscore import PrunedIndex as RefIndex
    from nrtsearch_tpu_torch.core.maxscore import PrunedIndex as PortIndex

    rng = np.random.default_rng(29 + require_all)
    post_docs, post_imps, run_offs, run_lens, max_doc = _index(rng)
    ref = RefIndex(jnp.asarray(post_docs), jnp.asarray(post_imps), run_offs, run_lens, max_doc)
    port = PortIndex(to_torch(post_docs), to_torch(post_imps), run_offs, run_lens, max_doc)
    assert port.use_pallas is False      # CPU postings: the plain branch by default
    ref.use_pallas = port.use_pallas = True
    queries = [
        {"entries": [(1.3, [0]), (0.7, [1]), (2.1, [4])], "require_all": require_all,
         "n_terms": 3 if require_all else 1},
        {"entries": [(0.9, [2]), (1.1, [3]), (0.4, [0]), (1.7, [5])],
         "require_all": require_all, "n_terms": 4 if require_all else 1},
        {"entries": [(2.0, [5]), (1.0, [1])], "require_all": require_all, "n_terms": 1},
    ][: 2 if require_all else 3]
    before = dict(port_ms.MERGE_BRANCH)
    ref_out = ref.search(queries, 40, prune=False)
    port_out = port.search(queries, 40, prune=False)
    assert port_ms.MERGE_BRANCH["alt"] == before["alt"] + 1
    for i, (r, p) in enumerate(zip(ref_out, port_out)):
        rs, rdocs, rh, rexact = r
        ps, pdocs, ph, pexact = p
        assert (ph, pexact) == (rh, rexact), i
        assert rh > 0, i
        np.testing.assert_array_equal(ps.view(np.int32), rs.view(np.int32), err_msg=str(i))
        fin = np.isfinite(rs)
        np.testing.assert_array_equal(pdocs[fin], rdocs[fin], err_msg=str(i))
