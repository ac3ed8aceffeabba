"""The bucket path: the port's plain versions and its ``PackedFieldView``
against the reference's Pallas kernels, on the CPU.

The reference's kernels (nrtsearch_tpu/ops/bucket_retrieval.py) run in
Pallas interpret mode (``interpret=True``, as tests/test_bucket_retrieval.py
runs them); inputs come from the port's ``BucketIndex.build`` and
``plan_bucket_batch`` over seeded numpy corpora, which equal the reference's
bit for bit (``test_bucket_build_matches_reference``), as does the port's
``reference_bucket_search``; the reference's ``reference_bucket_search``
stays the numpy oracle. The port's top k over rank keys,
``topk_i32_lowest_index``, equals the reference's ``_hierarchical_topk_i32``
on both of its branches. Everything the port
computes is compared bit for bit: the packed keys, the dense rank keys (the
reference's (rank, doc) pairs scattered into an ``I32_MIN`` array), the top-k
keys, docs and hits, and the served results. Against the f32 merge path the
bucket path agrees only modulo its 15-bit quantization: equal hit counts,
doc sets equal up to near-ties, scores within one quantum per query term.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrtsearch_tpu.ops import bucket_retrieval as ref_br
from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu.schema.fields import create_field_def as ref_create_field_def
from nrtsearch_tpu_torch.convert import segment_from_numpy
from nrtsearch_tpu_torch.core.searcher import Searcher as PortSearcher
from nrtsearch_tpu_torch.ops import bucket_retrieval as br
from nrtsearch_tpu_torch.ops.topk import topk_i32_lowest_index
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def

I32_MIN = int(ref_br.I32_MIN)


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)).copy())


def _corpus(rng, V, D, *, max_df=400, delete_frac=0.0, heavy=0):
    """V doc-sorted postings runs over D docs (the first ``heavy`` docs of
    term 0 when heavy > 0), impacts in [0.1, 1), deleted docs at impact 0,
    8192 + alignment entries of zero slack (the reference gather's DMA
    contract)."""
    runs = []
    for t in range(V):
        df = heavy if t == 0 and heavy else int(rng.integers(1, max_df))
        runs.append(np.sort(rng.choice(D, size=df, replace=False)).astype(np.int32))
    lens = np.array([len(r) for r in runs], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    n = int(lens.sum())
    P = -(-(n + 8192) // 128) * 128
    docs = np.zeros(P, np.int32)
    imps = np.zeros(P, np.float32)
    docs[:n] = np.concatenate(runs)
    imps[:n] = rng.uniform(0.1, 1.0, n).astype(np.float32)
    if delete_frac:
        deleted = rng.random(D) < delete_frac
        imps[:n] = np.where(deleted[docs[:n]], 0.0, imps[:n])
    return docs, imps, offs, lens


def _ref_keys(docs, imps, idx, plan):
    T = plan.term_offs.shape[1]
    keys = ref_br.gather_pack_pallas(
        jnp.asarray(docs), jnp.asarray(imps),
        (jnp.asarray(plan.term_offs), jnp.asarray(plan.bounds), jnp.asarray(plan.weights)),
        T=T, caps=plan.caps, tile=plan.tile, bucket_bits=idx.bucket_bits,
        m=idx.n_buckets, interpret=True)
    return np.asarray(keys).reshape(-1, plan.tile)


def _port_keys(docs, imps, idx, plan):
    return br.gather_pack_plain(to_torch(docs), to_torch(imps), to_torch(plan.term_offs),
                                to_torch(plan.bounds), to_torch(plan.weights),
                                tile=plan.tile, bucket_bits=idx.bucket_bits).numpy()


def _gather_case(name):
    """(docs, imps, BucketIndex, plan) of one gather_pack case."""
    rng = np.random.default_rng(len(name))
    if name == "skewed":
        # term 0 holds ~95% of the docs: its slot carries most of each tile
        docs, imps, offs, lens = _corpus(rng, 12, 4096, max_df=200, heavy=3900)
        queries = [[(0, 1.2), (3, 2.0), (7, 0.7)], [(5, 1.0), (0, 0.4)]]
    else:
        docs, imps, offs, lens = _corpus(
            rng, 40, 3000, delete_frac=0.3 if name == "deletions" else 0.0)
        queries = [[(int(t), float(rng.uniform(0.5, 3.0)))
                    for t in rng.choice(40, size=int(rng.integers(2, 6)), replace=False)]
                   for _ in range(3)]
        if name == "empty_query":
            queries.append([])
    idx = br.BucketIndex.build(docs, imps, offs, lens, capacity=4096, bucket_docs=1024)
    plan = br.plan_bucket_batch(idx, queries, offs, max_terms=6)
    if name == "zero_weight":
        # a zero-weight slot between live ones takes no room in the tile
        plan.weights[0, 1] = 0.0
        plan.weights[1, 0] = 0.0
    return docs, imps, idx, plan


@pytest.mark.parametrize("name", ["deletions", "skewed", "zero_weight", "empty_query"])
def test_gather_pack_plain_matches_pallas(name):
    """``gather_pack_plain`` == ``gather_pack_pallas`` bit for bit: slices
    back to back in slot order, deleted postings and padding ``I32_SENT``,
    one rounding of ``w * imp + 0.5`` (B <= 4, m = 4, tile <= 2048)."""
    docs, imps, idx, plan = _gather_case(name)
    assert plan.tile <= 2048 and idx.n_buckets == 4
    ref = _ref_keys(docs, imps, idx, plan)
    port = _port_keys(docs, imps, idx, plan)
    np.testing.assert_array_equal(port, ref)
    live = port != ref_br.I32_SENT
    assert live.any()
    if name == "skewed":   # the heavy slot fills most of every bucket's tile
        assert (np.diff(plan.bounds[0, 0]) > 900).all()
    if name == "empty_query":
        assert not live[-idx.n_buckets:].any()


def _dense_reference_rank(rank, docs, B, width):
    """The reference's (rank, doc) tile pairs with rank != I32_MIN,
    scattered into a dense [B, width] I32_MIN array."""
    rank = np.asarray(rank).reshape(B, -1)
    docs = np.asarray(docs).reshape(B, -1)
    dense = np.full((B, width), I32_MIN, np.int32)
    for q in range(B):
        hit = rank[q] != I32_MIN
        assert len(np.unique(docs[q][hit])) == hit.sum()
        dense[q, docs[q][hit]] = rank[q][hit]
    return dense


@pytest.mark.parametrize("require_all", [False, True])
def test_sort_finish_plain_matches_pallas(require_all):
    """``sort_finish_plain`` == ``sort_finish_pallas`` bit for bit, once the
    reference's (rank, doc) pairs are laid out by doc id."""
    docs, imps, idx, plan = _gather_case("deletions")
    keys = _ref_keys(docs, imps, idx, plan)
    B, T = plan.term_offs.shape
    n_terms = np.array([2, 1, 3], np.int32)[:B]
    rank, rdocs = ref_br.sort_finish_pallas(
        jnp.asarray(keys.reshape(B * idx.n_buckets, -1, 128)), jnp.asarray(n_terms),
        tile=plan.tile, max_seg=T, require_all=require_all,
        bucket_bits=idx.bucket_bits, n_buckets=idx.n_buckets, interpret=True)
    width = idx.n_buckets << idx.bucket_bits
    ref = _dense_reference_rank(rank, rdocs, B, width)
    port = br.sort_finish_plain(to_torch(keys), to_torch(n_terms), m=idx.n_buckets,
                                bucket_bits=idx.bucket_bits, require_all=require_all).numpy()
    np.testing.assert_array_equal(port, ref)
    assert (port != I32_MIN).sum() > 100


@pytest.mark.parametrize("name", ["deletions", "zero_weight"])
@pytest.mark.parametrize("require_all", [False, True])
def test_bucket_rank_plain_matches_pallas(name, require_all):
    """``bucket_rank_plain`` (the plain version of the one CUDA kernel that
    replaces both reference kernels) == ``gather_pack_pallas`` ->
    ``sort_finish_pallas`` bit for bit, the reference's (rank, doc) pairs
    scattered into the dense [B, m * bucket_docs] layout."""
    docs, imps, idx, plan = _gather_case(name)
    keys = _ref_keys(docs, imps, idx, plan)
    B, T = plan.term_offs.shape
    n_terms = np.array([2, 1, 3], np.int32)[:B]
    rank, rdocs = ref_br.sort_finish_pallas(
        jnp.asarray(keys.reshape(B * idx.n_buckets, -1, 128)), jnp.asarray(n_terms),
        tile=plan.tile, max_seg=T, require_all=require_all,
        bucket_bits=idx.bucket_bits, n_buckets=idx.n_buckets, interpret=True)
    ref = _dense_reference_rank(rank, rdocs, B, idx.n_buckets << idx.bucket_bits)
    port = br.bucket_rank_plain(
        *map(to_torch, (docs, imps, plan.term_offs, plan.bounds, plan.weights, n_terms)),
        tile=plan.tile, bucket_bits=idx.bucket_bits, require_all=require_all).numpy()
    np.testing.assert_array_equal(port, ref)
    assert (port != I32_MIN).sum() > 100
    # the CPU dispatcher is the plain version
    np.testing.assert_array_equal(br.bucket_rank(
        *map(to_torch, (docs, imps, plan.term_offs, plan.bounds, plan.weights, n_terms)),
        tile=plan.tile, bucket_bits=idx.bucket_bits, require_all=require_all).numpy(), port)


def _both_topk(docs, imps, idx, plan, k, require_all):
    args = (docs, imps, plan.term_offs, plan.bounds, plan.weights, plan.n_terms)
    ref = ref_br.bucket_search_topk(
        *map(jnp.asarray, args), T=plan.term_offs.shape[1], caps=plan.caps,
        tile=plan.tile, bucket_bits=idx.bucket_bits, m=idx.n_buckets, k=k,
        require_all=require_all, interpret=True)
    port = br.bucket_search_topk(*map(to_torch, args), tile=plan.tile,
                                 bucket_bits=idx.bucket_bits, k=k, require_all=require_all)
    return [np.asarray(x) for x in ref], [x.numpy() for x in port]


@pytest.mark.parametrize("require_all", [False, True])
def test_bucket_search_topk_matches_reference(require_all):
    """Top-k keys and hits bit-equal to the reference's interpret-mode
    ``bucket_search_topk``, docs equal at every filled slot (an empty slot's
    doc is the position the top-k happened to pick, which the two layouts
    fill differently; ``decode_topk`` maps it to -1); decoded docs and hits
    equal to the numpy model ``reference_bucket_search``."""
    rng = np.random.default_rng(11 + require_all)
    docs, imps, offs, lens = _corpus(rng, 30, 3000, max_df=900, delete_frac=0.1)
    idx = br.BucketIndex.build(docs, imps, offs, lens, capacity=4096, bucket_docs=1024)
    queries = [[(int(t), float(rng.uniform(0.5, 2.5)))
                for t in rng.choice(30, size=3, replace=False)] for _ in range(3)]
    queries.append([(4, 1.0)])
    plan = br.plan_bucket_batch(idx, queries, offs, max_terms=4)
    k = 40
    (rk, rd, rh), (pk, pd, ph) = _both_topk(docs, imps, idx, plan, k, require_all)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(ph, rh)
    filled = rk != I32_MIN
    np.testing.assert_array_equal(pd[filled], rd[filled])
    assert filled.sum() > k
    scores, pdocs = br.decode_topk(pk, pd, plan.scales)
    ms, mdocs, mh = ref_br.reference_bucket_search(docs, imps, idx, plan, k,
                                                   require_all=require_all)
    np.testing.assert_array_equal(pdocs, mdocs)
    np.testing.assert_array_equal(ph, mh)
    np.testing.assert_array_equal(scores, ms)


def _dense_route(docs, imps, idx, plan, k, require_all):
    """The dense route: ``bucket_rank_plain``'s [B, m * bucket_docs] keys,
    their hit counts and ``topk_i32_lowest_index`` over them, padded past
    the m * bucket_docs docs with (I32_MIN, 0)."""
    rank = br.bucket_rank_plain(
        *map(to_torch, (docs, imps, plan.term_offs, plan.bounds, plan.weights, plan.n_terms)),
        tile=plan.tile, bucket_bits=idx.bucket_bits, require_all=require_all)
    hits = (rank != I32_MIN).sum(dim=-1, dtype=torch.int32)
    keys, pos = topk_i32_lowest_index(rank, min(k, rank.shape[1]))
    pad = k - keys.shape[1]
    keys = torch.nn.functional.pad(keys, (0, pad), value=I32_MIN)
    pos = torch.nn.functional.pad(pos, (0, pad), value=0)
    return keys.numpy(), pos.to(torch.int32).numpy(), hits.numpy(), rank.numpy()


def _row_case(name):
    """(docs, imps, BucketIndex, plan, k, require_all) of one case of
    ``test_bucket_search_topk_by_row_candidates``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cap, bd, k, T, require_all = 4096, 256, 100, 4, False
    V, D, max_df, nq, nterms = 30, 4000, 900, 3, 3
    if name == "ties_across_buckets":
        max_df = 2000
    elif name == "rows_under_k":           # 16 rows of 10-60 hits, > k a query
        max_df = 250
    elif name == "total_under_k":
        max_df, k = 12, 100
    elif name == "require_all":
        require_all, bd, max_df = True, 1024, 3999
    elif name == "k_1":
        k = 1
    elif name == "k_at_least_bucket_docs":
        bd, k = 64, 100
    elif name == "k_past_every_doc":       # m * bucket_docs = 128 docs < k
        cap, bd, k, D, max_df = 128, 64, 200, 128, 60
    elif name == "bucket_bits_2":
        cap, bd, k, D, max_df = 256, 4, 10, 256, 80
    elif name == "bucket_bits_15":
        cap, bd, D, max_df = 65536, 32768, 60000, 6000
    elif name == "t_16":
        T, nterms = 16, 16
    docs, imps, offs, lens = _corpus(rng, V, D, max_df=max_df, delete_frac=0.1)
    if name == "ties_across_buckets":    # every posting adds the same quantum
        imps[imps > 0] = 0.5
    idx = br.BucketIndex.build(docs, imps, offs, lens, capacity=cap, bucket_docs=bd)
    weight = (lambda: 1.0) if name == "ties_across_buckets" else (
        lambda: float(rng.uniform(0.5, 2.5)))
    queries = [[(int(t), weight()) for t in rng.choice(V, size=nterms, replace=False)]
               for _ in range(nq)]
    if name == "require_all":  # the densest terms, so that AND rows pass k
        top = [int(t) for t in np.argsort(-lens)[:5]]
        queries = [[(top[0], weight()), (top[1], weight())],
                   [(top[0], weight()), (top[2], weight())],
                   [(top[1], weight()), (top[3], weight()), (top[4], weight())]]
    if name == "no_hits":      # an empty query, and terms whose postings are all deleted
        dead = [int(np.argmin(lens)), int(np.argsort(lens)[1])]
        for t in dead:
            imps[offs[t]: offs[t] + lens[t]] = 0.0
        idx = br.BucketIndex.build(docs, imps, offs, lens, capacity=cap, bucket_docs=bd)
        queries = [[], [(t, 1.0) for t in dead]]
    plan = br.plan_bucket_batch(idx, queries, offs, max_terms=T)
    return docs, imps, idx, plan, k, require_all


ROW_CASES = ["ties_across_buckets", "rows_under_k", "total_under_k", "no_hits",
             "require_all", "k_1", "k_at_least_bucket_docs", "k_past_every_doc",
             "bucket_bits_2", "bucket_bits_15", "t_16"]


@pytest.mark.parametrize("name", ROW_CASES)
def test_bucket_search_topk_by_row_candidates(name):
    """``bucket_search_topk`` on CPU tensors (``bucket_rank_topk_plain``:
    each (query, bucket) row's top min(k, bucket_docs), then one top k over
    the candidates) == the dense route bit for bit, keys, docs and hits,
    the docs of empty slots included; keys and hits == the reference's
    interpret-mode ``bucket_search_topk``, docs at every filled slot (its
    empty slots hold other positions) where its shapes allow."""
    docs, imps, idx, plan, k, require_all = _row_case(name)
    wk, wd, wh, rank = _dense_route(docs, imps, idx, plan, k, require_all)
    bd, B = 1 << idx.bucket_bits, len(plan.n_terms)
    row_hits = (rank != I32_MIN).reshape(B, idx.n_buckets, bd).sum(axis=2)
    if name == "ties_across_buckets":    # the k-th key shared by docs of several buckets
        assert any(len(set(wd[q][wk[q] == wk[q, -1]] >> idx.bucket_bits)) > 1
                   for q in range(B))
    if name == "rows_under_k":
        assert (row_hits.max(axis=1) < k).all() and (wh > k).all()
    if name in ("total_under_k", "k_past_every_doc"):
        assert (wh < k).all() and (wk == I32_MIN).any()
    if name == "no_hits":
        assert (wh == 0).all()
    if name in ("require_all", "k_1", "bucket_bits_15", "t_16"):
        assert (row_hits > min(k, bd)).any()
    args = (docs, imps, plan.term_offs, plan.bounds, plan.weights, plan.n_terms)
    pk, pd, ph = (x.numpy() for x in br.bucket_search_topk(
        *map(to_torch, args), tile=plan.tile, bucket_bits=idx.bucket_bits, k=k,
        require_all=require_all))
    np.testing.assert_array_equal(pk, wk)
    np.testing.assert_array_equal(pd, wd)
    np.testing.assert_array_equal(ph, wh)
    if name == "k_past_every_doc":      # the reference's top k needs k <= its width
        return
    (rk, rd, rh), _ = _both_topk(docs, imps, idx, plan, k, require_all)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(ph, rh)
    filled = rk != I32_MIN
    np.testing.assert_array_equal(pd[filled], rd[filled])


def test_tie_break_lowest_doc_id():
    """Equal quantized scores rank by ascending doc id (the case of
    tests/test_bucket_retrieval.py::test_tie_break_lowest_doc_id), across a
    bucket boundary too."""
    docs = np.zeros(500 + 8192 + 12, np.int32)
    imps = np.zeros_like(docs, dtype=np.float32)
    docs[:500] = np.arange(500)
    imps[:500] = 0.5
    offs, lens = np.array([0], np.int64), np.array([500], np.int32)
    idx = br.BucketIndex.build(docs, imps, offs, lens, capacity=512, bucket_docs=256)
    plan = br.plan_bucket_batch(idx, [[(0, 1.0)]], offs, max_terms=2)
    (rk, rd, rh), (pk, pd, ph) = _both_topk(docs, imps, idx, plan, 300, False)
    np.testing.assert_array_equal(pd[0], np.arange(300))
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pd, rd)
    assert ph[0] == rh[0] == 500


@pytest.mark.parametrize("name", ["deletions", "skewed", "zero_weight", "empty_query"])
def test_bucket_build_matches_reference(name):
    """The port's BucketIndex.build, plan_bucket_batch and
    reference_bucket_search give the reference's arrays bit for bit, on
    ``_gather_case``'s inputs."""
    docs, imps, idx, plan = _gather_case(name)
    rng = np.random.default_rng(len(name))
    offs, lens = _corpus_tables(idx)
    ref_idx = ref_br.BucketIndex.build(docs, imps, offs, lens, capacity=4096,
                                       bucket_docs=1024)
    for f in ("bucket_bits", "n_buckets", "bounds", "max_impact"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(ref_idx, f), err_msg=f)
    queries = [[(int(t), float(rng.uniform(0.5, 3.0)))
                for t in rng.choice(len(idx.bounds), size=int(rng.integers(1, 7)))]
               for _ in range(5)] + [[]]
    got = br.plan_bucket_batch(idx, queries, offs, max_terms=6)
    want = ref_br.plan_bucket_batch(ref_idx, queries, offs, max_terms=6)
    for f in ("term_offs", "bounds", "weights", "n_terms", "scales"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.caps, got.tile, got.shape_key) == (want.caps, want.tile, want.shape_key)
    for require_all in (False, True):
        for a, b in zip(br.reference_bucket_search(docs, imps, idx, got, 20,
                                                   require_all=require_all),
                        ref_br.reference_bucket_search(docs, imps, ref_idx, want, 20,
                                                       require_all=require_all)):
            np.testing.assert_array_equal(a, b)


def _corpus_tables(idx):
    """(offsets, lengths) of ``_gather_case``'s corpus, from its index: a
    term's run length is its last bucket bound."""
    lens = idx.bounds[:, -1].astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return offs, lens


@pytest.mark.parametrize("case", ["hierarchical", "tie_plateau", "narrow"])
def test_topk_i32_matches_reference_hierarchical(case):
    """The port's ``topk_i32_lowest_index`` (what ``bucket_search_topk``
    takes its top k with) == the reference's ``_hierarchical_topk_i32``:
    on its row-max branch where its check holds, on its full top-k where a
    tie plateau at tau fails it, and below 2 * r_take rows."""
    rng = np.random.default_rng(5)
    N = 128 * (64 if case == "narrow" else 1024)
    x = np.full((3, N), I32_MIN, np.int32)
    hit = rng.random((3, N)) < 0.05
    x[hit] = rng.integers(1, 32000, hit.sum())
    if case == "tie_plateau":
        x[1, ::64] = 7
        x[1, x[1] > 7] = I32_MIN
    pk, pi = topk_i32_lowest_index(torch.from_numpy(x), 100)
    rk, ri = ref_br._hierarchical_topk_i32(jnp.asarray(x), 100)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def test_topk_i32_lowest_index_matches_stable_sort():
    x = torch.from_numpy(np.random.default_rng(3).integers(-3, 3, (4, 5000)).astype(np.int32))
    x[1] = I32_MIN
    x[2, 17] = 2**31 - 1
    vals, idx = topk_i32_lowest_index(x, 300)
    ref = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(vals, ref.values[:, :300])
    assert torch.equal(idx, ref.indices[:, :300])


def test_split_rows_matches_reference_and_searchsorted():
    """``PrunedIndex.split_rows`` == the reference's device bisection ==
    ``np.searchsorted`` per run (empty runs, a boundary past every doc)."""
    from nrtsearch_tpu.core.maxscore import PrunedIndex as RefIndex
    from nrtsearch_tpu_torch.core.maxscore import PrunedIndex as PortIndex

    rng = np.random.default_rng(5)
    docs, imps, offs, lens = _corpus(rng, 25, 5000, max_df=3000)
    lens[3] = 0
    max_doc = 5000
    ref = RefIndex(jnp.asarray(docs), jnp.asarray(imps), offs, lens, max_doc)
    port = PortIndex(to_torch(docs), to_torch(imps), offs, lens, max_doc)
    np.testing.assert_array_equal(port.run_ub, ref.run_ub)
    boundaries = np.array([1, 700, 1024, 2500, 4999, 6000], np.int64)
    out = port.split_rows(offs, lens, boundaries)
    np.testing.assert_array_equal(
        out, ref.split_rows([(int(o), int(n), 1.0) for o, n in zip(offs, lens)], boundaries))
    for r, (o, n) in enumerate(zip(offs, lens)):
        want = np.searchsorted(docs[o : o + n], boundaries, side="left")
        np.testing.assert_array_equal(out[r], np.concatenate([[0], want, [n]]))


# ---------------------------------------------------------------------------
# the serving path: PackedFieldView.bucket_search_batch and search_batch
# ---------------------------------------------------------------------------


def _arrays(seg, field="body"):
    """A reference segment's arrays as plain numpy."""
    tfi = seg.fields[field]
    return {
        "terms": dict(tfi.terms), "offsets": np.asarray(tfi.offsets),
        "lengths": np.asarray(tfi.lengths), "doc_ids": np.asarray(tfi.doc_ids),
        "freqs": np.asarray(tfi.freqs), "doc_lens": np.asarray(tfi.doc_lens),
        "sum_doc_lens": tfi.sum_doc_lens, "doc_count": tfi.doc_count,
        "postings_len": tfi.postings_len, "live": np.asarray(seg.live),
        "host_live": np.asarray(seg.host_live), "num_docs": seg.num_docs,
        "capacity": seg.capacity, "stored": seg.stored,
    }


FIELDS = {"id": {"type": "_ID"}, "body": {"type": "TEXT", "search": True}}
VIEW_QUERIES = [
    ("w1 w7 w9", False),
    ("w2", False),
    ("w3 w5", True),        # require_all over 3 segments
    ("nope w1", True),      # dead: a required term is absent
    ("w0 w7 w11", False),
]
# terms of one weight: a repeated term (two slots per run) and two terms of
# equal idf; they share one bound in the scale of both packages
SHARED_WEIGHT = [("w0 w0", False), ("w0 w0 w7", False), ("w1 w4", False)]


@pytest.fixture(scope="module")
def views():
    """The corpus of tests/test_bucket_retrieval.py:257-279 (3 segments of
    100 docs, 30 words) in the reference and, carried over, in the port."""
    from nrtsearch_tpu.core.searcher import Searcher as RefSearcher
    from nrtsearch_tpu.core.writer import IndexWriter as RefWriter

    ref_fds = {n: ref_create_field_def(n, spec) for n, spec in FIELDS.items()}
    rng = random.Random(13)
    words = [f"w{i}" for i in range(30)]
    w = RefWriter(ref_fds, merge_factor=100)
    for _seg in range(3):
        w.add_documents([{"id": str(i), "body": " ".join(rng.choices(words, k=7))}
                         for i in range(100)])
        w.refresh()
    ref = RefSearcher(w.segments, ref_fds, version=1)
    fds = {n: create_field_def(n, spec) for n, spec in FIELDS.items()}
    port = PortSearcher([segment_from_numpy(_arrays(s), "cpu") for s in w.segments], fds)
    return ref, port


def _specs(searcher, queries):
    """Fast-path specs, each parsed by the searcher's own package."""
    parse = parse_query if isinstance(searcher, PortSearcher) else ref_parse_query
    specs = []
    for text, must in queries:
        node = parse({"matchQuery": {"field": "body", "query": text,
                                     **({"operator": "MUST"} if must else {})}})
        specs.append(searcher.fast_query_spec(node))
    assert all(s is not None for s in specs)
    return specs


def _assert_results_equal(port_out, ref_out):
    assert len(port_out) == len(ref_out)
    for i, (p, r) in enumerate(zip(port_out, ref_out)):
        np.testing.assert_array_equal(p.scores.view(np.int32), r.scores.view(np.int32),
                                      err_msg=str(i))
        np.testing.assert_array_equal(p.docs, r.docs, err_msg=str(i))
        assert (p.total_hits, p.pruned) == (r.total_hits, r.pruned), i


@pytest.mark.parametrize("require_all", [False, True])
def test_view_bucket_search_batch_matches_reference(views, require_all):
    """The port's ``bucket_search_batch`` == the reference's (its kernels in
    interpret mode) bit for bit on a 3-segment index: the same planning
    (slot order, per-term scale, tile), the same answers."""
    ref, port = views
    group = [q for q in VIEW_QUERIES if q[1] == require_all]
    specs = _specs(port, group)
    for spec in specs:      # distinct weights (SHARED_WEIGHT holds the others)
        weights = [w for _, w, runs in port.packed_view("body").term_entries(spec.terms)
                   if w and runs]
        assert len(set(weights)) == len(weights)
    r = ref.packed_view("body").bucket_search_batch(_specs(ref, group), 10)
    p = port.packed_view("body").bucket_search_batch(specs, 10)
    assert r is not None and p is not None
    _assert_results_equal(p, r)
    assert any(x.total_hits > 0 for x in p)


def _numpy_model(view, plan, k):
    """``reference_bucket_search`` (the reference's numpy model) over the
    port view's own plan and postings."""
    ref_plan = ref_br.BucketPlan(plan["term_offs"], plan["bounds"], plan["weights"],
                                 plan["n_terms"], plan["scales"], (), plan["tile"], ())
    return ref_br.reference_bucket_search(view.index.doc_ids.numpy(),
                                          view.index.impacts.numpy(), None, ref_plan, k)


def test_view_bucket_scale_bounds_every_query_term(views, monkeypatch):
    """The quantization scale as the reference computes it: QMAX over the
    sum, per distinct weight, of the weight times the largest run bound of
    that weight's slots. A repeated term, or two terms of equal idf, share
    one bound, so a doc's sum can pass QMAX and clip, and the clipped docs
    rank by doc id: the reference's fault, which the port keeps on purpose
    (ROADMAP §3). On these queries the port's plan has that scale, its
    answers equal the reference's bit for bit and the numpy model over its
    plan, its hit counts equal the exact merge path's, and in both packages
    the top score for ``w0 w0`` is cut well below the merge path's."""
    ref, port = views
    view = port.packed_view("body")
    specs = _specs(port, SHARED_WEIGHT)
    plan = view.bucket_plan(specs)
    for qi, spec in enumerate(specs):
        by_w: dict[float, float] = {}
        for _, w, runs in view.term_entries(spec.terms, spec.boost):
            for r in runs:
                by_w[w] = max(by_w.get(w, 0.0), float(view.index.run_ub[r]))
        assert len(by_w) < len(spec.terms)          # a bound is shared
        smax = sum(w * ub for w, ub in by_w.items())
        np.testing.assert_allclose(plan["scales"][qi], ref_br.QMAX / smax, rtol=1e-6)
    bucket = view.bucket_search_batch(specs, 10)
    _assert_results_equal(
        bucket, ref.packed_view("body").bucket_search_batch(_specs(ref, SHARED_WEIGHT), 10))
    ms, mdocs, mh = _numpy_model(view, plan, 10)
    monkeypatch.setenv("NRT_FAST_PATH", "merge")
    merge = view.search_batch(specs, 10)
    for qi, (b, m) in enumerate(zip(bucket, merge)):
        np.testing.assert_array_equal(b.docs, mdocs[qi].astype(np.int64))
        np.testing.assert_array_equal(b.scores, ms[qi])
        assert b.total_hits == mh[qi] == m.total_hits > 10
    (r,) = ref.packed_view("body").bucket_search_batch(_specs(ref, SHARED_WEIGHT[:1]), 10)
    assert r.scores[0] == bucket[0].scores[0] < 0.75 * merge[0].scores[0]


def test_view_bucket_refusals_match_reference(views):
    """Both views refuse a batch that mixes AND and OR and a query with more
    than 16 runs (6 terms x 3 segments)."""
    ref, port = views
    for queries in (VIEW_QUERIES, [("w1 w2 w3 w4 w5 w6", False)]):
        assert ref.packed_view("body").bucket_search_batch(_specs(ref, queries), 10) is None
        assert port.packed_view("body").bucket_search_batch(_specs(port, queries), 10) is None


def test_search_batch_routes_to_bucket_path(views, monkeypatch):
    """Under NRT_FAST_PATH=bucket, ``search_batch`` serves an eligible batch
    on the bucket path and sends a refused one to the merge path."""
    _ref, port = views
    monkeypatch.setenv("NRT_FAST_PATH", "bucket")
    view = port.packed_view("body")
    or_specs = _specs(port, [q for q in VIEW_QUERIES if not q[1]])
    before = dict(view.path_counts)
    out = view.search_batch(or_specs, 10)
    assert view.path_counts["bucket"] == before["bucket"] + len(or_specs)
    _assert_results_equal(out, view.bucket_search_batch(or_specs, 10))
    td = port.search(parse_query({"matchQuery": {"field": "body", "query": "w3 w5",
                                                 "operator": "MUST"}}), 5)
    assert view.path_counts["bucket"] == before["bucket"] + len(or_specs) + 1
    (direct,) = view.bucket_search_batch(_specs(port, [("w3 w5", True)]), 5)
    assert td.total_hits == direct.total_hits > 0
    assert [h.global_ord for h in td.hits] == direct.docs[: len(td.hits)].tolist()
    view.search_batch(_specs(port, VIEW_QUERIES), 10)          # mixed: merge path
    assert view.path_counts["merge"] == before["merge"] + 4     # the dead one never dispatches


def test_multi_bucket_view_against_numpy_model_and_merge(monkeypatch):
    """A 40,000-doc Zipf corpus in 3 segments (4 buckets of 16384): the
    view's bucket bounds equal ``np.searchsorted`` per run; the served
    answers equal ``reference_bucket_search`` over the view's own plan; and
    against the exact merge path hits are equal, docs equal up to near-ties
    and scores within one quantum (1 / scale) per query term."""
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    corpus = SyntheticCorpus(40_000, 2_000, 16, seed=9)
    fds = {"body": create_field_def("body", {"type": "TEXT", "search": True})}
    searcher = PortSearcher([segment_from_numpy(a, "cpu") for a in corpus.segment_arrays(3)],
                            fds)
    view = searcher.packed_view("body")
    st = view._bucket_state()
    assert st["m"] == 4
    host_docs = view.index.doc_ids.numpy()
    edges = np.arange(1, 4) * 16384
    for r in range(0, len(view.index.run_offsets), 97):
        o, n = int(view.index.run_offsets[r]), int(view.index.run_lengths[r])
        want = np.searchsorted(host_docs[o : o + n], edges)
        np.testing.assert_array_equal(st["bounds"][r], np.concatenate([[0], want, [n]]))

    k = 30
    queries = corpus.sample_queries(4, 4)
    specs = [searcher.fast_query_spec(parse_query(
        {"matchQuery": {"field": "body", "query": " ".join(q)}})) for q in queries]
    plan = view.bucket_plan(specs)
    monkeypatch.setenv("NRT_FAST_PATH", "bucket")
    bucket = view.search_batch(specs, k)
    assert view.path_counts["bucket"] == len(specs)
    ms, mdocs, mh = _numpy_model(view, plan, k)
    monkeypatch.setenv("NRT_FAST_PATH", "merge")
    merge = view.search_batch(specs, k)
    for qi, (b, mres) in enumerate(zip(bucket, merge)):
        np.testing.assert_array_equal(b.docs, mdocs[qi].astype(np.int64))
        np.testing.assert_array_equal(b.scores, ms[qi])
        assert b.total_hits == mh[qi] == mres.total_hits > k
        tol = len(queries[qi]) / float(plan["scales"][qi])
        b_score = dict(zip(b.docs.tolist(), b.scores.tolist()))
        m_score = dict(zip(mres.docs.tolist(), mres.scores.tolist()))
        for d in set(b_score) & set(m_score):
            assert abs(b_score[d] - m_score[d]) <= tol, (qi, d)
        for d in set(b_score) - set(m_score):      # a near-tie at the k-th score
            assert b_score[d] <= mres.scores[-1] + tol, (qi, d)
        for d in set(m_score) - set(b_score):
            assert m_score[d] <= b.scores[-1] + tol, (qi, d)
