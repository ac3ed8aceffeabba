"""Vector search on the port against the reference, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and
through ``nrtsearch_tpu_torch`` (``device="cpu"``): the similarity scores of
the five similarities over f32, bf16 and int8 columns (``ops/knn.py``),
``quantize_int8``, ``knn_search`` and ``knn_search_quantized``, IVF, and the
engine around them (the builder's VECTOR columns, ``Searcher.knn_search``
with filters and deletes over several segments, a merge of vector columns,
commits read both ways, fetch of a vector field, the exact vector query
through both evaluators, ``convert.segment_from_numpy``'s vectors).

Tolerances. Doc ids are equal but at near-ties: where the two top-k lists
differ at a rank, the reference's own score of the port's doc must lie
within the tolerance of the reference's score at that rank. Scores: the two
packages' products add in other orders (XLA's and torch's), so a score is
held within ``ULPS`` = 4 f32 ulps (2^-23 each) of the magnitude it is
computed from, ``S``: the dot product's Σ|q_i v_i| carried through the
similarity's mapping (l2: score² (|q|² + |v|² + 2Σ|q_i v_i|); dot product:
(Σ|q_i v_i| + 1) / 2; cosine: (Σ|q_i v_i| / (|q||v|) + 1) / 2; maximum
inner product: Σ|q_i v_i| + 1, or score² (Σ|q_i v_i| + 1) below 1), or of
the score itself where that is larger. int8 dots are exact int32 on both
sides; what differs there is the f32 query norm. The quantization and the
column layouts (values, presence, norms, scale) are bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nrtsearch_tpu.core.searcher import Searcher as RefSearcher
from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
from nrtsearch_tpu.ops import knn as ref_knn
from nrtsearch_tpu.query.plan import parse_query as ref_parse
from nrtsearch_tpu.schema.fields import create_field_def as ref_create
from nrtsearch_tpu_torch.core.searcher import Searcher
from nrtsearch_tpu_torch.core.segment import vector_column
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.ops import knn
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def

ULPS = 4
FORMATS = ("float32", "float16", "int8")
SIMS = knn.SIMILARITIES
CPU = torch.device("cpu")
# the reference's scores as its jitted searches compute them (XLA keeps a
# bf16 product in f32 inside the fused program)
_REF_SCORES = jax.jit(ref_knn._scores, static_argnums=3)
_REF_QSCORES = jax.jit(ref_knn._quantized_scores, static_argnums=4)


def score_scale(Q, V, sim: str, score) -> np.ndarray:
    """S of the module docstring, f64 [B, D] (Q and V as the product sees
    them: bf16-rounded or dequantized where the format stores so)."""
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


def tolerance(Q, V, sim: str, score) -> np.ndarray:
    return ULPS * 2.0 ** -23 * score_scale(Q, V, sim, score)


def assert_scores_close(port, ref, tol, ctx):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(port)), ctx
    err = np.abs(port - ref)[finite]
    assert (err <= np.asarray(tol)[finite]).all(), (ctx, float(np.max(err / np.asarray(tol)[finite])))


def assert_same_topk(p_ids, p_scores, r_ids, r_scores, full_ref, tol, ctx):
    """Top-k lists equal but at near-ties (module docstring); ``full_ref``
    and ``tol`` are the reference's [D] scores and tolerances of the row."""
    p_ids, r_ids = np.asarray(p_ids), np.asarray(r_ids)
    for rank in np.nonzero(p_ids != r_ids)[0]:
        assert abs(full_ref[p_ids[rank]] - r_scores[rank]) <= 2 * tol[r_ids[rank]], \
            (ctx, rank, p_ids[rank], r_ids[rank])
    assert_scores_close(p_scores, r_scores, tol[r_ids], ctx)


def _vectors(dims: int, n: int = 2048, b: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed + dims)
    V = rng.normal(size=(n, dims)).astype(np.float32)
    V[::97] *= 6.0                    # outliers past int8's quantile scale
    Q = rng.normal(size=(b, dims)).astype(np.float32)
    Q[0] = V[5] + 0.01                # a near-exact neighbour
    return Q, V


def _ref_column(V, fmt):
    """(values as the reference stores them, scale, what its product sees)."""
    if fmt == "int8":
        q8, scale = ref_knn.quantize_int8(V)
        return jnp.asarray(q8), scale, q8.astype(np.float32) * scale
    if fmt == "float16":
        vb = jnp.asarray(V).astype(jnp.bfloat16)
        return vb, 1.0, np.asarray(vb.astype(jnp.float32))
    return jnp.asarray(V), 1.0, V


def _both_scores(Q, V, fmt, sim):
    """(port [B, D], reference [B, D], Q and V as the product sees them)."""
    present = np.ones(len(V), bool)
    col = vector_column(V, present, fmt, CPU)
    sq = (np.linalg.norm(V, axis=1) ** 2).astype(np.float32)
    rv, scale, v_seen = _ref_column(V, fmt)
    qt = torch.from_numpy(Q)
    if fmt == "int8":
        ref = _REF_QSCORES(jnp.asarray(Q), rv, jnp.float32(scale),
                                        jnp.asarray(sq), sim)
        port = knn._quantized_scores(qt, col.values, col.scale, col.score_sq_norms, sim)
        q_seen = Q
    else:
        ref = _REF_SCORES(jnp.asarray(Q), rv, jnp.asarray(sq), sim)
        port = knn._scores(qt, col.values, col.score_sq_norms, sim)
        q_seen = (np.asarray(jnp.asarray(Q).astype(jnp.bfloat16).astype(jnp.float32))
                  if fmt == "float16" else Q)
    return port.numpy(), np.asarray(ref), q_seen, v_seen, col


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("dims", [16, 100])
def test_scores_match_reference(dims, sim, fmt):
    Q, V = _vectors(dims)
    port, ref, q_seen, v_seen, _ = _both_scores(Q, V, fmt, sim)
    assert port.shape == ref.shape == (3, 2048) and port.dtype == np.float32
    assert_scores_close(port, ref, tolerance(q_seen, v_seen, sim, ref), (dims, sim, fmt))


def test_column_layout_matches_reference_builder():
    """The builder's three formats hold the reference's values, presence,
    norms and scale bit for bit; bf16 rounds as JAX does."""
    rng = np.random.default_rng(4)
    V = rng.normal(size=(150, 12)).astype(np.float32)
    for fmt in FORMATS:
        spec = {"type": "VECTOR", "vectorDimensions": 12, "vectorSimilarity": "cosine",
                "vectorIndexingOptions": fmt}
        docs = [{"v": V[i].tolist()} if i % 7 else {} for i in range(150)]
        docs = [d or {"other": "x"} for d in docs]
        other = {"type": "ATOM", "storeDocValues": True}
        rw = RefWriter({"v": ref_create("v", spec), "other": ref_create("other", other)})
        pw = IndexWriter({"v": create_field_def("v", spec),
                          "other": create_field_def("other", other)}, "cpu")
        rw.add_documents([dict(d) for d in docs])
        pw.add_documents([dict(d) for d in docs])
        rc, pc = rw.refresh()[0].vectors["v"], pw.refresh()[0].vectors["v"]
        assert pc.fmt == rc.fmt == fmt and pc.scale == rc.scale
        np.testing.assert_array_equal(pc.present.numpy(), np.asarray(rc.present))
        np.testing.assert_array_equal(pc.host_norms, rc.host_norms)
        np.testing.assert_array_equal(pc.host_float(), rc.host_float())
        want = {"float32": torch.float32, "float16": torch.bfloat16, "int8": torch.int8}[fmt]
        assert pc.values.dtype == want


def test_quantize_int8_bit_for_bit():
    rng = np.random.default_rng(7)
    cases = [rng.normal(size=(500, 16)).astype(np.float32),
             rng.standard_cauchy(size=(300, 24)).astype(np.float32),
             np.zeros((4, 8), np.float32), np.zeros((0, 8), np.float32),
             np.float32([[0.0, 0.0, 3.0, -2.0]])]
    for V in cases:
        pq, ps = knn.quantize_int8(V)
        rq, rs = ref_knn.quantize_int8(V)
        assert pq.dtype == rq.dtype == np.int8 and ps == rs
        np.testing.assert_array_equal(pq, rq)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("dims", [16, 100])
def test_knn_search_matches_reference(dims, sim, fmt):
    """knn_search / knn_search_quantized under a random mask, k = 10."""
    Q, V = _vectors(dims, seed=3)
    mask = np.random.default_rng(dims).random(len(V)) < 0.7
    _, full_ref, q_seen, v_seen, col = _both_scores(Q, V, fmt, sim)
    tol = tolerance(q_seen, v_seen, sim, full_ref)
    rv, scale, _ = _ref_column(V, fmt)
    sq = (np.linalg.norm(V, axis=1) ** 2).astype(np.float32)
    if fmt == "int8":
        rs, ri = ref_knn.knn_search_quantized(rv, jnp.float32(scale), jnp.asarray(sq),
                                              jnp.asarray(mask), jnp.asarray(Q),
                                              similarity=sim, k=10)
        ps, pi = knn.knn_search_quantized(col.values, col.scale, col.score_sq_norms,
                                          torch.from_numpy(mask), torch.from_numpy(Q),
                                          similarity=sim, k=10)
    else:
        rs, ri = ref_knn.knn_search(rv, jnp.asarray(sq), jnp.asarray(mask), jnp.asarray(Q),
                                    similarity=sim, k=10)
        ps, pi = knn.knn_search(col.values, col.score_sq_norms, torch.from_numpy(mask),
                                torch.from_numpy(Q), similarity=sim, k=10)
    assert ps.shape == pi.shape == (3, 10)
    for b in range(3):
        assert mask[pi[b].numpy()].all()
        assert_same_topk(pi[b].numpy(), ps[b].numpy(), np.asarray(ri[b]), np.asarray(rs[b]),
                         full_ref[b], tol[b], (dims, sim, fmt, b))


def test_knn_search_masks_out_everything_past_the_matches():
    """Fewer matches than k: the rest of the row is -inf, as lax.top_k
    leaves it; ties keep the lower id."""
    V = np.ones((64, 8), np.float32)
    mask = np.zeros(64, bool)
    mask[[3, 9, 40]] = True
    Q = np.ones((1, 8), np.float32)
    s, i = knn.knn_search(torch.from_numpy(V), torch.full((64,), 8.0), torch.from_numpy(mask),
                          torch.from_numpy(Q), similarity="dot_product", k=5)
    rs, ri = ref_knn.knn_search(jnp.asarray(V), jnp.full((64,), 8.0), jnp.asarray(mask),
                                jnp.asarray(Q), similarity="dot_product", k=5)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(i.numpy()[0, :3], [3, 9, 40])
    np.testing.assert_array_equal(i.numpy()[0, :3], np.asarray(ri)[0, :3])
    assert np.isneginf(s.numpy()[0, 3:]).all()


@pytest.mark.parametrize("sim", ["l2_norm", "cosine"])
def test_ivf_matches_reference(sim):
    rng = np.random.default_rng(3)
    vectors = rng.normal(size=(2000, 16)).astype(np.float32)
    queries = rng.normal(size=(8, 16)).astype(np.float32)
    ref = ref_knn.IVFIndex(vectors, n_clusters=32, similarity=sim, seed=0)
    port = knn.IVFIndex(vectors, n_clusters=32, similarity=sim, seed=0, device="cpu")
    np.testing.assert_allclose(port.centroids, ref.centroids, atol=1e-5, rtol=0)
    assert (port.n_blocks, port.cap) == (ref.n_blocks, ref.cap)
    np.testing.assert_array_equal(port.block_ids.numpy(), np.asarray(ref.block_ids))
    rs, ri = ref.search(queries, k=10, nprobe=8)
    ps, pi = port.search(queries, k=10, nprobe=8)
    assert pi.dtype == ri.dtype and ps.shape == rs.shape == (8, 10)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs, rtol=4 * 2.0 ** -23 * 16, atol=0)

    def recall(ids):
        hits = 0
        for b in range(8):
            d2 = np.sum((vectors - queries[b]) ** 2, axis=1)
            hits += len(set(np.argsort(d2)[:10].tolist()) & set(ids[b].tolist()))
        return hits / 80

    assert recall(pi) == recall(ri) >= 0.8 if sim == "l2_norm" else recall(pi) == recall(ri)
    # nprobe above the blocks and k above the probed capacity pad as the reference
    rs, ri = ref.search(queries[:2], k=5000, nprobe=1000)
    ps, pi = port.search(queries[:2], k=5000, nprobe=1000)
    np.testing.assert_array_equal(pi, ri)
    assert np.array_equal(np.isneginf(ps), np.isneginf(rs))


# ---------------------------------------------------------------------------
# the engine: builder, Searcher.knn_search, merge, directory, fetch, queries
# ---------------------------------------------------------------------------

N, KDIMS = 90, 12
PRICES = [(i * 13) % 97 for i in range(N)]
COLORS = ["red", "blue", "green"]
DELETED = (5, 35, 65, 17)


def _specs(fmt: str, sim: str = "l2_norm") -> dict:
    return {
        "id": {"type": "_ID", "store": True},
        "vec": {"type": "VECTOR", "vectorDimensions": KDIMS, "vectorSimilarity": sim,
                "vectorIndexingOptions": fmt, "store": True},
        "price": {"type": "INT", "storeDocValues": True},
        "color": {"type": "ATOM", "storeDocValues": True, "search": True},
        "body": {"type": "TEXT", "search": True, "store": True},
    }


def _kvecs():
    return np.random.default_rng(9).normal(size=(N, KDIMS)).astype(np.float32)


def _kdocs(lo: int, hi: int) -> list[dict]:
    vecs = _kvecs()
    docs = []
    for i in range(lo, hi):
        d = {"id": str(i), "price": str(PRICES[i]), "color": COLORS[i % 3],
             "body": f"doc {i} " + ("alpha" if i % 2 else "beta gamma")}
        if i % 11 != 4:                 # some docs have no vector
            d["vec"] = vecs[i].tolist()
        docs.append(d)
    return docs


def _pair(fmt: str, sim: str = "l2_norm", merge_factor: int = 100, deletes: bool = True):
    """(reference Searcher, port Searcher) over 3 segments of 30 docs with
    DELETED removed by id."""
    specs = _specs(fmt, sim)
    rw = RefWriter({n: ref_create(n, s) for n, s in specs.items()}, merge_factor=merge_factor)
    fds = {n: create_field_def(n, s) for n, s in specs.items()}
    pw = IndexWriter(fds, "cpu", merge_factor=merge_factor)
    for lo in (0, 30, 60):
        for w in (rw, pw):
            w.add_documents(_kdocs(lo, lo + 30))
            w.refresh()
    if deletes:
        for w in (rw, pw):
            w.delete_by_id([str(i) for i in DELETED])
            w.refresh()
    return (RefSearcher(rw.segments, rw.field_defs, version=1), Searcher(pw.segments, fds),
            rw, pw)


def _hits(td):
    return [(h.segment_idx, h.local_id, h.global_ord) for h in td.hits]


def _assert_same_td(ptd, rtd, ctx, rel=ULPS * 2.0 ** -23 * 4):
    assert ptd.total_hits == rtd.total_hits, ctx
    assert _hits(ptd) == _hits(rtd), ctx
    np.testing.assert_allclose([h.score for h in ptd.hits], [h.score for h in rtd.hits],
                               rtol=rel, atol=0, err_msg=str(ctx))


FILTERS = {
    "nofilter": (None, lambda i: True),
    "range": ({"rangeQuery": {"field": "price", "upper": "50"}}, lambda i: PRICES[i] <= 50),
    "term": ({"termQuery": {"field": "color", "textValue": "red"}},
             lambda i: COLORS[i % 3] == "red"),
}


@pytest.mark.parametrize("case", list(FILTERS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_knn_filter_deletes_multisegment_matrix(fmt, case):
    """tests/test_knn.py's matrix (no filter | range | term, with deletes,
    over 3 segments) on the engine: the port's hits, totals and scores are
    the reference's; the f32 field's ids are also the numpy oracle's."""
    ref, port, *_ = _pair(fmt)
    fq, pred = FILTERS[case]
    q = np.random.default_rng(1).normal(size=KDIMS).astype(np.float32)
    for k, boost in ((5, 1.0), (40, 2.5)):
        rtd = ref.knn_search("vec", q, k, filter_node=ref_parse(fq) if fq else None,
                             boost=boost)
        ptd = port.knn_search("vec", q, k, filter_node=parse_query(fq) if fq else None,
                              boost=boost)
        _assert_same_td(ptd, rtd, (fmt, case, k))
        vecs = _kvecs()
        elig = [i for i in range(N) if i not in DELETED and pred(i) and i % 11 != 4]
        assert ptd.total_hits == len(elig)
        if fmt == "float32":
            d = ((vecs[elig] - q) ** 2).sum(axis=1)
            want = [elig[j] for j in np.argsort(d, kind="stable")[:k]]
            assert [int(port.segments[h.segment_idx].stored[h.local_id]["id"])
                    for h in ptd.hits] == want


@pytest.mark.parametrize("sim", SIMS)
def test_knn_search_similarities_on_the_engine(sim):
    """Each similarity through Searcher.knn_search on the bf16 and int8
    fields (the rounded and quantized norms the columns keep)."""
    q = _kvecs()[12] + 0.05
    for fmt in ("float16", "int8"):
        ref, port, *_ = _pair(fmt, sim, deletes=False)
        _assert_same_td(port.knn_search("vec", q, 10), ref.knn_search("vec", q, 10), (sim, fmt))


def test_knn_search_refusals_match_reference():
    ref, port, *_ = _pair("float32", deletes=False)
    for s in (ref, port):
        with pytest.raises(KeyError):
            s.knn_search("price", np.zeros(KDIMS, np.float32), 5)
        with pytest.raises(ValueError):
            s.knn_search("vec", np.zeros(KDIMS + 1, np.float32), 5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_merge_carries_vector_columns(fmt):
    """A tiered merge (segments_per_tier 2) and an explicit merge_segments
    over segments with deletes: the merged vector columns are the
    reference's, bit for bit (int8 re-quantized with the merged scale)."""
    from nrtsearch_tpu.core.merge import merge_segments as ref_merge
    from nrtsearch_tpu_torch.core.merge import merge_segments

    ref, port, rw, pw = _pair(fmt)
    rm, rremap = ref_merge(ref.segments, rw.field_defs)
    pm, premap = merge_segments(port.segments, pw.field_defs)
    assert [m.tolist() for m in premap.values()] == [m.tolist() for m in rremap.values()]
    rc, pc = rm.vectors["vec"], pm.vectors["vec"]
    assert (pc.fmt, pc.scale) == (rc.fmt, rc.scale) and pm.num_docs == rm.num_docs
    np.testing.assert_array_equal(pc.present.numpy(), np.asarray(rc.present))
    np.testing.assert_array_equal(pc.host_norms, rc.host_norms)
    np.testing.assert_array_equal(pc.host_float(), rc.host_float())
    assert pm.stored == rm.stored
    # the writers' own tiered merges
    specs = _specs(fmt)
    rw2 = RefWriter({n: ref_create(n, s) for n, s in specs.items()}, merge_factor=2)
    fds = {n: create_field_def(n, s) for n, s in specs.items()}
    pw2 = IndexWriter(fds, "cpu", merge_factor=2)
    for lo in range(0, N, 15):
        for w in (rw2, pw2):
            w.add_documents(_kdocs(lo, lo + 15))
            w.refresh()
    assert pw2.merge_stats["merges"] == rw2.merge_stats["merges"] > 0
    q = _kvecs()[3]
    _assert_same_td(Searcher(pw2.segments, fds).knn_search("vec", q, 20),
                    RefSearcher(rw2.segments, rw2.field_defs, version=1).knn_search("vec", q, 20),
                    fmt)


@pytest.mark.parametrize("fmt", FORMATS)
def test_commits_read_both_ways(fmt, tmp_path):
    """A reference commit opens in the port and a port commit in the
    reference (bf16 written as f32 and rounded back): equal columns and
    equal kNN answers."""
    from nrtsearch_tpu.core.directory import commit_segments as ref_commit
    from nrtsearch_tpu.core.directory import open_commit as ref_open
    from nrtsearch_tpu_torch.core.directory import commit_segments, open_commit

    ref, port, rw, pw = _pair(fmt)
    ref_commit(ref.segments, tmp_path / "r", gen=1, version=1)
    commit_segments(port.segments, tmp_path / "p", gen=1, version=1)
    _, from_ref = open_commit(tmp_path / "r", "cpu")
    _, from_port = ref_open(tmp_path / "p")
    for a, b in zip(from_ref, ref.segments):
        assert a.vectors["vec"].values.dtype == port.segments[0].vectors["vec"].values.dtype
        np.testing.assert_array_equal(a.vectors["vec"].host_float(), b.vectors["vec"].host_float())
        assert a.vectors["vec"].scale == b.vectors["vec"].scale
    for a, b in zip(from_port, port.segments):
        np.testing.assert_array_equal(a.vectors["vec"].host_float(), b.vectors["vec"].host_float())
        np.testing.assert_array_equal(a.vectors["vec"].host_norms, b.vectors["vec"].host_norms)
    q = _kvecs()[20] - 0.1
    _assert_same_td(Searcher(from_ref, pw.field_defs).knn_search("vec", q, 10),
                    ref.knn_search("vec", q, 10), fmt)
    _assert_same_td(port.knn_search("vec", q, 10),
                    RefSearcher(from_port, rw.field_defs, version=1).knn_search("vec", q, 10),
                    fmt)


@pytest.mark.parametrize("fmt", FORMATS)
def test_fetch_vector_field(fmt):
    """fetch_field_values of the vector field (its dequantized row alone),
    of a doc without a vector, and of the stored copy, equal the
    reference's."""
    from nrtsearch_tpu.search.fetch import fetch_field_values as ref_fetch
    from nrtsearch_tpu_torch.core.searcher import Hit
    from nrtsearch_tpu_torch.search.fetch import fetch_field_values

    ref, port, rw, pw = _pair(fmt, deletes=False)
    q = _kvecs()[7]
    rtd, ptd = ref.knn_search("vec", q, 30), port.knn_search("vec", q, 30)
    for rh, ph in zip(rtd.hits, ptd.hits):
        assert fetch_field_values(port, ph, "vec", pw.field_defs) == \
            ref_fetch(ref, rh, "vec", rw.field_defs)
    # doc 4 has no vector
    for s, fetch, fds in ((ref, ref_fetch, rw.field_defs), (port, fetch_field_values,
                                                             pw.field_defs)):
        assert fetch(s, Hit(0, 4, 4, 0.0), "vec", fds) is None


@pytest.mark.parametrize("compiled", ["1", "0"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_exact_vector_query_both_evaluators(fmt, compiled, monkeypatch):
    """exactVectorQuery through the compiled program and the eager
    evaluator: hits, totals and scores as the reference's (the dequantized
    f32 matrix and exact norms), alone and inside a boolean with a filter."""
    monkeypatch.setenv("NRT_COMPILED_EVAL", compiled)
    ref, port, *_ = _pair(fmt, "cosine")
    q = (_kvecs()[40] * 0.5).tolist()
    queries = [
        {"exactVectorQuery": {"field": "vec", "queryFloatVector": q}},
        {"boost": 2.0, "exactVectorQuery": {"field": "vec", "queryFloatVector": q}},
        {"booleanQuery": {"clauses": [
            {"occur": "MUST", "query": {"exactVectorQuery": {"field": "vec",
                                                             "queryFloatVector": q}}},
            {"occur": "FILTER", "query": {"termQuery": {"field": "color",
                                                        "textValue": "blue"}}}]}},
    ]
    for spec in queries:
        _assert_same_td(port.search(parse_query(spec), 15), ref.search(ref_parse(spec), 15),
                        (fmt, compiled, str(spec)[:40]))
    bad = {"exactVectorQuery": {"field": "vec", "queryFloatVector": q[:-1]}}
    with pytest.raises(ValueError):
        port.search(parse_query(bad), 5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_segment_from_numpy_carries_vectors(fmt):
    """convert.segment_from_numpy with a reference segment's vector column
    as numpy: the port answers kNN as the reference does on that segment."""
    from nrtsearch_tpu_torch.convert import segment_from_numpy

    ref, _port, rw, pw = _pair(fmt, deletes=False)
    seg = ref.segments[1]
    vc = seg.vectors["vec"]
    tfi = seg.fields["body"]
    arrays = {"terms": tfi.terms, "offsets": tfi.offsets, "lengths": tfi.lengths,
              "doc_ids": np.asarray(tfi.doc_ids), "freqs": np.asarray(tfi.freqs),
              "postings_len": tfi.postings_len, "doc_lens": np.asarray(tfi.doc_lens),
              "sum_doc_lens": tfi.sum_doc_lens, "doc_count": tfi.doc_count,
              "live": np.asarray(seg.live), "host_live": seg.host_live,
              "num_docs": seg.num_docs, "capacity": seg.capacity, "stored": seg.stored}
    port_seg = segment_from_numpy(arrays, "cpu", vectors={"vec": {
        "values": np.asarray(vc.values, np.float32) if fmt == "float16" else
        np.asarray(vc.values), "present": np.asarray(vc.present), "norms": vc.host_norms,
        "fmt": vc.fmt, "scale": vc.scale}})
    assert port_seg.vectors["vec"].values.dtype == \
        pw.segments[0].vectors["vec"].values.dtype
    q = _kvecs()[33]
    rtd = RefSearcher([seg], rw.field_defs, version=1).knn_search("vec", q, 12)
    ptd = Searcher([port_seg], pw.field_defs).knn_search("vec", q, 12)
    _assert_same_td(ptd, rtd, fmt)


def test_clustered_vectors_are_the_benchmarks():
    import importlib.util
    from pathlib import Path

    from nrtsearch_tpu_torch.models.synthetic import clustered_vectors

    path = Path(__file__).resolve().parent.parent / "benchmarks" / "vector_recall.py"
    spec = importlib.util.spec_from_file_location("vector_recall", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for args in ((3000, 16, 5, 42), (500, 100, 3, 7)):
        got, want = clustered_vectors(*args), mod.synthetic(*args)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
