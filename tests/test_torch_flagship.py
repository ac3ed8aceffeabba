"""The flagship model (models/flagship.py) of the port against the
reference's, route by route, on the CPU.

Both packages build their ``BatchedBM25`` from the same seeded
``SyntheticCorpus`` (the port's corpus draws the reference's numbers) and
attach the same bucket and dense-head indexes. Each of the five routes
then answers the same queries in both. The reference runs as its
own tests run it on the CPU: its merge step on the XLA branch, its bucket
kernels in Pallas interpret mode; the port runs its plain torch versions.

Tolerances, each stated where it is used:
- ``search``: docs and hits equal, scores bit-equal (the same f32
  operations in the same order).
- bucket: keys, docs and hits equal (integer sums).
- dense head + bucket tail: hits equal, docs equal but at near-ties, scores
  within 8 f32 ulps of the largest score the query can reach (XLA and
  torch sum the bf16 head products in different orders), plus, against the
  numpy oracle, one quantum (1 / scale) per tail term; head terms are never
  quantized.
- dense head + merge tail, fused: docs, hits and exact flags equal, scores
  within 1e-6 relative (the port's stated fused contract on the CPU,
  tests/test_torch_ops.py).
"""

import jax
import numpy as np
import pytest
import torch

from nrtsearch_tpu.models.flagship import BatchedBM25 as RefBM25
from nrtsearch_tpu.models.flagship import SyntheticCorpus as RefCorpus
from nrtsearch_tpu.ops import dense_head as ref_dh
from nrtsearch_tpu_torch import convert
from nrtsearch_tpu_torch.models import flagship
from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus
from nrtsearch_tpu_torch.ops import bucket_retrieval as br
from nrtsearch_tpu_torch.ops import dense_head as port_dh

K = 10
DOCS, VOCAB, DRAWS, SEED = 20_000, 2_000, 24, 5


@pytest.fixture(scope="module")
def models():
    ref_corpus = RefCorpus(DOCS, VOCAB, DRAWS, seed=SEED)
    corpus = SyntheticCorpus(DOCS, VOCAB, DRAWS, seed=SEED)
    ref, port = ref_corpus.to_model(), corpus.to_model("cpu")
    for m in (ref, port):
        m.attach_bucket(4096)
        m.attach_dense(max_rows=16, min_df=300, bucket_docs=4096, residual=True)
    queries = ref_corpus.sample_queries(12, 4)
    assert corpus.sample_queries(12, 4) == queries
    head = [str(int(t)) for t in port.dense_idx.head_ids]
    tail = [str(t) for t in range(VOCAB)
            if str(t) not in head and 0 < port.lengths[t] < 300]
    queries += [
        head[:3],                                 # head only
        tail[:4],                                 # tail only
        [head[0], tail[5], tail[6]],              # mixed
        [],                                       # empty
        ["no-such-term", tail[7]],                # unknown term
        [head[1], head[1], tail[8], tail[8]],     # duplicate terms
    ]
    return corpus, ref, port, queries


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_model_arrays_and_impacts_equal(models):
    _corpus, ref, port, _qs = models
    for name in ("doc_ids", "freqs", "doc_lens", "live"):
        np.testing.assert_array_equal(_np(getattr(port, name)), _np(getattr(ref, name)))
    assert port.avgdl == ref.avgdl and port.capacity == ref.capacity
    # the same f32 formula with its FMA taken once: bit-equal
    np.testing.assert_array_equal(_np(port.impacts).view(np.int32),
                                  _np(ref.impacts).view(np.int32))
    assert port.device == torch.device("cpu") and not port.on_cuda()


def test_default_device_is_the_card():
    corpus = SyntheticCorpus(300, 50, 8, seed=1)
    if torch.cuda.is_available():
        assert corpus.to_model().doc_ids.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            corpus.to_model()


@pytest.mark.parametrize("require_all", [False, True])
def test_search_bit_equal(models, require_all):
    """The merge step: docs and hits equal, scores bit-equal."""
    _corpus, ref, port, qs = models
    want = ref.search(ref.compile_queries(qs), K, require_all_terms=require_all)
    got = port.search(port.compile_queries(qs), K, require_all_terms=require_all)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def test_search_against_numpy_oracle(models):
    """The corpus's own numpy BM25 with the model's raw lengths: hits equal,
    docs equal but at near-ties, scores within 1e-5 relative (numpy has no
    FMA in the impact)."""
    corpus, _ref, port, _qs = models
    qs = corpus.sample_queries(8, 4)
    s, d, h = (_np(x) for x in port.search(port.compile_queries(qs), K))
    for qi, q in enumerate(qs):
        es, ed, eh = corpus.exact_topk(q, K, raw_lengths=True)
        assert h[qi] == eh
        n = len(ed)
        np.testing.assert_allclose(s[qi, :n], es, rtol=1e-5)
        for j in np.nonzero(d[qi, :n] != ed)[0]:
            assert abs(s[qi, j] - es[j]) <= 1e-5 * es[j], (qi, j)


def test_compile_query_batches_and_bucketed_split(models):
    """One shared (run_len, R) for several batches, and the width split:
    the same split as the reference, and the same answers as one batch."""
    corpus, ref, port, qs = models
    batches = [qs[:5], qs[5:]]
    for g, w in zip(port.compile_query_batches(batches), ref.compile_query_batches(batches)):
        for f in ("term_offsets", "term_lengths", "term_weights", "n_terms"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.run_len == w.run_len
    # one heavy query (the four most frequent terms) beside light ones
    # (pairs of tail terms) splits off
    tail = [str(t) for t in range(VOCAB) if 0 < port.lengths[t] < 300]
    mixed = [tail[2 * i : 2 * i + 2] for i in range(6)] + [["0", "1", "2", "3"]]
    split = port.compile_queries_bucketed(mixed)
    want = ref.compile_queries_bucketed(mixed)
    assert [ix for _b, ix in split] == [ix for _b, ix in want]
    assert len(split) == 2
    one = [_np(x) for x in port.search(port.compile_queries(mixed), K)]
    for qb, ix in split:
        part = [_np(x) for x in port.search(qb, K)]
        for x, y in zip(part, one):
            np.testing.assert_array_equal(x, y[ix])


def test_bucket_route_equal(models):
    """Integer rank keys: keys, docs and hits equal to the reference's
    interpret-mode kernels, and decoded scores to its numpy oracle."""
    _corpus, ref, port, qs = models
    rp, pp = ref.plan_bucket(qs), port.plan_bucket(qs)
    np.testing.assert_array_equal(pp.weights, rp.weights)
    want = [_np(x) for x in ref.serve_bucket_batch(rp, K)]
    got = [_np(x) for x in port.serve_bucket_batch(pp, K)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    # an empty slot's doc id is unspecified (decode_topk makes it -1)
    full = got[0] != br.I32_MIN
    assert (~full[15]).all()
    np.testing.assert_array_equal(got[1][full], want[1][full])
    docs, imps = port.host_postings()
    s, d = br.decode_topk(got[0], got[1], pp.scales)
    os_, od, oh = br.reference_bucket_search(docs, imps, port.bucket_idx, pp, K)
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(got[2], oh)
    np.testing.assert_array_equal(s, os_)


def _dense_tail_tolerance(port, plan, quanta: bool) -> np.ndarray:
    """Per query: 8 f32 ulps of the largest score the plan can reach (at
    most 8 products per query, summed in another order; the tail share
    added), and with ``quanta`` one quantum (1 / scale) per tail term."""
    top = np.abs(plan.W.astype(np.float64)) @ _np(port.dense_idx.row_max).astype(np.float64)
    q = 0.0
    if plan.tail is not None:
        top = top + np.where(plan.tail.n_terms > 0, br.QMAX / plan.tail.scales, 0.0)
        q = plan.tail.n_terms / plan.tail.scales
    return 8 * 2.0**-23 * top + (q if quanta else 0.0)


def test_dense_tail_route(models):
    """Dense head + bucket tail against the reference's route and its numpy
    oracle: hits equal, docs equal but at near-ties, scores within the
    summation bound (and one quantum per tail term against the oracle)."""
    _corpus, ref, port, qs = models
    rp, pp = ref.plan_dense(qs), port.plan_dense(qs)
    np.testing.assert_array_equal(pp.W, rp.W)
    assert pp.has_head and pp.tail is not None
    want = ref_dh.decode_packed(ref.serve_dense_batch(rp, K), K)
    got = port_dh.decode_packed(port.serve_dense_batch(pp, K), K)
    docs, imps = port.host_postings()
    oracle = port_dh.reference_dense_search(docs, imps, port.dense_idx,
                                            port.bucket_entries(qs), port.offsets,
                                            port.lengths, K)
    ref_oracle = ref_dh.reference_dense_search(
        np.asarray(ref.doc_ids), np.asarray(ref.impacts), ref.dense_idx,
        ref.bucket_entries(qs), ref.offsets, ref.lengths, K)
    for g, w in zip(oracle, ref_oracle):
        np.testing.assert_array_equal(g, w)
    # the reference's route sums the same 15-bit keys: only the head's sums
    # differ; the oracle rounds each tail term its own way
    for other, quanta in ((want, False), (oracle, True)):
        tol = _dense_tail_tolerance(port, pp, quanta)
        np.testing.assert_array_equal(got[2], other[2])
        for qi in range(len(qs)):
            fin = np.isfinite(other[0][qi])
            np.testing.assert_array_equal(np.isfinite(got[0][qi]), fin)
            assert np.abs(got[0][qi][fin] - other[0][qi][fin]).max(initial=0) <= tol[qi]
            for j in np.nonzero(got[1][qi] != other[1][qi])[0]:
                assert abs(got[0][qi][j] - other[0][qi][j]) <= tol[qi], (qi, j)
    assert (got[1][15] == -1).all() and got[2][15] == 0         # the empty query


def test_dense_merge_and_fused_routes(models):
    """Dense head + merge tail and the fused path against the reference's:
    docs, hits and exact flags equal, scores within 1e-6 relative; both
    window branches are reached across the cases."""
    _corpus, ref, port, qs = models
    rp, pp = ref.plan_dense_merge(qs), port.plan_dense_merge(qs)
    for f in ("W", "row_idx", "run_offs", "run_lens", "run_weights"):
        np.testing.assert_array_equal(getattr(pp, f), getattr(rp, f))
    assert pp.run_len == rp.run_len
    for kw in ({}, {"exact_counts": True}):
        want = ref_dh.decode_packed2(ref.serve_dense_merge(rp, K, **kw), K)
        got = port_dh.decode_packed2(port.serve_dense_merge(pp, K, **kw), K)
        _fused_equal(got, want)
        if kw:
            assert got[3].all()
        want = ref_dh.decode_packed2(ref.serve_dense_fused(rp, K, **kw), K)
        got = port_dh.decode_packed2(port.serve_dense_fused(pp, K, **kw), K)
        _fused_equal(got, want)


def _fused_equal(got, want):
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def _strong_head_model(device_ref: bool):
    """The reference test's constructed case (tests/test_dense_merge.py:
    134-180): a head term in every doc at one impact, a tail term over 1,000
    docs with 40 tf levels, so the window certificate holds."""
    D, n_tail = 20_000, 1_000
    post_docs = np.concatenate([np.arange(D), np.arange(n_tail)]).astype(np.int32)
    post_freqs = np.concatenate([np.ones(D), 10 + np.arange(n_tail) % 40]).astype(np.float32)
    pad = (1 << 16) + 65_536
    doc_ids = np.zeros(pad, np.int32)
    doc_ids[: len(post_docs)] = post_docs
    freqs = np.zeros(pad, np.float32)
    freqs[: len(post_freqs)] = post_freqs
    doc_lens = np.zeros(1 << 15, np.float32)
    doc_lens[:D] = 10.0
    live = np.zeros(1 << 15, bool)
    live[:D] = True
    arrays = dict(terms={"head": 0, "tail": 1}, offsets=np.array([0, D], np.int64),
                  lengths=np.array([D, n_tail], np.int32), doc_ids=doc_ids, freqs=freqs,
                  doc_lens=doc_lens, live=live, num_docs_real=D)
    if device_ref:
        return RefBM25(**{k: jax.device_put(v) if isinstance(v, np.ndarray)
                          and k not in ("offsets", "lengths") else v
                          for k, v in arrays.items()})
    return convert.batched_bm25_from_numpy(**arrays, device="cpu")


def test_dense_merge_pruned_branch_engaged():
    """The candidate window certifies the constructed case: the port takes
    the pruned branch (one host read, WINDOW_BRANCH counts it), its exact
    flag is False and docs and scores equal the reference's (which took its
    pruned branch too) and the exact merge path's."""
    ref, port = _strong_head_model(True), _strong_head_model(False)
    for m in (ref, port):
        m.attach_dense(max_rows=8, min_df=5_000, bucket_docs=8_192)
    assert port.dense_idx.n_rows == 1
    qs = [["head", "tail"]]
    before = dict(port_dh.WINDOW_BRANCH)
    syncs = port_dh.HOST_SYNCS["window_certificate"]
    got = port_dh.decode_packed2(port.serve_dense_merge(port.plan_dense_merge(qs), 100), 100)
    assert port_dh.WINDOW_BRANCH["window"] == before["window"] + 1
    assert port_dh.HOST_SYNCS["window_certificate"] == syncs + 1
    want = ref_dh.decode_packed2(ref.serve_dense_merge(ref.plan_dense_merge(qs), 100), 100)
    assert not got[3][0] and not want[3][0]
    _fused_equal(got, want)
    s, d, h = (_np(x) for x in port.search(port.compile_queries(qs), 100))
    assert got[2][0] <= h[0]
    np.testing.assert_allclose(got[0], s, rtol=6e-3)       # bf16 head vs exact f32


def test_from_segment_answers_as_the_arrays(models):
    """A model over a port Segment (from_segment) answers as the model built
    from the same arrays."""
    corpus, _ref, _port, qs = models
    arrays = corpus.segment_arrays(1, positions=False)[0]
    seg = convert.segment_from_numpy(arrays, "cpu")
    a = flagship.BatchedBM25.from_segment(seg, "body")
    b = convert.batched_bm25_from_numpy(
        terms=arrays["terms"], offsets=arrays["offsets"], lengths=arrays["lengths"],
        doc_ids=arrays["doc_ids"], freqs=arrays["freqs"], doc_lens=arrays["doc_lens"],
        live=arrays["live"], num_docs_real=arrays["num_docs"], device="cpu")
    for x, y in zip(a.search(a.compile_queries(qs), K), b.search(b.compile_queries(qs), K)):
        assert torch.equal(x, y)


def test_bucket_padding_refused_as_in_the_reference():
    """Postings without the bucket kernel's slack past their end are
    refused, as the reference refuses them."""
    docs = np.arange(4096, dtype=np.int32)
    arrays = dict(terms={"a": 0}, offsets=np.array([0], np.int64),
                  lengths=np.array([4096], np.int32), doc_ids=np.concatenate(
                      [docs, np.zeros(7000, np.int32)]),
                  freqs=np.ones(11096, np.float32), doc_lens=np.full(4096, 3.0, np.float32),
                  live=np.ones(4096, bool), num_docs_real=4096)
    model = convert.batched_bm25_from_numpy(**arrays, device="cpu")
    model.attach_bucket(4096)                   # 7000 >= 4096 + 2048
    with pytest.raises(ValueError, match="padding"):
        model.attach_bucket(8192)
    ref = RefBM25(**{k: jax.device_put(v) if k in ("doc_ids", "freqs", "doc_lens", "live")
                     else v for k, v in arrays.items()})
    with pytest.raises(ValueError, match="padding"):
        ref.attach_bucket(8192)
