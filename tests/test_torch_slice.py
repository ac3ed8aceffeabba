"""The port's search slice end to end vs the JAX reference, on the CPU.

A 3-wave, multi-segment TEXT index is built with the reference IndexWriter
(waves like tests/test_dense_path_matrix.py, plus deletes across the first
two segments so live masks differ per segment), carried into the port with
``convert.segment_from_numpy``, and searched through both packages'
``Searcher.search`` under the reference's own path switch NRT_FAST_PATH.

Tolerances: merge path (exact f32, same addition order) bit-equal; fused
path 1e-6 relative (torch and XLA sum the f32 head products in different
orders). Fused is compared with fused and exact with exact, never across.
"""

import random

import numpy as np
import pytest
import torch

from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu.schema.fields import create_field_def as ref_create_field_def
from nrtsearch_tpu_torch.convert import segment_from_numpy
from nrtsearch_tpu_torch.core.packed_view import QuerySpec
from nrtsearch_tpu_torch.core.searcher import Searcher as PortSearcher
from nrtsearch_tpu_torch.core.writer import IndexWriter as PortWriter
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def

FIELDS = {
    "id": {"type": "_ID", "store": True},
    "body": {"type": "TEXT", "search": True},
}
WORDS = ["alpha", "beta", "gamma", "delta"]
SCORE_REL = {"merge": 0.0, "fused": 1e-6}

QUERIES = {
    "or_head": {"matchQuery": {"field": "body", "query": "common alpha"}},
    "or_mixed": {"matchQuery": {"field": "body", "query": "common needle beta"}},
    "tail_only": {"matchQuery": {"field": "body", "query": "needle"}},
    "must_head": {"matchQuery": {"field": "body", "query": "common gamma",
                                 "operator": "MUST"}},
    "must_tail": {"matchQuery": {"field": "body", "query": "delta needle",
                                 "operator": "MUST"}},
    "term": {"termQuery": {"field": "body", "textValue": "beta"}},
}


def _wave(ids, rng):
    docs = []
    for i in ids:
        words = ["common"] * (1 + rng.randint(0, 2))
        words += [rng.choice(WORDS) for _ in range(rng.randint(1, 5))]
        if i % 23 == 0:
            words.append("needle")
        docs.append({"id": str(i), "body": " ".join(words)})
    return docs


def _field_defs(create=create_field_def):
    """The port's field defs; ``create=ref_create_field_def`` gives the
    reference's own from the same specs (their enums are other classes)."""
    return {n: create(n, spec) for n, spec in FIELDS.items()}


def _arrays(seg, field="body"):
    """A reference segment's arrays as plain numpy."""
    tfi = seg.fields[field]
    return {
        "terms": dict(tfi.terms),
        "offsets": np.asarray(tfi.offsets),
        "lengths": np.asarray(tfi.lengths),
        "doc_ids": np.asarray(tfi.doc_ids),
        "freqs": np.asarray(tfi.freqs),
        "doc_lens": np.asarray(tfi.doc_lens),
        "sum_doc_lens": tfi.sum_doc_lens,
        "doc_count": tfi.doc_count,
        "postings_len": tfi.postings_len,
        "live": np.asarray(seg.live),
        "host_live": np.asarray(seg.host_live),
        "num_docs": seg.num_docs,
        "capacity": seg.capacity,
        "stored": seg.stored,
    }


@pytest.fixture(scope="module")
def waves():
    rng = random.Random(71)
    return [_wave(range(0, 300), rng), _wave(range(300, 600), rng),
            _wave(range(600, 700), rng)]


@pytest.fixture(scope="module")
def searchers(waves):
    from nrtsearch_tpu.core.searcher import Searcher as RefSearcher
    from nrtsearch_tpu.core.writer import IndexWriter as RefWriter

    ref_fds = _field_defs(ref_create_field_def)
    writer = RefWriter(ref_fds)
    for i, wave in enumerate(waves):
        writer.add_documents([dict(d) for d in wave])
        writer.refresh()
        if i == 1:
            writer.delete_by_id([str(j) for j in range(0, 600, 13)])
    segs = writer.refresh()
    assert len(segs) == 3 and sum(s.del_count for s in segs) > 0
    port_segs = [segment_from_numpy(_arrays(s), "cpu") for s in segs]
    return RefSearcher(segs, ref_fds), PortSearcher(port_segs, _field_defs())


def _hits(td):
    return [h.global_ord for h in td.hits], np.array([h.score for h in td.hits])


def _assert_same(ref_td, port_td, path, ctx):
    rd, rs = _hits(ref_td)
    pd, ps = _hits(port_td)
    assert pd == rd, ctx
    assert port_td.total_hits == ref_td.total_hits, ctx
    assert port_td.relation == ref_td.relation, ctx
    if SCORE_REL[path] == 0.0:
        np.testing.assert_array_equal(ps, rs, err_msg=ctx)
    else:
        np.testing.assert_allclose(ps, rs, rtol=SCORE_REL[path], err_msg=ctx)


@pytest.mark.parametrize("path", ["merge", "fused"])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_search_matches_reference(searchers, monkeypatch, path, qname):
    ref, port = searchers
    monkeypatch.setenv("NRT_FAST_PATH", path)
    ref_td = ref.search(ref_parse_query(QUERIES[qname]), 15)
    assert ref_td.total_hits > 0
    _assert_same(ref_td, port.search(parse_query(QUERIES[qname]), 15), path, f"{qname}/{path}")


@pytest.mark.parametrize("path", ["merge", "fused"])
def test_fast_search_batch_matches_reference(searchers, monkeypatch, path):
    ref, port = searchers
    monkeypatch.setenv("NRT_FAST_PATH", path)
    rng = random.Random(5)
    texts = [" ".join(rng.sample(WORDS + ["common", "needle"], 3)) for _ in range(8)]
    queries = [{"matchQuery": {"field": "body", "query": t}} for t in texts]
    ref_out = ref.fast_search_batch([ref.fast_query_spec(ref_parse_query(q)) for q in queries], 20)
    port_out = port.fast_search_batch([port.fast_query_spec(parse_query(q)) for q in queries], 20)
    for i, (r, p) in enumerate(zip(ref_out, port_out)):
        _assert_same(r, p, path, f"batch[{i}]/{path}")


def test_fused_refusal_goes_to_merge(searchers, monkeypatch):
    """A conjunction with a tail term is refused by the fused path and
    served by the merge path, as in the reference."""
    _ref, port = searchers
    monkeypatch.setenv("NRT_FAST_PATH", "fused")
    view = port.packed_view("body")
    before = dict(view.path_counts)
    port.search(parse_query(QUERIES["must_tail"]), 10)
    port.search(parse_query(QUERIES["or_mixed"]), 10)
    assert view.path_counts["merge"] == before["merge"] + 1
    assert view.path_counts["fused"] == before["fused"] + 1


def test_unported_shapes_raise(searchers):
    _ref, port = searchers
    node = parse_query({"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": QUERIES["or_head"]}]}})
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        port.search(node, 10)


def test_port_ingest_matches_reference_segments(waves, searchers):
    """The port's IndexWriter builds the same postings, freqs, quantized
    lengths and stats per segment as the reference (compared per term: the
    two builders may number terms differently)."""
    ref, _port = searchers
    writer = PortWriter(_field_defs(), "cpu")
    for wave in waves:
        writer.add_documents([dict(d) for d in wave])
        writer.refresh()
    segs = writer.segments
    assert len(segs) == len(ref.segments)
    for rs, ps in zip(ref.segments, segs):
        rt, pt = rs.fields["body"], ps.fields["body"]
        assert (ps.num_docs, ps.capacity) == (rs.num_docs, rs.capacity)
        assert set(pt.terms) == set(rt.terms)
        assert (pt.sum_doc_lens, pt.doc_count, pt.postings_len) == (
            rt.sum_doc_lens, rt.doc_count, rt.postings_len)
        np.testing.assert_array_equal(pt.doc_lens.numpy(), np.asarray(rt.doc_lens))
        r_docs, r_freqs = np.asarray(rt.doc_ids), np.asarray(rt.freqs)
        p_docs, p_freqs = pt.doc_ids.numpy(), pt.freqs.numpy()
        for term in rt.terms:
            ro, rl = rt.lookup(term)
            po, pl = pt.lookup(term)
            assert pl == rl, term
            np.testing.assert_array_equal(p_docs[po : po + pl], r_docs[ro : ro + rl])
            np.testing.assert_array_equal(p_freqs[po : po + pl], r_freqs[ro : ro + rl])
        assert [r.get("id") for r in ps.stored] == [r.get("id") for r in rs.stored]


def test_port_writer_refuses_unported_operations():
    writer = PortWriter(_field_defs(), "cpu")
    writer.add_documents([{"id": "1", "body": "common alpha"}])
    with pytest.raises(NotImplementedError):
        writer.add_documents([{"id": "1", "body": "common beta"}])
    with pytest.raises(NotImplementedError):
        writer.delete_by_id(["1"])
    fds = {**_field_defs(), "n": create_field_def("n", {"type": "INT", "storeDocValues": True})}
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        PortWriter(fds, "cpu").add_documents([{"n": "3"}])


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card refusal cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        PortWriter(_field_defs(), "cuda")


def test_synthetic_corpus_matches_reference():
    from nrtsearch_tpu.models.flagship import SyntheticCorpus as RefCorpus
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    ref, port = RefCorpus(3000, 800, 16, seed=3), SyntheticCorpus(3000, 800, 16, seed=3)
    for name in ("post_docs", "post_freqs", "term_offsets", "term_lengths", "doc_lens"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    assert port.sample_queries(4, 4) == ref.sample_queries(4, 4)


@pytest.mark.parametrize("path", ["merge", "fused"])
def test_synthetic_segments_against_exact_numpy(monkeypatch, path):
    """SyntheticCorpus cut into doc-range segments and searched on the port
    equals the corpus's independent numpy BM25: scores within 1e-5 relative
    (numpy sums terms in another order; fused also carries its bf16/Dekker
    head contract at ~1e-6), docs equal except at such near-ties, hits
    exact on the merge path and a lower bound when the fused path says so."""
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    monkeypatch.setenv("NRT_FAST_PATH", path)
    corpus = SyntheticCorpus(60_000, 4_000, 24, seed=7)
    segs = [segment_from_numpy(a, "cpu") for a in corpus.segment_arrays(3)]
    searcher = PortSearcher(segs, {"body": create_field_def("body", {"type": "TEXT", "search": True})})
    queries = corpus.sample_queries(6, 4)
    for q in queries:
        td = searcher.search(parse_query({"matchQuery": {"field": "body", "query": " ".join(q)}}), 20)
        s, d, total = corpus.exact_topk(q, 20)
        docs, scores = _hits(td)
        np.testing.assert_allclose(scores, s, rtol=1e-5)
        for i, (a, b) in enumerate(zip(docs, d)):
            assert a == b or abs(scores[i] - s[i]) <= 1e-5 * s[i], (q, i)
        if td.relation == "EQUAL_TO":
            assert td.total_hits == total
        else:
            assert td.total_hits <= total
    assert searcher.packed_view("body").path_counts["fused" if path == "fused" else "merge"] > 0
