"""Virtual shards: the port's mesh (parallel/distributed.py) against the
reference's, on the CPU.

The reference runs its (4, 2) ``eight_device_mesh`` over 8 virtual host
devices (tests/conftest.py); the port lays the same (4, 2) grid over
``[cpu] * 8``. The inputs are those of tests/test_distributed.py, fed to
both packages: one seeded corpus object, and indexes that both writers build
from one dict spec. Tolerances:

- repartitioned postings and impacts: bit-equal (the same numpy);
- the merge mesh: docs, order and hits equal, scores bit-equal (each shard
  is the merge path, whose f32 additions keep the reference's order);
- the dense mesh: hits equal, scores within 1e-6 relative (torch and XLA
  sum the f32 head products in different orders, tests/test_torch_slice.py),
  docs equal but at such near-ties; the reference test's own bounds against
  the merge mesh hold as well;
- filtered, sorted and faceted: ids, keys, hits and facet counts equal;
- kNN: scores within 1e-5 relative, ids equal but at score ties.
"""

import random

import numpy as np
import pytest
import torch

from nrtsearch_tpu.parallel import distributed as ref_dist
from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus
from nrtsearch_tpu_torch.parallel import distributed as dist_mod

CPU8 = [torch.device("cpu")] * 8
K = 10


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_mesh():
    return dist_mod.make_search_mesh(8, devices=CPU8)


def _assert_merge_equal(port_out, ref_out, ctx=""):
    ps, pi, ph = (_np(x) for x in port_out)
    rs, ri, rh = (_np(x) for x in ref_out)
    np.testing.assert_array_equal(ph, rh, err_msg=ctx)
    np.testing.assert_array_equal(ps.view(np.int32), rs.view(np.int32), err_msg=ctx)
    valid = rs > -np.inf
    np.testing.assert_array_equal(pi[valid], ri[valid], err_msg=ctx)


def _assert_fused_close(port_out, ref_out, rel=1e-6, ctx=""):
    ps, pi, ph = (_np(x) for x in port_out)
    rs, ri, rh = (_np(x) for x in ref_out)
    np.testing.assert_array_equal(ph, rh, err_msg=ctx)
    np.testing.assert_array_equal(ps > -np.inf, rs > -np.inf, err_msg=ctx)
    valid = rs > -np.inf
    np.testing.assert_allclose(ps[valid], rs[valid], rtol=rel, err_msg=ctx)
    swap = valid & (pi != ri)
    near = np.abs(ps - rs) <= 2 * rel * np.abs(rs)
    assert (~swap | near).all(), ctx


@pytest.fixture(scope="module")
def corpus():
    return SyntheticCorpus(num_docs=2000, vocab_size=800, avg_doc_len=24, seed=7)


@pytest.fixture(scope="module")
def meshes(corpus, eight_device_mesh):
    """The reference's and the port's DistributedBM25.build on one corpus."""
    return (ref_dist.DistributedBM25.build(corpus, eight_device_mesh),
            dist_mod.DistributedBM25.build(corpus, _port_mesh()))


@pytest.fixture(scope="module")
def queries(corpus):
    return [[int(t) for t in q] for q in corpus.sample_queries(8, 3)]


@pytest.mark.parametrize("n,data", [(8, None), (6, None), (4, 1), (3, None), (1, None)])
def test_mesh_shape_rule(n, data):
    """make_search_mesh: (n / data, data) with data = 2 for an even n > 1."""
    mesh = dist_mod.make_search_mesh(n, data_parallel=data, devices=CPU8)
    want_data = data or (2 if n % 2 == 0 and n > 1 else 1)
    assert mesh.shape == {"shard": n // want_data, "data": want_data}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_search_devices_default_is_cpu_here():
    from nrtsearch_tpu_torch.device import search_devices

    if not torch.cuda.is_available():
        assert search_devices() == [torch.device("cpu")]


def test_repartition_bit_equal(meshes):
    ref, port = meshes
    np.testing.assert_array_equal(port.post_docs_host, np.asarray(ref.post_docs))
    np.testing.assert_array_equal(port.post_impacts_host.view(np.int32),
                                  np.asarray(ref.post_impacts).view(np.int32))
    np.testing.assert_array_equal(port.term_offsets_host, ref.term_offsets_host)
    np.testing.assert_array_equal(port.term_lengths_host, ref.term_lengths_host)
    np.testing.assert_array_equal(port.doc_freq_global, ref.doc_freq_global)
    assert port.shard_capacity == ref.shard_capacity


def test_merge_mesh_matches_reference(meshes, queries):
    ref, port = meshes
    planned = port.compile_queries(queries, max_terms=4)
    ref_planned = ref.compile_queries(queries, max_terms=4)
    for a, b in zip(planned, ref_planned):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    offs, lens, w, n_terms, run_len = planned
    out = port.search(offs, lens, w, n_terms, run_len=run_len, k=K)
    _assert_merge_equal(out, ref.search(offs, lens, w, n_terms, run_len=run_len, k=K))
    assert all(t.device == torch.device("cpu") for t in out)


@pytest.mark.parametrize("case", ["bf16", "residual", "tail_only"])
def test_dense_mesh_matches_reference(meshes, queries, case):
    """The fused mesh (each shard's bf16 head rows, kernel #1's function)
    against the reference's, and against the port's merge mesh under the
    reference test's bounds (6e-3 bf16, 5e-5 with residual rows, 1e-6
    tail-only)."""
    ref, port = meshes
    max_rows = 16 if case == "tail_only" else 32
    residual = case == "residual"
    H = port.attach_dense(max_rows=max_rows, min_df=100, residual=residual)
    assert H == ref.attach_dense(max_rows=max_rows, min_df=100, residual=residual) > 0
    assert (port.dense_rows_lo is not None) == residual
    np.testing.assert_array_equal(
        port.dense_rows[1][0].float().numpy(),
        np.asarray(ref.dense_rows[1], np.float32))
    qs = queries
    if case == "tail_only":
        tail = [t for t in range(400, 800) if 0 < port.doc_freq_global[t] < port.dense_min_df]
        qs = [tail[i * 3 : i * 3 + 3] for i in range(4)]
    compiled = port.compile_dense_queries(qs, max_terms=4)
    for a, b in zip(compiled, ref.compile_dense_queries(qs, max_terms=4)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    W, row_idx, n_req, r_offs, r_lens, r_w, drun_len, has_head, has_tail = compiled
    kw = dict(run_len=drun_len, k=K, has_head=True if case == "tail_only" else has_head,
              has_tail=has_tail)
    got = port.search_dense(W, row_idx, n_req, r_offs, r_lens, r_w, **kw)
    _assert_fused_close(got, ref.search_dense(W, row_idx, n_req, r_offs, r_lens, r_w, **kw),
                        ctx=case)
    offs, lens, w, n_terms, run_len = port.compile_queries(qs, max_terms=4)
    s0, d0, h0 = (_np(x) for x in port.search(offs, lens, w, n_terms, run_len=run_len, k=K))
    s1, d1, h1 = (_np(x) for x in got)
    np.testing.assert_array_equal(h1, h0)
    bound = {"bf16": 6e-3, "residual": 5e-5, "tail_only": 1e-6}[case]
    valid = s0 > -np.inf
    np.testing.assert_array_equal(s1 > -np.inf, valid)
    np.testing.assert_allclose(s1[valid], s0[valid], rtol=bound)
    assert (d1[~valid] == -1).all()


def _two_indexes(fields: dict, docs_of, n_segments: int, deleted=()):
    """The reference's and the port's Searcher over the same documents, one
    refresh per segment, the ids ``deleted`` deleted before the last one."""
    from nrtsearch_tpu.core.searcher import Searcher as RefSearcher
    from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
    from nrtsearch_tpu.schema.fields import create_field_def as ref_create
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.schema import create_field_def

    ref = RefWriter({n: ref_create(n, sp) for n, sp in fields.items()}, merge_factor=100)
    port = IndexWriter({n: create_field_def(n, sp) for n, sp in fields.items()}, "cpu",
                       merge_factor=100)
    for seg in range(n_segments):
        docs = docs_of(seg)
        ref.add_documents(docs)
        port.add_documents(docs)
        if seg == n_segments - 1 and deleted:
            ref.delete_by_id(deleted)
            port.delete_by_id(deleted)
        ref.refresh()
        port.refresh()
    return (RefSearcher(ref.segments, ref.field_defs, version=1),
            Searcher(port.segments, port.field_defs, version=1))


def test_from_searcher_matches_reference(eight_device_mesh):
    """A 3-segment index with deletes placed on both meshes: the same
    repartition, the same answers, and answers equal to the port's own
    unsharded search within 2e-5 (tests/test_distributed.py)."""
    from nrtsearch_tpu_torch.query import parse_query

    rng = random.Random(5)
    words = [f"w{i}" for i in range(30)]
    fields = {"id": {"type": "_ID", "store": True}, "t": {"type": "TEXT", "search": True}}
    ref_s, port_s = _two_indexes(fields, lambda seg: [
        {"id": str(seg * 100 + i), "t": " ".join(rng.choices(words, k=8))}
        for i in range(100)], 3, deleted=[str(i) for i in range(0, 200, 7)])
    assert not port_s.segments[0].host_live.all()
    ref = ref_dist.DistributedBM25.from_searcher(ref_s, "t", eight_device_mesh)
    port = dist_mod.DistributedBM25.from_searcher(port_s, "t", _port_mesh())
    assert port.vocab == ref.vocab
    np.testing.assert_array_equal(port.post_docs_host, np.asarray(ref.post_docs))
    np.testing.assert_array_equal(port.post_impacts_host.view(np.int32),
                                  np.asarray(ref.post_impacts).view(np.int32))
    queries = [[rng.choice(words) for _ in range(3)] for _ in range(8)]
    planned = port.compile_text_queries(queries)
    offs, lens, w, n_terms, run_len = planned
    got = port.search(offs, lens, w, n_terms, run_len=run_len, k=6)
    _assert_merge_equal(got, ref.search(offs, lens, w, n_terms, run_len=run_len, k=6))
    scores, ids, hits = (_np(x) for x in got)
    for qi, qterms in enumerate(queries):
        td = port_s.search(parse_query({"matchQuery": {"field": "t",
                                                       "query": " ".join(qterms)}}), 6)
        assert int(hits[qi]) == td.total_hits
        np.testing.assert_allclose(scores[qi][: len(td.hits)], [h.score for h in td.hits],
                                   rtol=2e-5)


@pytest.fixture(scope="module")
def general_indexes():
    rng = random.Random(11)
    words = [f"w{i}" for i in range(25)]
    colors = ["red", "green", "blue", "teal"]
    fields = {
        "id": {"type": "_ID", "storeDocValues": True},
        "t": {"type": "TEXT", "search": True},
        "price": {"type": "INT", "storeDocValues": True, "sort": True},
        "color": {"type": "ATOM", "storeDocValues": True, "search": True},
        "size": {"type": "ATOM", "storeDocValues": True},
    }
    return _two_indexes(fields, lambda seg: [
        {"id": str(seg * 80 + i), "t": " ".join(rng.choices(words, k=6)),
         "price": (seg * 80 + i) * 7 % 997, "color": rng.choice(colors),
         "size": rng.choice(["s", "m", "l", "xl"])}
        for i in range(80)], 3), words


@pytest.mark.parametrize("case", ["filter_sort_facet", "ordinal_filter_multi_facet"])
def test_search_general_matches_reference(general_indexes, eight_device_mesh, case):
    """Filters, a doc-value sort and facets over both meshes: equal ids,
    keys, hits and facet counts; and the port's mesh equal to its own
    unsharded Searcher (hits and sorted ids)."""
    from nrtsearch_tpu_torch.core.searcher import SortSpec
    from nrtsearch_tpu_torch.query import parse_query

    (ref_s, port_s), words = general_indexes
    ref = ref_dist.DistributedBM25.from_searcher(ref_s, "t", eight_device_mesh)
    port = dist_mod.DistributedBM25.from_searcher(port_s, "t", _port_mesh())
    cols = ["price", "color", "size"]
    ref.attach_columns(ref_s, cols)
    port.attach_columns(port_s, cols)
    for f in cols:
        for key in ("values", "present"):
            np.testing.assert_array_equal(
                np.stack([port.columns[f][key][s][0].numpy() for s in range(4)]),
                np.asarray(ref.columns[f][key]))
    rng = random.Random(23 if case.startswith("ordinal") else 17)
    queries = [[rng.choice(words) for _ in range(3)] for _ in range(4)]
    offs, lens, w, n_terms, run_len = port.compile_text_queries(queries)
    if case == "filter_sort_facet":
        kw = dict(filters=[("price", "<=", 600.0)], sort=("price", True, False),
                  facet_fields=["color"])
        clause = {"rangeQuery": {"field": "price", "upper": "600"}}
        sort = SortSpec(field="price", reverse=False)
    else:
        kw = dict(filters=[("color", "ord==", "red")], facet_fields=["color", "size"])
        clause = {"termQuery": {"field": "color", "textValue": "red"}}
        sort = None
    k = 8
    got = port.search_general(offs, lens, w, n_terms, run_len=run_len, k=k, **kw)
    want = ref.search_general(offs, lens, w, n_terms, run_len=run_len, k=k, **kw)
    _assert_merge_equal(got[:3], want[:3], ctx=case)
    assert got[3].keys() == want[3].keys()
    for f in got[3]:
        np.testing.assert_array_equal(got[3][f], want[3][f])
        assert port.facet_labels(f) == ref.facet_labels(f)
    scores, ids, hits = (_np(x) for x in got[:3])
    for qi, qterms in enumerate(queries):
        node = parse_query({"booleanQuery": {"clauses": [
            {"occur": "MUST", "query": {"matchQuery": {"field": "t",
                                                       "query": " ".join(qterms)}}},
            {"occur": "FILTER", "query": clause}]}})
        td = port_s.search(node, k, sort=sort)
        assert int(hits[qi]) == td.total_hits, qi
        if sort is not None:
            assert ids[qi][scores[qi] > -np.inf].tolist() == [h.global_ord for h in td.hits]


def test_distributed_knn_matches_reference():
    """Mesh kNN over contiguous shard blocks, both packages on one input."""
    rng = np.random.default_rng(3)
    N, dims, B = 1000, 16, 6
    vecs = rng.normal(size=(N, dims)).astype(np.float32)
    queries = rng.normal(size=(B, dims)).astype(np.float32)
    mask = rng.random(N) > 0.1
    ref = ref_dist.DistributedKNN.from_vectors(vecs, ref_dist.make_search_mesh(8), mask=mask,
                                               similarity="cosine")
    port = dist_mod.DistributedKNN.from_vectors(vecs, _port_mesh(), mask=mask,
                                                similarity="cosine")
    assert port.shard_capacity == ref.shard_capacity
    ps, pi = (_np(x) for x in port.search(queries, k=K))
    rs, ri = (_np(x) for x in ref.search(queries, k=K))
    np.testing.assert_allclose(ps, rs, rtol=1e-5, atol=1e-6)
    assert (mask[pi]).all()
    for b in range(B):
        assert ((pi[b] == ri[b]) | np.isclose(ps[b], rs[b], rtol=1e-5)).all()
