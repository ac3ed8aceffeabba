"""Term positions and positional queries on the port vs the JAX reference,
on the CPU.

``ops.phrase`` is held to the reference's ``ops/phrase.py`` (its jitted
program on the CPU) on the same segment: ``run_phrase`` freqs and padded
candidates equal, ``phrase_scatter`` scores bit-equal (``SCORE_ULPS`` = 0:
the port keeps XLA's order of f32 ops and its fused multiply-add) and
matches equal; and to the port's own host loop (``_phrase_freq``),
freqs equal. Then each package's ``IndexWriter`` builds an index from the
same documents (three segments, a multi-valued field, a price column) and
both ``Searcher.search`` answer phrase, match-phrase, phrase-prefix,
multi-match PHRASE_PREFIX and span-near queries (in order or not, nested
near groups), a phrase beside BM25 clauses and a filter, and a phrase
across the multi-valued gap: the same hits in the same order, the same
totals, bit-equal scores.
A commit carries the positions both ways, and phrase answers stay the
reference's after a merge and after a delete. ``SyntheticCorpus`` keeps
its postings with ``keep_positions`` and its exact phrases match their
source docs.
"""

import dataclasses

import numpy as np
import pytest

from nrtsearch_tpu.core.directory import commit_segments as ref_commit, open_commit as ref_open
from nrtsearch_tpu.core.merge import merge_segments as ref_merge
from nrtsearch_tpu.core.searcher import Searcher as RefSearcher
from nrtsearch_tpu.core.writer import IndexWriter as RefWriter
from nrtsearch_tpu.ops import phrase as ref_phrase
from nrtsearch_tpu.query.plan import parse_query as ref_parse_query
from nrtsearch_tpu.schema.fields import create_field_def as ref_create_field_def
from nrtsearch_tpu_torch.core.directory import commit_segments, open_commit
from nrtsearch_tpu_torch.core.merge import merge_segments
from nrtsearch_tpu_torch.core.searcher import Searcher
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.ops import phrase as phrase_ops
from nrtsearch_tpu_torch.query import eval as qeval
from nrtsearch_tpu_torch.query import parse_query
from nrtsearch_tpu_torch.schema import create_field_def
from torch_positional_data import (
    OPS_CASES, PHRASE_QUERIES, SPECS, build, candidates, phrase_docs, ulps,
)

SCORE_ULPS = 0


def _fields(create):
    return {name: create(name, spec) for name, spec in SPECS.items()}


@pytest.fixture(scope="module")
def indexes():
    """(reference writer, port writer), each over the same three segments."""
    docs = phrase_docs()
    ref = RefWriter(_fields(ref_create_field_def), merge_factor=100)
    port = IndexWriter(_fields(create_field_def), "cpu", merge_factor=100)
    build(ref, docs)
    build(port, docs)
    assert len(ref.segments) == len(port.segments) == 3
    return ref, port


def _searchers(ref_segs, port_segs):
    return (RefSearcher(ref_segs, _fields(ref_create_field_def), version=1),
            Searcher(port_segs, _fields(create_field_def)))


def assert_same(want, got, ctx=""):
    """Hits, order and totals equal; scores within SCORE_ULPS f32 ulps."""
    assert [h.global_ord for h in got.hits] == [h.global_ord for h in want.hits], ctx
    assert (got.total_hits, got.relation) == (want.total_hits, want.relation), ctx
    diff = ulps([h.score for h in got.hits], [h.score for h in want.hits])
    assert diff.max(initial=0) <= SCORE_ULPS, (ctx, diff)


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
@pytest.mark.parametrize("name", sorted(PHRASE_QUERIES))
def test_query_matches_reference(indexes, monkeypatch, name, compiled):
    monkeypatch.setenv("NRT_COMPILED_EVAL", "1" if compiled else "0")
    ref, port = _searchers(indexes[0].segments, indexes[1].segments)
    q = PHRASE_QUERIES[name]
    want = ref.search(ref_parse_query(q), top_hits=50)
    got = port.search(parse_query(q), top_hits=50)
    if name not in ("phrase_absent", "phrase_prefix_none"):
        assert want.total_hits > 0, name
    assert_same(want, got, name)


def test_multivalued_gap_is_not_a_phrase(indexes):
    """Positions of a multi-valued field's values lie POSITION_GAP apart: a
    phrase spanning two values does not match (doc built for it here)."""
    port_fds = _fields(create_field_def)
    w = IndexWriter(port_fds, "cpu")
    w.add_documents([{"id": "a", "mv": ["beta delta", "alpha gamma"]},
                     {"id": "b", "mv": ["beta delta alpha"]}])
    port = Searcher(w.refresh(), port_fds)
    td = port.search(parse_query(PHRASE_QUERIES["multivalued_gap"]), 10)
    assert [h.global_ord for h in td.hits] == [1]
    tfi = port.segments[0].fields["mv"]
    assert tfi.positions_of("alpha", 0).tolist() == [2 + w._builder.POSITION_GAP]


def test_positions_equal_reference(indexes):
    """Per term and doc, each segment's positions equal the reference's
    (the two builders may number terms differently)."""
    ref, port = indexes
    for rs, ps in zip(ref.segments, port.segments):
        for field in ("t", "mv"):
            rt, pt = rs.fields[field], ps.fields[field]
            assert set(pt.terms) == set(rt.terms)
            assert len(pt.positions) == len(rt.positions)
            for term in rt.terms:
                ro, rl = rt.lookup(term)
                po, pl = pt.lookup(term)
                assert rl == pl
                np.testing.assert_array_equal(
                    pt.positions[pt.position_offsets[po]:pt.position_offsets[po + pl]],
                    rt.positions[rt.position_offsets[ro]:rt.position_offsets[ro + rl]])


# -- ops.phrase against the reference's ops/phrase.py -------------------------

@pytest.mark.parametrize("cands", ["all", "doc0_and_pads"])
@pytest.mark.parametrize("case", sorted(OPS_CASES))
def test_ops_match_reference(indexes, case, cands):
    terms, req, slop, exp, exp_req = OPS_CASES[case]
    ref, port = indexes
    for rs, ps in zip(ref.segments, port.segments):
        cand_ids = candidates(ps, cands)
        rres = ref_phrase.run_phrase(rs.fields["t"], cand_ids, terms, req, slop,
                                     expansions=list(exp), exp_req=exp_req)
        pres = phrase_ops.run_phrase(ps.fields["t"], cand_ids, terms, req, slop,
                                     expansions=list(exp), exp_req=exp_req)
        np.testing.assert_array_equal(pres[0].numpy(), np.asarray(rres[0]), err_msg=case)
        np.testing.assert_array_equal(pres[1].numpy(), rres[1], err_msg=case)
        args = (1.7, 1.25, 1.2, 0.75, 13.37)
        want_s, want_m = ref_phrase.phrase_scatter(
            rres[0], np.asarray(rres[1]), rs.fields["t"].doc_lens,
            *(np.float32(x) for x in args))
        got_s, got_m = phrase_ops.phrase_scatter(*pres, ps.fields["t"].doc_lens, *args)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m), err_msg=case)
        assert ulps(got_s.numpy(), want_s).max() <= SCORE_ULPS, case
        if cands == "doc0_and_pads" and case == "exact2":
            # doc 0's own value survives the pads' scatter
            assert got_s[0].item() == float(np.asarray(want_s)[0])


@pytest.mark.parametrize("case", sorted(OPS_CASES))
def test_device_path_matches_host_loop(indexes, case):
    """The port's ``run_phrase`` against its own host loop, every doc."""
    terms, req, slop, exp, exp_req = OPS_CASES[case]
    for seg in indexes[1].segments:
        tfi = seg.fields["t"]
        cand_ids = np.arange(seg.num_docs)
        freqs = phrase_ops.run_phrase(tfi, cand_ids, terms, req, slop, expansions=list(exp),
                                      exp_req=exp_req)[0].numpy()[: seg.num_docs]
        host = np.zeros(seg.num_docs, np.int32)
        for doc in cand_ids:
            plists = [tfi.positions_of(t, int(doc)) for t in terms]
            if exp:
                found = [tfi.positions_of(t, int(doc)) for t in exp if t in tfi.terms]
                if not found:
                    continue
                plists.append(np.unique(np.concatenate(found)))
            host[doc] = qeval._phrase_freq(plists, list(req) + ([exp_req] if exp else []), slop)
        np.testing.assert_array_equal(freqs, host, err_msg=case)
        if case == "exact2":
            assert freqs.sum() > 0


def test_device_positions_refuse_wide_offsets(indexes):
    """int32 offsets on the device: a field with more than 2^31 - 1
    positions raises rather than wraps."""
    tfi = indexes[1].segments[0].fields["t"]
    offs = tfi.position_offsets.copy()
    offs[-1] = 2**31
    wide = dataclasses.replace(tfi, position_offsets=offs)
    with pytest.raises(ValueError, match="positions"):
        phrase_ops.device_positions(wide)


def test_phrase_queries_take_the_device_path(indexes):
    """Phrase and phrase-prefix queries with a fixed term are verified by
    ``ops.phrase``, as the reference's default path does; a one-term
    phrase-prefix has no anchor and takes the host loop in both."""
    port = _searchers(indexes[0].segments, indexes[1].segments)[1]
    before = dict(qeval.PHRASE_PATHS)
    for name in ("phrase2", "phrase_sloppy3", "match_phrase", "phrase_prefix"):
        port.search(parse_query(PHRASE_QUERIES[name]), 10)
    assert qeval.PHRASE_PATHS["device"] == before["device"] + 4 * 3
    assert qeval.PHRASE_PATHS["host"] == before["host"]
    port.search(parse_query(PHRASE_QUERIES["phrase_prefix_one"]), 10)
    assert qeval.PHRASE_PATHS["host"] == before["host"] + 3


# -- the on-disk index, merges and deletes ------------------------------------


def _phrase_answers(ref_segs, port_segs, names=("phrase2", "phrase_sloppy1", "match_phrase",
                                                "phrase_prefix", "span_nested")):
    ref, port = _searchers(ref_segs, port_segs)
    for name in names:
        q = PHRASE_QUERIES[name]
        assert_same(ref.search(ref_parse_query(q), 50), port.search(parse_query(q), 50), name)


@pytest.mark.parametrize("writer_side", ["reference", "port"])
def test_commit_carries_positions_both_ways(indexes, tmp_path, writer_side):
    ref, port = indexes
    if writer_side == "reference":
        ref_commit(ref.segments, tmp_path, gen=1, version=1)
        _m, opened = open_commit(tmp_path, "cpu")
        ref_segs, port_segs, ours = ref.segments, opened, opened
    else:
        commit_segments(port.segments, tmp_path, gen=1, version=1)
        _m, opened = ref_open(tmp_path)
        ref_segs, port_segs, ours = opened, port.segments, port.segments
    theirs = ref_segs if writer_side == "reference" else opened
    for a, b in zip(theirs, ours):
        for field in ("t", "mv"):
            np.testing.assert_array_equal(np.asarray(a.fields[field].positions),
                                          b.fields[field].positions)
            np.testing.assert_array_equal(np.asarray(a.fields[field].position_offsets),
                                          b.fields[field].position_offsets)
    _phrase_answers(ref_segs, port_segs)


def test_phrases_after_merge_and_delete(indexes):
    ref, port = indexes
    ref_fds, port_fds = _fields(ref_create_field_def), _fields(create_field_def)
    deleted = np.arange(0, 120, 7)
    ref_segs = [ref.segments[0].with_deletes(deleted)] + ref.segments[1:]
    port_segs = [port.segments[0].with_deletes(deleted)] + port.segments[1:]
    _phrase_answers(ref_segs, port_segs)
    ref_m, _ = ref_merge(ref_segs, ref_fds)
    port_m, _ = merge_segments(port_segs, port_fds)
    assert list(port_m.fields["t"].terms) == list(ref_m.fields["t"].terms)
    np.testing.assert_array_equal(port_m.fields["t"].positions, ref_m.fields["t"].positions)
    np.testing.assert_array_equal(port_m.fields["t"].position_offsets,
                                  ref_m.fields["t"].position_offsets)
    _phrase_answers([ref_m], [port_m])


# -- the synthetic corpus' positions ------------------------------------------


def test_synthetic_positions_keep_postings_and_match_phrases():
    from nrtsearch_tpu_torch.convert import segment_from_numpy
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    plain = SyntheticCorpus(1500, 300, 12, seed=5)
    kept = SyntheticCorpus(1500, 300, 12, seed=5, keep_positions=True)
    np.testing.assert_array_equal(plain.post_docs, kept.post_docs)
    np.testing.assert_array_equal(plain.post_freqs, kept.post_freqs)
    np.testing.assert_array_equal(plain.doc_lens, kept.doc_lens)
    arrays = kept.segment_arrays(2)
    for a, b in zip(plain.segment_arrays(2), arrays):
        for key in ("offsets", "lengths", "doc_ids", "freqs", "doc_lens"):
            np.testing.assert_array_equal(a[key], b[key])
        assert "positions" not in a
        np.testing.assert_array_equal(np.diff(b["position_offsets"]),
                                      b["freqs"][: b["postings_len"]].astype(np.int64))
    segs = [segment_from_numpy(a, "cpu") for a in arrays]
    fds = {"body": create_field_def("body", {"type": "TEXT", "search": True})}
    searcher = Searcher(segs, fds)
    rng = np.random.default_rng(9)
    starts = kept.doc_starts
    for doc in rng.choice(kept.num_docs, 12, replace=False):
        for n in (2, 3):
            off = int(rng.integers(0, starts[doc + 1] - starts[doc] - n + 1))
            toks = kept.tokens[starts[doc] + off : starts[doc] + off + n]
            td = searcher.search(parse_query({"phraseQuery": {
                "field": "body", "terms": [str(t) for t in toks]}}), 2000)
            assert int(doc) in {h.global_ord for h in td.hits}, (doc, toks)


def test_match_phrase_highlights_consecutive_positions_only():
    """A match-phrase's highlight marks its terms only where they stand at
    consecutive positions, as the reference's highlighter does (the served
    request over gRPC is in tests/test_torch_nested.py)."""
    from nrtsearch_tpu.search import highlight as ref_hl
    from nrtsearch_tpu_torch.search import highlight as hl

    text = "green tea and a garden, then the green garden gate, green old garden"
    q = {"matchPhraseQuery": {"field": "t", "query": "green garden"}}
    got = hl.highlight_text(text, hl.build_highlight_query(parse_query(q), "t"),
                            hl.HighlightSettings(pre_tag="<b>", post_tag="</b>"))
    want = ref_hl.highlight_text(text, ref_hl.build_highlight_query(ref_parse_query(q), "t"),
                                 ref_hl.HighlightSettings(pre_tag="<b>", post_tag="</b>"))
    assert got == want
    marked = "".join(got)
    assert marked.count("<b>") == 1 and "<b>green garden</b>" in marked, got
