"""The plain reference: BM25 worked by hand on a hand-made corpus, its
SmallFloat copy against the program's, and the program against it at a
tiny size on the CPU."""

import math

import numpy as np
import pytest
import torch

from portbench import smallfloat
from portbench.generate import Corpus
from portbench.harness import run_cell
from portbench.kinds import bm25
from portbench.reference import Reference


def _hand_corpus() -> Corpus:
    # 4 docs of lengths 3, 5, 2, 6; term 0 in docs 0 (tf 2) and 2 (tf 1),
    # term 1 in docs 1 (tf 1) and 3 (tf 3), term 2 in doc 3 (tf 1)
    return Corpus(
        num_docs=4, vocab_size=3,
        post_docs=torch.tensor([0, 2, 1, 3, 3], dtype=torch.int32),
        post_freqs=torch.tensor([2, 1, 1, 3, 1], dtype=torch.float32),
        doc_lens=torch.tensor([3, 5, 2, 6]),
        term_offsets=np.array([0, 2, 4]), term_lengths=np.array([2, 2, 1]),
    )


def _bm25(tf, dl, avgdl, df, n, k1=1.2, b=0.75):
    idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
    return idf * tf / (tf + k1 * (1 - b + b * dl / avgdl))


def test_scores_by_hand():
    ref = Reference(_hand_corpus(), k1=1.2, b=0.75, quantized_norms=False)
    avgdl = 16 / 4
    dense, matched = ref.dense(np.array([[0, 1], [2, 2]]))
    want0 = [_bm25(2, 3, avgdl, 2, 4), _bm25(1, 5, avgdl, 2, 4), _bm25(1, 2, avgdl, 2, 4),
             _bm25(3, 6, avgdl, 2, 4)]
    assert np.allclose(dense[0].numpy(), want0, rtol=1e-15)
    # a repeated token counts twice; docs without the term do not match
    assert dense[1, 3].item() == pytest.approx(2 * _bm25(1, 6, avgdl, 1, 4), rel=1e-15)
    assert matched[1].tolist() == [False, False, False, True]
    scores, docs, hits = ref.topk(dense, matched, 3)
    assert docs[0].tolist() == list(np.argsort(-np.array(want0), kind="stable")[:3])
    assert hits.tolist() == [4, 1] and docs[1].tolist() == [3, -1, -1]
    assert np.isneginf(scores[1, 1:]).all()


def test_ties_break_to_the_lower_doc():
    c = _hand_corpus()
    c.doc_lens = torch.tensor([4, 4, 4, 4])
    c.post_freqs = torch.tensor([1, 1, 1, 1, 1], dtype=torch.float32)
    ref = Reference(c, k1=1.2, b=0.75, quantized_norms=False)
    dense, matched = ref.dense(np.array([[0, 1]]))
    _s, docs, _h = ref.topk(dense, matched, 4)
    assert docs[0].tolist() == [0, 1, 2, 3]


def test_quantum_and_coarse_control():
    ref = Reference(_hand_corpus(), k1=1.2, b=0.75, quantized_norms=False)
    top = ref.idf(1) * ref.max_impact(1) + 2 * ref.idf(2) * ref.max_impact(2)
    assert ref.quantum([1, 2, 2]) == pytest.approx(top / 32000)
    low = Reference(_hand_corpus(), k1=1.2, b=0.75, quantized_norms=False, qmax=127)
    dense, matched = low.dense(np.array([[1, 2, 2]]))
    exact, _ = ref.dense(np.array([[1, 2, 2]]))
    unit = top / 127
    assert np.all(np.abs(dense[0].numpy() - exact[0].numpy()) <= 3 * unit)


def test_the_kind_builds_the_configured_reference():
    cfg = {"bm25": {"k1": 1.2, "b": 0.75, "quantized_norms": False}}
    q = np.array([[0, 1], [2, 2]])
    want, _ = Reference(_hand_corpus(), k1=1.2, b=0.75, quantized_norms=False).dense(q)
    got, _ = bm25.Reference(_hand_corpus(), cfg).dense(q)
    assert torch.equal(got, want)
    # the traffic's control: a lower precision, or the quantized algorithm
    assert bm25.Reference(_hand_corpus(), cfg, {"dtype": "bfloat16"}).dtype == torch.bfloat16
    assert bm25.Reference(_hand_corpus(), cfg, {"qmax": 127}).qmax == 127


def test_smallfloat_copy_matches_the_program():
    from nrtsearch_tpu_torch.utils.smallfloat import quantize_length

    n = np.concatenate([np.arange(0, 5000), np.random.default_rng(0).integers(0, 2**31, 5000)])
    assert np.array_equal(smallfloat.quantize_length(n), quantize_length(n))


@pytest.mark.parametrize("cell", ["node-8m.text-b32", "batch-8m.search-b32",
                                  "batch-8m.bucket-b32"])
def test_program_agrees_with_the_reference(cell, cpu, tiny):
    result, lines = run_cell(cell, 77, 0.5, False, cpu, tiny(cell))
    assert result["correct"], lines
    gap = result["check"].get("score_gap", result["check"].get("quanta_gap"))
    # exact f32 against f64 (merge), or within the quantization (bucket)
    assert gap["value"] <= (1e-6 if cell != "batch-8m.bucket-b32" else 1.0)


def test_node_segments_hold_only_their_terms(cpu):
    from portbench import generate
    from portbench.engines.node import _segment_arrays
    from portbench.harness import _merge, load_cell

    cfg = _merge(load_cell("node-8m.text-b32")[2],
                 {"corpus": {"num_docs": 3000, "vocab_size": 50000}})
    c = generate.make_corpus(cfg, 8, cpu)
    post_terms = torch.repeat_interleave(torch.arange(c.vocab_size),
                                         torch.as_tensor(c.term_lengths))
    seg = _segment_arrays(c, 1000, 2000, post_terms)
    ids = np.array([int(t) for t in seg["terms"]])
    # rare terms miss a segment: its dictionary leaves them out
    assert len(ids) < c.vocab_size and (seg["lengths"] > 0).all()
    assert seg["lengths"].sum() == seg["postings_len"]
    for term, tid in list(seg["terms"].items())[::97]:
        t = int(term)
        run = c.post_docs[c.term_offsets[t]:c.term_offsets[t] + c.term_lengths[t]].numpy()
        want = run[(run >= 1000) & (run < 2000)] - 1000
        off, ln = seg["offsets"][tid], seg["lengths"][tid]
        assert np.array_equal(seg["doc_ids"][off:off + ln], want)


REL = {"mode": "relative"}


def test_check_reads_each_fault():
    ref = Reference(_hand_corpus(), k1=1.2, b=0.75, quantized_norms=False)
    q = np.array([[0, 1]])
    dense, matched = ref.dense(q)
    s, d, h = ref.topk(dense, matched, 3)
    good = (s.astype(np.float32), d, h)
    assert bm25.check(ref, q, good, 3, REL) == {
        "score_gap": pytest.approx(0, abs=1e-7), "hits_wrong": 0, "short_lists": 0,
        "order_faults": 0}
    swapped = (good[0], d[:, [1, 0, 2]], h)
    assert bm25.check(ref, q, swapped, 3, REL)["score_gap"] > 1e-3
    unsorted = (good[0][:, [1, 0, 2]], d[:, [1, 0, 2]], h)
    assert bm25.check(ref, q, unsorted, 3, REL)["order_faults"] > 0
    repeated = (good[0], d[:, [0, 0, 2]], h)
    assert bm25.check(ref, q, repeated, 3, REL)["order_faults"] > 0
    assert bm25.check(ref, q, (good[0], good[1], h + 1), 3, REL)["hits_wrong"] == 1
    short = (np.where(np.arange(3) < 2, good[0], -np.inf).astype(np.float32), d, h)
    assert bm25.check(ref, q, short, 3, REL)["short_lists"] == 1
    off = (good[0] * np.float32(1.001), d, h)
    assert bm25.check(ref, q, off, 3, REL)["score_gap"] > 5e-4
