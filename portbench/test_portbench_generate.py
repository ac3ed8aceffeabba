"""The generator: the same seed gives the same inputs, other seeds others,
and the corpus has the layout and the laws the configuration states."""

import numpy as np
import pytest
import torch

from portbench import generate
from portbench.kinds.bm25 import TINY
from portbench.harness import _merge, load_cell

CFG = _merge(load_cell("node-8m.text-b32")[2], TINY["config"])
TRAFFIC = _merge(load_cell("node-8m.text-b32")[3], TINY["traffic"])
BIG_SEED = 2**31 + 12345


def _same(a, b) -> bool:
    return (a.num_docs == b.num_docs and torch.equal(a.post_docs, b.post_docs)
            and torch.equal(a.post_freqs, b.post_freqs) and torch.equal(a.doc_lens, b.doc_lens)
            and np.array_equal(a.term_offsets, b.term_offsets)
            and np.array_equal(a.term_lengths, b.term_lengths))


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_same_seed_same_corpus_and_queries(cpu, seed):
    assert _same(generate.make_corpus(CFG, seed, cpu), generate.make_corpus(CFG, seed, cpu))
    a = generate.QueryStream(CFG, TRAFFIC, seed, "queries", 8, cpu)
    b = generate.QueryStream(CFG, TRAFFIC, seed, "queries", 8, cpu)
    assert np.array_equal(a.ids, b.ids)
    ca, cb = generate.make_columns(CFG, seed, cpu), generate.make_columns(CFG, seed, cpu)
    assert all(np.array_equal(x, y) for n in ca for x, y in zip(ca[n][:2], cb[n][:2]))


def test_seeds_and_streams_differ(cpu):
    assert not _same(generate.make_corpus(CFG, 1, cpu), generate.make_corpus(CFG, 2, cpu))
    q = generate.QueryStream(CFG, TRAFFIC, 1, "queries", 8, cpu).ids
    assert not np.array_equal(q, generate.QueryStream(CFG, TRAFFIC, 2, "queries", 8, cpu).ids)
    assert not np.array_equal(q, generate.QueryStream(CFG, TRAFFIC, 1, "warmup", 8, cpu).ids)
    assert len({generate.sub_seed(BIG_SEED, s) for s in generate.STREAMS}) == len(generate.STREAMS)


def test_corpus_layout_and_laws(cpu):
    c = generate.make_corpus(CFG, 3, cpu)
    V, D = c.vocab_size, c.num_docs
    docs, freqs = c.post_docs.numpy(), c.post_freqs.numpy()
    # term-major runs, docs strictly ascending inside a run
    assert c.term_offsets[0] == 0 and c.term_lengths.sum() == len(docs)
    assert np.array_equal(c.term_offsets[1:], np.cumsum(c.term_lengths)[:-1])
    for t in range(0, V, 97):
        run = docs[c.term_offsets[t]:c.term_offsets[t] + c.term_lengths[t]]
        assert np.all(np.diff(run) > 0)
    # every draw lands in its doc: a doc's frequencies sum to its length
    lens = c.doc_lens.numpy()
    assert lens.min() >= CFG["corpus"]["min_doc_len"] and freqs.min() >= 1
    assert np.array_equal(np.bincount(docs, weights=freqs, minlength=D).astype(np.int64), lens)
    # lognormal lengths averaging the stated mean, Zipf term masses ~ 1/rank
    assert abs(lens.mean() - CFG["corpus"]["mean_doc_len"]) < 0.5
    mass = np.bincount(np.repeat(np.arange(V), c.term_lengths), weights=freqs, minlength=V)
    share = mass / mass.sum()
    h = np.sum(1.0 / np.arange(1, V + 1))
    assert abs(share[0] * h - 1) < 0.05 and abs(share[1] * h * 2 - 1) < 0.05


def test_queries_are_zipf_term_ids(cpu):
    q = generate.QueryStream(CFG, TRAFFIC, 5, "queries", 64, cpu)
    assert q.ids.shape == (64, TRAFFIC["batch"], TRAFFIC["terms_per_query"])
    assert q.ids.min() >= 0 and q.ids.max() < CFG["corpus"]["vocab_size"]
    h = np.sum(1.0 / np.arange(1, CFG["corpus"]["vocab_size"] + 1))
    assert abs((q.ids == 0).mean() * h - 1) < 0.15
    with pytest.raises(RuntimeError, match="max_batches"):
        q.batch(64)


def test_columns(cpu):
    cols = generate.make_columns(CFG, 4, cpu)
    price, present = cols["price"]
    assert 0.0 <= price.min() and price.max() < 1000.0 and 0.97 < present.mean() < 1.0
    assert np.all(price[~present] == 0)
    tag, tag_present, names = cols["tag"]
    assert tag.max() < 100 and tag_present.all() and names[:2] == ["tag_00", "tag_01"]
