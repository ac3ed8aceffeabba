"""Corpus, doc values and query streams, drawn on the device from ``--seed``.

The laws are those of the repository's synthetic corpus (the numpy
``SyntheticCorpus`` of ``nrtsearch_tpu_torch/models/synthetic.py``), redrawn
with a ``torch.Generator`` on the run's device in a few large calls:

- doc lengths: ``max(floor(lognormal(mu, sigma)), min_doc_len)`` term draws
  per doc, with ``mu = ln(mean_doc_len + 0.5) - sigma^2 / 2`` so that the
  floored lengths average ``mean_doc_len``;
- term draws: Zipf with exponent ``zipf_s`` over ``vocab_size`` ranks
  (probability of rank r proportional to r^-s), by inverse CDF;
- postings: the draws of one doc collapsed to (doc, term, freq), laid out
  term-major and doc-ascending inside a term;
- the field length of a doc is its number of draws.

Queries draw ``terms_per_query`` terms from the same Zipf law, with
replacement (a term may repeat in a query, and then counts twice, as a
Lucene boolean of one SHOULD clause per token does). The stream of batches
comes from a generator of its own, so the same seed gives the same batches
whatever the corpus size. Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# sub-seeds of one run: the corpus, its doc values, the timed batches, the
# warm-up batches and the sample of answers that the check compares
STREAMS = {"corpus": 0, "columns": 1, "queries": 2, "warmup": 3, "sample": 4}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for one stream of a run (any whole ``seed``)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + STREAMS[stream] * 0xBF58476D1CE4E5B9) % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)


def generator(seed: int, stream: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def zipf_cdf(vocab_size: int, s: float, device: torch.device) -> torch.Tensor:
    """f64 [V] cumulative Zipf probabilities of ranks 1..V."""
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float64, device=device)
    w = ranks.pow(-float(s))
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def zipf_draws(cdf: torch.Tensor, n: int, g: torch.Generator) -> torch.Tensor:
    """int64 [n] term ids (rank - 1) drawn by inverse CDF."""
    u = torch.rand(n, generator=g, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


@dataclass
class Corpus:
    """One field's postings on the device, and its host dictionary sizes."""

    num_docs: int
    vocab_size: int
    post_docs: torch.Tensor      # int32 [P], term-major, doc-ascending per term
    post_freqs: torch.Tensor     # f32 [P]
    doc_lens: torch.Tensor       # int64 [num_docs] draws per doc
    term_offsets: np.ndarray     # int64 [V]
    term_lengths: np.ndarray     # int64 [V] (document frequency)

    @property
    def num_postings(self) -> int:
        return int(self.post_docs.numel())


def make_corpus(cfg: dict, seed: int, device: torch.device) -> Corpus:
    """The corpus of ``cfg["corpus"]`` (num_docs, vocab_size, mean_doc_len,
    doc_len_sigma, min_doc_len, zipf_s) drawn from ``seed`` on ``device``."""
    c = cfg["corpus"]
    D, V = int(c["num_docs"]), int(c["vocab_size"])
    g = generator(seed, "corpus", device)
    lens = torch.empty(D, dtype=torch.float64, device=device)
    sigma = float(c["doc_len_sigma"])
    mu = math.log(float(c["mean_doc_len"]) + 0.5) - sigma * sigma / 2
    lens.log_normal_(mu, sigma, generator=g)
    lens = lens.floor().to(torch.int64).clamp_(min=int(c["min_doc_len"]))
    total = int(lens.sum())
    terms = zipf_draws(zipf_cdf(V, c["zipf_s"], device), total, g)
    docs = torch.repeat_interleave(torch.arange(D, dtype=torch.int64, device=device), lens)
    uniq, counts = torch.unique(docs * V + terms, sorted=True, return_counts=True)
    del docs, terms
    u_docs, u_terms = uniq // V, uniq % V
    del uniq
    order = torch.argsort(u_terms * D + u_docs)
    post_docs = u_docs[order].to(torch.int32)
    post_freqs = counts[order].to(torch.float32)
    lengths = torch.bincount(u_terms, minlength=V)
    del u_docs, u_terms, counts, order
    lengths_h = lengths.cpu().numpy().astype(np.int64)
    offsets_h = np.zeros(V, np.int64)
    np.cumsum(lengths_h[:-1], out=offsets_h[1:])
    return Corpus(D, V, post_docs, post_freqs, lens, offsets_h, lengths_h)


def make_columns(cfg: dict, seed: int, device: torch.device) -> dict:
    """The doc-value columns of ``cfg["doc_values"]`` over all docs, as
    host numpy: FLOAT columns uniform over [lo, hi) with a ``missing``
    share absent, ATOM columns as ordinals over ``n_terms`` names
    (``<prefix>NNN``, sorted in ordinal order). Each entry is (values,
    present[, names])."""
    D = int(cfg["corpus"]["num_docs"])
    g = generator(seed, "columns", device)
    out = {}
    for name, spec in cfg.get("doc_values", {}).items():
        missing = float(spec.get("missing", 0.0))
        present = torch.rand(D, generator=g, device=device) >= missing
        if spec["type"] == "FLOAT":
            lo, hi = float(spec["lo"]), float(spec["hi"])
            vals = torch.rand(D, generator=g, dtype=torch.float64, device=device) * (hi - lo) + lo
            vals = torch.where(present, vals.to(torch.float32), torch.zeros((), device=device))
            out[name] = (vals.cpu().numpy(), present.cpu().numpy())
        elif spec["type"] == "ATOM":
            n = int(spec["n_terms"])
            vals = torch.randint(0, n, (D,), generator=g, device=device, dtype=torch.int32)
            width = len(str(n - 1))
            names = [f"{spec['prefix']}{i:0{width}d}" for i in range(n)]
            out[name] = (vals.cpu().numpy(), present.cpu().numpy(), names)
        else:
            raise ValueError(f"doc value {name}: unknown type {spec['type']!r}")
    return out


class QueryStream:
    """Batches of Zipf term-id queries, drawn at set-up: [n_batches, B, T]
    int64 on the host. ``batch(i)`` is the i-th batch; a run that needs
    more batches than were drawn fails rather than repeat any."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, stream: str,
                 n_batches: int, device: torch.device):
        c = cfg["corpus"]
        B, T = int(traffic["batch"]), int(traffic["terms_per_query"])
        g = generator(seed, stream, device)
        cdf = zipf_cdf(int(c["vocab_size"]), c["zipf_s"], device)
        self.ids = zipf_draws(cdf, n_batches * B * T, g).reshape(n_batches, B, T).cpu().numpy()

    def __len__(self) -> int:
        return len(self.ids)

    def batch(self, i: int) -> np.ndarray:
        if i >= len(self.ids):
            raise RuntimeError(f"the run needed more than the {len(self.ids)} batches drawn; "
                               "raise the traffic's max_batches")
        return self.ids[i]


def quantized_lengths(corpus: Corpus) -> np.ndarray:
    """Doc lengths through Lucene's one-byte norm (the frozen SmallFloat copy)."""
    from portbench.smallfloat import quantize_length

    return quantize_length(corpus.doc_lens.cpu().numpy())
