"""A served nrtsearch node: the port's ``Searcher`` over a multi-segment
index, driven as the micro-batcher drives it for one group.

Set-up cuts the corpus into doc-range segments (the port's SmallFloat norm
quantizes each segment's field lengths, as its ingest does), places them with ``convert.segment_from_numpy`` beside the
configuration's doc-value columns, opens a ``Searcher`` and warms the text
field (``Searcher.warm``), as a node does after a refresh. A batch is B
match-query requests: each parsed (``query.parse_query``), compiled
(``Searcher.compile_batchable``) and served in one
``Searcher.fast_search_batch`` call, the call ``server/batcher.py``
``_run_group`` makes for each group.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import sync


def _segment_arrays(corpus, lo: int, hi: int, post_terms: torch.Tensor) -> dict:
    """Docs [lo, hi) of the corpus in ``convert.segment_from_numpy``'s layout."""
    from nrtsearch_tpu_torch.core.segment import pad_to_bucket
    from nrtsearch_tpu_torch.utils.smallfloat import quantize_length

    V = corpus.vocab_size
    sel = (corpus.post_docs >= lo) & (corpus.post_docs < hi)
    docs = (corpus.post_docs[sel] - lo).cpu().numpy()
    freqs = corpus.post_freqs[sel].cpu().numpy()
    # the segment's dictionary holds the terms that occur in it, as Lucene's does
    lengths = torch.bincount(post_terms[sel], minlength=V).cpu().numpy().astype(np.int32)
    present = np.flatnonzero(lengths)
    lengths = lengths[present]
    offsets = np.zeros(len(present), np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    n = hi - lo
    capacity = pad_to_bucket(n)
    raw = np.zeros(capacity, np.int64)
    raw[:n] = corpus.doc_lens[lo:hi].cpu().numpy()
    qlens = quantize_length(raw).astype(np.float32)
    total = len(docs)
    p_pad = pad_to_bucket(total + 16384)
    doc_ids = np.zeros(p_pad, np.int32)
    doc_ids[:total] = docs
    pf = np.zeros(p_pad, np.float32)
    pf[:total] = freqs
    live = np.zeros(capacity, bool)
    live[:n] = True
    return {
        "terms": dict(zip(map(str, present.tolist()), range(len(present)))),
        "offsets": offsets, "lengths": lengths,
        "doc_ids": doc_ids, "freqs": pf, "doc_lens": qlens,
        "sum_doc_lens": int(qlens[:n].sum()), "doc_count": int(np.count_nonzero(raw[:n])),
        "postings_len": total, "live": live, "host_live": np.ones(n, bool),
        "num_docs": n, "capacity": capacity, "stored": [{} for _ in range(n)],
    }


def _segment_doc_values(columns: dict, lo: int, hi: int) -> dict:
    """One segment's doc-value columns: FLOAT as DOUBLE, ATOM as ORDINAL
    with the segment's own sorted dictionary."""
    from nrtsearch_tpu_torch.core.segment import pad_to_bucket

    n = hi - lo
    capacity = pad_to_bucket(n)
    seg = {}
    for name, col in columns.items():
        vals, present = col[0][lo:hi], col[1][lo:hi]
        full_present = np.zeros(capacity, bool)
        full_present[:n] = present
        if len(col) == 3:
            used = np.unique(vals[present])
            host = np.full(capacity, -1, np.int32)
            host[:n] = np.where(present, np.searchsorted(used, vals), -1)
            seg[name] = {"kind": "ORDINAL", "values": host, "present": full_present,
                         "ord_terms": [col[2][u] for u in used]}
        else:
            host = np.zeros(capacity, np.float64)
            host[:n] = np.where(present, vals, 0)
            seg[name] = {"kind": "DOUBLE", "values": host, "present": full_present}
    return seg


class Engine:
    def __init__(self, cfg: dict, traffic: dict, corpus, columns: dict, device: torch.device):
        from nrtsearch_tpu_torch.convert import segment_from_numpy
        from nrtsearch_tpu_torch.core.searcher import Searcher
        from nrtsearch_tpu_torch.schema import create_field_def

        self.k = int(traffic["k"])
        field = cfg["index"]["field"]
        self.field = field
        fds = {field: create_field_def(field, {"type": "TEXT", "search": True})}
        for name, spec in cfg.get("doc_values", {}).items():
            fds[name] = create_field_def(name, {"type": spec["type"], "storeDocValues": True})
        t0 = time.perf_counter()
        V = corpus.vocab_size
        post_terms = torch.repeat_interleave(
            torch.arange(V, dtype=torch.int64, device=device),
            torch.as_tensor(corpus.term_lengths, device=device))
        bounds = np.linspace(0, corpus.num_docs, int(cfg["index"]["segments"]) + 1).astype(np.int64)
        segs = []
        for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            segs.append(segment_from_numpy(
                _segment_arrays(corpus, lo, hi, post_terms), device, field=field,
                doc_values=_segment_doc_values(columns, lo, hi)))
        del post_terms
        self.searcher = Searcher(segs, fds)
        sync(device)
        t1 = time.perf_counter()
        self.searcher.warm([field])
        self.view = self.searcher.packed_view(field)
        sync(device)
        self.setup_split = {"ingest": t1 - t0, "warm": time.perf_counter() - t1}

    def run_batch(self, ids: np.ndarray):
        from nrtsearch_tpu_torch.query import parse_query

        with record_function("portbench.plan"):
            specs = [self.searcher.compile_batchable(parse_query(
                {"matchQuery": {"field": self.field, "query": " ".join(map(str, row.tolist()))}}))
                for row in ids]
        with record_function("portbench.search"):
            return self.searcher.fast_search_batch(specs, self.k)

    def answers(self, raw) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(scores f32 [B, k], docs int32 [B, k], hits int64 [B])."""
        B, k = len(raw), self.k
        scores = np.full((B, k), -np.inf, np.float32)
        docs = np.full((B, k), -1, np.int32)
        hits = np.zeros(B, np.int64)
        for qi, td in enumerate(raw):
            n = min(len(td.hits), k)
            scores[qi, :n] = [h.score for h in td.hits[:n]]
            docs[qi, :n] = [h.global_ord for h in td.hits[:n]]
            # a hit count that is only a lower bound is no exact count
            hits[qi] = td.total_hits if td.relation == "EQUAL_TO" else -1
        return scores, docs, hits

    def describe(self) -> str:
        return f"paths served {dict(self.view.path_counts)}"

    def close(self) -> None:
        self.searcher.release_device_caches()
        self.searcher = self.view = None
