"""Batch retrieval: the port's ``models.flagship.BatchedBM25`` over the
whole corpus as one segment with raw (unquantized) field lengths, laid out
as ``SyntheticCorpus.to_model`` lays it out.

The traffic's ``route`` picks the model's route:

- ``search``: ``compile_queries`` on the host, ``search`` (the merge step,
  ``merge_score_topk``), results read back;
- ``bucket``: ``plan_bucket`` on the host (``attach_bucket`` at set-up),
  ``serve_bucket_batch`` (``bucket_search_topk``), the rank keys read back
  and decoded with ``ops.bucket_retrieval.decode_topk``.

The model takes the benchmark's device tensors of doc ids and term
frequencies as they are (padded); it computes its impacts itself.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import sync


class Engine:
    def __init__(self, cfg: dict, traffic: dict, corpus, columns: dict, device: torch.device):
        from nrtsearch_tpu_torch.core.packed_view import GATHER_TILE
        from nrtsearch_tpu_torch.core.segment import pad_to_bucket
        from nrtsearch_tpu_torch.models.flagship import BatchedBM25

        self.k = int(traffic["k"])
        self.route = traffic["route"]
        if self.route not in ("search", "bucket"):
            raise ValueError(f"flagship: unknown route {self.route!r}")
        t0 = time.perf_counter()
        D, P = corpus.num_docs, corpus.num_postings
        d_pad = pad_to_bucket(D)
        p_pad = pad_to_bucket(P + max(2 * GATHER_TILE, 34816))
        doc_ids = torch.zeros(p_pad, dtype=torch.int32, device=device)
        doc_ids[:P] = corpus.post_docs
        freqs = torch.zeros(p_pad, dtype=torch.float32, device=device)
        freqs[:P] = corpus.post_freqs
        lens = torch.zeros(d_pad, dtype=torch.float32, device=device)
        lens[:D] = corpus.doc_lens.to(torch.float32)
        live = torch.zeros(d_pad, dtype=torch.bool, device=device)
        live[:D] = True
        self.model = BatchedBM25(
            terms={str(t): t for t in range(corpus.vocab_size)},
            offsets=corpus.term_offsets, lengths=corpus.term_lengths.astype(np.int32),
            doc_ids=doc_ids, freqs=freqs, doc_lens=lens, live=live,
            num_docs_real=D, device=device,
        )
        sync(device)
        t1 = time.perf_counter()
        if self.route == "bucket":
            self.model.attach_bucket(int(cfg["index"]["bucket_docs"]))
        sync(device)
        self.setup_split = {"ingest": t1 - t0, "attach": time.perf_counter() - t1}
        self.plan_s: list[float] = []

    def run_batch(self, ids: np.ndarray):
        queries = [[str(t) for t in row] for row in ids.tolist()]
        m = self.model
        t = time.perf_counter()
        with record_function("portbench.plan"):
            plan = m.compile_queries(queries) if self.route == "search" else m.plan_bucket(queries)
        self.plan_s.append(time.perf_counter() - t)
        with record_function("portbench.search"):
            if self.route == "search":
                out = m.search(plan, k=self.k)
            else:
                out = m.serve_bucket_batch(plan, self.k)
        with record_function("portbench.readback"):
            host = tuple(x.cpu().numpy() for x in out)
        return host, (plan.scales if self.route == "bucket" else None)

    def answers(self, raw) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        from nrtsearch_tpu_torch.ops.bucket_retrieval import decode_topk

        (a, docs, hits), scales = raw
        if scales is not None:
            scores, docs = decode_topk(a, docs, scales)
        else:
            scores = a
        scores = np.asarray(scores, np.float32)
        docs = np.where(np.isfinite(scores), np.asarray(docs, np.int32), np.int32(-1))
        return scores, docs, np.asarray(hits, np.int64)

    def describe(self) -> str:
        return f"route {self.route}"

    def close(self) -> None:
        self.model = None
