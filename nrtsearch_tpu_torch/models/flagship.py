"""The flagship serving program: batched BM25 retrieval over one field
(counterpart: nrtsearch_tpu/models/flagship.py).

``BatchedBM25`` holds one field's packed postings and their refresh-time
impacts on one device, the term dictionary on the host, and five routes:

- ``search``: the scatter-free merge step (``bm25_search_step``, the
  port's ``merge_score_topk``), on its accelerator branch when the postings
  live on CUDA: kernels #2-#6.
- ``serve_bucket_batch``: the bucket-local kernel with 15-bit quantized
  scores (``attach_bucket``; kernels #7 and #8 in one launch on the card).
- ``serve_dense_batch``: dense bf16 head rows + the bucket tail
  (``attach_dense``, ``ops.dense_head.dispatch``).
- ``serve_dense_merge``: dense head rows + the exact merge tail with the
  theta candidate window (``ops.dense_head.dispatch_merge``).
- ``serve_dense_fused``: the fused dense path (``ops.dense_fused``, kernel
  #1 for the head scores).

Where the reference asks ``_on_tpu()``, the port reads where the model's
tensors live (``device.on_cuda``). A model is built on an explicit device
(default CUDA; asking for CUDA without a card raises); tests pass "cpu".
The reference's shape pins (``force_caps``, ``force_tile``,
``force_run_len``, ``force_theta`` ...) are not ported: eager torch
compiles no shapes to freeze.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.device import on_cuda, resolve_device
from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus  # noqa: F401  (the reference's module holds it)
from nrtsearch_tpu_torch.ops.bm25 import lucene_idf, precompute_impacts
from nrtsearch_tpu_torch.ops.merge_scoring import merge_score_topk
from nrtsearch_tpu_torch.tracing import span

bm25_search_step = merge_score_topk  # the flagship fused step

# the reference's bucket DMA row alignment (ops/bucket_retrieval.py:58): the
# port's bucket kernel reads no slack, but the postings keep the padding the
# reference demands, so both refuse the same layouts
_DMA_ROWS = 8


@dataclass
class QueryBatch:
    """Host-compiled query term tables for one batch."""

    term_offsets: np.ndarray  # int32 [B, R] (R = power-of-two padded runs)
    term_lengths: np.ndarray  # int32 [B, R]
    term_weights: np.ndarray  # float32 [B, R]
    n_terms: np.ndarray       # int32 [B]
    run_len: int              # padded per-run length (power of two)


def _tensor(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A tensor on ``dev`` (no copy when ``x`` already is one there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class BatchedBM25:
    """Batched match-query retrieval against one searchable field.

    The host holds the term dictionary; queries compile to [B, R] run
    tables. Wraps a port ``Segment`` (``from_segment``) or packed arrays."""

    def __init__(
        self,
        *,
        terms: dict[str, int],
        offsets: np.ndarray,
        lengths: np.ndarray,
        doc_ids,                  # int32 [P_pad] (numpy or tensor)
        freqs,                    # float32 [P_pad]
        doc_lens,                 # float32 [D]
        live,                     # bool [D]
        num_docs_real: int,
        k1: float = 1.2,
        b: float = 0.75,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        self.device = dev
        self.terms = terms
        self.offsets = offsets
        self.lengths = lengths
        self.doc_ids = _tensor(doc_ids, torch.int32, dev)
        self.freqs = _tensor(freqs, torch.float32, dev)
        self.doc_lens = _tensor(doc_lens, torch.float32, dev)
        self.live = _tensor(live, torch.bool, dev)
        self.capacity = int(self.doc_lens.shape[0])
        self.num_docs_real = num_docs_real
        self.k1 = k1
        self.b = b
        # the reference's f32 numpy sum of the lengths
        lens_sum = float(_host(doc_lens).astype(np.float32, copy=False).sum())
        self.avgdl = lens_sum / max(num_docs_real, 1)
        # refresh-time precompute: per-posting impacts, deletions folded in
        self.impacts = precompute_impacts(
            self.doc_ids, self.freqs, self.doc_lens, self.live, k1, b, self.avgdl,
        )
        self._host_postings: Optional[tuple] = None

    @classmethod
    def from_segment(cls, segment, field: str) -> "BatchedBM25":
        tfi = segment.fields[field]
        return cls(
            terms=tfi.terms,
            offsets=tfi.offsets,
            lengths=tfi.lengths,
            doc_ids=tfi.doc_ids,
            freqs=tfi.freqs,
            doc_lens=tfi.doc_lens,
            live=segment.live,
            num_docs_real=segment.num_docs,
            device=segment.device,
        )

    def on_cuda(self) -> bool:
        """Where the model's tensors live (the reference's ``_on_tpu()``)."""
        return on_cuda(self.doc_ids)

    def host_postings(self) -> tuple[np.ndarray, np.ndarray]:
        """(doc ids, impacts) as host numpy arrays, copied once."""
        if self._host_postings is None:
            self._host_postings = (self.doc_ids.cpu().numpy(), self.impacts.cpu().numpy())
        return self._host_postings

    def compile_queries(
        self, queries: Sequence[Sequence[str]], max_terms: int = 8
    ) -> QueryBatch:
        """Analyzed query terms -> padded [B, R] run tables (R a power of
        two); high-df terms are chunked into runs (plan_runs) so the merged
        width tracks the postings touched."""
        from nrtsearch_tpu_torch.ops.merge_scoring import plan_runs

        with span("plan"):
            B = len(queries)
            offs = np.zeros((B, max_terms), np.int64)
            lens = np.zeros((B, max_terms), np.int32)
            weights = np.zeros((B, max_terms), np.float32)
            n_terms = np.zeros(B, np.int32)
            for qi, qterms in enumerate(queries):
                n_terms[qi] = min(len(qterms), max_terms)
                for ti, term in enumerate(qterms[:max_terms]):
                    tid = self.terms.get(term)
                    if tid is None:
                        continue
                    offs[qi, ti] = self.offsets[tid]
                    lens[qi, ti] = self.lengths[tid]
                    weights[qi, ti] = lucene_idf(self.num_docs_real, int(self.lengths[tid]))
            run_offs, run_lens, run_w, run_len = plan_runs(
                offs, lens, weights, max_run=int(self.doc_ids.shape[0])
            )
            return QueryBatch(run_offs, run_lens, run_w, n_terms, run_len)

    def compile_query_batches(
        self, batches: Sequence[Sequence[Sequence[str]]], max_terms: int = 8
    ) -> list[QueryBatch]:
        """Compile several batches with one shared (run_len, R)."""
        all_queries = [q for batch in batches for q in batch]
        joint = self.compile_queries(all_queries, max_terms)
        out = []
        i = 0
        for batch in batches:
            n = len(batch)
            out.append(QueryBatch(
                joint.term_offsets[i : i + n], joint.term_lengths[i : i + n],
                joint.term_weights[i : i + n], joint.n_terms[i : i + n], joint.run_len,
            ))
            i += n
        return out

    def compile_queries_bucketed(
        self, queries: Sequence[Sequence[str]], max_terms: int = 8
    ) -> list[tuple[QueryBatch, list[int]]]:
        """Width-class split: when the light queries (width at most half the
        batch's width W) plan at most W/2 on their own, the heavy ones go to
        a second batch, since merge cost is B x width. Returns
        [(QueryBatch, original query indices)]."""
        full = self.compile_queries(queries, max_terms)
        W = full.run_len * full.term_offsets.shape[1]
        widths = []
        for q in queries:
            qb = self.compile_queries([q], max_terms)
            widths.append(qb.run_len * qb.term_offsets.shape[1])
        light_idx = [i for i, w in enumerate(widths) if w <= W // 2]
        heavy_idx = [i for i, w in enumerate(widths) if w > W // 2]
        if not heavy_idx or not light_idx:
            return [(full, list(range(len(queries))))]
        light = self.compile_queries([queries[i] for i in light_idx], max_terms)
        if light.run_len * light.term_offsets.shape[1] > W // 2:
            return [(full, list(range(len(queries))))]
        heavy = self.compile_queries([queries[i] for i in heavy_idx], max_terms)
        return [(light, light_idx), (heavy, heavy_idx)]

    def search(self, batch: QueryBatch, k: int = 10, require_all_terms: bool = False):
        """One merge step. Returns (scores f32 [B, k], docs int32 [B, k],
        hits int32 [B]) as tensors on the model's device."""
        dev = self.device
        return bm25_search_step(
            self.doc_ids,
            self.impacts,
            _tensor(batch.term_offsets, torch.int32, dev),
            _tensor(batch.term_lengths, torch.int32, dev),
            _tensor(batch.term_weights, torch.float32, dev),
            _tensor(batch.n_terms, torch.int32, dev),
            run_len=batch.run_len,
            k=k,
            require_all_terms=require_all_terms,
            use_pallas=self.on_cuda(),
        )

    # -- bucket ---------------------------------------------------------------

    def attach_bucket(self, bucket_docs: int = 16384):
        """The bucket-local retrieval index (ops/bucket_retrieval.py): host
        bucket bounds per term; the postings stay shared."""
        from nrtsearch_tpu_torch.ops.bucket_retrieval import BucketIndex

        docs, imps = self.host_postings()
        self.bucket_idx = BucketIndex.build(
            docs, imps, np.asarray(self.offsets, np.int64),
            np.asarray(self.lengths, np.int32),
            capacity=self.capacity, bucket_docs=bucket_docs,
        )
        self._assert_bucket_padding(self.bucket_idx)
        return self.bucket_idx

    def bucket_entries(self, queries, max_terms: int = 8):
        """Analyzed query term lists -> [(term_id, idf weight)] per query."""
        out = []
        for qterms in queries:
            ents = []
            for term in list(qterms)[:max_terms]:
                tid = self.terms.get(term)
                if tid is None or not self.lengths[tid]:
                    continue
                ents.append((tid, float(lucene_idf(self.num_docs_real,
                                                   int(self.lengths[tid])))))
            out.append(ents)
        return out

    def plan_bucket(self, queries, *, max_terms: int = 8):
        from nrtsearch_tpu_torch.ops.bucket_retrieval import plan_bucket_batch

        with span("plan"):
            return plan_bucket_batch(self.bucket_idx, self.bucket_entries(queries, max_terms),
                                     self.offsets, max_terms=max_terms)

    def serve_bucket_batch(self, plan, k: int):
        """One planned batch on the bucket kernel. Returns tensors (rank keys
        [B, k], doc ids [B, k], hits [B]); decode scores with
        ops.bucket_retrieval.decode_topk(..., plan.scales)."""
        from nrtsearch_tpu_torch.ops.bucket_retrieval import bucket_search_topk

        dev = self.device
        return bucket_search_topk(
            self.doc_ids, self.impacts,
            _tensor(plan.term_offs, torch.int32, dev), _tensor(plan.bounds, torch.int32, dev),
            _tensor(plan.weights, torch.float32, dev), _tensor(plan.n_terms, torch.int32, dev),
            tile=plan.tile, bucket_bits=self.bucket_idx.bucket_bits, k=k,
        )

    # -- dense head -----------------------------------------------------------

    def attach_dense(self, *, max_rows: int = 256, min_df: int | None = None,
                     bucket_docs: int = 32768, residual: bool = False):
        """The dense-head + sparse-tail index (ops/dense_head.py) on the
        model's device: head terms become bf16 impact rows, the tail keeps
        its postings; ``residual`` adds the Dekker residual rows (the fused
        path's ~f32 head scores at twice the head bytes)."""
        from nrtsearch_tpu_torch.ops.dense_head import DenseHeadIndex

        docs, imps = self.host_postings()
        self.dense_idx = DenseHeadIndex.build(
            docs, imps, np.asarray(self.offsets, np.int64),
            np.asarray(self.lengths, np.int32), capacity=self.capacity,
            max_rows=max_rows, min_df=min_df, bucket_docs=bucket_docs,
            residual=residual, device=self.device,
        )
        self._assert_bucket_padding(self.dense_idx.tail)
        return self.dense_idx

    def plan_dense(self, queries, *, max_terms: int = 8):
        from nrtsearch_tpu_torch.ops.dense_head import plan_dense_batch

        return plan_dense_batch(self.dense_idx, self.bucket_entries(queries, max_terms),
                                self.offsets, max_terms=max_terms)

    def serve_dense_batch(self, plan, k: int):
        """One planned batch on the dense + bucket-tail path: the packed
        [B, 2k+1] tensor (ops.dense_head.decode_packed)."""
        from nrtsearch_tpu_torch.ops import dense_head

        return dense_head.dispatch(self.dense_idx, plan, self.doc_ids, self.impacts, k)

    def plan_dense_merge(self, queries, *, max_terms: int = 8):
        from nrtsearch_tpu_torch.ops.dense_head import plan_dense_merge

        return plan_dense_merge(self.dense_idx, self.bucket_entries(queries, max_terms),
                                self.offsets, self.lengths, max_terms=max_terms)

    def serve_dense_merge(self, plan, k: int, *, exact_counts: bool = False):
        """One planned batch on the dense + merge-tail path: the packed
        [B, 2k+2] tensor (ops.dense_head.decode_packed2)."""
        from nrtsearch_tpu_torch.ops import dense_head

        return dense_head.dispatch_merge(self.dense_idx, plan, self.doc_ids, self.impacts,
                                         k, exact_counts=exact_counts)

    def serve_dense_fused(self, plan, k: int, **kw):
        """One planned batch (a ``plan_dense_merge`` plan) on the fused dense
        path: the packed [B, 2k+2] tensor (ops.dense_head.decode_packed2)."""
        from nrtsearch_tpu_torch.ops.dense_fused import dispatch_fused

        return dispatch_fused(self.dense_idx, plan, self.doc_ids, self.impacts, k, **kw)

    def _assert_bucket_padding(self, idx):
        """The reference's check: the postings must carry the bucket
        kernel's DMA slack (bucket_docs + 2 * 8 * 128 entries) past the last
        valid posting."""
        valid = int((np.asarray(self.offsets, np.int64)
                     + np.asarray(self.lengths, np.int64)).max())
        pad = int(self.doc_ids.shape[0]) - valid
        need = (1 << idx.bucket_bits) + 2 * _DMA_ROWS * 128
        if pad < need:
            raise ValueError(
                f"postings padding {pad} < bucket DMA slack {need}; "
                f"repack with more tail padding"
            )
