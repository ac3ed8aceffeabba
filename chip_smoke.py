#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nrtsearch_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: require CUDA; print torch/CUDA versions and the card's name and
   power limit (nvidia-smi); keep matmuls at full f32.
2. build: compile the kernels from nrtsearch_tpu_torch/csrc with nvcc.
3. kernels vs their plain torch twins on the card at main-path shapes
   (head_scores at Hp=536, D=1,000,064 with the Dekker rows, distinct head
   rows as the planner picks them and pad slots repeating row 0, (B, U) in
   {(1, 32), (8, 32), (16, 128), (32, 128)} and one require_all case: S
   within the f32 summation bound of the plain version, S > 0 and the count
   C equal; with one weight per query, S within 4 f32 ulps of the exact sum
   of all four Dekker products; near_stages and
   far_stage at B=32, N from 2^15 up to the first B=32 batch's width with
   duplicate docs, both sentinels and an all-pad row, near_stages also with
   a direction per pair; the accelerator merge branch on the first B=32
   batch of phase 5 as the merge path plans it: gather_runs (alternating),
   the alternating network, finish_mask; far_pair_stage and finish_mask at
   B=32 and N from 4 near tiles up to that batch's width): outputs must be
   bit-equal; CUDA-event times at the batch's shapes (the L2 evicted
   before each timed launch, and the card kept busy while the host enqueues
   it, so that the events time device work), each beside its bound (bytes over 3.35 TB/s
   or operations over 67 TFLOP/s, the tensor cores' 989 TFLOP/s for
   head_scores, the larger) and, for head_scores, beside the parent's
   sequence (two index_select gathers, four bf16 products with f32 out,
   three adds) and torch.index_select alone.
4. index: SyntheticCorpus(1M docs, 100k vocab, 48 draws/doc, seed 42) cut
   into 4 doc-range segments on the card, Searcher.warm builds the dense
   head rows; device memory is printed.
5. search: 8 single queries through Searcher.search, 4 batches of 32
   through fast_search_batch, one conjunction with a tail term (merge
   path). Launch counters are reset just before and read just after; every
   kernel must have launched, and every B=32 batch must have taken the
   merge path's alternating branch. Latencies at B=1 and B=32; then
   torch.profiler over one run of the first B=32 batch: device busy time
   (and its share of the B=32 p50) and the largest device items, and over
   one fused B=1 single (its device time).
6. the answers against an independent numpy BM25 of the same corpus.
7. ingest ~2,000 text docs through IndexWriter on the card and on the CPU;
   merge results bit-equal, fused results within 1e-6 relative.
8. the bucket path (NRT_FAST_PATH=bucket for this phase only) on the same
   index: bucket_rank against its plain version at the first B=32 batch's
   plan, bit-equal with require_all both ways, CUDA-event times, and the
   share of its (query, bucket) rows with more than k hits; then
   bucket_rank_topk (the entry that selects each row's top k in the block)
   at the bucket cell's shape (tests/torch_bucket_data.py: B=32, T=4,
   m=1024 buckets of 2^14 docs, k=100) on drawn scores and on a tie-heavy
   batch, require_all both ways: its candidates equal to the plain
   version's row by row, bucket_search_topk equal to the dense route
   (bucket_rank and topk_i32_lowest_index) bit for bit, keys, docs and hits;
   the share of rows it prunes (hits above k, as the plain version reads
   them); CUDA-event times of the entry, of bucket_search_topk and of the
   dense route. The 8 singles and 4 batches of phase 5 through
   the merge path (timed), then, with the launch counters reset just before
   and read just after, through the bucket path: every spec must be served
   there and bucket_rank_topk must launch once per bucket batch. Answers against
   the merge path's: equal hit counts, scores
   within one quantum (1 / scale) per query term, docs equal up to
   near-ties at the k-th score; a query whose plan shares a scale bound
   between two slots (a repeated term, or two terms of equal weight) can
   clip at QMAX, as in the reference, and is held to equal hit counts only.
   p50 at B=1 and B=32 of both paths, the bucket phase's peak device
   memory, and torch.profiler over one bucket run of the first B=32 batch.

9. config #3 (BASELINE.json: term + numeric-range filters, doc-value
   sort, terms facets) on phase 4's index, which carries the stress
   benchmark's columns (price FLOAT over 0-1000 with 1% missing, ts FLOAT
   over 0-1e9, tag ATOM with 100 ordinals; numpy draws from the seed): 8
   singles each of the scored config-#3 tree, the tree sorted by ts
   descending and a plain match sorted by price ascending (missing first),
   4 of each served by the fused path (2 head + 2 tail terms) and 4 by the
   merge path (3 tail terms); one B=32 batch of match queries sharing one
   ts sort (one group, one dispatch); 8 faceted singles (tag counts + price
   sum, merge path). Launch counters are reset just before and read just
   after: head_scores, near_stages, far_stage, far_pair_stage, gather_runs
   and finish_mask must all launch, both paths must serve and the merge
   path must take the alternating branch. Every answer against the numpy
   oracle (models.synthetic exact_filtered_topk): hits exact, scores
   within MERGE_REL (merge) or FUSED_REL (fused), sorted keys and docs
   equal, facet counts equal, the sum within 1e-5 relative. p50 of each
   form at B=1 and of the sorted B=32 batch, torch.profiler over that
   batch, _hierarchical_topk's full-sort fallbacks and the peak device
   memory. Then a 2,000-doc index with doc values (phase 7's documents
   plus price, tag, a LONG above 2^24 and a multi-valued ATOM) is
   committed with commit_segments and reopened on the card with
   open_commit: its filtered, sorted and faceted answers bit-equal.

10. the served path on the card: phase 4's index committed with
   commit_segments into the directory createIndex chose, then opened by
   the port's NrtsearchServer (in-process, port 0) through startIndex (its
   open time logged). Over gRPC, with the launch counters reset just before
   and read just after: phase 5's 8 singles one at a time and its first
   B=32 batch as 32 concurrent client threads (the micro-batcher forms the
   groups), 3 times; phase 9's scored, ts-sorted and faceted config #3
   singles (the facet through the ``facets`` field and a price-sum
   collector, in-dispatch through fast_search_reduce; the tree's filters
   grouped under one FILTER clause, which leaves its matches and scores as
   they are). head_scores, near_stages, far_stage, far_pair_stage,
   gather_runs and finish_mask must all launch. Every answer against the
   numpy oracle under its path's contract (a concurrent answer under the
   fused one unless no group took the fused path); served p50s, the
   batcher's group sizes, the handler's firstPassSearchTimeMs against the
   client's round trip, host syncs, fallbacks and the peak device memory.
   Then 2,000 documents with config #3's fields through addDocuments in 8
   chunks, each followed by refresh (small merges: segmentsPerTier 6,
   maxMergedSegmentMB 1) until a merge ran; a term only they hold answers
   them with their fields (retrieveFields); commit, stopIndex, startIndex
   answer bit for bit. Last, ``python -m nrtsearch_tpu_torch.server`` as a
   child process with no --device answers status and a search on a small
   index, and its log names the CUDA device.
11. replication on the card: phase 4's index committed and opened by a
   PRIMARY node (primaryGen 1, in-process); a REPLICA node with its own
   indexDir registers (addReplicas, through a primary discovery file),
   copies the commit over recvRawFile and installs it onto the card (the
   initial sync's seconds and bytes printed). With the launch counters
   reset just before and read just after, phase 5's 8 singles and its
   first B=32 batch as 32 concurrent clients, 3 times, to the replica
   alone: head_scores, near_stages, far_stage, far_pair_stage, gather_runs
   and finish_mask must all launch; every answer meets the numpy oracle
   under its path's contract and each single is bit-equal to the primary's
   at the same version; served B=1 p50 of both nodes. Then 2,000 documents
   in 8 addDocuments + refresh rounds on the primary: per round the
   replication lag (refresh returned to replicaCurrentSearchingVersion),
   the replica's install seconds and the bytes copied, p50 and max; a
   search pinned to a version the replica lacks waits for it; 'needle'
   answers the new docs. The primary commits, stops and restarts with
   primaryGen 2 and restore; the replica follows the discovery file to it
   and answers its documents. Peak device memory with both 1M-doc nodes
   and after the 8 installs. Then an isolated replica: a primary with
   bucketName over a FakeS3Server on loopback, a replica with no primary
   address restores from and polls the object store and answers bit for
   bit as the primary. Last, a primary and a replica as ``python -m
   nrtsearch_tpu_torch.server`` children with no --device, driven through
   ``python -m nrtsearch_tpu_torch.cli``: the replica answers what the
   primary indexed and both logs name the CUDA device.

12. the general evaluator on the card, on phase 10's node before its
   ingest (phase 4's index with the LAT_LON ``loc`` column, models.synthetic
   METRO_BOX): the query surface of tests/test_compiled_eval.py:48-117 on
   the corpus's fields (match SHOULD and MUST in a boolean,
   minimumNumberShouldMatch 2, fuzzy, a term on text, prefix and wildcard
   on a head term's first digits, dismax, a function score ``_score *
   log(price + 1)``, a multi-function score with a filter weight and a
   script, a function filter, geo bbox, radius and polygon, text with a
   geo radius, a nested boolean with text, range and MUST_NOT text, a
   column-only tree, a two-component sort (tag, then ts), docid and score
   sorts, terminate_after, return_arrays), 3 times each through the
   node's Searcher.search with NRT_COMPILED_EVAL at its default; none may
   take a fast path. Each answer against the same query on the commit
   opened on the CPU (open_commit): hits, order, totals and relation
   equal, scores bit-equal but where a transcendental function is in the
   score (within 4 f32 ulps); for the geo kinds the whole match masks
   too, a doc flipping only where its CPU f32 distance lies within 4 f32
   ulps of the radius (counted and printed); and against the numpy
   oracles (BM25, the function score, eval_column_query, radius within
   2 m of the f64 distance, and bbox match sets). With the launch counters reset just before and read just after:
   a search with timeout_sec and timeout_check_every 500,000 (two docid
   chunks on the merge path) must launch gather_runs, far_pair_stage,
   far_stage, near_stages and finish_mask, and a score-free return_arrays
   single head_scores. Then 8 requests over gRPC to the node (geo radius
   with text, function score, virtualFields with a script, a
   two-component sort, terminateAfter, timeoutSec, a facet that needs
   match arrays, a prefix query), each bit-equal to the engine's answer
   at the same version. Prints the B=1 p50 per kind, the host waits
   (torch's sync debug mode) and full-sort fallbacks per query, the device-busy share of one nested
   boolean single, the text-scatter time of the largest prefix expansion,
   the peak device memory, the query cache's entries and device bytes and
   the phase's seconds.

13. the write path on the card: a PRIMARY node over phase 4's index with an
   _ID field (and a stored revision marker) added, the commit also opened
   on the CPU, where every operation is replayed through the port's writer
   (the plain versions; the two segment lists must come out equal). Over
   gRPC: deleteByQuery of one tag ordinal and of a price range (about 1%
   each), refresh; 2,000 id'd docs (phase 7's documents with config #3's
   fields) in 4 addDocuments + refresh rounds (tiered merges), delete of
   200 ids and 200 upserts, refresh, UPDATE_DOC_VALUES of price and ts of
   200 more (values above every drawn one), refresh. Each refresh is split
   into the writer's refresh, the publish, the view and head-row rebuild
   and the first single after it. With the launch counters reset just
   before and read just after: phase 5's 8 singles (fused), its first B=32
   batch (merge path, alternating branch), phase 8's singles and batches
   under NRT_FAST_PATH=bucket and the merge path, phase 9's config #3
   forms over gRPC, four general kinds (range filter, geo radius, function
   score, prefix), and the updated values in a range, a ts sort and a
   price sum; head_scores, near_stages, far_stage, far_pair_stage,
   gather_runs, finish_mask and bucket_rank_topk must all launch. No answer
   may hold a deleted doc, a deleted id or an upserted doc's old version.
   Each against the CPU replay's general evaluator (exact f32): fused
   within FUSED_REL, merge within MERGE_REL with hits exact, config #3
   sorts and facets exact, the general kinds bit-equal (geo flips only
   within 4 ulps of the radius); the bucket path within one quantum per
   term of the card's merge path. Then commit, stopIndex, startIndex: 21
   answers bit for bit; and a REPLICA node installs the point (del_gen > 0
   and _dv segments) and answers those 21 requests as the primary does.
   Prints the deleteByQuery seconds, the refresh splits, fused B=1 p50 and
   merge B=32 before and after the deletes, bucket B=32 after them, the
   peak device memory and the phase's seconds.

14. vector search and the result tail on the card (BASELINE config #4,
   SIFT1M's 1,000,000 x 128 shape, and config #5's hybrid request): 1M
   clustered vectors (models.synthetic.clustered_vectors, 1,000 clusters,
   the seed) doc for doc beside phase 4's text and columns, in the same 4
   segments, as three fields: vec (f32, l2_norm), vec_bf16 (bf16, cosine)
   and vec_i8 (int8, dot_product), built with convert.segment_from_numpy;
   the commit also opened on the CPU (the plain runs). First the kNN
   kernel knn_topk at one segment of the vec cell (1,105,228 x 768 f32, B
   = 32 and 1, k = 100) against an f64 reference, timed beside its bound,
   the plain version and torch.mm + masked_top_k; the engine's searches of
   the f32 field must launch it once a segment. Ops: knn_search and
   knn_search_quantized on one 250,000-doc segment (its vector column's
   250,000 rows under the segment's [262,144] mask) for the 5 similarities
   and 3 formats at B=1, k=100, against the CPU run of the same inputs
   (ids equal but at near-ties, scores within 4 f32 ulps of their scale S,
   tests/test_torch_knn.py), p50 by cuda_ms beside the bytes bound. Engine:
   Searcher.knn_search at k=10 and 100, 32 queries per field, B=1 p50 and
   p99, host waits per query; recall@10 of vec against an f64 brute force
   (1.0 but at ties) and of vec_bf16 and vec_i8 against the f32 column
   under their similarity; 8 queries per field plain, filtered on a tag and
   after deleting a tag ordinal, against the CPU copy. Served: a PRIMARY
   node on the card and a CPU node on the same commit; kNN-only (three
   formats, a filter), query + kNN, multiRetriever (BM25 + kNN) under
   WEIGHTED_RRF, WEIGHTED_SCORE SUM and MAX and a raw merge, a query and a
   script rescorer over a window of 100, a drill-sideways facet, each held
   to the CPU node (totals and facets equal, ids equal but at near-ties,
   scores within FUSED_REL where a text score is in them, else the kNN
   tolerance); the hybrid request's launch counters (reset just before,
   read just after). Writes: 2,000 docs with vectors in 4 rounds on both
   nodes (tiered merges carry the vector columns), then the requests again
   with highlights over the new docs' stored text and kNN on the new docs.
   Last, a REPLICA on the card syncs the commit and answers 8 of them bit
   for bit as the primary. Prints the peak device memory and the phase's
   seconds.

15. term positions and the field types that need them. Part A: phase 4's
   corpus with its token sequence kept (the postings unchanged), each
   segment's positions CSR (about 51M positions) beside the postings on
   the card and on a CPU copy; the positions' bytes on the card. At B = 1,
   PHRASE_REPS times each: 8 exact 2-term and 8 exact 3-term phrases drawn
   from the tokens at seeded docs and offsets, the two most frequent terms
   as a phrase (the widest window), 4 sloppy phrases, 4 match-phrases
   through the standard analyzer, 4 phrase-prefixes, 2 span-near queries,
   a phrase MUST beside BM25 SHOULD terms and a phrase under config #3's
   price filter. Exact phrases against a numpy oracle over the flat token
   sequence (hits and docs equal, scores within 1e-6 relative of its f64
   BM25 phrase score, docs equal but at near-ties); every other kind equal
   to the CPU copy (scores within PHRASE_ULPS); ``query.eval.PHRASE_PATHS``
   must show every phrase and phrase-prefix verified by ops.phrase, none by
   the host loop. Prints p50 and p99 per kind, candidates per query, the
   span-near host loop's cost per candidate, a torch.profiler trace of the
   widest phrase (device busy share, largest items), host waits per query
   and the peak device memory. Part B: a PRIMARY node on the card and a
   CPU node; 20,000 parents with 0-4 nested reviews each, a title with a
   keyword child field and indexPrefixes, a POLYGON area and a
   CONTEXT_SUGGEST name, ingested over gRPC; nested queries with inner
   hits, polygon containment, completion (contexts, fuzzy), a prefix on the
   indexPrefixes field, a child-field term and a highlighted match-phrase,
   each bit for bit equal to the CPU node's, before and after deleting
   every tenth parent and a forced merge; served p50 per kind; then a
   REPLICA on the card answers the phrase and nested requests as the
   primary does.

16. virtual shards: ``Searcher.dist_shards`` 2 and 4 with
   ``device.search_devices`` answering the card S times (a mesh of one
   card, data = 1): the repartition (``DistributedBM25.from_searcher``) and
   the dense rows timed, the card bytes per shard; phase 5's 8 singles and
   its first B=32 batch on the merge mesh (NRT_FAST_PATH=merge) with the
   same docs and hits as the local merge path, scores within MESH_REL
   (docs may swap only at such near-ties: the mesh's host impacts may
   differ from the device's in the last bit), and on the fused mesh under
   phase 5's fused contract; p50 at B=1 and B=32 for S = 1 (the local
   path), 2 and 4, and the launches of #1-#6 per request at S=4;
   ``search_general`` at S=4 with config #3's price filter (and a tag
   filter), a ts sort and tag facets, equal to Searcher.search and
   fast_search_reduce; DistributedKNN over phase 14's 1M x 128 f32 vectors
   against knn_search; a served node (phase 10's commit) at virtualShards
   4 on the card x 4 answering phase 5's 32 batch queries as singles like
   the node at virtualShards 1, and with the seam left alone (one card) on
   the local path; the mesh on distinct cards when there are two or more.
18. the standalone bucket API: BucketIndex.build and plan_bucket_batch
   over the merge path's packed postings and phase 5's singles (a term's
   runs as slots), bucket_search_topk on the card (kernel #7/#8's top-k
   entry) equal bit for bit to reference_bucket_search on a host copy.
19. the flagship model (models/flagship.py) at bench.py's configuration:
   phase 4's corpus as one segment (``SyntheticCorpus.to_model``, raw
   lengths), attach_bucket(16384), attach_dense(max_rows 1024, min_df 2048,
   residual rows), each timed, with the bytes on the
   card. With the launch counters reset just before and read just after:
   each of the five routes (search, bucket, dense head + bucket
   tail, dense head + merge tail, fused) on 8 singles and a B=32 batch of
   4 Zipf terms, then one compile_queries_bucketed batch (31 tail-term
   queries and one of the four most frequent terms, which must split);
   head_scores, near_stages, far_stage, far_pair_stage, gather_runs,
   finish_mask, bucket_rank (the dense tail) and bucket_rank_topk (the
   bucket route) must all launch. Per route: B=1 and B=32
   p50 on the host clock, a traced B=32 call's device-busy share (every
   kernel the call launched must show in its trace), its launches, the
   index bytes on the card it holds and its B=32 call's peak working bytes.
   The answers: search bit-equal to a CPU copy of the model (the
   accelerator branch's plain versions) on a B=8 batch and within MERGE_REL
   of the corpus's numpy BM25 (raw lengths), the bucketed split as one
   batch, bucket bit-equal to the CPU copy and to reference_bucket_search
   (4 queries), the dense tail within 8 f32 ulps of the largest score a
   query can reach of the CPU copy (bit-equal rank keys, the head products
   summed in another order) and, plus one quantum per tail term, of
   reference_dense_search (4 queries), dense merge and fused within CPU_GPU_FUSED_REL of the CPU
   copy, their window branch and exact flags printed. Last, the segment
   builder over 20,000 documents of the corpus's token draws with the
   native accumulator (which must load) and with NRT_NATIVE=0, timed; the
   segments must be equal.

Launches per main-path batch: the counters around one fast_search_batch
of the first B=32 batch (merge path), one B=1 query (fused path) and, for
the bucket kernels, one bucket batch.

The last lines are the kernel table as JSON (``launches`` from phase 5's
run, or phase 8's for bucket_rank_topk; ``launches_config3`` from phase 9's, and
``launches_per_config3_request`` from one sorted B=32 batch, or for
head_scores one fused config-#3 single; ``launches_served`` from phase 10's
served searches, ``launches_replica`` from phase 11's searches sent to the
replica alone, ``launches_general`` from phase 12's timeout and arrays
searches, ``launches_write`` from phase 13's searches on the deleted index,
``launches_vectors`` from phase 14's hybrid request, ``launches_mesh`` from
phase 16's S = 2 and S = 4 runs, ``launches_bucket_standalone`` from phase 18's search,
``launches_flagship`` from phase 19's routes),
the card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 42
NUM_DOCS, VOCAB, DRAWS = 1_000_000, 100_000, 48   # bench.py:26-28 defaults
SEGMENTS = 4
TOP_K = 100            # bench.py TOP_K
BATCH = 32             # bench.py BATCH
TERMS_PER_QUERY = 4    # bench.py TERMS_PER_QUERY
FUSED_REL = 1e-4       # fused bound vs exact (tests/test_dense_path_matrix.py)
MERGE_REL = 1e-5       # exact f32, numpy sums in another order
CPU_GPU_FUSED_REL = 1e-6

KERNEL_SOURCES = {
    # the gather of #1 folded into the head products
    "head_scores": ("nrtsearch_tpu_torch/csrc/head_scores.cu",
                    "nrtsearch_tpu/ops/dense_fused.py:77"),
    "near_stages": ("nrtsearch_tpu_torch/csrc/bitonic_merge.cu",
                    "nrtsearch_tpu/ops/pallas_merge.py:194"),
    "far_stage": ("nrtsearch_tpu_torch/csrc/bitonic_merge.cu",
                  "nrtsearch_tpu/ops/pallas_merge.py:54"),
    "far_pair_stage": ("nrtsearch_tpu_torch/csrc/bitonic_merge.cu",
                       "nrtsearch_tpu/ops/pallas_merge.py:112"),
    "gather_runs": ("nrtsearch_tpu_torch/csrc/gather_runs.cu",
                    "nrtsearch_tpu/ops/pallas_merge.py:317"),
    "finish_mask": ("nrtsearch_tpu_torch/csrc/finish_mask.cu",
                    "nrtsearch_tpu/ops/pallas_merge.py:450"),
    # one kernel for both TPU kernels of the bucket path, with two entries:
    # the dense keys (the dense tail's) and each row's top k (the bucket path's)
    "bucket_rank": ("nrtsearch_tpu_torch/csrc/bucket_rank.cu",
                    "nrtsearch_tpu/ops/bucket_retrieval.py:293 (gather_pack_pallas); "
                    "nrtsearch_tpu/ops/bucket_retrieval.py:418 (sort_finish_pallas)"),
    "bucket_rank_topk": ("nrtsearch_tpu_torch/csrc/bucket_rank.cu",
                         "nrtsearch_tpu/ops/bucket_retrieval.py:293 (gather_pack_pallas); "
                         "nrtsearch_tpu/ops/bucket_retrieval.py:418 (sort_finish_pallas) "
                         "and _hierarchical_topk_i32 over its keys"),
    # replaces no TPU kernel: the reference leaves the kNN products and top
    # k to XLA
    "knn_topk": ("nrtsearch_tpu_torch/csrc/knn_topk.cu",
                 "none: nrtsearch_tpu/ops/knn.py _scores (lax.dot_general) and "
                 "masked_top_k (lax.top_k), left to XLA"),
}
# the kernel of phase 8's bucket path; phase 5 drives the others but these
# and the dense entry, which only the dense tail (phase 19) launches
BUCKET_KERNELS = ("bucket_rank_topk",)
DENSE_TAIL_KERNELS = ("bucket_rank",)
# the kNN path's kernel, which phase 14 drives
VECTOR_KERNELS = ("knn_topk",)
# the one PyTorch call that computes a kernel's function, timed beside it
# (the port never calls it), or why there is none
LIBRARY = {
    "head_scores": "none: no single torch call gathers and multiplies; the parent's "
                   "sequence is timed beside it",
    "near_stages": "none: no torch call runs a fixed compare-exchange network",
    "far_stage": "none: no torch call runs one compare-exchange stage",
    "far_pair_stage": "none: no torch call runs two compare-exchange stages",
    "gather_runs": "none: no torch call gathers ragged runs with a weight",
    "finish_mask": "none: no torch call runs a bounded segmented scan",
    "bucket_rank": "none: torch.Tensor.index_add_ sums but weighs, quantizes and "
                   "masks nothing",
    "bucket_rank_topk": "none: no torch call sums postings; library_ms times the "
                        "route it replaces, bucket_rank and topk_i32_lowest_index "
                        "(torch.topk over [B, m * 2^bits] int64 keys)",
    "knn_topk": "torch.mm (f32, TF32 off) and ops/topk.py masked_top_k over the "
                "[B, rows] dots",
}
# the card's peaks (H100 SXM data sheet): device memory, the f32 rate
# outside the tensor cores, at which one compare-exchange or add counts, and
# the dense bf16 tensor-core rate of head_scores' products
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
TENSOR_OPS_PER_S = 989e12
L2_FLUSH_BYTES = 128 << 20   # written before each timed launch: > the 50 MB L2
# GPU spin before each timed launch (about 1 ms on an H100), so that the host
# has enqueued the timed work before the start event runs: the events then
# time the device's work, not the host's Python before the launch
SPIN_CYCLES = 2_000_000
# profile_call: idle inside each trace on both sides of the measured call,
# and the traces taken at most before a missing kernel fails the phase
PROFILE_PAD_S = 0.2
PROFILE_TRIES = 3
# (B, U) of the fused path's dispatches: an engine single, the batcher's
# padded groups and a B=32 batch, at the U menu's two widths
HEAD_SHAPES = ((1, 32), (8, 32), (16, 128), (32, 128))


def bound(nbytes: float, ops: float, ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _log2(x: int) -> int:
    return x.bit_length() - 1


def scan_steps(max_seg: int) -> int:
    """The segmented scan's steps: distances 1, 2, 4, ... below max_seg."""
    return max(0, (max_seg - 1).bit_length())


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, setup=lambda: (), reps: int = 25, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times of ``fn(*setup())``, in ms;
    ``setup`` (fresh inputs for in-place kernels) runs outside the timed
    window, then a write of L2_FLUSH_BYTES evicts the L2, so that no launch
    finds its input (or the copy setup just made) there, and a GPU spin of
    SPIN_CYCLES keeps the card busy while the host enqueues ``fn``."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    times = []
    for i in range(warmup + reps):
        args = setup()
        scratch.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        if i >= warmup:
            times.append(a.elapsed_time(b))
    return float(np.median(times))


def sm_clock_under(fn, seconds: float = 3.0) -> dict:
    """What nvidia-smi samples every 100 ms while ``fn`` runs back to back
    for ``seconds`` (the first two samples, taken as the load starts, left
    out): the median and lowest SM clock, the card's highest SM clock, in
    MHz, and the median power draw in W."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        proc.stdout.readline()          # sampling has started
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    samples = []
    for line in out.splitlines():
        try:
            samples.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    samples = np.array(samples[2:], dtype=np.float64).reshape(-1, 3)
    if not len(samples):
        raise AssertionError(f"nvidia-smi gave no clock samples: {out[:200]!r}")
    return {"sm_mhz": float(np.median(samples[:, 0])), "sm_mhz_min": float(samples[:, 0].min()),
            "sm_mhz_max": float(samples[:, 1].max()), "watts": float(np.median(samples[:, 2])),
            "samples": len(samples)}


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------


def _merge_inputs(gen, B: int, N: int, dev):
    """[B, N] rows of two sorted halves, the second reversed (one bitonic
    merge level of run_len N/2): duplicate docs, LOW front padding in the
    first half, HIGH back padding, and row B-1 all HIGH padding."""
    from nrtsearch_tpu_torch.ops.merge_scoring import DOC_SENTINEL, DOC_SENTINEL_LOW

    half = N // 2
    docs = torch.randint(0, N // 4, (B, 2, half), generator=gen, device=dev, dtype=torch.int32)
    docs[:, 0, :64] = int(DOC_SENTINEL_LOW)
    docs[:, :, -half // 8 :] = int(DOC_SENTINEL)
    docs = torch.sort(docs, dim=-1).values
    docs[:, 1] = torch.flip(docs[:, 1], dims=(-1,))
    docs = docs.reshape(B, N).contiguous()
    docs[B - 1] = int(DOC_SENTINEL)
    contribs = torch.rand((B, N), generator=gen, device=dev)
    contribs[docs == int(DOC_SENTINEL)] = 0.0
    return docs, contribs


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _inplace_bytes(docs: torch.Tensor, contribs: torch.Tensor, fn) -> int:
    """Bytes an in-place compare-exchange pass must move on this input:
    every doc read once (the compares), and for each entry it changes the
    contrib read and both written once; a pair that stays needs no
    contrib."""
    x, y = docs.clone(), contribs.clone()
    fn(x, y)
    changed = (x != docs) | (y.view(torch.int32) != contribs.view(torch.int32))
    return 4 * docs.numel() + 12 * int(changed.sum())


def _abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries where either is finite (both -inf
    counts as equal)."""
    a, b = a.double(), b.double()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def parent_head_sequence(rows, rows_lo, idx, w_hi, w_lo, ind_w=None):
    """The head scores as the parent computed them, the yardstick of
    head_scores: two row gathers (torch.index_select standing in for the
    removed copy kernel, which tied or trailed it), four bf16 products with
    f32 out (the parent's ``_mm``: ``torch.mm(..., out_dtype=torch.float32)``
    on the card) and three adds; with ``ind_w`` (bf16 W != 0) the indicator
    product too."""
    from nrtsearch_tpu_torch.ops.dense_fused import _mm

    ru, lu = torch.index_select(rows, 0, idx), torch.index_select(rows_lo, 0, idx)
    S = _mm(w_hi, ru) + _mm(w_hi, lu) + _mm(w_lo, ru) + _mm(w_lo, lu)
    return S, None if ind_w is None else _mm(ind_w, (ru > 0).to(torch.bfloat16))


def head_bytes_ops(B: int, U: int, n_rows: int, D: int,
                   require_all: bool) -> tuple[int, int]:
    """head_scores' bytes (the n_rows distinct head and residual row slices
    of its U slots read once, idx and the bf16 weights, S written, and C
    under require_all) and its tensor-core operations (the [2B, 2U] x
    [2U, D] product, and the [B, U] x [U, D] count)."""
    nbytes = (2 * n_rows * D * 2 + 4 * U + 2 * 2 * B * U
              + B * D * 4 * (2 if require_all else 1))
    ops = 2 * (2 * B) * (2 * U) * D + (2 * B * U * D if require_all else 0)
    return nbytes, ops


def exact_dekker_check(rows, rows_lo, idx, gen, B: int, U: int) -> float:
    """head_scores with one weight per query: each S element is one weight
    times one row, so the four Dekker products are exact and S must equal
    their f64 sum within EXACT_ULPS * sum|products| (three rounded adds).
    W_lo * rows_lo alone must pass that tolerance at many elements, so a
    kernel that dropped any term fails. Returns max |dS| / sum|products|."""
    from nrtsearch_tpu_torch import kernels

    dev = rows.device
    slot = torch.randint(0, U - 4, (B,), generator=gen, device=dev)
    W = torch.zeros((B, U), device=dev)
    W[torch.arange(B, device=dev), slot] = one_weights(
        torch.rand((2, B), generator=gen, device=dev))
    w_hi = W.to(torch.bfloat16)
    w_lo = (W - w_hi.float()).to(torch.bfloat16)
    S, _ = kernels.head_scores(rows, rows_lo, idx, w_hi, w_lo, False)
    r = idx.long()[slot]
    wh, wl = w_hi.double().gather(1, slot[:, None]), w_lo.double().gather(1, slot[:, None])
    R, L = rows[r].double(), rows_lo[r].double()
    scale = (wh.abs() + wl.abs()) * (R.abs() + L.abs())
    err = (S.double() - (wh + wl) * (R + L)).abs()
    tol = EXACT_ULPS * scale
    if int((wl.abs() * L.abs() > 4 * tol).sum()) < 1000:
        raise AssertionError(f"head_scores exact check cannot see W_lo * rows_lo at B={B} U={U}")
    if not bool((err <= tol).all()):
        raise AssertionError(f"head_scores misses a Dekker term at B={B} U={U}: max |dS| / "
                             f"sum|products| {float((err / scale.clamp_min(1e-30)).max()):.3g}")
    return float((err / scale.clamp_min(1e-30)).max())


def one_weights(u: torch.Tensor) -> torch.Tensor:
    """f32 weights from uniforms u [2, n]: a bf16 value in [0.25, 4.25) plus
    0.5-0.95 of half its ulp, so that W_lo is at least 2^-10 of W and the
    residual products are far above f32 rounding."""
    w_hi = (0.25 + 4 * u[0]).to(torch.bfloat16).float()
    return w_hi + (0.5 + 0.45 * u[1]) * torch.exp2(torch.floor(torch.log2(w_hi)) - 8)


# the three f32 adds of exact products each round by at most 2^-23 of
# sum|products| (tensor cores may truncate), plus one for slack
EXACT_ULPS = 4 * 2.0**-23


def phase_head_scores(dev, gen, Hp: int = 536, D: int = 1_000_064) -> dict:
    """head_scores against head_scores_plain on the card at HEAD_SHAPES
    (and the require_all count at (16, 128)), the Dekker rows of sparse
    random impacts, U - 4 distinct head rows (the planner's idx) and 4 pad
    slots, nonnegative weights: S within 2 * (4U) * 2^-24 * sum|products|
    of the plain version (the f32 summation bound of both orders), S > 0
    equal everywhere (nonnegative terms), C bit-equal; with one weight per
    query, every Dekker term (exact_dekker_check). Times of the kernel, the
    plain version, the parent's sequence and index_select alone; the bound
    counts the distinct rows read."""
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.ops import dense_fused

    f = torch.rand((Hp, D), generator=gen, device=dev)
    f = torch.where(torch.rand((Hp, D), generator=gen, device=dev) < 0.3, 4 * f, 0.0)
    rows = f.to(torch.bfloat16)
    rows_lo = (f - rows.float()).to(torch.bfloat16)
    del f
    st = {"max_abs_err": 0.0, "max_rel_err": 0.0, "max_exact_rel_err": 0.0, "shapes": []}
    cases = [(B, U, False) for B, U in HEAD_SHAPES] + [(16, 128, True)]
    for B, U, require_all in cases:
        idx = torch.zeros(U, dtype=torch.int32, device=dev)   # pad slots repeat row 0 ...
        idx[: U - 4] = torch.argsort(torch.rand(Hp, generator=gen, device=dev))[: U - 4]
        n_rows = int(idx.unique().numel())
        W = 0.25 + 4 * torch.rand((B, U), generator=gen, device=dev)
        W[:, U - 4:] = 0.0                                # ... at weight 0
        W[0, 0] = 0.0
        w_hi = W.to(torch.bfloat16)
        w_lo = (W - w_hi.float()).to(torch.bfloat16)
        S, C = kernels.head_scores(rows, rows_lo, idx, w_hi, w_lo, require_all)
        ref_s, ref_c = dense_fused.head_scores_plain(rows, rows_lo, idx, W, require_all)
        absum = (rows.index_select(0, idx).float().abs()
                 + rows_lo.index_select(0, idx).float().abs())
        P = w_hi.float().abs() @ absum + w_lo.float().abs() @ absum
        del absum
        err = (S.double() - ref_s.double()).abs()
        ctx = f"B={B} U={U} require_all={require_all}"
        if not bool((err <= 2 * (4 * U) * 2.0**-24 * P.double()).all()):
            raise AssertionError(f"head_scores beyond the summation bound at {ctx}")
        if not torch.equal(S > 0, ref_s > 0):
            raise AssertionError(f"head_scores S > 0 differs from the plain version at {ctx}")
        if require_all and not _bits_equal(C, ref_c):
            raise AssertionError(f"head_scores C differs from the plain version at {ctx}")
        if not bool((S > 0).any()):
            raise AssertionError(f"head_scores matched nothing at {ctx}")
        abs_err = float(err.max())
        rel_err = float((err / P.double().clamp_min(1e-30)).max())
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
        st["max_rel_err"] = max(st["max_rel_err"], rel_err)
        del S, C, ref_s, ref_c, P, err
        exact_err = exact_dekker_check(rows, rows_lo, idx, gen, B, U)
        st["max_exact_rel_err"] = max(st["max_exact_rel_err"], exact_err)
        ind_w = (W != 0).to(torch.bfloat16) if require_all else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(100):
            kernels.head_scores(rows, rows_lo, idx, w_hi, w_lo, require_all)
        host_us = 1e4 * (time.perf_counter() - t)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kernels.head_scores(rows, rows_lo, idx, w_hi, w_lo, require_all))
        plain = cuda_ms(lambda: dense_fused.head_scores_plain(rows, rows_lo, idx, W, require_all))
        parent = cuda_ms(lambda: parent_head_sequence(rows, rows_lo, idx, w_hi, w_lo, ind_w))
        gather = cuda_ms(lambda: torch.index_select(rows, 0, idx))
        nbytes, ops = head_bytes_ops(B, U, n_rows, D, require_all)
        b_ms, b_by = bound(nbytes, ops, TENSOR_OPS_PER_S)
        one = {"B": B, "U": U, "rows": n_rows, "require_all": require_all, "ms": ms,
               "plain_ms": plain, "parent_ms": parent, "index_select_ms": gather,
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": abs_err,
               "max_rel_err": rel_err, "exact_rel_err": exact_err, "host_us": host_us}
        st["shapes"].append(one)
        log(f"kernel head_scores Hp={Hp} D={D} {ctx} ({n_rows} distinct rows, Dekker rows): "
            f"S within the bound (max |dS| {abs_err:.3g}, max |dS| / sum|products| "
            f"{rel_err:.3g}; the bound allows {2 * 4 * U * 2.0**-24:.3g}), S > 0 equal"
            f"{', C bit-equal' if require_all else ''}; one weight per query: every Dekker "
            f"term, |dS| / sum|products| {exact_err:.3g} (allowed {EXACT_ULPS:.3g}); "
            f"{ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {100 * b_ms / ms:.1f}%), plain {plain:.4f} ms, parent's sequence "
            f"{parent:.4f} ms, index_select of the head rows {gather:.4f} ms; the host "
            f"enqueues a call in {host_us:.1f} us")
        if (B, U, require_all) == HEAD_SHAPES[-1] + (False,):
            st.update(ms=ms, plain_ms=plain, library_ms=None, parent_ms=parent,
                      index_select_ms=gather, shape=[Hp, D, B, U], bytes=nbytes, ops=ops,
                      ops_per_s=TENSOR_OPS_PER_S)
    del rows, rows_lo
    return st


def phase_kernels(dev, merge_widths, batch_n: int, head: bool = True) -> dict:
    from nrtsearch_tpu_torch.ops import bitonic_merge as bm

    gen = torch.Generator(device=dev).manual_seed(SEED)
    stats = {name: {"max_abs_err": 0.0} for name in ("near_stages", "far_stage")}
    if head:
        stats["head_scores"] = phase_head_scores(dev, gen)
        torch.cuda.empty_cache()

    B = 32
    for N in merge_widths:
        docs, contribs = _merge_inputs(gen, B, N, dev)
        kd, kc = docs.clone(), contribs.clone()
        bm.merge_level(kd, kc, N // 2)                     # kernels
        td, tc = docs.clone(), contribs.clone()
        d = N // 2
        while d >= 1:                                      # twins
            bm.far_stage_twin(td, tc, d)
            d //= 2
        err = max(float((kd.long() - td.long()).abs().max()),
                  float((kc - tc).abs().max()))
        for name in ("near_stages", "far_stage"):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if not (torch.equal(kd, td) and torch.equal(kc.view(torch.int32), tc.view(torch.int32))):
            raise AssertionError(f"merge level differs from its twin at N={N}")
        if not bool((kd[:, 1:] >= kd[:, :-1]).all()):
            raise AssertionError(f"merge level output not sorted at N={N}")
        # each timed launch gets a fresh copy of the input the level hands
        # it (the stages before it applied), so the in-place stages swap as
        # they do on the main path
        d0 = bm.near_tile(N) // 2
        far_d = bm.near_tile(N)          # the far stage the merge batch runs
        far_in = (docs.clone(), contribs.clone())
        d = N // 2
        while d > far_d:
            bm.far_stage(*far_in, d)
            d //= 2
        near_in = (far_in[0].clone(), far_in[1].clone())
        bm.far_stage(*near_in, far_d)

        def fresh_far():
            return far_in[0].clone(), far_in[1].clone()

        def fresh():
            return near_in[0].clone(), near_in[1].clone()

        near_ms = cuda_ms(lambda x, y: bm.near_stages(x, y, d0), fresh)
        near_plain = cuda_ms(lambda x, y: bm.near_stages_twin(x, y, d0), fresh)
        far_ms = cuda_ms(lambda x, y: bm.far_stage(x, y, far_d), fresh_far)
        far_plain = cuda_ms(lambda x, y: bm.far_stage_twin(x, y, far_d), fresh_far)
        log(f"kernel merge level B={B} N={N}: bit-equal; near_stages(d0={d0}) "
            f"{near_ms:.4f} ms, twin {near_plain:.4f} ms; far_stage(d={far_d}) "
            f"{far_ms:.4f} ms, twin {far_plain:.4f} ms")
        if N == batch_n:
            # bytes: _inplace_bytes (docs read, changed entries moved); ops:
            # one compare-exchange per pair and stage
            near_b = _inplace_bytes(*near_in, lambda x, y: bm.near_stages(x, y, d0))
            far_b = _inplace_bytes(*far_in, lambda x, y: bm.far_stage(x, y, far_d))
            stats["near_stages"].update(ms=near_ms, plain_ms=near_plain, shape=[B, N, d0],
                                        bytes=near_b, ops=(_log2(d0) + 1) * B * N // 2)
            stats["far_stage"].update(ms=far_ms, plain_ms=far_plain, shape=[B, N, far_d],
                                      bytes=far_b, ops=B * N // 2)
        if N == 1 << 15:
            # short runs: one direction per pair (m below the tile)
            for m in (64, 2048):
                kd, kc = docs.clone(), contribs.clone()
                bm.near_stages(kd, kc, m // 2, m)
                td, tc = bm.near_stages_twin(docs.clone(), contribs.clone(), m // 2, m)
                if not (_bits_equal(kd, td) and _bits_equal(kc, tc)):
                    raise AssertionError(f"near_stages differs from its twin at m={m}")
            log(f"kernel near_stages B={B} N={N} m in (64, 2048): bit-equal")
        del docs, contribs, kd, kc, td, tc, far_in, near_in
    return stats


def batch_plan(searcher, queries):
    """The [B, R] run tables and run_len the merge path plans for one batch
    of term lists (PackedFieldView.search_batch -> PrunedIndex._run_full)."""
    from nrtsearch_tpu_torch.ops.merge_scoring import plan_run_lists

    view = searcher.packed_view("body")
    idx = view.index
    rows = []
    for q in queries:
        spec = searcher.fast_query_spec(_match(q))
        rows.append([
            (int(idx.run_offsets[r]), int(idx.run_lengths[r]), w)
            for _t, w, runs in view.term_entries(spec.terms, spec.boost) if w
            for r in runs if idx.run_lengths[r]
        ])
    return plan_run_lists(rows, max_run=int(idx.doc_ids.shape[0]))


def phase_accel_kernels(dev, searcher, batch) -> dict:
    """The merge path's accelerator branch, kernels against twins: the
    batch's own gather, network and finish, then far_pair_stage and
    finish_mask at B=32 and N from four near tiles up to the batch's width."""
    from nrtsearch_tpu_torch.ops import bitonic_merge as bm
    from nrtsearch_tpu_torch.ops import merge_scoring as ms

    idx = searcher.packed_view("body").index
    offs, lens, weights, run_len = batch_plan(searcher, batch)
    B, R = offs.shape
    width = R * run_len
    log(f"kernel plan: first B={B} batch -> R={R} run_len={run_len} width {width} "
        f"(alternating branch from {ms.ALT_MIN_WIDTH}: {width >= ms.ALT_MIN_WIDTH})")
    if width < ms.ALT_MIN_WIDTH:
        raise AssertionError("the B=32 batch would not take the alternating branch")
    tabs = [torch.as_tensor(a, device=dev) for a in (offs, lens, weights)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    stats = {name: {"max_abs_err": 0.0} for name in ("gather_runs", "far_pair_stage", "finish_mask")}

    def hold(name, out, ref, ctx):
        for o, r in zip(out, ref):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], _abs_err(o, r))
            if not _bits_equal(o, r):
                raise AssertionError(f"{name} differs from its twin: {ctx}")

    gather_args = (idx.doc_ids, idx.impacts, *tabs, run_len, True)
    kd, kc = ms.gather_runs_accel(*gather_args)
    td, tc = ms.gather_runs_twin(*gather_args)
    hold("gather_runs", (kd, kc), (td, tc), f"B={B} R={R} run_len={run_len}")
    g_ms = cuda_ms(lambda: ms.gather_runs_accel(*gather_args))
    g_plain = cuda_ms(lambda: ms.gather_runs_twin(*gather_args))
    # bytes: the runs' live postings read (doc + impact), the tables, the
    # [B, R, run_len] docs and contribs written
    live = int(np.minimum(lens, run_len).sum())
    stats["gather_runs"].update(ms=g_ms, plain_ms=g_plain, shape=[B, R, run_len],
                                bytes=8 * live + 12 * B * R + 8 * B * R * run_len,
                                ops=live)
    log(f"kernel gather_runs B={B} R={R} run_len={run_len} alternating: bit-equal; "
        f"{g_ms:.4f} ms, twin {g_plain:.4f} ms")

    t0 = time.perf_counter()
    md, mc = bm.merge_sorted_runs_alt(kd, kc)            # kernels, in place
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wd, wc = bm.merge_sorted_runs_alt_twin(td, tc)       # twins, in place
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not (_bits_equal(md, wd) and _bits_equal(mc, wc)):
        raise AssertionError("the alternating network differs from its twin")
    if not bool((md[:, 1:] >= md[:, :-1]).all()):
        raise AssertionError("the alternating network's output is not sorted")
    log(f"kernel merge_sorted_runs_alt B={B} N={width}: bit-equal and sorted; "
        f"{1e3 * (t1 - t0):.3f} ms, twins {1e3 * (t2 - t1):.3f} ms (host clock, one run)")
    del td, tc, wd, wc

    n_terms = torch.randint(1, 4, (B,), generator=gen, device=dev, dtype=torch.int32)
    for require_all in (False, True):
        out = ms.finish_mask(md, mc, n_terms, R, require_all)
        ref = ms.finish_mask_twin(md, mc, n_terms, R, require_all)
        hold("finish_mask", (out,), (ref,), f"batch, require_all={require_all}")
        if not bool(torch.isfinite(out).any()):
            raise AssertionError("finish_mask kept no doc of the batch")
    f_ms = cuda_ms(lambda: ms.finish_mask(md, mc, n_terms, R, False))
    f_plain = cuda_ms(lambda: ms.finish_mask_twin(md, mc, n_terms, R, False))
    # bytes: the stream read (8 B an entry), the scores written (4 B);
    # ops: one add per entry and scan step
    stats["finish_mask"].update(ms=f_ms, plain_ms=f_plain, shape=[B, width, R],
                                bytes=12 * B * width + 4 * B,
                                ops=B * width * scan_steps(R))
    log(f"kernel finish_mask B={B} N={width} max_seg={R}: bit-equal; {f_ms:.4f} ms, "
        f"twin {f_plain:.4f} ms")
    del kd, kc, md, mc

    N = 4 * bm.NEAR_TILE               # the least width far_pair_stage takes
    while N <= width:
        docs, contribs = _merge_inputs(gen, B, N, dev)
        cases = [(N // 2, 0)] + ([(N // 4, N // 2)] if N // 8 >= bm.near_tile(N) else [])
        for d, m in cases:
            kd, kc = docs.clone(), contribs.clone()
            bm.far_pair_stage(kd, kc, d, m)
            td, tc = docs.clone(), contribs.clone()
            bm.far_pair_stage_twin(td, tc, d, m)
            hold("far_pair_stage", (kd, kc), (td, tc), f"N={N} d={d} m={m}")

        def fresh():
            return docs.clone(), contribs.clone()

        p_ms = cuda_ms(lambda x, y: bm.far_pair_stage(x, y, N // 2), fresh)
        p_plain = cuda_ms(lambda x, y: bm.far_pair_stage_twin(x, y, N // 2), fresh)
        pair_b = _inplace_bytes(docs, contribs, lambda x, y: bm.far_pair_stage(x, y, N // 2))
        bm.merge_level(docs, contribs, N // 2)            # a sorted stream
        fk = ms.finish_mask(docs, contribs, n_terms, R, True)
        ft = ms.finish_mask_twin(docs, contribs, n_terms, R, True)
        hold("finish_mask", (fk,), (ft,), f"N={N}")
        fn_ms = cuda_ms(lambda: ms.finish_mask(docs, contribs, n_terms, R, True))
        fn_plain = cuda_ms(lambda: ms.finish_mask_twin(docs, contribs, n_terms, R, True))
        log(f"kernel B={B} N={N}: far_pair_stage(d={N // 2}) bit-equal {p_ms:.4f} ms, twin "
            f"{p_plain:.4f} ms; finish_mask(max_seg={R}, require_all) bit-equal "
            f"{fn_ms:.4f} ms, twin {fn_plain:.4f} ms")
        if 2 * N > width:
            stats["far_pair_stage"].update(ms=p_ms, plain_ms=p_plain, shape=[B, N, N // 2],
                                           bytes=pair_b, ops=B * N)
        del docs, contribs, kd, kc, td, tc, fk, ft
        N *= 2
    return stats


# ---------------------------------------------------------------------------
# phases 4-7: index, search, exact answers, ingest
# ---------------------------------------------------------------------------


def body_field_defs():
    from nrtsearch_tpu_torch.schema import create_field_def

    return {"body": create_field_def("body", {"type": "TEXT", "search": True})}


# BASELINE config #3's doc-value fields (benchmarks/stress_deep_boolean.py:131-136)
CONFIG3_FIELDS = {
    "price": {"type": "FLOAT", "storeDocValues": True},
    "ts": {"type": "FLOAT", "storeDocValues": True},
    "tag": {"type": "ATOM", "storeDocValues": True},
}


# the general evaluator's geo column (models.synthetic METRO_BOX points)
GENERAL_FIELDS = {"loc": {"type": "LAT_LON", "storeDocValues": True}}


def index_field_defs():
    from nrtsearch_tpu_torch.schema import create_field_def

    return {**body_field_defs(),
            **{n: create_field_def(n, spec)
               for n, spec in {**CONFIG3_FIELDS, **GENERAL_FIELDS}.items()}}


def phase_index(dev, num_docs: int, vocab: int, draws: int, segments: int):
    from nrtsearch_tpu_torch.convert import segment_from_numpy
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.models.synthetic import SyntheticCorpus

    t0 = time.perf_counter()
    # the token sequence is kept for phase 15 (term positions); the draws
    # and postings are the same with and without it, and phases 4-14 take
    # the segments without positions
    corpus = SyntheticCorpus(num_docs, vocab, draws, seed=SEED, keep_positions=True)
    columns = corpus.doc_columns(seed=SEED)
    t1 = time.perf_counter()
    segs = [segment_from_numpy(a, dev, doc_values=dv) for a, dv in zip(
        corpus.segment_arrays(segments, positions=False),
        corpus.segment_doc_values(columns, segments))]
    t2 = time.perf_counter()
    searcher = Searcher(segs, index_field_defs())
    searcher.warm(["body"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    st = searcher.packed_view("body")._dense_state()
    log(f"index: {num_docs} docs, vocab {vocab}, {len(corpus.post_docs)} postings, "
        f"{segments} segments; corpus {t1 - t0:.1f} s, segments to device "
        f"{t2 - t1:.1f} s, pack + dense rows {t3 - t2:.1f} s")
    log(f"index: {len(st['head_pos'])} head rows x D={st['D']} (+ residual rows: "
        f"{st['rows_lo'] is not None}), tail_max_df {st['tail_max_df']}; doc values "
        f"{', '.join([*CONFIG3_FIELDS, *GENERAL_FIELDS])} "
        f"({sum(c[0].nbytes + c[1].nbytes for c in columns.values()) / 2**20:.1f} MiB)")
    return corpus, columns, searcher


def fused_tail_width(searcher) -> int:
    """R * run_len of the fused path's fixed tail shape on this snapshot."""
    view = searcher.packed_view("body")
    return view._DENSE_R * view.dense_run_len(view._dense_state()["tail_max_df"])


def conjunction_terms(corpus, searcher) -> list[str]:
    """Two head terms and the most frequent tail term: a conjunction the
    fused path refuses (a tail term), served by the merge path."""
    head = searcher.packed_view("body")._dense_state()["head_pos"]
    order = np.argsort(-corpus.term_lengths, kind="stable")
    tail = next(str(t) for t in order if str(t) not in head)
    return [str(order[0]), str(order[1]), tail]


def _match(terms, operator="SHOULD"):
    from nrtsearch_tpu_torch.query import parse_query

    return parse_query({"matchQuery": {"field": "body", "query": " ".join(terms),
                                       "operator": operator}})


def sample_search_queries(corpus) -> tuple[list, list]:
    """Phase 5's queries: 8 singles and 4 batches of 32."""
    singles = corpus.sample_queries(8, TERMS_PER_QUERY)
    batches = [corpus.sample_queries(BATCH, TERMS_PER_QUERY) for _ in range(4)]
    return singles, batches


def merge_branches() -> dict:
    """The merge path's accelerator-branch calls so far on the card, by
    network, from the kernels' launch counts: each call launches
    ``gather_runs`` once, and a call on the alternating network ends in one
    ``finish_mask``."""
    from nrtsearch_tpu_torch import kernels

    alt = kernels.LAUNCHES["finish_mask"]
    return {"alt": alt, "plain": kernels.LAUNCHES["gather_runs"] - alt}


def _branch_delta(before: dict) -> dict:
    now = merge_branches()
    return {k: now[k] - before[k] for k in before}


def batcher_totals(batcher) -> dict:
    """The micro-batcher's exported totals so far (``server/monitoring.py``'s
    histograms): ``group_count`` and ``group_sum`` (groups and the queries
    in them), ``wait_count`` and ``wait_sum`` (queries and their seconds from
    enqueue to dispatch)."""
    out = {}
    for key, hist in (("group", batcher.metrics.batcher_group_size),
                      ("wait", batcher.metrics.batcher_wait)):
        for metric in hist.collect():
            for sample in metric.samples:
                for end in ("_count", "_sum"):
                    if sample.name.endswith(end):
                        out[key + end] = sample.value
    return out


def phase_search(corpus, searcher, singles, batches, reps: int = 3) -> dict:
    """The main path. Returns results, latencies, path counts and the merge
    branch each B=32 batch took."""
    conj = conjunction_terms(corpus, searcher)
    view = searcher.packed_view("body")
    paths0 = dict(view.path_counts)
    lat1, lat32, batch_branches = [], [], []
    single_out = batch_out = None
    for _ in range(reps):
        single_out = []
        for q in singles:
            t = time.perf_counter()
            single_out.append(searcher.search(_match(q), TOP_K))
            lat1.append(time.perf_counter() - t)
        batch_out = []
        for qs in batches:
            t = time.perf_counter()
            specs = [searcher.fast_query_spec(_match(q)) for q in qs]
            before = merge_branches()
            batch_out.append(searcher.fast_search_batch(specs, TOP_K))
            lat32.append(time.perf_counter() - t)
            batch_branches.append(_branch_delta(before))
    conj_out = searcher.search(_match(conj, "MUST"), TOP_K)
    paths = {k: view.path_counts[k] - paths0[k] for k in paths0}
    return {
        "singles": singles, "single_out": single_out, "batches": batches,
        "batch_out": batch_out, "conj": conj, "conj_out": conj_out,
        "lat1": lat1, "lat32": lat32, "paths": paths, "batch_branches": batch_branches,
    }


def profile_batch(searcher, batch, specs=None) -> dict:
    """``profile_call`` over one ``fast_search_batch`` of ``batch`` (or of
    ``specs``, when given)."""
    if specs is None:
        specs = [searcher.fast_query_spec(_match(q)) for q in batch]
    return profile_call(lambda: searcher.fast_search_batch(specs, TOP_K))


def _traced_kernel(name: str, items) -> bool:
    """Whether a device item of the trace is the port's kernel ``name``
    (its C++ function ``<name>_kernel``, or ``<name>_wide_kernel``)."""
    pat = re.compile(rf"\b{name}(_wide)?_kernel\b")
    return any(pat.search(n) for n in items)


def profile_call(fn) -> dict:
    """``torch.profiler`` over one ``fn()``: the device's busy time (the sum
    of the durations of every kernel, copy and memset on the card; one
    stream, so they do not overlap), the number of those device items, the
    largest ones and the traced wall time on the host clock. The tracer's
    own host cost varies from run to run (tens to hundreds of ms), so the
    busy share is taken against the untraced latency, not this wall.

    Every kernel of the port that the traced call launched (its count in
    ``kernels.LAUNCHES`` moved) must show among the trace's device items.
    Without a warm-up step the tracer loses more and more of a call's
    kernels the longer the process has run (on an H100, all five of a merge
    batch's kernels after about 3 minutes of searches), so each trace is a
    schedule of one warm-up call, traced and discarded, and the measured
    call, with PROFILE_PAD_S of idle on both sides; a trace that still
    lacks a launched kernel (or holds no device item) is taken again,
    PROFILE_TRIES in all, and then the phase fails."""
    from nrtsearch_tpu_torch import kernels

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for attempt in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            prof.step()
            before = dict(kernels.LAUNCHES)
            time.sleep(PROFILE_PAD_S)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
            time.sleep(PROFILE_PAD_S)
            prof.step()
        # device items only: an operator's row would count its kernels
        # again, and the profiler's own step annotation spans the whole
        # batch on the device's timeline
        per_name: dict[str, list] = {}
        for e in prof.events():
            annotation = (getattr(e, "is_user_annotation", False)
                          or e.name.startswith("ProfilerStep"))
            if e.device_type == torch.autograd.DeviceType.CUDA and not annotation:
                acc = per_name.setdefault(e.name, [0.0, 0])
                acc[0] += e.time_range.elapsed_us() / 1e3
                acc[1] += 1
        launched = sorted(k for k, v in kernels.LAUNCHES.items() if v > before.get(k, 0))
        lost = [k for k in launched if not _traced_kernel(k, per_name)]
        if per_name and not lost:
            break
        log(f"profile: trace {attempt + 1} held {len(per_name)} device item names and "
            f"lacks the launched kernels {lost}; tracing once more")
    else:
        raise AssertionError(f"{PROFILE_TRIES} traces of one call lacked the kernels it "
                             f"launched: {lost} (held {sorted(per_name)[:8]})")
    items = sorted(((k, ms, n) for k, (ms, n) in per_name.items()), key=lambda x: -x[1])
    busy = sum(x[1] for x in items)
    return {"traced_wall_ms": wall, "device_busy_ms": busy,
            "device_items": sum(x[2] for x in items), "kernels": launched,
            "top": [[k[:60], ms, n] for k, ms, n in items[:10]]}


def launches_per_batch(searcher, single, batch) -> dict:
    """Kernel launches of one main-path request: the first B=32 batch
    through fast_search_batch (the merge path's kernels) and one B=1 query
    (head_scores, on the fused path)."""
    from nrtsearch_tpu_torch import kernels

    specs = [searcher.fast_query_spec(_match(q)) for q in batch]
    kernels.reset_launch_counts()
    searcher.fast_search_batch(specs, TOP_K)
    torch.cuda.synchronize()
    b32 = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    searcher.search(_match(single), TOP_K)
    torch.cuda.synchronize()
    b1 = dict(kernels.LAUNCHES)
    log(f"search: launches per B=32 batch {b32}; per B=1 query {b1}")
    return {k: b1[k] if k == "head_scores" else b32[k] for k in KERNEL_SOURCES}


def _check_topk(td, exact, rel: float, ctx: str) -> int:
    """Scores rank by rank within ``rel``; a doc may differ from the exact
    answer only where the two scores at that rank are within ``rel`` (a
    near-tie: f32 sums taken in another order break ties by score, not by
    docid). Hits exact, or a lower bound when the relation says so.
    Returns the number of near-tie swaps."""
    s, d, total = exact
    docs = np.array([h.global_ord for h in td.hits], np.int64)
    scores = np.array([h.score for h in td.hits], np.float32)
    if len(docs) != len(d):
        raise AssertionError(f"{ctx}: {len(docs)} hits, exact has {len(d)}")
    err = np.abs(scores - s) / np.maximum(np.abs(s), 1e-9)
    if len(err) and err.max() > rel:
        raise AssertionError(f"{ctx}: score rel err {err.max():.3g} > {rel}")
    swaps = np.nonzero(docs != d)[0]
    if len(set(docs.tolist())) != len(docs):
        raise AssertionError(f"{ctx}: duplicate docs in the top-k")
    for i in swaps:
        if abs(float(s[i]) - float(scores[i])) > rel * abs(float(s[i])):
            raise AssertionError(f"{ctx}: doc {docs[i]} != {d[i]} at rank {i}")
    exact_hits = td.relation == "EQUAL_TO"
    if (exact_hits and td.total_hits != total) or td.total_hits > total:
        raise AssertionError(f"{ctx}: hits {td.total_hits} ({td.relation}) vs {total}")
    return len(swaps)


def phase_exact(corpus, res) -> dict:
    """The 8 singles (fused path) and the conjunction (merge path) against
    the corpus's independent numpy BM25."""
    out = {"fused_rel": 0.0, "merge_rel": 0.0, "swaps": 0}
    for q, td in zip(res["singles"], res["single_out"]):
        ex = corpus.exact_topk(q, TOP_K)
        out["swaps"] += _check_topk(td, ex, FUSED_REL, f"single {q}")
        out["fused_rel"] = max(out["fused_rel"], _max_rel(td, ex))
    ex = corpus.exact_topk(res["conj"], TOP_K, require_all=True)
    td = res["conj_out"]
    if td.relation != "EQUAL_TO" or td.total_hits != ex[2]:
        raise AssertionError(f"conjunction hits {td.total_hits} vs exact {ex[2]}")
    out["swaps"] += _check_topk(td, ex, MERGE_REL, f"conjunction {res['conj']}")
    out["merge_rel"] = _max_rel(td, ex)
    out["conj_hits"] = ex[2]
    return out


def _max_rel(td, exact) -> float:
    s = exact[0]
    if not len(s):
        return 0.0
    sc = np.array([h.score for h in td.hits], np.float32)
    return float(np.max(np.abs(sc - s) / s))


INGEST_QUERIES = {
    "or_head": ("common alpha", "SHOULD"),
    "or_mixed": ("common needle beta", "SHOULD"),
    "tail_only": ("needle", "SHOULD"),
    "must_head": ("common gamma", "MUST"),
    "must_tail": ("delta needle", "MUST"),
}


def _ingest_docs(n: int) -> list[dict]:
    rng = np.random.default_rng(SEED)
    words = ["alpha", "beta", "gamma", "delta"]
    docs = []
    for i in range(n):
        toks = ["common"] * int(rng.integers(1, 4))
        toks += [words[j] for j in rng.integers(0, 4, size=int(rng.integers(1, 6)))]
        if i % 23 == 0:
            toks.append("needle")
        docs.append({"id": str(i), "body": " ".join(toks)})
    return docs


def _with_env(name: str, value: str, fn):
    """Run ``fn()`` with the environment variable ``name`` set to
    ``value``, then restore it."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def _with_path(path: str, fn):
    """Run ``fn()`` with NRT_FAST_PATH set to ``path``, then restore it."""
    return _with_env("NRT_FAST_PATH", path, fn)


def phase_ingest(dev, n_docs: int = 2000) -> dict:
    """IndexWriter -> refresh on the card and on the CPU; search both."""
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.schema import create_field_def

    fds = {"id": create_field_def("id", {"type": "_ID", "store": True}),
           **body_field_defs()}
    docs = _ingest_docs(n_docs)
    searchers = {}
    for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        w = IndexWriter(fds, d)
        w.add_documents([dict(x) for x in docs[: n_docs // 2]])
        w.refresh()
        w.add_documents([dict(x) for x in docs[n_docs // 2 :]])
        searchers[name] = Searcher(w.refresh(), fds)

    def check(path: str) -> int:
        for qname, (text, op) in INGEST_QUERIES.items():
            node = _match(text.split(), op)
            alt0 = merge_branches()["alt"]
            g = searchers["gpu"].search(node, 50)
            c = searchers["cpu"].search(node, 50)
            ctx = f"ingest {qname}/{path}"
            gd = [h.global_ord for h in g.hits]
            cd = [h.global_ord for h in c.hits]
            gs = np.array([h.score for h in g.hits], np.float32)
            cs = np.array([h.score for h in c.hits], np.float32)
            if (g.total_hits, g.relation) != (c.total_hits, c.relation) or not gd:
                raise AssertionError(f"{ctx}: hits {g.total_hits} vs {c.total_hits}")
            if path == "merge":
                # the card runs the accelerator branch (unclamped gather),
                # the CPU the plain branch (clamping gather): bit-equal
                # only because these widths stay below ALT_MIN_WIDTH, so
                # both use the plain network, and no run clamps (the
                # packed postings carry 2 * 8192 entries of slack)
                if merge_branches()["alt"] != alt0:
                    raise AssertionError(f"{ctx}: took the alternating branch")
                if gd != cd or not np.array_equal(gs, cs):
                    raise AssertionError(f"{ctx}: cuda and cpu differ")
            else:
                if len(gd) != len(cd) or np.max(np.abs(gs - cs) / cs) > CPU_GPU_FUSED_REL:
                    raise AssertionError(f"{ctx}: scores differ beyond 1e-6")
                for i, (a, b) in enumerate(zip(gd, cd)):
                    if a != b and abs(gs[i] - cs[i]) > CPU_GPU_FUSED_REL * cs[i]:
                        raise AssertionError(f"{ctx}: doc {a} != {b} at rank {i}")
        return len(INGEST_QUERIES)

    checked = sum(_with_path(path, lambda: check(path)) for path in ("merge", "fused"))
    return {"docs": n_docs, "queries_checked": checked}


# ---------------------------------------------------------------------------
# phase 8: the bucket path
# ---------------------------------------------------------------------------


def _timed_searches(searcher, singles, batches, reps: int = 3) -> dict:
    lat1, lat32 = [], []
    single_out = batch_out = None
    for _ in range(reps):
        single_out = []
        for q in singles:
            t = time.perf_counter()
            single_out.append(searcher.search(_match(q), TOP_K))
            lat1.append(time.perf_counter() - t)
        batch_out = []
        for qs in batches:
            t = time.perf_counter()
            specs = [searcher.fast_query_spec(_match(q)) for q in qs]
            batch_out.append(searcher.fast_search_batch(specs, TOP_K))
            lat32.append(time.perf_counter() - t)
    return {"single_out": single_out, "batch_out": batch_out, "lat1": lat1, "lat32": lat32}


def phase_bucket_kernels(dev, view, specs) -> dict:
    """bucket_rank against its plain version at the plan the bucket path
    makes for ``specs``."""
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.ops import bucket_retrieval as br

    plan = view.bucket_plan(specs)
    if plan is None or plan["live"] is None:
        raise AssertionError("the bucket path refused the first B=32 batch")
    docs, imps = view.index.doc_ids, view.index.impacts
    toffs, bounds, wts, n_terms = (torch.as_tensor(plan[k], device=dev) for k in
                                   ("term_offs", "bounds", "weights", "n_terms"))
    B, T, m1 = bounds.shape
    m, tile, bits = m1 - 1, plan["tile"], plan["bits"]
    # bytes: the live slots' postings read (doc + impact), the plan tables,
    # the [B, m * 2^bits] rank written
    live = int(np.where(plan["weights"][..., None] != 0,
                        plan["bounds"][..., 1:] - plan["bounds"][..., :-1], 0).sum())
    tables = 4 * (toffs.numel() + bounds.numel() + wts.numel() + n_terms.numel())
    rank_bytes = 4 * B * (m << bits)
    log(f"bucket plan: first B={B} batch -> T={T} slots, m={m} buckets of {1 << bits} "
        f"docs; bucket_rank reads {8 * live / 2**20:.1f} MiB of postings ({live} live) "
        f"and writes {rank_bytes / 2**20:.1f} MiB of rank keys (the plain version's key "
        f"tile: {B * m * tile * 4 / 2**20:.0f} MiB at tile {tile})")
    args = (docs, imps, toffs, bounds, wts)
    need = torch.randint(1, 3, (B,), device=dev, dtype=torch.int32)
    for require_all, nt in ((False, n_terms), (True, need)):
        ref = br.bucket_rank_plain(*args, nt, tile=tile, bucket_bits=bits,
                                   require_all=require_all)
        out = kernels.bucket_rank(*args, nt, bits, require_all)
        if not _bits_equal(out, ref):
            raise AssertionError(f"bucket_rank differs from its plain version, "
                                 f"require_all={require_all}")
        if not bool((ref != int(br.I32_MIN)).any()):
            raise AssertionError("bucket_rank kept no doc of the batch")
        if not require_all:
            over = _rows_over(ref, B * m, TOP_K)
        del ref, out
    log(f"bucket rows: {100 * over:.2f}% of the first B={B} batch's {B * m} (query, "
        f"bucket) rows hold more than k={TOP_K} hits (the plain version's keys)")
    ms = cuda_ms(lambda: kernels.bucket_rank(*args, n_terms, bits, False))
    plain_ms = cuda_ms(lambda: br.bucket_rank_plain(*args, n_terms, tile=tile,
                                                    bucket_bits=bits, require_all=False))
    log(f"kernel bucket_rank B={B} T={T} m={m} bits={bits}: bit-equal (require_all both "
        f"ways); {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"bucket_rank": {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                            "shape": [B, T, m, 1 << bits],
                            "bytes": 8 * live + tables + rank_bytes, "ops": live}}


def _rows_over(rank, rows: int, k: int) -> float:
    """The share of ``rows`` (query, bucket) rows of dense rank keys that
    hold more than k hits: the rows whose top k the selection prunes."""
    hits = (rank != -(2**31)).reshape(rows, -1).sum(dim=1)
    return float((hits > k).float().mean())


def phase_bucket_topk(dev) -> dict:
    """bucket_rank_topk at the bucket cell's shape, on drawn scores and on
    a tie-heavy batch (see the module docstring, phase 8)."""
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.ops import bucket_retrieval as br
    from nrtsearch_tpu_torch.ops.topk import topk_i32_lowest_index

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_bucket_data import CELL, bucket_tables

    B, T, m, bits, k = CELL["B"], CELL["T"], CELL["m"], CELL["bits"], TOP_K
    kk = min(k, 1 << bits)
    out = {}
    for ties in (False, True):
        tabs, n_terms, tile = bucket_tables(dev, 1900 + ties, ties=ties)
        need = torch.minimum(n_terms, (torch.arange(B, device=dev, dtype=torch.int32) // 2)
                             % T + 1)
        for require_all, nt in ((False, n_terms), (True, need)):
            kernels.reset_launch_counts()
            keys, docs, hits = br.bucket_search_topk(*tabs, nt, tile=tile, bucket_bits=bits,
                                                     k=k, require_all=require_all)
            torch.cuda.synchronize()
            launched = {n: kernels.LAUNCHES[n] for n in ("bucket_rank", "bucket_rank_topk")}
            if launched != {"bucket_rank": 0, "bucket_rank_topk": 1}:
                raise AssertionError(f"bucket_search_topk launched {launched}")
            cands, _ = kernels.bucket_rank_topk(*tabs, nt, bits, require_all, k)
            ref_c, ref_h = br.bucket_rank_topk_plain(*tabs, nt, tile=tile, bucket_bits=bits,
                                                     require_all=require_all, k=k)
            rows = torch.sort(cands.reshape(-1, kk), dim=-1, descending=True).values
            if not (_bits_equal(rows.reshape(cands.shape), ref_c)
                    and _bits_equal(hits, ref_h)):
                raise AssertionError(f"bucket_rank_topk differs from its plain version, "
                                     f"ties={ties} require_all={require_all}")
            del cands, ref_c, rows
            rank = br.bucket_rank_plain(*tabs, nt, tile=tile, bucket_bits=bits,
                                        require_all=require_all)
            want_k, want_d = topk_i32_lowest_index(rank, k)
            if not (_bits_equal(keys, want_k) and _bits_equal(docs, want_d.to(torch.int32))):
                raise AssertionError(f"bucket_search_topk differs from the dense route, "
                                     f"ties={ties} require_all={require_all}")
            out[(ties, require_all)] = _rows_over(rank, B * m, kk)
            del rank, want_k, want_d
        torch.cuda.empty_cache()
        if not ties:
            drawn = (tabs, n_terms, tile)
    tabs, n_terms, tile = drawn

    def dense_route():
        rank = kernels.bucket_rank(*tabs, n_terms, bits, False)
        hits = (rank != int(br.I32_MIN)).sum(dim=-1, dtype=torch.int32)
        return topk_i32_lowest_index(rank, k), hits

    ms = cuda_ms(lambda: kernels.bucket_rank_topk(*tabs, n_terms, bits, False, k))
    search_ms = cuda_ms(lambda: br.bucket_search_topk(*tabs, n_terms, tile=tile,
                                                      bucket_bits=bits, k=k))
    library_ms = cuda_ms(dense_route, reps=10)
    plain_ms = cuda_ms(lambda: br.bucket_rank_topk_plain(
        *tabs, n_terms, tile=tile, bucket_bits=bits, require_all=False, k=k), reps=5)
    live = int(torch.where((tabs[4] != 0)[..., None], tabs[3][..., 1:] - tabs[3][..., :-1],
                           0).sum())
    tables = 4 * sum(t.numel() for t in tabs[2:]) + 4 * B
    log(f"kernel bucket_rank_topk B={B} T={T} m={m} bits={bits} k={k}: candidates equal to "
        f"the plain version's and bucket_search_topk equal to the dense route bit for bit "
        f"(drawn and tie-heavy, require_all both ways); rows over k (pruned): drawn "
        f"{100 * out[(False, False)]:.2f}% ({100 * out[(False, True)]:.2f}% with "
        f"require_all), tie-heavy {100 * out[(True, False)]:.2f}% "
        f"({100 * out[(True, True)]:.2f}%); {ms:.4f} ms, bucket_search_topk {search_ms:.4f} "
        f"ms, the dense route (bucket_rank, topk_i32_lowest_index) {library_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms; {live} live postings")
    return {"bucket_rank_topk": {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                 "library_ms": library_ms, "search_ms": search_ms,
                                 "rows_over_k": {f"ties={t},require_all={r}": v
                                                 for (t, r), v in out.items()},
                                 "shape": [B, T, m, 1 << bits, k],
                                 "bytes": 8 * live + tables + 8 * B * m * kk + 4 * B,
                                 "ops": live}}


def _check_bucket_answer(b, mres, tol: float, ctx: str) -> float:
    """Bucket TopDocs against merge TopDocs: equal hit counts, scores of a
    doc in both within ``tol``, a doc in one top-k only within ``tol`` of
    the other's k-th score. Returns the worst score difference."""
    if b.total_hits != mres.total_hits or b.relation != mres.relation:
        raise AssertionError(f"{ctx}: bucket hits {b.total_hits} vs merge {mres.total_hits}")
    bs = {h.global_ord: h.score for h in b.hits}
    ms = {h.global_ord: h.score for h in mres.hits}
    if len(bs) != len(ms):
        raise AssertionError(f"{ctx}: {len(bs)} bucket hits returned vs {len(ms)}")
    worst = 0.0
    for d in bs.keys() & ms.keys():
        worst = max(worst, abs(bs[d] - ms[d]))
        if abs(bs[d] - ms[d]) > tol:
            raise AssertionError(f"{ctx}: doc {d} bucket {bs[d]} vs merge {ms[d]}")
    b_kth = b.hits[-1].score if b.hits else 0.0
    m_kth = mres.hits[-1].score if mres.hits else 0.0
    for d in bs.keys() - ms.keys():
        if bs[d] > m_kth + tol:
            raise AssertionError(f"{ctx}: doc {d} only in the bucket top-k")
    for d in ms.keys() - bs.keys():
        if ms[d] > b_kth + tol:
            raise AssertionError(f"{ctx}: doc {d} only in the merge top-k")
    return worst


def _shares_scale_bound(view, spec) -> bool:
    """Two slots of one weight on different query terms, or a repeated
    term: the bucket plan keys its scale bounds by weight."""
    weights = [w for _t, w, runs in view.term_entries(spec.terms, spec.boost)
               if w and any(view.index.run_lengths[r] for r in runs)]
    return len(set(weights)) < len(weights)


def phase_bucket(dev, searcher, singles, batches, card: str) -> dict:
    from nrtsearch_tpu_torch import kernels

    view = searcher.packed_view("body")
    t = time.perf_counter()
    st = view._bucket_state()
    torch.cuda.synchronize()
    log(f"bucket state: {len(st['bounds'])} runs x {st['m'] + 1} bounds "
        f"({st['bounds'].nbytes / 2**20:.1f} MiB on the host) in "
        f"{time.perf_counter() - t:.2f} s")
    stats = phase_bucket_kernels(
        dev, view, [searcher.fast_query_spec(_match(q)) for q in batches[0]])
    torch.cuda.empty_cache()
    stats.update(phase_bucket_topk(dev))
    torch.cuda.empty_cache()

    merge = _with_path("merge", lambda: _timed_searches(searcher, singles, batches))
    paths0 = dict(view.path_counts)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    bucket = _with_path("bucket", lambda: _timed_searches(searcher, singles, batches))
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in BUCKET_KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    paths = {k: view.path_counts[k] - paths0[k] for k in paths0}
    n_specs = 3 * (len(singles) + sum(len(b) for b in batches))
    n_batches = 3 * (len(singles) + len(batches))
    log(f"bucket: launches {launches} over {n_batches} bucket batches; specs by path {paths}")
    if paths["bucket"] != n_specs or paths["merge"] or paths["fused"]:
        raise AssertionError(f"every bucket-phase spec must take the bucket path: {paths}")
    if any(n != n_batches for n in launches.values()):
        raise AssertionError(f"bucket kernels must launch once per bucket batch: {launches}")
    specs = [searcher.fast_query_spec(_match(q)) for q in batches[0]]
    kernels.reset_launch_counts()
    _with_path("bucket", lambda: searcher.fast_search_batch(specs, TOP_K))
    per_batch = {k: kernels.LAUNCHES[k] for k in BUCKET_KERNELS}
    prof = _with_path("bucket", lambda: profile_batch(searcher, batches[0]))
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiled bucket batch ran nothing on the device")

    worst, shared = 0.0, 0
    pairs = list(zip(singles, bucket["single_out"], merge["single_out"]))
    for qs, bo, mo in zip(batches, bucket["batch_out"], merge["batch_out"]):
        pairs += list(zip(qs, bo, mo))
    for q, b, mres in pairs:
        spec = searcher.fast_query_spec(_match(q))
        if _shares_scale_bound(view, spec):
            # the reference's scale: one bound per weight, so sums can clip
            # at QMAX and the clipped docs rank by doc id (ROADMAP §3)
            shared += 1
            if (b.total_hits, b.relation) != (mres.total_hits, mres.relation):
                raise AssertionError(f"bucket {q}: hits {b.total_hits} vs merge "
                                     f"{mres.total_hits}")
            continue
        scale = float(view.bucket_plan([spec])["scales"][0])
        worst = max(worst, scale * _check_bucket_answer(
            b, mres, len(q) / scale, f"bucket {q}"))
    p50 = {name: (1e3 * float(np.median(r["lat1"])), 1e3 * float(np.median(r["lat32"])))
           for name, r in (("merge", merge), ("bucket", bucket))}
    log(f"bucket: {len(pairs)} answers against the merge path: hits equal; "
        f"{len(pairs) - shared} with scores, worst difference {worst:.3f} quanta "
        f"(bound: 1 per query term); {shared} whose plan shares a scale bound "
        f"held to hit counts only")
    log(f"bucket: p50 B=1 {p50['bucket'][0]:.2f} ms (merge {p50['merge'][0]:.2f}), "
        f"B=32 {p50['bucket'][1]:.2f} ms (merge {p50['merge'][1]:.2f}); n = "
        f"{len(bucket['lat1'])} / {len(bucket['lat32'])}; peak device memory "
        f"{peak / 2**30:.3f} GiB | {card}")
    log(f"bucket profile: first B={BATCH} batch, device busy {prof['device_busy_ms']:.3f} ms "
        f"({100 * prof['device_busy_ms'] / p50['bucket'][1]:.1f}% of the bucket B={BATCH} "
        f"p50; traced wall {prof['traced_wall_ms']:.3f} ms); top device items "
        f"{json.dumps(prof['top'])} | {card}")
    return {"stats": stats, "launches": launches, "per_batch": per_batch}


# ---------------------------------------------------------------------------
# phase 9: config #3, the filtered, sorted and faceted forms
# ---------------------------------------------------------------------------

# the kernels of the port's fused and merge paths, which phase 9 must launch
CONFIG3_KERNELS = ("head_scores", "near_stages", "far_stage", "far_pair_stage",
                   "gather_runs", "finish_mask")
FACETS = [{"kind": "ordinal", "field": "tag"}, {"kind": "sum", "field": "price"}]
SUM_REL = 1e-5


def config3_singles(corpus, searcher) -> list[tuple[str, list[str]]]:
    """8 (expected path, terms) pairs: 4 with two head and two tail terms
    (the fused path: 4 segments x 2 tail terms fill its R = 8 tail runs)
    and 4 with one head and three tail terms (12 tail runs: the merge
    path). Tail terms come from the 2,000 most frequent ones, so that
    matches survive the filters."""
    head = searcher.packed_view("body")._dense_state()["head_pos"]
    by_df = np.argsort(-corpus.term_lengths, kind="stable")
    head_terms = [str(t) for t in by_df if str(t) in head][:200]
    tail_terms = [str(t) for t in by_df if str(t) not in head][:2000]
    rng = np.random.default_rng(SEED + 3)
    out = []
    for i in range(8):
        n_head = 2 if i < 4 else 1
        hs = rng.choice(len(head_terms), n_head, replace=False)
        ts = rng.choice(len(tail_terms), 4 - n_head, replace=False)
        out.append(("fused" if i < 4 else "merge",
                    [head_terms[j] for j in hs] + [tail_terms[j] for j in ts]))
    return out


def _served(view, fn):
    """``fn()`` and the path that served it (by the view's path counts)."""
    before = dict(view.path_counts)
    out = fn()
    moved = [k for k in before if view.path_counts[k] != before[k]]
    if len(moved) != 1:
        raise AssertionError(f"one path must serve each search: {moved}")
    return out, moved[0]


def _check_sorted(td, ex, ctx: str) -> None:
    keys = np.array([h.sort_key for h in td.hits], np.float32)
    docs = np.array([h.global_ord for h in td.hits], np.int64)
    if td.total_hits != ex["hits"] or td.relation != "EQUAL_TO":
        raise AssertionError(f"{ctx}: hits {td.total_hits} vs exact {ex['hits']}")
    if not (np.array_equal(keys.view(np.int32), ex["scores"].astype(np.float32).view(np.int32))
            and np.array_equal(docs, ex["docs"])):
        raise AssertionError(f"{ctx}: sorted keys or docs differ from the exact answer")


def phase_config3(corpus, columns, searcher, batch, card: str) -> dict:
    """The three config-#3 forms on the card (see the module docstring);
    launch counters reset just before the searches and read just after."""
    from dataclasses import replace

    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.core.searcher import SortSpec
    from nrtsearch_tpu_torch.models.synthetic import column_clauses, config3_query
    from nrtsearch_tpu_torch.ops import merge_scoring
    from nrtsearch_tpu_torch.query import parse_query

    view = searcher.packed_view("body")
    names = columns["tag"][2]
    singles = config3_singles(corpus, searcher)
    trees = [config3_query(terms, names, SEED + i) for i, (_p, terms) in enumerate(singles)]
    ts_desc, price_asc = SortSpec("ts", reverse=True), SortSpec("price")
    forms = {
        "scored": lambda i: searcher.search(parse_query(trees[i]), TOP_K),
        "sorted_ts": lambda i: searcher.search(parse_query(trees[i]), TOP_K, sort=ts_desc),
        "sorted_price": lambda i: searcher.search(_match(singles[i][1]), TOP_K, sort=price_asc),
        "faceted": lambda i: searcher.fast_search_reduce(
            searcher.compile_batchable(parse_query(trees[i])), TOP_K, FACETS),
    }
    batch_specs = [searcher.compile_batchable(_match(q), ts_desc) for q in batch]
    if len({id(sp.sort[0]) for sp in batch_specs}) != 1:
        raise AssertionError("the B=32 batch's specs must share one sort key object")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    fallbacks0 = merge_scoring.TOPK_FALLBACKS["hierarchical_topk"]
    branch0 = merge_branches()
    paths0 = dict(view.path_counts)
    lat = {name: [] for name in forms}
    lat["sorted_b32"] = []
    # _hierarchical_topk's full-sort fallbacks per form and path
    falls = {(name, p): 0 for name in lat for p in ("fused", "merge")}
    out: dict = {}
    for _rep in range(3):
        for name, run in forms.items():
            for i in range(len(singles)):
                f0 = merge_scoring.TOPK_FALLBACKS["hierarchical_topk"]
                t = time.perf_counter()
                res, path = _served(view, lambda: run(i))
                lat[name].append(time.perf_counter() - t)
                out[(name, i)] = (res, path)
                falls[(name, path)] += merge_scoring.TOPK_FALLBACKS["hierarchical_topk"] - f0
        f0 = merge_scoring.TOPK_FALLBACKS["hierarchical_topk"]
        t = time.perf_counter()
        b0 = merge_branches()
        batch_out = searcher.fast_search_batch(batch_specs, TOP_K)
        lat["sorted_b32"].append(time.perf_counter() - t)
        batch_calls = _branch_delta(b0)
        falls[("sorted_b32", "merge")] += merge_scoring.TOPK_FALLBACKS["hierarchical_topk"] - f0
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in CONFIG3_KERNELS}
    fallbacks = merge_scoring.TOPK_FALLBACKS["hierarchical_topk"] - fallbacks0
    branches = _branch_delta(branch0)
    paths = {k: view.path_counts[k] - paths0[k] for k in paths0}
    peak = torch.cuda.max_memory_allocated()
    log(f"config3: launches {launches}; specs by path {paths}; merge branch {branches}; "
        f"_hierarchical_topk full-sort fallbacks {fallbacks}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"config #3 did not launch {missing}")
    if not (paths["fused"] and paths["merge"] and branches["alt"]):
        raise AssertionError(f"both paths and the alternating branch must serve: "
                             f"{paths} {branches}")
    if batch_calls != {"alt": 1, "plain": 0}:
        raise AssertionError(f"the shared-sort B=32 batch must be one alternating "
                             f"dispatch: {batch_calls}")
    # launches of one column request, each counted alone: the shared-sort
    # B=32 batch (merge path) and one scored tree single on each path
    per_request = {}
    for label, fn in (("sorted_b32", lambda: searcher.fast_search_batch(batch_specs, TOP_K)),
                      ("scored_fused", lambda: forms["scored"](0)),
                      ("scored_merge", lambda: forms["scored"](len(singles) - 1))):
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        per_request[label] = {k: kernels.LAUNCHES[k] for k in CONFIG3_KERNELS}
    log(f"config3: launches per column request {per_request}")

    # against the independent numpy answer
    worst = {"fused": 0.0, "merge": 0.0}
    swaps = 0
    for i, (want, terms) in enumerate(singles):
        node = column_clauses(trees[i])
        for name in forms:
            res, path = out[(name, i)]
            expect = "merge" if name == "faceted" else want
            if path != expect:
                raise AssertionError(f"{name} single {i} took the {path} path, not {expect}")
            ctx = f"config3 {name} {terms} ({path})"
            if name == "sorted_price":
                ex = corpus.exact_filtered_topk(terms, TOP_K, columns,
                                                sort=("price", True, False))
                _check_sorted(res, ex, ctx)
                continue
            sort = ("ts", False, False) if name == "sorted_ts" else None
            ex = corpus.exact_filtered_topk(terms, TOP_K, columns, node, sort=sort,
                                            facet="tag", total="price")
            if name == "sorted_ts":
                _check_sorted(res, ex, ctx)
                continue
            td = res[0] if name == "faceted" else res
            rel = FUSED_REL if path == "fused" else MERGE_REL
            swaps += _check_topk(td, (ex["scores"], ex["docs"], ex["hits"]), rel, ctx)
            worst[path] = max(worst[path], _max_rel(td, (ex["scores"],)))
            if name == "faceted":
                facets, total = res[1]
                want_f = {names[j]: int(c) for j, c in enumerate(ex["facet"]) if c}
                if facets != want_f:
                    raise AssertionError(f"{ctx}: facet counts differ")
                if abs(total - ex["total"]) > SUM_REL * abs(ex["total"]):
                    raise AssertionError(f"{ctx}: price sum {total} vs {ex['total']}")
    for q, td in zip(batch, batch_out):
        ex = corpus.exact_filtered_topk(q, TOP_K, columns, sort=("ts", False, False))
        _check_sorted(td, ex, f"config3 sorted batch {q}")
    log(f"config3 exact: {len(singles)} x {len(forms)} singles and the B={len(batch)} "
        f"sorted batch; hits exact; scores worst rel fused {worst['fused']:.3g} "
        f"(<= {FUSED_REL}), merge {worst['merge']:.3g} (<= {MERGE_REL}); near-tie swaps "
        f"{swaps}; sorted keys and docs equal; facet counts equal, price sums within "
        f"{SUM_REL}")

    p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
    prof = profile_batch(searcher, batch, specs=batch_specs)
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiled sorted batch ran nothing on the device")
    log(f"config3 p50 B=1: " + ", ".join(f"{k} {v:.2f} ms" for k, v in p50.items()
                                         if k != "sorted_b32")
        + f"; sorted B={len(batch)} {p50['sorted_b32']:.2f} ms (n = {len(lat['scored'])} per "
        f"form, {len(lat['sorted_b32'])} batches); peak device memory {peak / 2**30:.3f} GiB "
        f"| {card}")
    log(f"config3 profile: sorted B={len(batch)} batch, device busy "
        f"{prof['device_busy_ms']:.3f} ms ({100 * prof['device_busy_ms'] / p50['sorted_b32']:.1f}% "
        f"of its p50; traced wall {prof['traced_wall_ms']:.3f} ms); top device items "
        f"{json.dumps(prof['top'])} | {card}")
    for i in (0, len(singles) - 1):
        one = profile_call(lambda: forms["scored"](i))
        log(f"config3 profile: scored single {i} ({singles[i][0]} path), device busy "
            f"{one['device_busy_ms']:.3f} ms in {one['device_items']} device items "
            f"(traced wall {one['traced_wall_ms']:.3f} ms; p50 of the form "
            f"{p50['scored']:.2f} ms); top {json.dumps(one['top'][:5])} | {card}")
    log(f"config3 _hierarchical_topk: {fallbacks} full-sort fallbacks over "
        f"{3 * (len(singles) * len(forms) + 1)} searches; by form and path "
        f"{ {f'{k[0]}/{k[1]}': n for k, n in falls.items() if n} } | {card}")
    # per request as for the main path: head_scores from a fused single,
    # the merge path's kernels from the sorted batch
    return {"launches": launches, "per_request": {
        k: per_request["scored_fused" if k == "head_scores" else "sorted_b32"][k]
        for k in CONFIG3_KERNELS}}


def _ingest_docs_with_values(n: int) -> list[dict]:
    """Phase 7's documents plus doc-value fields: price (f32-exact), tag,
    a LONG above 2^24 (an f64 column) and a multi-valued ATOM."""
    rng = np.random.default_rng(SEED + 5)
    docs = _ingest_docs(n)
    for i, d in enumerate(docs):
        d["price"] = str(float(np.float32(rng.uniform(0, 100))))
        d["tag"] = f"t{int(rng.integers(0, 6))}"
        d["big"] = str((1 << 25) + 3 * i)
        d["labels"] = [f"l{int(j)}" for j in rng.integers(0, 5, 1 + i % 3)]
    return docs


def phase_commit(dev, n_docs: int = 2000) -> dict:
    """IndexWriter on the card -> commit_segments -> open_commit on the
    card: filtered (an f64 and a multi-valued clause through the eager
    leaf evaluator), sorted and faceted answers bit-equal before and after."""
    import tempfile

    from nrtsearch_tpu_torch.core.directory import commit_segments, open_commit
    from nrtsearch_tpu_torch.core.searcher import Searcher, SortSpec
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.query import parse_query
    from nrtsearch_tpu_torch.schema import create_field_def

    specs = {"id": {"type": "_ID", "store": True},
             "body": {"type": "TEXT", "search": True},
             "price": {"type": "FLOAT", "storeDocValues": True},
             "tag": {"type": "ATOM", "storeDocValues": True},
             "big": {"type": "LONG", "storeDocValues": True},
             "labels": {"type": "ATOM", "storeDocValues": True, "multiValued": True}}
    fds = {n: create_field_def(n, sp) for n, sp in specs.items()}
    docs = _ingest_docs_with_values(n_docs)
    w = IndexWriter(fds, dev)
    w.add_documents(docs[: n_docs // 2])
    w.refresh()
    w.add_documents(docs[n_docs // 2 :])
    before = Searcher(w.refresh(), fds)
    tree = parse_query({"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"matchQuery": {"field": "body", "query": "common needle beta"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "10",
                                                      "upper": "80"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "big", "lower": "33554500"}}},
        {"occur": "MUST_NOT", "query": {"termQuery": {"field": "labels", "textValue": "l2"}}},
        {"occur": "MUST", "query": {"boost": 1.5, "termInSetQuery": {
            "field": "tag", "textTerms": {"terms": ["t1", "t3"]}}}}]}})
    plain = _match(["common", "delta"])

    def answers(s):
        out = []
        for td in (s.search(tree, 50), s.search(tree, 50, sort=SortSpec("price")),
                   s.search(plain, 50, sort=SortSpec("tag", reverse=True))):
            out.append((td.total_hits, [h.global_ord for h in td.hits],
                        [np.float32(h.score).view(np.int32).item() for h in td.hits],
                        [h.sort_key for h in td.hits]))
        td, red = s.fast_search_reduce(s.compile_batchable(tree), 50,
                                       [{"kind": "ordinal", "field": "labels"},
                                        {"kind": "sum", "field": "price"}])
        out.append((td.total_hits, [h.global_ord for h in td.hits], red))
        return out

    want = answers(before)
    with tempfile.TemporaryDirectory() as tmp:
        commit_segments(before.segments, tmp, gen=1, version=1)
        manifest, segs = open_commit(tmp, dev)
        n_files = len(os.listdir(tmp))
    after = Searcher(segs, fds)
    if any(seg.device != dev for seg in segs):
        raise AssertionError(f"open_commit must place the segments on {dev}")
    got = answers(after)
    if got != want:
        raise AssertionError("the committed index answers differently after open_commit")
    if not all(a[0] for a in want):
        raise AssertionError("a commit-phase search matched nothing")
    log(f"commit: {n_docs} docs in {len(segs)} segments (gen {manifest.gen}, {n_files} files), "
        f"reopened on the card: 4 filtered/sorted/faceted answers bit-equal (hits "
        f"{[a[0] for a in want]})")
    return {"segments": len(segs)}


# ---------------------------------------------------------------------------
# phase 10: the served path, through the port's gRPC server
# ---------------------------------------------------------------------------

SERVED_INDEX = "synthetic"
# 32 client threads and the batcher's 8 workers: the gRPC pool must hold
# every concurrent request, or the batcher cannot see them together
SERVED_CONFIG = {"threadPoolConfiguration": {"grpc": {"maxThreads": 64}}}
SERVED_CHUNKS = 8          # addDocuments + refresh rounds of the ingest
SERVED_FIELDS = [
    ("body", {"type": "TEXT", "search": True}),
    ("price", {"type": "FLOAT", "storeDocValues": True}),
    ("ts", {"type": "FLOAT", "storeDocValues": True}),
    ("tag", {"type": "ATOM", "storeDocValues": True}),
    ("loc", {"type": "LAT_LON", "storeDocValues": True}),
]


def _served_td(resp, sort_field: str | None = None):
    """A SearchResponse in the shape ``_check_topk`` / ``_check_sorted``
    read (hits with global_ord, score and sort_key; total_hits; relation)."""
    from types import SimpleNamespace

    from nrtsearch_tpu_torch.gen import pb

    hits = [SimpleNamespace(
        global_ord=h.luceneDocId, score=h.score,
        sort_key=h.sortedFields[sort_field].fieldValue[0].doubleValue if sort_field else None)
        for h in resp.hits]
    return SimpleNamespace(hits=hits, total_hits=resp.totalHits.value,
                           relation=pb.TotalHits.Relation.Name(resp.totalHits.relation))


def _request(query: dict, k: int = TOP_K, **kw):
    from google.protobuf.json_format import ParseDict

    from nrtsearch_tpu_torch.gen import pb

    req = pb.SearchRequest(indexName=SERVED_INDEX, topHits=k, **kw)
    ParseDict(query, req.query)
    return req


def _match_dict(terms, operator: str = "SHOULD") -> dict:
    return {"matchQuery": {"field": "body", "query": " ".join(terms), "operator": operator}}


def _grouped_filters(tree: dict) -> dict:
    """The config #3 tree with its FILTER clauses inside one FILTER boolean:
    the same matches and scores, and no top-level FILTER on the faceted
    ``tag`` field, which would ask for drill-sideways counts (the
    reference's arrays path, ROADMAP item 8) instead of the in-dispatch
    reduction over the query's own matches."""
    clauses = tree["booleanQuery"]["clauses"]
    filters = [c for c in clauses if c["occur"] == "FILTER"]
    rest = [c for c in clauses if c["occur"] != "FILTER"]
    return {"booleanQuery": {"clauses": rest + [
        {"occur": "FILTER", "query": {"booleanQuery": {"clauses": filters}}}]}}


def _strip(resp):
    """A response without its timings and timestamp, for bit-for-bit checks."""
    resp = type(resp).FromString(resp.SerializeToString())
    resp.ClearField("diagnostics")
    resp.searchState.ClearField("timestamp")
    return resp.SerializeToString(deterministic=True)


def _served_ingest_docs(n: int) -> list[dict]:
    """Phase 7's documents with config #3's fields (f32-exact price and ts, a
    tag of the corpus's dictionary)."""
    rng = np.random.default_rng(SEED + 7)
    docs = []
    for d in _ingest_docs(n):
        docs.append({"body": d["body"],
                     "price": str(float(np.float32(rng.uniform(0, 1000)))),
                     "ts": str(float(np.float32(rng.uniform(0, 1e9)))),
                     "tag": f"tag_{int(rng.integers(0, 100)):03d}"})
    return docs


def _add_requests(docs):
    from nrtsearch_tpu_torch.gen import pb

    for d in docs:
        req = pb.AddDocumentRequest(indexName=SERVED_INDEX)
        for name, value in d.items():
            req.fields[name].value.append(value)
        yield req


def _concurrent(fn, n: int) -> tuple[list, list]:
    """``fn(i)`` for i < n in n threads released together; results and each
    call's seconds, in order."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    barrier = threading.Barrier(n)

    def one(i):
        barrier.wait(timeout=60)
        t = time.perf_counter()
        out = fn(i)
        return out, time.perf_counter() - t

    with ThreadPoolExecutor(n) as pool:
        done = list(pool.map(one, range(n)))
    return [d[0] for d in done], [d[1] for d in done]


def start_served(dev, searcher, root: str, singles, card: str):
    """A standalone NrtsearchServer on the card over phase 4's index,
    committed where startIndex opens it. Returns (server, client, runtime,
    index_dir)."""
    from nrtsearch_tpu_torch.client import NrtsearchClient
    from nrtsearch_tpu_torch.config import NrtsearchConfig
    from nrtsearch_tpu_torch.core.directory import commit_segments
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer

    config = NrtsearchConfig.from_dict({
        **SERVED_CONFIG, "stateDir": f"{root}/state", "indexDir": f"{root}/index"})
    server = NrtsearchServer(config, device=dev)
    client = NrtsearchClient(f"localhost:{server.start(0)}")
    client.create_index(SERVED_INDEX)
    client.register_fields(pb.FieldDefRequest(indexName=SERVED_INDEX, field=[
        pb.Field(name=n, **{k: (pb.FieldType.Value(v) if k == "type" else v)
                            for k, v in spec.items()}) for n, spec in SERVED_FIELDS]))
    # 1. phase 4's index, committed where startIndex opens it
    index_dir = os.path.join(config.index_dir, server.global_state.index_ids[SERVED_INDEX])
    t = time.perf_counter()
    commit_segments(searcher.segments, index_dir, gen=1, version=1)
    commit_s = time.perf_counter() - t
    nbytes = sum(os.path.getsize(os.path.join(index_dir, f)) for f in os.listdir(index_dir))
    log(f"served: committed phase 4's index ({len(searcher.segments)} segments, "
        f"{nbytes / 2**30:.3f} GiB in {len(os.listdir(index_dir))} files) in {commit_s:.2f} s")
    # few, small merges: each group stays within 1 MB (1,000 docs)
    ls = pb.LiveSettingsV2Request(indexName=SERVED_INDEX)
    ls.liveSettings.maxMergedSegmentMB.value = 1
    ls.liveSettings.segmentsPerTier.value = 6
    ls.liveSettings.maxRefreshSec.value = 3600.0
    client.live_settings_v2(ls)

    # 2. startIndex opens the commit on the card
    torch.cuda.synchronize()
    t = time.perf_counter()
    started = client.start_index(pb.StartIndexRequest(
        indexName=SERVED_INDEX, mode=pb.Mode.STANDALONE))
    open_s = time.perf_counter() - t
    rt = server.global_state.runtimes[SERVED_INDEX]
    if started.maxDoc != NUM_DOCS or any(s.device != dev for s in rt.searcher.segments):
        raise AssertionError(f"startIndex opened {started.maxDoc} docs on "
                             f"{[str(s.device) for s in rt.searcher.segments]}")
    t = time.perf_counter()
    client.search(_request(_match_dict(singles[0])))
    first_s = time.perf_counter() - t
    log(f"served: startIndex opened the committed 1M-doc index in {open_s:.2f} s "
        f"(startTimeMS {started.startTimeMS:.1f}); first search {first_s:.2f} s "
        f"(packs the view and builds the dense rows) | {card}")
    return server, client, rt, index_dir


def phase_served(dev, corpus, columns, searcher, singles, batch, card: str,
                 general=None) -> dict:
    """The port's server on the card (see the module docstring); launch
    counters reset just before the served searches and read just after.
    ``general(server, client, runtime, index_dir)`` (phase 12) runs on the
    same node after those searches and before the ingest; its result is
    returned under "general"."""
    import shutil
    import tempfile

    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.models.synthetic import column_clauses, config3_query
    from nrtsearch_tpu_torch.ops import dense_fused, merge_scoring

    root = tempfile.mkdtemp(prefix="served_")
    server = client = None
    general_out = None
    try:
        server, client, rt, index_dir = start_served(dev, searcher, root, singles, card)

        # 3-4. the served searches, counted alone
        view = rt.searcher.packed_view("body")
        names = columns["tag"][2]
        c3 = config3_singles(corpus, searcher)
        trees = [config3_query(terms, names, SEED + i) for i, (_p, terms) in enumerate(c3)]
        batcher = server.handlers.batcher
        stats0 = batcher_totals(batcher)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        syncs0 = (dense_fused.HOST_SYNCS["window_certificate"],
                  merge_scoring.HOST_SYNCS["hierarchical_topk"])
        falls0 = merge_scoring.TOPK_FALLBACKS["hierarchical_topk"]
        paths0 = dict(view.path_counts)
        kernels.reset_launch_counts()
        lat1, lat32, wall32, first_pass, rt_ms = [], [], [], [], []
        single_out, single_paths = [], []
        falls_by = {"singles": 0, "concurrent": 0, "config3": 0}

        def fallbacks() -> int:
            return merge_scoring.TOPK_FALLBACKS["hierarchical_topk"]

        for rep in range(3):
            for q in singles:
                before = dict(view.path_counts)
                f0 = fallbacks()
                t = time.perf_counter()
                resp = client.search(_request(_match_dict(q)))
                lat1.append(time.perf_counter() - t)
                falls_by["singles"] += fallbacks() - f0
                first_pass.append(resp.diagnostics.firstPassSearchTimeMs)
                rt_ms.append(1e3 * lat1[-1])
                if rep == 0:
                    single_out.append(resp)
                    single_paths.append(
                        next(k for k in before if view.path_counts[k] != before[k]))
            t = time.perf_counter()
            b_paths = dict(view.path_counts)
            f0 = fallbacks()
            batch_out, secs = _concurrent(
                lambda i: client.search(_request(_match_dict(batch[i]))), len(batch))
            wall32.append(time.perf_counter() - t)
            falls_by["concurrent"] += fallbacks() - f0
            lat32.extend(secs)
            b_paths = {k: view.path_counts[k] - b_paths[k] for k in b_paths}
        forms = {
            "scored": lambda i: client.search(_request(trees[i])),
            "sorted_ts": lambda i: client.search(_sorted_request(trees[i])),
            "faceted": lambda i: client.search(_faceted_request(_grouped_filters(trees[i]))),
        }
        c3_out, c3_paths = {}, {}
        for name, run in forms.items():
            for i in range(len(c3)):
                before = dict(view.path_counts)
                f0 = fallbacks()
                c3_out[(name, i)] = run(i)
                falls_by["config3"] += fallbacks() - f0
                c3_paths[(name, i)] = next(
                    k for k in before if view.path_counts[k] != before[k])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        syncs = (dense_fused.HOST_SYNCS["window_certificate"] - syncs0[0],
                 merge_scoring.HOST_SYNCS["hierarchical_topk"] - syncs0[1])
        falls = merge_scoring.TOPK_FALLBACKS["hierarchical_topk"] - falls0
        paths = {k: view.path_counts[k] - paths0[k] for k in paths0}
        stats1 = batcher_totals(batcher)
        n_searches = 3 * (len(singles) + len(batch)) + len(forms) * len(c3)
        log(f"served: launches {launches} (module counters, read without a lock: lower "
            f"bounds under concurrency); specs by path {paths}; host syncs window "
            f"{syncs[0]}, hierarchical_topk {syncs[1]}; _hierarchical_topk full-sort "
            f"fallbacks {falls} over {n_searches} searches ({falls_by}: on the fused "
            f"path a served single is 1 live row of 8, and the batcher's empty pad rows "
            f"leave tau at -inf; the merge path drops pad specs, but its own "
            f"power-of-two rows and a query with fewer than k hits do the same) | {card}")
        missing = [k for k in CONFIG3_KERNELS if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"the served path did not launch {missing}")
        grown = {k: stats1[k] - stats0[k] for k in stats0}
        log(f"served: batcher groups {grown['group_count']:.0f} for "
            f"{grown['group_sum']:.0f} queries, mean wait "
            f"{1e3 * grown['wait_sum'] / max(grown['wait_count'], 1):.3f} ms from enqueue to "
            f"dispatch; each group padded to a power of two >= 8 with empty specs | {card}")

        # against the numpy oracle, under the contract of the path taken
        worst, swaps = {"fused": 0.0, "merge": 0.0}, 0
        for q, resp, path in zip(singles, single_out, single_paths):
            rel = FUSED_REL if path == "fused" else MERGE_REL
            td, ex = _served_td(resp), corpus.exact_topk(q, TOP_K)
            swaps += _check_topk(td, ex, rel, f"served single {q} ({path})")
            worst[path] = max(worst[path], _max_rel(td, ex))
        # a concurrent group's path is not told apart per request: every
        # answer is held to the fused contract, and to the exact one when
        # no group of the batch took the fused path
        b_rel = MERGE_REL if b_paths["fused"] == 0 else FUSED_REL
        for q, resp in zip(batch, batch_out):
            td, ex = _served_td(resp), corpus.exact_topk(q, TOP_K)
            swaps += _check_topk(td, ex, b_rel, f"served concurrent {q}")
        for i, (_want, terms) in enumerate(c3):
            node = column_clauses(trees[i])
            ex = corpus.exact_filtered_topk(terms, TOP_K, columns, node,
                                            facet="tag", total="price")
            for name in ("scored", "faceted"):
                path = c3_paths[(name, i)]
                rel = FUSED_REL if path == "fused" else MERGE_REL
                resp = c3_out[(name, i)]
                ctx = f"served config3 {name} {terms} ({path})"
                swaps += _check_topk(_served_td(resp), (ex["scores"], ex["docs"], ex["hits"]),
                                     rel, ctx)
            resp = c3_out[("faceted", i)]
            (fr,) = resp.facetResult
            got = {lv.label: int(lv.value) for lv in fr.labelValues}
            want_f = {names[j]: int(c) for j, c in enumerate(ex["facet"]) if c}
            if got != want_f or int(fr.value) != sum(want_f.values()):
                raise AssertionError(f"served config3 facet {terms}: counts differ")
            total = resp.collectorResults["price_sum"].doubleResult.value
            if abs(total - ex["total"]) > SUM_REL * abs(ex["total"]):
                raise AssertionError(f"served config3 price sum {total} vs {ex['total']}")
            ex = corpus.exact_filtered_topk(terms, TOP_K, columns, node,
                                            sort=("ts", False, False))
            _check_sorted(_served_td(c3_out[("sorted_ts", i)], "ts"), ex,
                          f"served config3 sorted {terms}")
        log(f"served exact: {len(singles)} singles, {len(batch)} concurrent and "
            f"{len(c3)} x {len(forms)} config #3 answers against the numpy oracle; hits "
            f"exact; worst rel fused {worst['fused']:.3g}, merge {worst['merge']:.3g}; "
            f"concurrent batch within {b_rel} (batch paths {b_paths}); near-tie swaps "
            f"{swaps}; sorted keys and docs equal; facet counts equal, price sums within "
            f"{SUM_REL}")
        # where a served request's time goes: the card's busy share of one
        # single and of one concurrent wave (torch.profiler traces every
        # thread's device work)
        one = profile_call(lambda: client.search(_request(_match_dict(singles[0]))))
        wave = profile_call(lambda: _concurrent(
            lambda i: client.search(_request(_match_dict(batch[i]))), len(batch)))
        for label, prof in (("single", one), (f"concurrent B={len(batch)} wave", wave)):
            log(f"served profile: {label}, device busy {prof['device_busy_ms']:.3f} ms in "
                f"{prof['device_items']} device items (traced wall "
                f"{prof['traced_wall_ms']:.3f} ms); top {json.dumps(prof['top'][:6])} | {card}")
            if prof["device_busy_ms"] <= 0:
                raise AssertionError(f"the profiled served {label} ran nothing on the device")
        p50_1, p50_32 = 1e3 * float(np.median(lat1)), 1e3 * float(np.median(lat32))
        fp = float(np.median(first_pass))
        log(f"served p50: B=1 {p50_1:.2f} ms (n={len(lat1)}; handler firstPassSearchTimeMs "
            f"p50 {fp:.2f} ms of the client's round trip {float(np.median(rt_ms)):.2f} ms), "
            f"concurrent B={len(batch)} per request {p50_32:.2f} ms (n={len(lat32)}), "
            f"all {len(batch)} answered in {1e3 * float(np.median(wall32)):.2f} ms "
            f"(p50 of {len(wall32)}); peak device memory {peak / 2**30:.3f} GiB | {card}")

        # phase 12 on this node, before the ingest changes its index
        if general is not None:
            general_out = general(server, client, rt, index_dir)

        # 5. ingest through addDocuments + refresh until a merge ran
        docs = _served_ingest_docs(2000)
        step = len(docs) // SERVED_CHUNKS
        t = time.perf_counter()
        for c in range(SERVED_CHUNKS):
            client.add_documents(_add_requests(docs[c * step:(c + 1) * step]))
            client.refresh(SERVED_INDEX)
        ingest_s = time.perf_counter() - t
        st = rt.stats()
        if st["merges"] == 0 or st["maxDoc"] != NUM_DOCS + len(docs):
            raise AssertionError(f"ingest: {st}")
        needle = _request(_match_dict(["needle"]), k=200, retrieveFields=["price", "ts", "tag"])
        resp = client.search(needle)
        want = sorted((d["price"], d["ts"], d["tag"]) for d in docs if "needle" in d["body"].split())
        got = sorted((repr(h.fields["price"].fieldValue[0].floatValue),
                      repr(h.fields["ts"].fieldValue[0].floatValue),
                      h.fields["tag"].fieldValue[0].textValue) for h in resp.hits)
        if resp.totalHits.value != len(want) or got != want:
            raise AssertionError(f"ingest: the new docs' term answers {resp.totalHits.value} "
                                 f"hits, want {len(want)}, or their fields differ")
        log(f"served ingest: {len(docs)} docs in {SERVED_CHUNKS} addDocuments + refresh "
            f"rounds in {ingest_s:.2f} s; {st['merges']} merges ({st['merged_docs']} docs), "
            f"{st['numSegments']} segments; 'needle' answers its {len(want)} docs with their "
            f"price, ts and tag (retrieveFields, from doc values)")

        # commit, stop, start: the same answers, bit for bit
        again = [needle, *(_request(_match_dict(q)) for q in singles),
                 _request(trees[0]), _request(trees[-1]), _sorted_request(trees[1]),
                 _faceted_request(_grouped_filters(trees[2]))]
        before = [_strip(client.search(r)) for r in again]
        client.commit(SERVED_INDEX)
        client.stop_index(SERVED_INDEX)
        t = time.perf_counter()
        client.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.STANDALONE))
        reopen_s = time.perf_counter() - t
        after = [_strip(client.search(r)) for r in again]
        if after != before:
            bad = [i for i, (a, b) in enumerate(zip(after, before)) if a != b]
            raise AssertionError(f"after commit, stop and start, requests {bad} answer differently")
        log(f"served restart: commit, stopIndex, startIndex ({reopen_s:.2f} s): "
            f"{len(again)} answers bit for bit")
    finally:
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
        shutil.rmtree(root, ignore_errors=True)
    child = phase_served_process(card)
    return {"launches": launches, "child": child, "general": general_out}


def _sorted_request(tree: dict):
    req = _request(tree)
    sf = req.querySort.fields.sortedFields.add()
    sf.fieldName = "ts"
    sf.reverse = True
    return req


def _faceted_request(tree: dict):
    req = _request(tree)
    f = req.facets.add()
    f.dim = "tag"
    f.topN = 100
    req.collectors["price_sum"].sum.field = "price"
    return req


class _Children:
    """``python -m nrtsearch_tpu_torch.server`` child processes of this
    checkout, each logging to a file; ``stop()`` ends every one."""

    def __init__(self):
        self.here = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [self.here, *filter(None, [os.environ.get("PYTHONPATH")])]))
        self.procs, self.logs = {}, {}

    def start(self, name: str, log_path: str, *args: str) -> None:
        self.logs[name] = log_path
        with open(log_path, "w") as log_f:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "nrtsearch_tpu_torch.server", *args],
                cwd=self.here, env=self.env, stdout=log_f, stderr=subprocess.STDOUT)

    def status(self, name: str, port: int, deadline: float):
        """The child's status answer, polled until it answers; fails if the
        child exits or the deadline passes."""
        from nrtsearch_tpu_torch.client import NrtsearchClient

        with NrtsearchClient(f"localhost:{port}") as client:
            while True:
                try:
                    return client.status()
                except Exception:
                    proc = self.procs[name]
                    if proc.poll() is not None or time.time() > deadline:
                        raise AssertionError(
                            f"the {name} child did not answer: rc {proc.poll()}\n"
                            + open(self.logs[name]).read()[-4000:])
                    time.sleep(0.5)

    def cuda_lines(self) -> dict:
        """Each child's log line that names the CUDA device; fails if one
        names none."""
        named = {}
        for name, path in self.logs.items():
            text = open(path).read()
            lines = [ln for ln in text.splitlines() if "indexes on cuda" in ln]
            if not lines:
                raise AssertionError(f"the {name} child's log names no CUDA device:\n"
                                     + text[-4000:])
            named[name] = lines[0].strip()
        return named

    def stop(self) -> None:
        for proc in self.procs.values():
            proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


def _free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def phase_served_process(card: str) -> dict:
    """``python -m nrtsearch_tpu_torch.server cfg.yaml`` as a child process
    with no --device: it must serve on the card, answer status and a search
    on a small index, and name the CUDA device in its log."""
    import tempfile

    from nrtsearch_tpu_torch.client import NrtsearchClient
    from nrtsearch_tpu_torch.gen import pb

    children = _Children()
    with tempfile.TemporaryDirectory(prefix="served_child_") as tmp:
        cfg = os.path.join(tmp, "cfg.yaml")
        with open(cfg, "w") as f:
            f.write(f"stateDir: {tmp}/state\nindexDir: {tmp}/index\n")
        (port,) = _free_ports(1)
        children.start("server", os.path.join(tmp, "server.log"), cfg, "--port", str(port))
        client = NrtsearchClient(f"localhost:{port}")
        try:
            t = time.perf_counter()
            health = children.status("server", port, time.time() + 180).health
            up_s = time.perf_counter() - t
            if health != pb.TransferStatusCode.Done:
                raise AssertionError(f"child status {health}")
            client.create_index("small")
            client.register_fields(pb.FieldDefRequest(indexName="small", field=[
                pb.Field(name="body", type=pb.FieldType.TEXT, search=True)]))
            client.start_index(pb.StartIndexRequest(indexName="small",
                                                    mode=pb.Mode.STANDALONE))
            docs = _ingest_docs(300)

            def reqs():
                for d in docs:
                    r = pb.AddDocumentRequest(indexName="small")
                    r.fields["body"].value.append(d["body"])
                    yield r

            client.add_documents(reqs())
            client.refresh("small")
            req = pb.SearchRequest(indexName="small", topHits=5)
            req.query.matchQuery.field = "body"
            req.query.matchQuery.query = "needle"
            resp = client.search(req)
            want = sum("needle" in d["body"].split() for d in docs)
            if resp.totalHits.value != want or not resp.hits:
                raise AssertionError(f"child search: {resp.totalHits.value} hits, want {want}")
        finally:
            client.close()
            children.stop()
        named = children.cuda_lines()["server"]
        log(f"served child: python -m nrtsearch_tpu_torch.server answered status after "
            f"{up_s:.1f} s and a search ({want} hits); its log: {named} | {card}")
        return {"up_s": up_s}


# ---------------------------------------------------------------------------
# phase 11: replication on the card
# ---------------------------------------------------------------------------

REPLICA_ROUND_S = 120.0    # a replica that has not installed a point by then fails


def _node(root: str, name: str, extra: dict | None = None, *, dev, state: str):
    """An in-process NrtsearchServer on ``dev`` (port 0) and its client."""
    from nrtsearch_tpu_torch.client import NrtsearchClient
    from nrtsearch_tpu_torch.config import NrtsearchConfig
    from nrtsearch_tpu_torch.server.grpc_server import NrtsearchServer

    config = NrtsearchConfig.from_dict({
        **SERVED_CONFIG, "stateDir": state, "indexDir": f"{root}/{name}_index",
        "nodeName": name, **(extra or {})})
    server = NrtsearchServer(config, device=dev)
    return server, NrtsearchClient(f"localhost:{server.start(0)}")


class _Installs:
    """Times every IndexRuntime.install_point of the process, split into the
    file copies it runs (ReplicationService._fetch_files, which the merge
    pre-copy also runs), the segment loads (index_runtime.load_segment) and
    the rest (the searcher's publish): measurement only, the wrapped
    functions are called as they are. ``installs`` holds one dict per
    install, ``fetches`` (start, seconds, bytes) per copy."""

    def __init__(self):
        import threading

        from nrtsearch_tpu_torch.server import index_runtime
        from nrtsearch_tpu_torch.server.replication import ReplicationService

        self.installs, self.fetches = [], []
        self._orig = (index_runtime.IndexRuntime.install_point,
                      ReplicationService._fetch_files, index_runtime.load_segment)
        install, fetch, load = self._orig
        loads = threading.local()

        def timed_fetch(service, rt, client, index_name, files):
            t = time.perf_counter()
            fetch(service, rt, client, index_name, files)
            nbytes = sum(os.path.getsize(os.path.join(rt.index_dir, f)) for f in files)
            self.fetches.append((t, time.perf_counter() - t, nbytes))

        def timed_load(*args, **kw):
            t = time.perf_counter()
            seg = load(*args, **kw)
            loads.s = getattr(loads, "s", 0.0) + time.perf_counter() - t
            return seg

        def timed_install(rt, point, file_fetcher=None):
            n0, t = len(self.fetches), time.perf_counter()
            loads.s = 0.0
            ok = install(rt, point, file_fetcher)
            if rt.device.type == "cuda":
                torch.cuda.synchronize(rt.device)
            copied = self.fetches[n0:]
            self.installs.append({"s": time.perf_counter() - t, "ok": ok, "load_s": loads.s,
                                  "copy_s": sum(f[1] for f in copied),
                                  "bytes": sum(f[2] for f in copied)})
            return ok

        index_runtime.IndexRuntime.install_point = timed_install
        index_runtime.load_segment = timed_load
        ReplicationService._fetch_files = timed_fetch

    def close(self) -> None:
        from nrtsearch_tpu_torch.server import index_runtime
        from nrtsearch_tpu_torch.server.replication import ReplicationService

        (index_runtime.IndexRuntime.install_point, ReplicationService._fetch_files,
         index_runtime.load_segment) = self._orig


def _wait_version(rclient, index: str, version: int, what: str) -> float:
    """Seconds until the replica's replicaCurrentSearchingVersion reaches
    ``version``; fails after REPLICA_ROUND_S."""
    t = time.perf_counter()
    while True:
        got = rclient.replica_current_searching_version(index).version
        if got >= version:
            return time.perf_counter() - t
        if time.perf_counter() - t > REPLICA_ROUND_S:
            raise AssertionError(f"{what}: the replica stayed at version {got}, "
                                 f"the primary is at {version}")
        time.sleep(0.01)


def _hits_bits(resp) -> tuple:
    """A response's answer, bit for bit: hit count, relation, docs, scores."""
    return (resp.totalHits.value, resp.totalHits.relation,
            [(h.luceneDocId, np.float32(h.score).view(np.int32).item()) for h in resp.hits])


def phase_replication(dev, corpus, columns, searcher, singles, batch, card: str) -> dict:
    """Phase 11 (see the module docstring): a PRIMARY and a REPLICA node of
    the 1M-doc index in this process, push replication, the replica's served
    main path (launch counters reset just before its searches and read just
    after), NRT ingest, a new primary incarnation; then an isolated replica
    through S3 and a primary-replica pair of child processes."""
    import shutil
    import tempfile
    import threading

    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.core.directory import commit_segments
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.server.replication import ReplicationClient

    root = tempfile.mkdtemp(prefix="replication_")
    state = f"{root}/state"
    discovery = f"{root}/primary.json"
    nodes, clients = [], []
    installs = _Installs()

    def close(node, client):
        client.close()
        node.stop()
        nodes.remove(node)
        clients.remove(client)

    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        # 1. the primary opens phase 4's index, committed where startIndex opens it
        primary, pc = _node(root, "primary", dev=dev, state=state)
        nodes.append(primary)
        clients.append(pc)
        pc.create_index(SERVED_INDEX)
        pc.register_fields(pb.FieldDefRequest(indexName=SERVED_INDEX, field=[
            pb.Field(name=n, **{k: (pb.FieldType.Value(v) if k == "type" else v)
                                for k, v in spec.items()}) for n, spec in SERVED_FIELDS]))
        index_dir = os.path.join(primary.config.index_dir,
                                 primary.global_state.index_ids[SERVED_INDEX])
        commit_segments(searcher.segments, index_dir, gen=1, version=1, primary_gen=1)
        ls = pb.LiveSettingsV2Request(indexName=SERVED_INDEX)
        ls.liveSettings.maxMergedSegmentMB.value = 1
        ls.liveSettings.segmentsPerTier.value = 6
        ls.liveSettings.maxRefreshSec.value = 3600.0
        pc.live_settings_v2(ls)
        t = time.perf_counter()
        pc.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.PRIMARY,
                                            primaryGen=1))
        p_open = time.perf_counter() - t
        p_rt = primary.global_state.runtimes[SERVED_INDEX]
        with open(discovery, "w") as f:
            json.dump({"host": "localhost", "port": primary.replication_port}, f)

        # 2. the replica registers and copies the commit over recvRawFile
        replica, rc = _node(root, "replica", dev=dev, state=state)
        nodes.append(replica)
        clients.append(rc)
        rrc = ReplicationClient(f"localhost:{replica.replication_port}")
        t = time.perf_counter()
        rc.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.REPLICA,
                                            primaryDiscoveryFile=discovery))
        sync_s = time.perf_counter() - t
        r_rt = replica.global_state.runtimes[SERVED_INDEX]
        if (r_rt.searcher.version != p_rt.searcher.version
                or r_rt.searcher.num_docs != NUM_DOCS
                or any(s.device != dev for s in r_rt.searcher.segments)
                or not installs.installs):
            raise AssertionError(
                f"initial sync: replica at version {r_rt.searcher.version} with "
                f"{r_rt.searcher.num_docs} docs on {[str(s.device) for s in r_rt.searcher.segments]}"
                f", primary at {p_rt.searcher.version}")
        first = installs.installs[-1]
        log(f"replication: primary startIndex opened the committed {NUM_DOCS}-doc index in "
            f"{p_open:.2f} s; the replica's startIndex (addReplicas, recvCopyState, "
            f"recvRawFile of {first['bytes'] / 2**30:.3f} GiB in "
            f"{len(os.listdir(r_rt.index_dir))} files, install onto the card) took "
            f"{sync_s:.2f} s: copy {first['copy_s']:.2f} s "
            f"({first['bytes'] / 2**20 / max(first['copy_s'], 1e-9):.1f} MiB/s), install "
            f"{first['s'] - first['copy_s']:.2f} s (segment loads {first['load_s']:.2f} s) "
            f"| {card}")

        # 3. the replica serves the main path, counted alone
        client_of = {"replica": rc, "primary": pc}

        def singles_on(side):
            out, lat = [], []
            for q in singles:
                t = time.perf_counter()
                out.append(client_of[side].search(_request(_match_dict(q))))
                lat.append(time.perf_counter() - t)
            return out, lat

        singles_on("replica")       # first searches pack the view and build the rows
        singles_on("primary")
        r_view = r_rt.searcher.packed_view("body")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        r_lat, r_single_paths, r_out, b_out = [], [], [], []
        b_fused = 0
        for rep in range(3):
            for q in singles:
                before = dict(r_view.path_counts)
                t = time.perf_counter()
                resp = rc.search(_request(_match_dict(q)))
                r_lat.append(time.perf_counter() - t)
                if rep == 0:
                    r_single_paths.append(
                        next(k for k in before if r_view.path_counts[k] != before[k]))
                    r_out.append(resp)
            before = r_view.path_counts["fused"]
            outs, _secs = _concurrent(
                lambda i: rc.search(_request(_match_dict(batch[i]))), len(batch))
            b_fused += r_view.path_counts["fused"] - before
            b_out.append(outs)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        log(f"replication: the replica's served launches {launches} (8 singles and "
            f"{len(batch)} concurrent clients, 3 times; read without a lock: lower bounds)")
        missing = [k for k in CONFIG3_KERNELS if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"the replica's served path did not launch {missing}")
        p_out, p_lat = [], []
        for rep in range(3):
            out, lat = singles_on("primary")
            p_lat.extend(lat)
            if rep == 0:
                p_out = out
        if p_rt.searcher.version != r_rt.searcher.version:
            raise AssertionError("the primary moved during the replica's singles")
        for q, r, p_ in zip(singles, r_out, p_out):
            if _hits_bits(r) != _hits_bits(p_):
                raise AssertionError(f"replica single {q} differs from the primary's")
        worst, swaps = {"fused": 0.0, "merge": 0.0}, 0
        for q, resp, path in zip(singles, r_out, r_single_paths):
            rel = FUSED_REL if path == "fused" else MERGE_REL
            td, ex = _served_td(resp), corpus.exact_topk(q, TOP_K)
            swaps += _check_topk(td, ex, rel, f"replica single {q} ({path})")
            worst[path] = max(worst[path], _max_rel(td, ex))
        b_rel = MERGE_REL if b_fused == 0 else FUSED_REL
        for outs in b_out:
            for q, resp in zip(batch, outs):
                swaps += _check_topk(_served_td(resp), corpus.exact_topk(q, TOP_K), b_rel,
                                     f"replica concurrent {q}")
        r_p50, p_p50 = 1e3 * float(np.median(r_lat)), 1e3 * float(np.median(p_lat))
        torch.cuda.synchronize()
        two_nodes = torch.cuda.max_memory_allocated(dev)
        log(f"replication: the replica's {len(singles)} singles bit-equal to the primary's "
            f"at version {r_rt.searcher.version} (docs, order, hits, scores); singles "
            f"({r_single_paths}) and 3 x {len(batch)} concurrent answers against the numpy "
            f"oracle: worst rel fused {worst['fused']:.3g}, merge {worst['merge']:.3g}, "
            f"concurrent within {b_rel}; near-tie swaps {swaps}")
        log(f"replication: served B=1 p50 replica {r_p50:.2f} ms, primary {p_p50:.2f} ms "
            f"(n={len(r_lat)} each); peak device memory with both 1M-doc nodes "
            f"{two_nodes / 2**30:.3f} GiB ({(two_nodes - base) / 2**30:.3f} GiB above the "
            f"phase's start, which holds phase 4's index) | {card}")

        # 4. NRT ingest: 8 addDocuments + refresh rounds on the primary
        docs = _served_ingest_docs(2000)
        step = len(docs) // SERVED_CHUNKS
        needle = _request(_match_dict(["needle"]), k=200)
        lags, inst, copied, pinned = [], [], [], []
        for c in range(SERVED_CHUNKS):
            pc.add_documents(_add_requests(docs[c * step:(c + 1) * step]))
            n_inst = len(installs.installs)
            f0 = len(installs.fetches)
            pc.refresh(SERVED_INDEX)
            t_ref = time.perf_counter()
            version = p_rt.searcher.version
            want = sum("needle" in d["body"].split() for d in docs[:(c + 1) * step])
            behind = rrc.replica_current_searching_version(SERVED_INDEX).version < version
            box = {}
            if behind:
                req = _request(_match_dict(["needle"]), k=200)
                req.version = version

                def run_pinned(req=req):
                    try:
                        box["resp"] = rc.search(req)
                    except Exception as e:  # noqa: BLE001 - raised below
                        box["error"] = e

                th = threading.Thread(target=run_pinned)
                th.start()
            lag = _wait_version(rrc, SERVED_INDEX, version, f"ingest round {c}")
            if behind:
                th.join(timeout=REPLICA_ROUND_S)
                if "resp" not in box:
                    raise AssertionError(f"round {c}: the pinned search failed: {box}")
                got = box["resp"]
                if got.searchState.searcherVersion != version or got.totalHits.value != want:
                    raise AssertionError(
                        f"round {c}: the search pinned to version {version} answered version "
                        f"{got.searchState.searcherVersion} with {got.totalHits.value} hits, "
                        f"want {want}")
                pinned.append(c)
            lags.append(lag)
            new = installs.installs[n_inst:]
            if not new or not all(i["ok"] for i in new):
                raise AssertionError(f"round {c}: no install of the replica ran: {new}")
            inst.append(sum(i["s"] - i["copy_s"] for i in new))
            copied.append(sum(f[2] for f in installs.fetches[f0:]))
            log(f"replication ingest round {c}: lag {1e3 * lag:.1f} ms (refresh returned to "
                f"replicaCurrentSearchingVersion {version}), replica install "
                f"{1e3 * inst[-1]:.1f} ms in {len(new)} install(s) (copy not counted; segment "
                f"loads {1e3 * sum(i['load_s'] for i in new):.1f} ms), "
                f"{copied[-1] / 2**20:.3f} MiB copied; segments {len(r_rt.searcher.segments)}"
                f"; pinned search {'waited' if behind else 'not sent (already installed)'}")
            if time.perf_counter() - t_ref > REPLICA_ROUND_S:
                raise AssertionError(f"round {c} took too long")
        if not pinned:
            raise AssertionError("no search was pinned to a version the replica lacked")
        torch.cuda.synchronize()
        after8 = torch.cuda.max_memory_allocated(dev)
        held = torch.cuda.memory_allocated(dev)
        resp = rc.search(needle)
        want = sum("needle" in d["body"].split() for d in docs)
        if resp.totalHits.value != want or _hits_bits(resp) != _hits_bits(pc.search(needle)):
            raise AssertionError(f"after ingest the replica answers 'needle' with "
                                 f"{resp.totalHits.value} hits, want {want}, or differs")
        st = p_rt.stats()
        log(f"replication ingest: {len(docs)} docs in {SERVED_CHUNKS} rounds; lag p50 "
            f"{1e3 * float(np.median(lags)):.1f} ms, max {1e3 * max(lags):.1f} ms; replica "
            f"install p50 {1e3 * float(np.median(inst)):.1f} ms, max {1e3 * max(inst):.1f} ms;"
            f" copied p50 {float(np.median(copied)) / 2**20:.3f} MiB, max "
            f"{max(copied) / 2**20:.3f} MiB; primary merges {st['merges']}; searches pinned "
            f"to an uninstalled version waited in rounds {pinned}; 'needle' answers its "
            f"{want} docs on the replica | {card}")
        log(f"replication memory: peak {after8 / 2**30:.3f} GiB after {SERVED_CHUNKS} installs "
            f"(with both nodes {two_nodes / 2**30:.3f}); allocated now {held / 2**30:.3f} GiB, "
            f"{(held - base) / 2**30:.3f} above the phase's start; the replica keeps "
            f"{len(r_rt._searchers_by_version)} searcher versions | {card}")

        # 5. a new primary incarnation: commit, stop, restart with primaryGen 2
        pc.commit(SERVED_INDEX)
        pc.stop_index(SERVED_INDEX)
        close(primary, pc)
        t = time.perf_counter()
        primary, pc = _node(root, "primary", dev=dev, state=state)
        nodes.append(primary)
        clients.append(pc)
        req = pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.PRIMARY, primaryGen=2)
        req.restore.resourceName = SERVED_INDEX
        pc.start_index(req)
        p_rt = primary.global_state.runtimes[SERVED_INDEX]
        restart_s = time.perf_counter() - t
        with open(discovery, "w") as f:
            json.dump({"host": "localhost", "port": primary.replication_port}, f)
        extra = [{"body": "incarnation needle", "price": "1.0", "ts": "2.0", "tag": "tag_000"}
                 for _ in range(5)]
        pc.add_documents(_add_requests(extra))
        pc.refresh(SERVED_INDEX)
        lag = _wait_version(rrc, SERVED_INDEX, p_rt.searcher.version, "new incarnation")
        inc = _request(_match_dict(["incarnation"]), k=10)
        resp = rc.search(inc)
        if (r_rt.primary_gen != 2 or resp.totalHits.value != len(extra)
                or _hits_bits(resp) != _hits_bits(pc.search(inc))
                or _hits_bits(rc.search(needle)) != _hits_bits(pc.search(needle))):
            raise AssertionError(f"new incarnation: replica primaryGen {r_rt.primary_gen}, "
                                 f"'incarnation' {resp.totalHits.value} hits")
        log(f"replication incarnation: primary restarted with primaryGen 2 and restore in "
            f"{restart_s:.2f} s; the replica followed the discovery file to it and answers "
            f"its documents {1e3 * lag:.1f} ms after its refresh | {card}")
        rrc.close()
    finally:
        installs.close()
        for client in clients:
            client.close()
        for node in nodes:
            node.stop()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    s3 = phase_replication_s3(dev, card)
    pair = phase_replication_processes(card)
    return {"launches": launches, "sync_s": sync_s, "lags": lags, "installs": inst,
            "s3": s3, "pair": pair}


def phase_replication_s3(dev, card: str) -> dict:
    """An isolated replica: a primary with bucketName publishes to a
    FakeS3Server on loopback; a replica with no primaryAddress restores from
    and polls the object store, and answers bit for bit as the primary."""
    import shutil
    import tempfile

    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.remote.fake_s3 import FakeS3Server
    from nrtsearch_tpu_torch.remote.s3 import S3Backend
    from nrtsearch_tpu_torch.server.replication import ReplicationClient

    s3 = FakeS3Server()
    endpoint = s3.start()
    root = tempfile.mkdtemp(prefix="replication_s3_")
    remote = {"serviceName": "smoke", "bucketName": "smoke-bucket",
              "stateConfig": {"backendType": "REMOTE"},
              "s3": {"endpoint": endpoint, "accessKey": "k", "secretKey": "s"}}
    nodes = []
    try:
        primary, pc = _node(root, "primary", remote, dev=dev, state=f"{root}/p_state")
        nodes.append((primary, pc))
        if not isinstance(primary.global_state.remote, S3Backend):
            raise AssertionError(f"bucketName built {type(primary.global_state.remote)}")
        pc.create_index("s3")
        pc.register_fields(pb.FieldDefRequest(indexName="s3", field=[
            pb.Field(name=n, **{k: (pb.FieldType.Value(v) if k == "type" else v)
                                for k, v in spec.items()}) for n, spec in SERVED_FIELDS]))
        ls = pb.LiveSettingsV2Request(indexName="s3")
        ls.liveSettings.maxRefreshSec.value = 3600.0
        pc.live_settings_v2(ls)
        pc.start_index(pb.StartIndexRequest(indexName="s3", mode=pb.Mode.PRIMARY, primaryGen=1))
        docs = _served_ingest_docs(2000)
        reqs = list(_add_requests(docs[:1500]))
        for r in reqs:
            r.indexName = "s3"
        pc.add_documents(iter(reqs))
        pc.refresh("s3")
        p_rt = primary.global_state.runtimes["s3"]

        replica, rc = _node(root, "replica", remote, dev=dev, state=f"{root}/r_state")
        nodes.append((replica, rc))
        req = pb.StartIndexRequest(indexName="s3", mode=pb.Mode.REPLICA)
        req.restore.resourceName = "s3"
        t = time.perf_counter()
        rc.start_index(req)
        restore_s = time.perf_counter() - t
        r_rt = replica.global_state.runtimes["s3"]
        if r_rt.searcher.num_docs != 1500 or any(s.device != dev for s in r_rt.searcher.segments):
            raise AssertionError(f"the S3 replica restored {r_rt.searcher.num_docs} docs")
        reqs = list(_add_requests(docs[1500:]))
        for r in reqs:
            r.indexName = "s3"
        pc.add_documents(iter(reqs))
        pc.refresh("s3")
        rrc = ReplicationClient(f"localhost:{replica.replication_port}")
        try:
            lag = _wait_version(rrc, "s3", p_rt.searcher.version, "S3 replica")
        finally:
            rrc.close()
        requests = []
        for terms in (["needle"], ["alpha", "gamma"], ["common", "delta", "beta"]):
            r = _request(_match_dict(terms), k=50, retrieveFields=["price", "ts", "tag"])
            r.indexName = "s3"
            requests.append(r)
        want = [_strip(pc.search(r)) for r in requests]
        got = [_strip(rc.search(r)) for r in requests]
        if got != want or pc.search(requests[0]).totalHits.value == 0:
            raise AssertionError("the S3 replica's answers differ from the primary's")
        log(f"replication s3: an isolated replica restored 1500 docs from the object store "
            f"in {restore_s:.2f} s and polled the next point in {lag:.2f} s (poll interval "
            f"1 s); {len(requests)} answers bit for bit as the primary's | {card}")
        return {"restore_s": restore_s, "lag_s": lag}
    finally:
        for node, client in nodes:
            client.close()
            node.stop()
        s3.stop()
        shutil.rmtree(root, ignore_errors=True)


def phase_replication_processes(card: str) -> dict:
    """A primary and a replica as ``python -m nrtsearch_tpu_torch.server``
    children with no --device, driven through ``python -m
    nrtsearch_tpu_torch.cli``: the replica answers what the primary indexed
    and both logs name the CUDA device."""
    import tempfile

    children = _Children()
    cli_s = []

    def cli(node_port, *argv):
        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "nrtsearch_tpu_torch.cli", "--port", str(node_port), *argv],
            cwd=children.here, env=children.env, capture_output=True, text=True, timeout=120)
        cli_s.append(time.perf_counter() - t)
        if out.returncode != 0:
            raise AssertionError(f"cli {argv}: rc {out.returncode}\n{out.stderr[-2000:]}")
        return out.stdout

    with tempfile.TemporaryDirectory(prefix="replication_pair_") as tmp:
        # the replication port comes from the YAML only when --port is not given
        p, p_repl, r, r_repl = _free_ports(4)
        try:
            for name, port, rport in (("primary", p, p_repl), ("replica", r, r_repl)):
                cfg = os.path.join(tmp, f"{name}.yaml")
                with open(cfg, "w") as f:
                    f.write(f"stateDir: {tmp}/state\nindexDir: {tmp}/{name}_index\n"
                            f"nodeName: {name}\nport: {port}\nreplicationPort: {rport}\n")
                children.start(name, os.path.join(tmp, f"{name}.log"), cfg)
            deadline = time.time() + 180
            children.status("primary", p, deadline)
            children.status("replica", r, deadline)
            files = {}
            for name, body in (
                ("fields.json", {"indexName": "pair", "field": [
                    {"name": "id", "type": "_ID", "store": True},
                    {"name": "body", "type": "TEXT", "search": True}]}),
                ("start.json", {"indexName": "pair", "mode": "PRIMARY", "primaryGen": 1}),
                ("query.json", {"indexName": "pair", "topHits": 5,
                                "query": {"matchQuery": {"field": "body", "query": "needle"}}}),
            ):
                files[name] = os.path.join(tmp, name)
                with open(files[name], "w") as f:
                    json.dump(body, f)
            docs = _ingest_docs(600)
            for part, chunk in (("a", docs[:300]), ("b", docs[300:])):
                files[part] = os.path.join(tmp, f"docs_{part}.json")
                with open(files[part], "w") as f:
                    f.write("\n".join(json.dumps({"id": f"{part}{i}", "body": d["body"]})
                                      for i, d in enumerate(chunk)))
            cli(p, "createIndex", "--indexName", "pair")
            cli(p, "registerFields", "--fileName", files["fields.json"])
            cli(p, "startIndex", "--fileName", files["start.json"])
            cli(p, "addDocuments", "--indexName", "pair", "--fileName", files["a"],
                "--fileType", "json")
            cli(p, "refresh", "--indexName", "pair")
            cli(r, "reloadState")
            cli(r, "startIndex", "--indexName", "pair", "--mode", "REPLICA",
                "--primaryAddress", f"localhost:{p_repl}")
            cli(p, "addDocuments", "--indexName", "pair", "--fileName", files["b"],
                "--fileType", "json")
            cli(p, "refresh", "--indexName", "pair")
            want = sum("needle" in d["body"].split() for d in docs)
            num_docs = json.loads(cli(p, "stats", "--indexName", "pair")).get("numDocs")
            deadline = time.time() + REPLICA_ROUND_S
            while True:
                got = json.loads(cli(r, "search", "--fileName", files["query.json"]))
                hits = int(got.get("totalHits", {}).get("value", 0))
                if hits == want:
                    break
                if time.time() > deadline:
                    raise AssertionError(f"the replica child answers {hits} hits, want {want}")
                time.sleep(0.5)
            ref = json.loads(cli(p, "search", "--fileName", files["query.json"]))
            if [h["luceneDocId"] for h in got["hits"]] != [h["luceneDocId"] for h in ref["hits"]]:
                raise AssertionError("the replica child's hits differ from the primary's")
        finally:
            children.stop()
        named = children.cuda_lines()
        log(f"replication pair: python -m nrtsearch_tpu_torch.server as a primary and a "
            f"replica child, driven by {len(cli_s)} python -m nrtsearch_tpu_torch.cli calls "
            f"(p50 {float(np.median(cli_s)):.2f} s each); the replica answers 'needle' with "
            f"{want} hits as the primary (primary numDocs {num_docs}); logs: "
            f"{named['primary']} / {named['replica']} | {card}")
        return {"cli_calls": len(cli_s)}


# ---------------------------------------------------------------------------
# phase 12: the general evaluator
# ---------------------------------------------------------------------------

GENERAL_REPS = 3
# a transcendental function in the score (log in a script, the haversine's
# sin, cos, asin and sqrt): the card's and the CPU's results may differ in
# their last bits; held within 4 f32 ulps relative
TRANSCENDENTAL_REL = 4 * 2.0**-23
# the f64 oracle's band (meters) around a radius: the engine's f32
# haversine is within a few decimeters of the f64 distance, so a doc this
# close to the radius may land on either side of it
GEO_NEAR_M = 2.0
# card against CPU: the card's and the CPU's f32 sin, cos, asin and sqrt
# differ in their last bits, so a doc may match on one and not on the
# other only where its CPU f32 distance lies within this many f32 ulps of
# the radius
GEO_FLIP_ULPS = 4
# the merge kernels a chunked timeout search on the merge path launches
TIMEOUT_KERNELS = ("gather_runs", "far_pair_stage", "far_stage", "near_stages", "finish_mask")
# the kernel a score-free return_arrays single launches (the fused path)
ARRAYS_KERNELS = ("head_scores",)
RADIUS = (37.75, -122.4, 5000.0)            # lat, lon, meters
BBOX = (37.70, 37.80, -122.50, -122.40)     # min_lat, max_lat, min_lon, max_lon
POLYGON = ((37.65, -122.50), (37.85, -122.45), (37.70, -122.30))
TIMEOUT_CHECK_EVERY = 500_000               # two docid chunks of the 1M docs


def general_terms(corpus) -> dict:
    """The phase's terms by document frequency: head, mid and tail terms,
    and a prefix (a head term's first two digits)."""
    order = np.argsort(-corpus.term_lengths, kind="stable")
    V = len(order)
    pick = [str(order[min(i, V - 1)]) for i in (0, 3, 40, 120, 300, V // 30, V // 10)]
    head = next(str(t) for t in order if len(str(t)) >= 2)
    return {"head": pick[:2], "mid": pick[2:5], "tail": pick[5:], "prefix": head[:2]}


def general_queries(t: dict, names: list) -> dict:
    """The query surface of tests/test_compiled_eval.py:48-117 on the
    corpus's fields: name -> (query dict, search kwargs maker, contract).
    ``contract`` is how the card's answer is held to the CPU copy's:
    "exact" (bit-equal), "transcendental" (scores within
    TRANSCENDENTAL_REL) or "geo" (flips only within GEO_FLIP_ULPS of the
    radius). Each takes
    the general evaluator: a match or term query sits in a boolean, so the
    fast paths refuse it."""
    from nrtsearch_tpu_torch.core.searcher import SortComponent, SortSpec

    h, m, tl = t["head"], t["mid"], t["tail"]

    def match(terms, **kw):
        return {"matchQuery": {"field": "body", "query": " ".join(terms), **kw}}

    def should(*qs):
        return {"booleanQuery": {"clauses": [{"occur": "SHOULD", "query": q} for q in qs]}}

    radius = {"geoRadiusQuery": {"field": "loc", "center": {
        "latitude": RADIUS[0], "longitude": RADIUS[1]}, "radius": f"{RADIUS[2]}m"}}
    bbox = {"geoBoundingBoxQuery": {"field": "loc",
                                    "topLeft": {"latitude": BBOX[1], "longitude": BBOX[2]},
                                    "bottomRight": {"latitude": BBOX[0], "longitude": BBOX[3]}}}
    polygon = {"geoPolygonQuery": {"field": "loc", "polygons": [{"points": [
        {"latitude": a, "longitude": b} for a, b in POLYGON]}]}}
    none = lambda: {}
    q = {
        "match_should": (should(match([h[1], m[0], tl[0]])), none, "exact"),
        "match_must": (should(match([h[0], m[1]], operator="MUST")), none, "exact"),
        "match_msm2": (match([h[1], m[0], m[2], tl[1]], minimumNumberShouldMatch=2),
                       none, "exact"),
        "match_fuzzy": (match([m[1]], fuzzyParams={"maxEdits": 1, "prefixLength": 1}),
                        none, "exact"),
        "term_text": (should({"termQuery": {"field": "body", "textValue": m[2]}}), none,
                      "exact"),
        "prefix": ({"prefixQuery": {"field": "body", "prefix": t["prefix"]}}, none, "exact"),
        "wildcard": ({"wildcardQuery": {"field": "body", "pattern": t["prefix"] + "*7"}},
                     none, "exact"),
        "dismax": ({"disjunctionMaxQuery": {"disjuncts": [match([h[1]]), match(m[:2])],
                                            "tieBreakerMultiplier": 0.3}}, none, "exact"),
        "function_score": ({"functionScoreQuery": {
            "query": match([h[1], m[0]]), "script": {"source": "_score * log(price + 1)"}}},
                           none, "transcendental"),
        "multi_function": ({"multiFunctionScoreQuery": {
            "query": match([m[0], m[1]]),
            "functions": [
                {"filter": {"termQuery": {"field": "tag", "textValue": names[3]}},
                 "weight": 2.0},
                {"script": {"source": "price / 100"}, "weight": 0.5}],
            "scoreMode": "SCORE_MODE_SUM", "boostMode": "BOOST_MODE_MULTIPLY"}},
            none, "exact"),
        "function_filter": ({"functionFilterQuery": {"script": {"source": "price - 990"}}},
                            none, "exact"),
        "geo_bbox": (bbox, none, "exact"),
        "geo_radius": (radius, none, "geo"),
        "geo_polygon": (polygon, none, "exact"),
        "text_geo_radius": (should(match([h[1], m[0]]), radius), none, "geo"),
        "nested_bool": ({"booleanQuery": {"clauses": [
            {"occur": "MUST", "query": should(match([h[1]]), match([m[0], m[1]]))},
            {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "100",
                                                          "upper": "700"}}},
            {"occur": "MUST_NOT", "query": match([m[2]])}]}}, none, "exact"),
        "columns": ({"booleanQuery": {"clauses": [
            {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "100",
                                                          "upper": "150"}}},
            {"occur": "SHOULD", "query": {"termInSetQuery": {"field": "tag", "textTerms": {
                "terms": list(names[:5])}}}},
            {"occur": "MUST_NOT", "query": {"termQuery": {"field": "tag",
                                                          "textValue": names[2]}}}]}},
            none, "exact"),
        "sort_two": (match([h[1], m[0]]), lambda: {"sort": SortSpec(
            "tag", rest=(SortComponent("ts", reverse=True),))}, "exact"),
        "sort_docid": (should(match([m[0], m[1]])), lambda: {"sort": SortSpec(
            "docid", reverse=True)}, "exact"),
        "sort_score": (should(match([m[0], m[1]])), lambda: {"sort": SortSpec(
            "score", rest=(SortComponent("docid"),))}, "exact"),
        "terminate_after": (match([h[1], m[0]]), lambda: {"terminate_after": 20_000},
                            "exact"),
        "return_arrays": (match([m[0], tl[0]]), lambda: {"return_arrays": True}, "exact"),
    }
    return q


def _answer(td) -> tuple:
    """A TopDocs (or (TopDocs, arrays)) as comparable host values."""
    if isinstance(td, tuple):
        td = td[0]
    keys = [h.sort_key if isinstance(h.sort_key, tuple) else (h.sort_key,) for h in td.hits]
    return ([h.global_ord for h in td.hits], np.array([h.score for h in td.hits], np.float32),
            keys, td.total_hits, td.relation)


def _check_general(name: str, contract: str, card, cpu, masks=None,
                   flip_ok=frozenset()) -> list:
    """The card's answer against the CPU copy's under ``contract``; returns
    the geo flips: docs that match on one device and not on the other.
    ``masks`` (the card's and the CPU's global match masks, given for every
    geo kind) are compared whole; a flip must lie in ``flip_ok``, the
    totals must differ by the flips' net count, and the hits that are not
    flips must agree in order with bit-equal scores."""
    c_ids, c_s, c_k, c_tot, c_rel = _answer(card)
    p_ids, p_s, p_k, p_tot, p_rel = _answer(cpu)
    if masks is not None:
        cm, pm = masks
        flips = np.nonzero(cm != pm)[0]
        fl = set(flips.tolist())
        net = int(cm[flips].sum()) - int(pm[flips].sum())
        if not fl <= flip_ok or c_tot - p_tot != net or c_rel != p_rel:
            raise AssertionError(f"general {name}: card and cpu differ beyond the radius's "
                                 f"last ulps: flips {flips[:10].tolist()}, hits {c_tot} vs "
                                 f"{p_tot}")
        kept = [[(i, v) for i, v in zip(ids, sc.view(np.int32).tolist()) if i not in fl]
                for ids, sc in ((c_ids, c_s), (p_ids, p_s))]
        n = min(len(kept[0]), len(kept[1]))
        if kept[0][:n] != kept[1][:n] or (not fl and len(kept[0]) != len(kept[1])):
            raise AssertionError(f"general {name}: card {c_ids[:5]} vs cpu {p_ids[:5]} "
                                 f"beside the flips")
        return flips.tolist()
    if c_ids != p_ids or (c_tot, c_rel) != (p_tot, p_rel) or c_k != p_k:
        raise AssertionError(f"general {name}: card {c_ids[:5]} {c_tot} {c_rel} vs cpu "
                             f"{p_ids[:5]} {p_tot} {p_rel}")
    if contract == "transcendental":
        err = np.abs(c_s - p_s) / np.maximum(np.abs(p_s), 1e-30)
        if len(err) and err.max() > TRANSCENDENTAL_REL:
            raise AssertionError(f"general {name}: score rel err {err.max():.3g}")
    elif not np.array_equal(c_s.view(np.int32), p_s.view(np.int32)):
        raise AssertionError(f"general {name}: scores not bit-equal")
    return []


class SyncCount:
    """Counts the host's waits on the card inside a ``with`` block. torch's
    sync debug mode warns at every synchronizing CUDA call it detects (a
    blocking copy either way, ``item``, ``nonzero``, a synchronize); each
    such warning is recorded and counted in ``n``. The mode calls itself a
    prototype that does not see every sync, so ``n`` is a lower bound."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._records = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        self.n = sum(str(r.message).startswith("called a synchronizing CUDA operation")
                     for r in self._records)
        return False


def geo_distances(s) -> np.ndarray:
    """Each doc's f32 haversine distance to RADIUS's center, computed on
    the device of ``s``'s segments as the engine computes it, in global
    doc order (inf in a segment without a ``loc`` column)."""
    from nrtsearch_tpu_torch.ops.masks import haversine_meters

    return np.concatenate([
        haversine_meters(seg.doc_values["loc"].values, RADIUS[0], RADIUS[1])
        .cpu().numpy()[: seg.num_docs] if "loc" in seg.doc_values
        else np.full(seg.num_docs, np.inf, np.float32) for seg in s.segments])


def _cache_report() -> tuple[int, int]:
    """The query cache's entries and the bytes of its CUDA tensors."""
    from nrtsearch_tpu_torch.search.query_cache import DEFAULT_QUERY_CACHE

    nbytes = 0
    for value in list(DEFAULT_QUERY_CACHE._lru.values()):
        for t in value:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                nbytes += t.numel() * t.element_size()
    return len(DEFAULT_QUERY_CACHE._lru), nbytes


def phase_general(dev, corpus, columns, server, client, rt, index_dir, card: str) -> dict:
    """The general evaluator on the card (see the module docstring): the
    query surface on the served node's searcher against the commit opened
    on the CPU and the numpy oracles, the chunked timeout and the
    score-free arrays single with their kernels, then 8 served requests
    against the engine's answers."""
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.core.directory import open_commit
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.models.synthetic import (
        eval_column_query, geo_bbox_oracle, geo_radius_oracle)
    from nrtsearch_tpu_torch.ops import bm25, merge_scoring
    from nrtsearch_tpu_torch.query import parse_query

    t_phase = time.perf_counter()
    searcher = rt.searcher
    names = columns["tag"][2]
    terms = general_terms(corpus)
    queries = general_queries(terms, names)
    t = time.perf_counter()
    _m, cpu_segs = open_commit(index_dir, "cpu")
    cpu = Searcher(cpu_segs, searcher.field_defs)
    log(f"general: the commit opened on the CPU in {time.perf_counter() - t:.2f} s "
        f"({cpu.max_doc} docs); terms {terms}")
    r_match, r_near = geo_radius_oracle(columns, *RADIUS, near_m=GEO_NEAR_M)
    near_docs = set(np.nonzero(r_near)[0].tolist())
    with SyncCount() as sc:
        torch.ones(2, device=dev).sum().item()
    if sc.n != 1:
        raise AssertionError(f"general: the sync counter saw {sc.n} syncs in one item()")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    view = searcher.packed_view("body")
    paths0 = dict(view.path_counts)
    lat: dict[str, list] = {}
    card_out, per_query = {}, {}
    for name, (qd, kw, _contract) in queries.items():
        node = parse_query(qd)
        for rep in range(GENERAL_REPS):
            s0 = merge_scoring.HOST_SYNCS["hierarchical_topk"]
            f0 = merge_scoring.TOPK_FALLBACKS["hierarchical_topk"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = searcher.search(node, TOP_K, **kw())
            torch.cuda.synchronize()
            lat.setdefault(name, []).append(time.perf_counter() - t)
            if rep == 0:
                card_out[name] = out
                per_query[name] = (merge_scoring.HOST_SYNCS["hierarchical_topk"] - s0,
                                   merge_scoring.TOPK_FALLBACKS["hierarchical_topk"] - f0)
    # every host wait of one more untimed search per kind
    all_syncs = {}
    for name, (qd, kw, _contract) in queries.items():
        node = parse_query(qd)
        with SyncCount() as sc:
            searcher.search(node, TOP_K, **kw())
        all_syncs[name] = sc.n
    paths = {k: view.path_counts[k] - paths0[k] for k in paths0}
    if any(paths.values()):
        raise AssertionError(f"general: a query took a fast path: {paths}")

    # the chunked timeout inside the merge path, and a score-free arrays
    # single on the fused path: their kernels must launch
    head_q = parse_query({"matchQuery": {"field": "body", "query": " ".join(
        terms["head"] + terms["mid"][:2])}})
    kernels.reset_launch_counts()
    t = time.perf_counter()
    timed = searcher.search(head_q, TOP_K, timeout_sec=1e6,
                            timeout_check_every=TIMEOUT_CHECK_EVERY)
    torch.cuda.synchronize()
    timeout_ms = 1e3 * (time.perf_counter() - t)
    timeout_launches = dict(kernels.LAUNCHES)
    missing = [k for k in TIMEOUT_KERNELS if timeout_launches.get(k, 0) == 0]
    if missing or timed.hit_timeout:
        raise AssertionError(f"general: the chunked timeout search did not launch {missing} "
                             f"(timed out {timed.hit_timeout}): {timeout_launches}")
    _check_topk(timed, corpus.exact_topk(terms["head"] + terms["mid"][:2], TOP_K),
                MERGE_REL, "general chunked timeout")
    kernels.reset_launch_counts()
    t = time.perf_counter()
    arr_td, arrays = searcher.search(head_q, TOP_K, return_arrays=True, arrays_score_free=True)
    torch.cuda.synchronize()
    arrays_ms = 1e3 * (time.perf_counter() - t)
    arrays_launches = dict(kernels.LAUNCHES)
    if any(arrays_launches.get(k, 0) == 0 for k in ARRAYS_KERNELS):
        raise AssertionError(f"general: the score-free arrays single launched "
                             f"{arrays_launches}, not {ARRAYS_KERNELS}")
    n_match = sum(int(m.sum()) for _s, m in arrays)
    if n_match != arr_td.total_hits or any(s is not None for s, _m in arrays):
        raise AssertionError(f"general: score-free arrays hold {n_match} matches, the "
                             f"top-k {arr_td.total_hits}")
    log(f"general: chunked timeout search ({TIMEOUT_CHECK_EVERY} docs per deadline check) "
        f"{timeout_ms:.2f} ms, launches {timeout_launches}; score-free arrays single "
        f"{arrays_ms:.2f} ms, launches {arrays_launches} | {card}")

    # the CPU copy and the numpy oracles
    def global_mask(s, node):
        return np.concatenate([m.cpu().numpy()[: seg.num_docs]
                               for m, seg in zip(s.match_masks(node), s.segments)])

    d_card, d_cpu = geo_distances(searcher), geo_distances(cpu)
    radius32 = np.float32(RADIUS[2])
    ulp = np.spacing(radius32)
    flip_ok = set(np.nonzero(np.abs(d_cpu - radius32) <= GEO_FLIP_ULPS * ulp)[0].tolist())
    d_ulps = float(np.max(np.abs(d_card.astype(np.float64) - d_cpu)
                          / np.spacing(np.maximum(np.abs(d_cpu), np.float32(1.0)))))
    flips = {}
    for name, (qd, kw, contract) in queries.items():
        want = cpu.search(parse_query(qd), TOP_K, **kw())
        masks = None
        if name.startswith(("geo_", "text_geo")):
            masks = (global_mask(searcher, parse_query(qd)), global_mask(cpu, parse_query(qd)))
        flips[name] = _check_general(name, contract, card_out[name], want, masks=masks,
                                     flip_ok=flip_ok if contract == "geo" else frozenset())
        for doc in flips[name]:
            log(f"general {name}: geo flip doc {doc}, distance card {d_card[doc]!r} cpu "
                f"{d_cpu[doc]!r} m, radius {RADIUS[2]} m")
        if name == "return_arrays":
            (_td, ca), (_tw, pa) = card_out[name], want
            for (cs, cm), (ps, pm) in zip(ca, pa):
                cm_h, pm_h = cm.cpu().numpy(), pm.numpy()
                if not np.array_equal(cm_h, pm_h) or not np.array_equal(
                        np.where(cm_h, cs.cpu().numpy(), 0), np.where(pm_h, ps.numpy(), 0)):
                    raise AssertionError("general return_arrays: arrays differ")
    def masks(name):
        return global_mask(searcher, parse_query(queries[name][0]))

    got = masks("geo_radius")
    bad = np.nonzero(got != r_match)[0]
    if not set(bad.tolist()) <= near_docs:
        raise AssertionError(f"general geo_radius: {len(bad)} docs differ from the oracle")
    if not np.array_equal(masks("geo_bbox"), geo_bbox_oracle(columns, *BBOX)):
        raise AssertionError("general geo_bbox: the match set differs from the oracle")
    scores, match = eval_column_query(queries["columns"][0], columns)
    docs = np.nonzero(match)[0]
    want_ids = docs[np.lexsort((docs, -scores[docs]))[:TOP_K]]
    if (card_out["columns"].total_hits != int(match.sum())
            or [h.global_ord for h in card_out["columns"].hits] != want_ids.tolist()
            or [h.score for h in card_out["columns"].hits] != scores[want_ids].tolist()):
        raise AssertionError("general columns: differs from eval_column_query")
    ex = corpus.exact_topk(queries["match_should"][0]["booleanQuery"]["clauses"][0]["query"][
        "matchQuery"]["query"].split(), TOP_K)
    swaps = _check_topk(card_out["match_should"], ex, MERGE_REL, "general match_should")
    fs, fd, ftot = corpus.exact_function_score([terms["head"][1], terms["mid"][0]], TOP_K,
                                               columns)
    swaps += _check_topk(card_out["function_score"], (fs, fd, ftot), MERGE_REL,
                         "general function_score")
    log(f"general exact: {len(queries)} kinds bit-equal to the CPU copy (function_score "
        f"within {TRANSCENDENTAL_REL:.3g}); geo flips "
        f"{ {k: len(v) for k, v in flips.items() if k.startswith(('geo_', 'text_geo'))} } "
        f"({len(flip_ok)} docs within {GEO_FLIP_ULPS} f32 ulps of the radius; the card's and "
        f"the CPU's distances at most {d_ulps:.1f} ulps apart); oracles: BM25, "
        f"function score (near-tie swaps {swaps}), columns, radius ({len(bad)} of "
        f"{len(near_docs)} docs within {GEO_NEAR_M} m of the f64 radius off), bbox | {card}")

    # what the phase shows: per-kind p50, syncs and fallbacks, the busy share
    prof = profile_call(lambda: searcher.search(parse_query(queries["nested_bool"][0]), TOP_K))
    p50_nested = 1e3 * float(np.median(lat["nested_bool"]))
    expand = sorted(((len(seg.fields["body"].terms_with_prefix(terms["prefix"], 128)), i)
                     for i, seg in enumerate(searcher.segments)))[-1]
    seg = searcher.segments[expand[1]]
    tfi = seg.fields["body"]
    exp_terms = tfi.terms_with_prefix(terms["prefix"], 128)
    offs = np.array([tfi.lookup(x)[0] for x in exp_terms])
    lens = np.array([tfi.lookup(x)[1] for x in exp_terms])
    wts = np.ones(len(exp_terms), np.float32)
    avgdl = searcher.stats.avgdl("body")
    def scatter():
        return bm25.score_text_clause(tfi.doc_ids, tfi.freqs, tfi.doc_lens, offs, lens, wts,
                                      1.2, 0.75, avgdl, num_docs=seg.capacity)

    scatter_ms = cuda_ms(scatter, reps=5, warmup=1)
    torch.cuda.synchronize()
    with SyncCount() as sc:
        scatter()
    scatter_syncs = sc.n
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    entries, cache_bytes = _cache_report()
    for name in queries:
        sy, fa = per_query[name]
        log(f"general p50 {name}: {1e3 * float(np.median(lat[name])):.2f} ms (n="
            f"{len(lat[name])}), hits {_answer(card_out[name])[3]}; host syncs {all_syncs[name]} "
            f"(hierarchical_topk {sy}), full-sort fallbacks {fa} per query | {card}")
    log(f"general profile: nested_bool single, device busy {prof['device_busy_ms']:.3f} ms in "
        f"{prof['device_items']} device items, {100 * prof['device_busy_ms'] / p50_nested:.1f}% "
        f"of its p50 {p50_nested:.2f} ms; top {json.dumps(prof['top'][:6])} | {card}")
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("general: the profiled single ran nothing on the device")
    log(f"general: text scatter of the largest prefix expansion ({expand[0]} terms, "
        f"{int(lens.sum())} postings, one index_add_ per term) {scatter_ms:.3f} ms, "
        f"{scatter_syncs} host syncs; peak device memory "
        f"{peak / 2**30:.3f} GiB; query cache {entries} entries, {cache_bytes / 2**20:.2f} "
        f"MiB on the card | {card}")

    # 8 served requests, each bit-equal to the engine's answer
    served = general_served(client, searcher, columns, terms, names)
    launches = dict(timeout_launches)
    for k, v in arrays_launches.items():
        launches[k] = launches.get(k, 0) + v
    seconds = time.perf_counter() - t_phase
    log(f"general: phase {seconds:.1f} s; {served} served requests bit-equal to the "
        f"engine | {card}")
    return {"launches": launches, "seconds": seconds}


def general_served(client, searcher, columns, terms, names) -> int:
    """8 requests over gRPC, each held bit-equal to ``searcher``'s direct
    answer: geo radius with text, function score, virtualFields with a
    script, a two-component sort, terminateAfter, timeoutSec, a facet that
    needs match arrays and a prefix query."""
    from nrtsearch_tpu_torch.core.packed_view import QuerySpec
    from nrtsearch_tpu_torch.core.searcher import SortComponent, SortSpec
    from nrtsearch_tpu_torch.query import parse_query
    from nrtsearch_tpu_torch.query.eval import _ScriptDocValues
    from nrtsearch_tpu_torch.script.expr import compile_expression

    h, m = terms["head"], terms["mid"]
    match = {"matchQuery": {"field": "body", "query": f"{h[1]} {m[0]}"}}
    text_geo = {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": match},
        {"occur": "FILTER", "query": {"geoRadiusQuery": {"field": "loc", "center": {
            "latitude": RADIUS[0], "longitude": RADIUS[1]}, "radius": f"{RADIUS[2]}m"}}}]}}
    fscore = {"functionScoreQuery": {"query": match,
                                     "script": {"source": "_score * log(price + 1)"}}}
    prefix = {"prefixQuery": {"field": "body", "prefix": terms["prefix"]}}
    msm = {"matchQuery": {"field": "body", "query": f"{h[1]} {m[0]} {m[1]}",
                          "minimumNumberShouldMatch": 2}}
    two = SortSpec("tag", rest=(SortComponent("ts", reverse=True),))
    n = 0

    def same(name, req, node, **kw):
        """The served answer against the engine's, taken as the handler
        takes it: a batchable spec through a batcher group (padded to 8
        with empty specs), the rest through Searcher.search."""
        nonlocal n
        resp = client.search(req)
        spec = None if kw else searcher.compile_batchable(parse_query(node))
        if spec is not None:
            pad = QuerySpec(field=spec.field, terms=())
            td = searcher.fast_search_batch([spec] + [pad] * 7, TOP_K)[0]
        else:
            td = searcher.search(parse_query(node), TOP_K, **kw)
        got = [(x.luceneDocId, x.score) for x in resp.hits]
        want = [(x.global_ord, x.score if kw.get("sort") is None else 0.0) for x in td.hits]
        if got != want or resp.totalHits.value != td.total_hits:
            raise AssertionError(f"general served {name}: {got[:3]} {resp.totalHits.value} vs "
                                 f"{want[:3]} {td.total_hits}")
        n += 1
        return resp, td

    same("text_geo_radius", _request(text_geo), text_geo)
    same("function_score", _request(fscore), fscore)
    req = _request(match, retrieveFields=["price"])
    vf = req.virtualFields.add()
    vf.name = "price_x2"
    vf.script.source = "price * 2 + ts / 1000"
    req.retrieveFields.append("price_x2")
    resp, td = same("virtual_fields", req, match)
    fn = compile_expression(vf.script.source)
    cols = {}
    for hit_pb, hit in zip(resp.hits, td.hits):
        if hit.segment_idx not in cols:
            seg = searcher.segments[hit.segment_idx]
            cols[hit.segment_idx] = fn(_ScriptDocValues(seg), np.zeros(seg.capacity, np.float32))
        want = float(cols[hit.segment_idx][hit.local_id])
        if hit_pb.fields["price_x2"].fieldValue[0].doubleValue != want:
            raise AssertionError("general served virtual_fields: the script value differs")
    req = _request(match)
    for name, rev in (("tag", False), ("ts", True)):
        sf = req.querySort.fields.sortedFields.add()
        sf.fieldName = name
        sf.reverse = rev
    resp, td = same("sort_two", req, match, sort=two)
    got = [(x.sortedFields["tag"].fieldValue[0].doubleValue,
            x.sortedFields["ts"].fieldValue[0].doubleValue) for x in resp.hits]
    if got != [x.sort_key for x in td.hits]:
        raise AssertionError("general served sort_two: sort values differ")
    same("terminate_after", _request(match, terminateAfter=30_000), match,
         terminate_after=30_000)
    same("timeout_sec", _request(match, timeoutSec=1e6), match, timeout_sec=1e6)
    req = _request(msm)
    f = req.facets.add()
    f.dim = "tag"
    f.topN = 200
    resp, _td = same("facet_arrays", req, msm)
    masks = searcher.match_masks(parse_query(msm))
    counts: dict = {}
    for seg, mask in zip(searcher.segments, masks):
        mk = mask.cpu().numpy()[: seg.num_docs]
        dv = seg.doc_values["tag"]
        for o, c in zip(*np.unique(dv.host_values[: seg.num_docs][mk], return_counts=True)):
            counts[dv.ord_terms[int(o)]] = counts.get(dv.ord_terms[int(o)], 0) + int(c)
    (fr,) = resp.facetResult
    if {lv.label: int(lv.value) for lv in fr.labelValues} != counts:
        raise AssertionError("general served facet_arrays: facet counts differ")
    same("prefix", _request(prefix), prefix)
    return n


# ---------------------------------------------------------------------------
# phase 13: the write path on the card
# ---------------------------------------------------------------------------

# the fields phase 13's node adds to the served index: an _ID for upserts,
# deletes by id and doc-value updates, and a stored revision marker that
# tells an upserted doc's new version from its old one
WRITE_FIELDS = [("doc_id", {"type": "_ID", "store": True, "storeDocValues": True}),
                ("rev", {"type": "ATOM", "store": True})]
WRITE_DOCS = 2000          # id'd docs, added in WRITE_CHUNKS addDocuments + refresh rounds
WRITE_CHUNKS = 4
WRITE_OPS = 200            # deletes by id, upserts and doc-value updates, each
DBQ_TAG = 7                # deleteByQuery: one tag ordinal (about 1% of the docs)
DBQ_PRICE = (500.0, 510.0)  # and a price range (about 1%), bounds inclusive
UPDATED_PRICE = 5000.0     # above every drawn price: a range finds the updated docs
UPDATED_TS = 2e9           # above every drawn ts; UPDATED_TS + 128 i is an f32 number
WRITE_KERNELS = ("head_scores", "near_stages", "far_stage", "far_pair_stage",
                 "gather_runs", "finish_mask", "bucket_rank_topk")
GENERAL_WRITE_KINDS = ("columns", "geo_radius", "function_score", "prefix")
WRITE_BRANCH = {"alt": 1, "plain": 0}   # the B=32 batch's merge network on the card


def _write_docs() -> tuple[list, list, list, list]:
    """Phase 7's documents with config #3's fields and an id each, and the
    ids deleted, the upserts (new bodies, rev 1) and the doc-value updates
    (price and ts) of three disjoint groups of WRITE_OPS."""
    docs = _served_ingest_docs(WRITE_DOCS)
    for i, d in enumerate(docs):
        d.update(doc_id=f"w{i}", rev="0")
    n = WRITE_OPS
    deleted = [f"w{i}" for i in range(n)]
    upserts = [dict(docs[i], body="needle upserted " + docs[i]["body"], rev="1")
               for i in range(n, 2 * n)]
    updates = [{"doc_id": f"w{i}", "price": str(UPDATED_PRICE + j),
                "ts": str(UPDATED_TS + 128 * j)} for j, i in enumerate(range(2 * n, 3 * n))]
    return docs, deleted, upserts, updates


def _requests_of(docs, request_type=None):
    from nrtsearch_tpu_torch.gen import pb

    for req in _add_requests(docs):
        if request_type is not None:
            req.requestType = request_type
        yield req


def _layout(segments) -> list:
    """Per segment: kind (flushed, _m merged, _dv updated), docs, deleted
    docs, del_gen and the live mask's bytes."""
    import re

    return [(re.sub(r"^seg_[0-9a-f]+_\d+", "", s.seg_id), s.num_docs, s.del_count, s.del_gen,
             np.asarray(s.host_live).tobytes()) for s in segments]


def _strip_state(resp) -> bytes:
    """A response without timings and search state: bit for bit across nodes."""
    resp = type(resp).FromString(resp.SerializeToString())
    resp.ClearField("diagnostics")
    resp.ClearField("searchState")
    return resp.SerializeToString(deterministic=True)


def phase_write(dev, corpus, columns, searcher, singles, batches, card: str) -> dict:
    """Phase 13, the write path on the card (see the module docstring).
    Returns the launches of the phase's searches and its timings."""
    import shutil
    import tempfile

    from google.protobuf.json_format import ParseDict

    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.core.directory import commit_segments, open_commit
    from nrtsearch_tpu_torch.core.searcher import Searcher, SortSpec
    from nrtsearch_tpu_torch.core.writer import IndexWriter
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.models.synthetic import config3_query
    from nrtsearch_tpu_torch.ops import merge_scoring
    from nrtsearch_tpu_torch.query import parse_query

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="write_")
    state, discovery = f"{root}/state", f"{root}/primary.json"
    nodes = []
    warm_s: list = []
    orig_warm = Searcher.warm

    def timed_warm(s, fields):
        # the view and head-row rebuild a refresh starts off the request path
        t = time.perf_counter()
        orig_warm(s, fields)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t)

    names = columns["tag"][2]
    tag_vals, tag_present = columns["tag"][:2]
    price_vals, price_present = columns["price"][:2]
    lo, hi = DBQ_PRICE
    base_deleted = ((tag_present & (tag_vals == DBQ_TAG))
                    | (price_present & (price_vals >= lo) & (price_vals <= hi)))
    docs, deleted, upserts, updates = _write_docs()
    deleted_ids, upserted_ids = set(deleted), {d["doc_id"] for d in upserts}
    Searcher.warm = timed_warm
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # 1. a PRIMARY node over phase 4's index, with an _ID field
        primary, pc = _node(root, "primary", dev=dev, state=state)
        nodes.append((primary, pc))
        pc.create_index(SERVED_INDEX)
        pc.register_fields(pb.FieldDefRequest(indexName=SERVED_INDEX, field=[
            pb.Field(name=n, **{k: (pb.FieldType.Value(v) if k == "type" else v)
                                for k, v in spec.items()})
            for n, spec in SERVED_FIELDS + WRITE_FIELDS]))
        index_dir = os.path.join(primary.config.index_dir,
                                 primary.global_state.index_ids[SERVED_INDEX])
        commit_segments(searcher.segments, index_dir, gen=1, version=1, primary_gen=1)
        ls = pb.LiveSettingsV2Request(indexName=SERVED_INDEX)
        ls.liveSettings.maxMergedSegmentMB.value = 1
        ls.liveSettings.segmentsPerTier.value = 6
        ls.liveSettings.maxRefreshSec.value = 3600.0
        pc.live_settings_v2(ls)
        pc.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.PRIMARY,
                                            primaryGen=1))
        rt = primary.global_state.runtimes[SERVED_INDEX]
        with open(discovery, "w") as f:
            json.dump({"host": "localhost", "port": primary.replication_port}, f)
        base_segs = [(s.seg_id, s.num_docs) for s in rt.searcher.segments]
        fds = rt.field_defs

        # the oracle: the same commit on the CPU, every operation replayed
        # through the port's writer there (its plain versions)
        t = time.perf_counter()
        _m, cpu_segs = open_commit(index_dir, "cpu")
        cpu_w = IndexWriter(fds, "cpu")
        cpu_w.install_segments(cpu_segs)
        cpu_w.segments_per_tier = rt.writer.segments_per_tier
        cpu_w.max_merged_docs = rt.writer.max_merged_docs
        log(f"write: the commit opened on the CPU in {time.perf_counter() - t:.2f} s; the "
            f"node's writer: segmentsPerTier {rt.writer.segments_per_tier}, max merged docs "
            f"{rt.writer.max_merged_docs}")

        def timings(label: str, bucket: bool = False) -> dict:
            s = rt.searcher
            s.search(_match(singles[0]), TOP_K)
            lat1 = []
            for _ in range(3):
                for q in singles:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    s.search(_match(q), TOP_K)
                    torch.cuda.synchronize()
                    lat1.append(time.perf_counter() - t)
            out = {"fused_p50": 1e3 * float(np.median(lat1))}
            paths = ["merge", "bucket"] if bucket else ["merge"]
            for path in paths:
                lat = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    _with_path(path, lambda: s.fast_search_batch(
                        [s.fast_query_spec(_match(q)) for q in batches[0]], TOP_K))
                    torch.cuda.synchronize()
                    lat.append(time.perf_counter() - t)
                out[f"{path}_b32"] = 1e3 * float(np.median(lat))
            log(f"write {label}: fused B=1 p50 {out['fused_p50']:.2f} ms (n={len(lat1)}), "
                + ", ".join(f"{p} B={BATCH} p50 {out[f'{p}_b32']:.2f} ms (n=3)" for p in paths)
                + f" | {card}")
            return out

        before = timings("before the deletes")

        def join_warm() -> None:
            if rt._warm_thread is not None:
                rt._warm_thread.join()

        def refresh(label: str) -> dict:
            """The refresh RPC, split: the writer's refresh, the rest of the
            RPC (publish), the view and head-row rebuild it starts, and the
            first single after it."""
            w = {}
            orig = rt.writer.refresh

            def timed():
                t = time.perf_counter()
                out = orig()
                torch.cuda.synchronize()
                w["s"] = time.perf_counter() - t
                return out

            rt.writer.refresh = timed
            join_warm()
            n_warm = len(warm_s)
            try:
                t = time.perf_counter()
                pc.refresh(SERVED_INDEX)
                rpc_s = time.perf_counter() - t
                join_warm()
                total_s = time.perf_counter() - t
            finally:
                del rt.writer.refresh
            t = time.perf_counter()
            rt.searcher.search(_match(singles[0]), TOP_K)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t
            cpu_w.refresh()
            out = {"rpc_s": rpc_s, "writer_s": w.get("s", 0.0),
                   "rebuild_s": sum(warm_s[n_warm:]), "total_s": total_s, "first_s": first_s}
            log(f"write refresh {label}: {total_s:.2f} s to a warm searcher: RPC "
                f"{rpc_s:.3f} s (writer {out['writer_s']:.3f} s, publish "
                f"{rpc_s - out['writer_s']:.3f} s), view and head-row rebuild "
                f"{out['rebuild_s']:.3f} s; first single after it {first_s * 1e3:.2f} ms "
                f"| {card}")
            return out

        # 2. deleteByQuery: one tag ordinal and a price range
        dbq = {"tag": {"termQuery": {"field": "tag", "textValue": names[DBQ_TAG]}},
               "price": {"rangeQuery": {"field": "price", "lower": str(lo), "upper": str(hi)}}}
        dbq_s = {}
        for label, q in dbq.items():
            req = pb.DeleteByQueryRequest(indexName=SERVED_INDEX)
            ParseDict(q, req.query.add())
            join_warm()
            torch.cuda.synchronize()
            t = time.perf_counter()
            pc.delete_by_query(req)
            dbq_s[label] = time.perf_counter() - t
            # its own refresh published a searcher whose rebuild runs on
            n_warm = len(warm_s)
            join_warm()
            dbq_s[f"{label} rebuild"] = sum(warm_s[n_warm:])
            # replayed: the runtime's refresh, the match masks, delete_matches
            cpu_w.refresh()
            cs = Searcher(list(cpu_w.segments), fds)
            matches = {}
            for seg, m in zip(cs.segments, cs.match_masks(parse_query(q))):
                ids = np.nonzero(m.numpy()[: seg.num_docs])[0]
                if len(ids):
                    matches[seg.seg_id] = ids
            cpu_w.delete_matches(matches)
        refreshes = {"delete_by_query": refresh("after deleteByQuery")}
        n_del = sum(s.del_count for s in rt.searcher.segments)
        if n_del != int(base_deleted.sum()):
            raise AssertionError(f"write: deleteByQuery deleted {n_del} docs, the columns "
                                 f"say {int(base_deleted.sum())}")
        log(f"write deleteByQuery: tag {names[DBQ_TAG]} {dbq_s['tag']:.3f} s, price "
            f"[{lo}, {hi}] {dbq_s['price']:.3f} s (its refresh published the tag's "
            f"deletes; their view and head-row rebuild {dbq_s['price rebuild']:.3f} s ran "
            f"after the RPC); {n_del} docs deleted "
            f"({100 * n_del / NUM_DOCS:.2f}%) | {card}")
        after_dbq = timings("after the deletes", bucket=True)

        # 3. id'd docs: adds (tiered merges), deletes by id, upserts, updates
        step = WRITE_DOCS // WRITE_CHUNKS
        t = time.perf_counter()
        for c in range(WRITE_CHUNKS):
            chunk = docs[c * step:(c + 1) * step]
            pc.add_documents(_requests_of(chunk))
            cpu_w.add_documents([dict(d) for d in chunk])
            refreshes[f"add {c}"] = refresh(f"after adding docs {c * step}-{(c + 1) * step}")
        add_s = time.perf_counter() - t
        req = pb.AddDocumentRequest(indexName=SERVED_INDEX)
        req.fields["doc_id"].value.extend(deleted)
        t = time.perf_counter()
        pc.delete(req)
        del_s = time.perf_counter() - t
        t = time.perf_counter()
        pc.add_documents(_requests_of(upserts))
        ups_s = time.perf_counter() - t
        cpu_w.delete_by_id(deleted)
        cpu_w.add_documents([dict(d) for d in upserts])
        refreshes["writes"] = refresh("after deletes by id and upserts")
        # the updates get a refresh of their own: one that adds a segment
        # would merge the new _dv segment away
        t = time.perf_counter()
        pc.add_documents(_requests_of(updates, pb.IndexingRequestType.UPDATE_DOC_VALUES))
        upd_s = time.perf_counter() - t
        cpu_w.update_doc_values([dict(d) for d in updates])
        refreshes["updates"] = refresh("after doc-value updates")
        st = rt.stats()
        segs = rt.writer.segments
        if _layout(segs) != _layout(cpu_w.segments):
            raise AssertionError("write: the card's segments differ from the CPU replay's")
        if [(s.seg_id, s.num_docs) for s in segs[: len(base_segs)]] != base_segs:
            raise AssertionError("write: the 1M-doc segments moved")
        if st["merges"] == 0 or not any(s.del_gen > 0 for s in segs) or not any(
                s.seg_id.endswith("_dv") for s in segs):
            raise AssertionError(f"write: no merge, no del_gen > 0 or no _dv segment: "
                                 f"{[lay[:4] for lay in _layout(segs)]} {st}")
        log(f"write ops: {WRITE_DOCS} id'd docs in {WRITE_CHUNKS} rounds {add_s:.2f} s "
            f"({st['merges']} merges); delete of {len(deleted)} ids {del_s:.3f} s, "
            f"{len(upserts)} upserts {ups_s:.3f} s, {len(updates)} UPDATE_DOC_VALUES "
            f"{upd_s:.3f} s; {len(segs)} segments "
            f"{[(k, n, d, g) for k, n, d, g, _l in _layout(segs)]} equal to the CPU replay's "
            f"| {card}")

        # 4. the answers, every path, with the launch counters around them
        eng = rt.searcher
        bases = np.asarray(eng.bases)
        cpu = Searcher(list(cpu_w.segments), fds)
        cpu._fast_text_search = cpu._fast_filtered_text = lambda *a, **k: None

        def check_live(ords, ctx: str) -> None:
            """No deleted base doc, no deleted id and no replaced version."""
            seen = set()
            for g in ords:
                g = int(g)
                if g < NUM_DOCS:
                    if base_deleted[g]:
                        raise AssertionError(f"{ctx}: deleted doc {g} answered")
                    continue
                si = int(np.searchsorted(bases, g, side="right")) - 1
                row = eng.segments[si].stored[g - int(bases[si])]
                did = row.get("doc_id")
                if did in deleted_ids or did in seen or (
                        did in upserted_ids and row.get("rev") != "1"):
                    raise AssertionError(f"{ctx}: {did} (rev {row.get('rev')}) answered")
                seen.add(did)

        view = eng.packed_view("body")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        paths0 = dict(view.path_counts)
        fused_out = [eng.search(_match(q), TOP_K) for q in singles]
        fused_paths = view.path_counts["fused"] - paths0["fused"]
        branch0, paths1 = merge_branches(), dict(view.path_counts)
        merge_out = eng.fast_search_batch([eng.fast_query_spec(_match(q))
                                           for q in batches[0]], TOP_K)
        branch = _branch_delta(branch0)
        batch_rel = (MERGE_REL if view.path_counts["merge"] - paths1["merge"] == BATCH
                     else FUSED_REL)
        merge_all = _with_path("merge", lambda: _timed_searches(eng, singles, batches, reps=1))
        b0 = view.path_counts["bucket"]
        bucket = _with_path("bucket", lambda: _timed_searches(eng, singles, batches, reps=1))
        bucket_specs = view.path_counts["bucket"] - b0
        c3 = config3_singles(corpus, searcher)
        trees = [config3_query(terms, names, SEED + i) for i, (_p, terms) in enumerate(c3)]
        forms = {
            "scored": lambda i: _request(trees[i]),
            "sorted_ts": lambda i: _sorted_request(trees[i]),
            "faceted": lambda i: _faceted_request(_grouped_filters(trees[i])),
        }
        c3_out, c3_paths = {}, {}
        for name, make in forms.items():
            for i in range(len(trees)):
                before_p = dict(view.path_counts)
                c3_out[(name, i)] = pc.search(make(i))
                moved = [k for k in before_p if view.path_counts[k] != before_p[k]]
                c3_paths[(name, i)] = moved[0] if moved else "general"
        gq = general_queries(general_terms(corpus), names)
        general_out = {k: eng.search(parse_query(gq[k][0]), TOP_K) for k in GENERAL_WRITE_KINDS}
        common = _match_dict(["common"])
        upd_q = {"rangeQuery": {"field": "price", "lower": str(UPDATED_PRICE)}}
        upd_range = pc.search(_request(upd_q, k=2 * WRITE_OPS, retrieveFields=["doc_id"]))
        ts_req = _request(common, k=20)
        sf = ts_req.querySort.fields.sortedFields.add()
        sf.fieldName, sf.reverse = "ts", True
        upd_sorted = pc.search(ts_req)
        upd_facet = pc.search(_faceted_request(common))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in WRITE_KERNELS if launches.get(k, 0) == 0]
        log(f"write: launches {launches}; fused singles {fused_paths} of {len(singles)}, "
            f"B={BATCH} merge branch {branch}, bucket specs {bucket_specs}, config #3 paths "
            f"{sorted(set(c3_paths.values()))} | {card}")
        if missing:
            raise AssertionError(f"write: kernels not launched on the deleted index: {missing}")
        if fused_paths != len(singles) or branch != WRITE_BRANCH:
            raise AssertionError(f"write: singles on the fused path {fused_paths}, the batch "
                                 f"on {branch}")
        n_bucket = len(singles) + sum(len(b) for b in batches)
        if bucket_specs != n_bucket:
            raise AssertionError(f"write: {bucket_specs} of {n_bucket} specs on the bucket path")

        # every answer against the deleted and replaced docs, and the CPU copy
        for ctx, td in ([(f"fused {q}", o) for q, o in zip(singles, fused_out)]
                        + [(f"merge {q}", o) for q, o in zip(batches[0], merge_out)]
                        + [(f"bucket {q}", o) for q, o in zip(
                            singles + [q for b in batches for q in b],
                            bucket["single_out"] + [o for b in bucket["batch_out"] for o in b])]
                        + [(f"general {k}", o) for k, o in general_out.items()]):
            check_live([h.global_ord for h in td.hits], ctx)
        for (name, i), resp in c3_out.items():
            check_live([h.luceneDocId for h in resp.hits], f"config3 {name} {i}")
        for resp in (upd_range, upd_sorted, upd_facet):
            check_live([h.luceneDocId for h in resp.hits], "updated values")

        t = time.perf_counter()
        swaps, worst = 0, {"fused": 0.0, "merge": 0.0}
        for q, td in zip(singles, fused_out):
            want = cpu.search(_match(q), TOP_K)
            ex = (np.array([h.score for h in want.hits], np.float32),
                  np.array([h.global_ord for h in want.hits]), want.total_hits)
            swaps += _check_topk(td, ex, FUSED_REL, f"write fused {q}")
            worst["fused"] = max(worst["fused"], _max_rel(td, ex))
        for q, td in zip(batches[0], merge_out):
            want = cpu.search(_match(q), TOP_K)
            ex = (np.array([h.score for h in want.hits], np.float32),
                  np.array([h.global_ord for h in want.hits]), want.total_hits)
            swaps += _check_topk(td, ex, batch_rel, f"write merge {q}")
            worst["merge"] = max(worst["merge"], _max_rel(td, ex))
        quanta, shared = 0.0, 0
        pairs = list(zip(singles, bucket["single_out"], merge_all["single_out"]))
        for qs, bo, mo in zip(batches, bucket["batch_out"], merge_all["batch_out"]):
            pairs += list(zip(qs, bo, mo))
        for q, b, mres in pairs:
            spec = eng.fast_query_spec(_match(q))
            if _shares_scale_bound(view, spec):
                shared += 1
                if (b.total_hits, b.relation) != (mres.total_hits, mres.relation):
                    raise AssertionError(f"write bucket {q}: hits {b.total_hits} vs merge "
                                         f"{mres.total_hits}")
                continue
            scale = float(view.bucket_plan([spec])["scales"][0])
            quanta = max(quanta, scale * _check_bucket_answer(
                b, mres, len(q) / scale, f"write bucket {q}"))
        for i, (_p, terms) in enumerate(c3):
            node = parse_query(trees[i])
            want = cpu.search(node, TOP_K)
            path = c3_paths[("scored", i)]
            rel = FUSED_REL if path == "fused" else MERGE_REL
            ex = (np.array([h.score for h in want.hits], np.float32),
                  np.array([h.global_ord for h in want.hits]), want.total_hits)
            swaps += _check_topk(_served_td(c3_out[("scored", i)]), ex, rel,
                                 f"write config3 scored {terms} ({path})")
            want = cpu.search(node, TOP_K, sort=SortSpec("ts", reverse=True))
            _check_sorted(_served_td(c3_out[("sorted_ts", i)], "ts"), {
                "hits": want.total_hits,
                "scores": np.array([h.sort_key for h in want.hits], np.float32),
                "docs": np.array([h.global_ord for h in want.hits])},
                f"write config3 sorted {terms}")
            _check_facet(cpu, node, c3_out[("faceted", i)], f"write config3 faceted {terms}")
        d_cpu = geo_distances(cpu)
        radius32 = np.float32(RADIUS[2])
        flip_ok = set(np.nonzero(np.abs(d_cpu - radius32)
                                 <= GEO_FLIP_ULPS * np.spacing(radius32))[0].tolist())
        flips = 0
        for k in GENERAL_WRITE_KINDS:
            node = parse_query(gq[k][0])
            masks = None
            if gq[k][2] == "geo":
                masks = (_global_mask(eng, node), _global_mask(cpu, node))
            flips += len(_check_general(f"write {k}", gq[k][2], general_out[k],
                                        cpu.search(node, TOP_K), masks=masks,
                                        flip_ok=flip_ok if masks is not None else frozenset()))
        # the updated values in a filter, a sort and a facet
        upd_ids = {d["doc_id"] for d in updates}
        got = {h.fields["doc_id"].fieldValue[0].textValue for h in upd_range.hits}
        if upd_range.totalHits.value != len(upd_ids) or got != upd_ids:
            raise AssertionError(f"write: price >= {UPDATED_PRICE} answers "
                                 f"{upd_range.totalHits.value} docs, not the updated ones")
        want = cpu.search(parse_query(common), 20, sort=SortSpec("ts", reverse=True))
        keys = [h.sortedFields["ts"].fieldValue[0].doubleValue for h in upd_sorted.hits]
        if ([h.luceneDocId for h in upd_sorted.hits] != [h.global_ord for h in want.hits]
                or keys != [h.sort_key for h in want.hits]
                or keys[0] != UPDATED_TS + 128 * (WRITE_OPS - 1)):
            raise AssertionError(f"write: the ts sort does not lead with the updated ts: {keys[:3]}")
        total = _check_facet(cpu, parse_query(common), upd_facet, "write facet of 'common'")
        if total < UPDATED_PRICE * WRITE_OPS:
            raise AssertionError(f"write: the price sum {total} misses the updated prices")
        log(f"write exact: against the CPU replay (its general evaluator, exact f32): "
            f"{len(singles)} fused singles within {FUSED_REL} (worst {worst['fused']:.3g}), "
            f"{len(merge_out)} merge answers within {batch_rel} (worst {worst['merge']:.3g}), "
            f"hits exact, near-tie swaps {swaps}; {len(pairs)} bucket answers within one "
            f"quantum per term of the merge path (worst {quanta:.3f} quanta; {shared} shared "
            f"scale bounds held to hit counts); {len(trees)} x {len(forms)} config #3 "
            f"answers, sorts and facets exact; {len(GENERAL_WRITE_KINDS)} general kinds "
            f"bit-equal ({flips} geo flips within {GEO_FLIP_ULPS} ulps); updated price and "
            f"ts in a range, a sort and a facet; no deleted or replaced doc in any answer "
            f"({time.perf_counter() - t:.1f} s) | {card}")
        after = timings("after every write", bucket=True)

        # 5. commit, stopIndex, startIndex: bit for bit
        again = ([_request(_match_dict(q)) for q in singles]
                 + [make(i) for make in forms.values() for i in (0, len(trees) - 1)]
                 + [_request(gq[k][0]) for k in GENERAL_WRITE_KINDS]
                 + [_request(upd_q, k=2 * WRITE_OPS), ts_req, _faceted_request(common)])
        answers = [_strip(pc.search(r)) for r in again]
        pc.commit(SERVED_INDEX)
        pc.stop_index(SERVED_INDEX)
        t = time.perf_counter()
        pc.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.PRIMARY,
                                            primaryGen=1))
        reopen_s = time.perf_counter() - t
        rt = primary.global_state.runtimes[SERVED_INDEX]
        if [_strip(pc.search(r)) for r in again] != answers:
            raise AssertionError("write: after commit, stopIndex and startIndex the answers "
                                 "differ")
        log(f"write restart: commit, stopIndex, startIndex ({reopen_s:.2f} s): {len(again)} "
            f"answers bit for bit")

        # 6. a replica installs the point: del_gen > 0 and _dv segments
        replica, rc = _node(root, "replica", dev=dev, state=state)
        nodes.append((replica, rc))
        t = time.perf_counter()
        rc.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.REPLICA,
                                            primaryDiscoveryFile=discovery))
        sync_s = time.perf_counter() - t
        r_rt = replica.global_state.runtimes[SERVED_INDEX]
        r_segs = r_rt.searcher.segments
        if (_layout(r_segs) != _layout(rt.searcher.segments)
                or not any(s.del_gen > 0 for s in r_segs)
                or not any(s.seg_id.endswith("_dv") for s in r_segs)):
            raise AssertionError("write: the replica's point lacks the primary's deletes or "
                                 "updates")
        p_ans = [_strip_state(pc.search(r)) for r in again]
        if [_strip_state(rc.search(r)) for r in again] != p_ans:
            raise AssertionError("write: the replica answers differently from the primary")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        seconds = time.perf_counter() - t_phase
        log(f"write replica: initial sync {sync_s:.2f} s of a point with "
            f"{sum(s.del_gen > 0 for s in r_segs)} segments at del_gen > 0 and "
            f"{sum(s.seg_id.endswith('_dv') for s in r_segs)} _dv segments; "
            f"{len(again)} answers equal to the primary's | {card}")
        log(f"write: phase {seconds:.1f} s; peak device memory {peak / 2**30:.3f} GiB "
            f"(phase 4's index and two 1M-doc nodes) | {card}")
        return {"launches": launches, "seconds": seconds, "before": before,
                "after_dbq": after_dbq, "after": after, "refreshes": refreshes,
                "dbq_s": dbq_s}
    finally:
        Searcher.warm = orig_warm
        for node, client in nodes:
            client.close()
            node.stop()
        shutil.rmtree(root, ignore_errors=True)


def _global_mask(s, node) -> np.ndarray:
    return np.concatenate([m.cpu().numpy()[: seg.num_docs]
                           for m, seg in zip(s.match_masks(node), s.segments)])


def _check_facet(cpu, node, resp, ctx: str) -> float:
    """A served tag facet and price-sum collector against the CPU copy's
    match masks over its columns: counts equal, the sum within SUM_REL.
    Returns the sum."""
    counts: dict = {}
    total = 0.0
    for seg, mask in zip(cpu.segments, cpu.match_masks(node)):
        mk = mask.numpy()[: seg.num_docs]
        tag = seg.doc_values["tag"]
        sel = mk & tag.host_present[: seg.num_docs]
        for o, c in zip(*np.unique(tag.host_values[: seg.num_docs][sel], return_counts=True)):
            counts[tag.ord_terms[int(o)]] = counts.get(tag.ord_terms[int(o)], 0) + int(c)
        price = seg.doc_values.get("price")
        if price is not None:
            sel = mk & price.host_present[: seg.num_docs]
            total += float(price.host_values[: seg.num_docs][sel].astype(np.float64).sum())
    (fr,) = resp.facetResult
    if {lv.label: int(lv.value) for lv in fr.labelValues} != counts:
        raise AssertionError(f"{ctx}: facet counts differ from the CPU copy")
    got = resp.collectorResults["price_sum"].doubleResult.value
    if abs(got - total) > SUM_REL * abs(total):
        raise AssertionError(f"{ctx}: price sum {got} vs {total}")
    return total


# ---------------------------------------------------------------------------
# phase 14: vector search and the result tail (BASELINE configs #4 and #5)
# ---------------------------------------------------------------------------

VEC_DIMS = 128             # SIFT1M's shape (BASELINE config #4)
# field, storage format, similarity
VEC_FIELDS = (("vec", "float32", "l2_norm"), ("vec_bf16", "float16", "cosine"),
              ("vec_i8", "int8", "dot_product"))
VEC_QUERIES = 32           # per field, at each k
VEC_KS = (10, 100)
VEC_REPLAY = 8             # queries per field replayed on the CPU copy of the commit
VEC_ULPS = 4               # a score within 4 f32 ulps of its scale S (tests/test_torch_knn.py)
VEC_OP_REPS = 15
VEC_INGEST = 2000          # docs with vectors, in VEC_ROUNDS addDocuments + refresh rounds
VEC_ROUNDS = 4
VEC_WINDOW = 100           # rescore window
VEC_DBQ_TAG = 13           # kNN after deleting one tag ordinal (about 1% of the docs)
# knn_topk at one segment of the vec cell (portbench/configs/vec-8m.json:
# 8,841,823 x 768 f32 embeddings in 8 segments), dot_product, top 100
KNN_CELL_ROWS, KNN_CELL_DIMS, KNN_CELL_B, KNN_CELL_K = 1_105_228, 768, 32, 100
KNN_CELL_REPS = 10
INT8_TOPS = 1979e12        # dense int8 tensor-core operations per second
VEC_WIRE_FIELDS = [
    ("body", {"type": "TEXT", "search": True, "store": True}),
    *SERVED_FIELDS[1:],
]


def _vec_scale(q, V, sim: str, score) -> np.ndarray:
    """S: the magnitude a kNN score is computed from (the dot product's sum
    of |q_i v_i| carried through the similarity's mapping), f64; a score
    is held within VEC_ULPS f32 ulps of it (tests/test_torch_knn.py)."""
    q, V = np.asarray(q, np.float64).reshape(1, -1), np.asarray(V, np.float64)
    A = (np.abs(V) @ np.abs(q[0]))
    qn, vn = np.linalg.norm(q), np.linalg.norm(V, axis=1)
    s = np.asarray(score, np.float64)
    if sim == "l2_norm":
        S = s * s * (qn ** 2 + vn ** 2 + 2 * A)
    elif sim == "dot_product":
        S = (A + 1) / 2
    elif sim in ("cosine", "normalized_cosine"):
        S = (A / np.maximum(qn * vn, 1e-30) + 1) / 2
    else:
        S = np.where(s >= 1, A + 1, s * s * (A + 1))
    return np.maximum(S, np.abs(s))


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 rows rounded through bf16, as a bf16 column's product sees its
    queries."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _check_knn_lists(card_ids, card_s, cpu_ids, cpu_s, cpu_full, tol_of, ctx: str) -> int:
    """Card against CPU top-k: equal ids but at near-ties (where the ids
    differ at a rank, the CPU's own score of the card's doc lies within two
    tolerances of the CPU's score there); scores within tolerance. Returns
    the near-tie swaps."""
    swaps = 0
    for r in np.nonzero(np.asarray(card_ids) != np.asarray(cpu_ids))[0]:
        a, b = int(card_ids[r]), int(cpu_ids[r])
        if abs(cpu_full(a) - cpu_s[r]) > 2 * tol_of(b, cpu_s[r]):
            raise AssertionError(f"{ctx}: rank {r} holds {a} on the card and {b} on the CPU")
        swaps += 1
    for r, (a, sa, sb) in enumerate(zip(card_ids, card_s, cpu_s)):
        if abs(float(sa) - float(sb)) > tol_of(int(a), sb):
            raise AssertionError(f"{ctx}: rank {r} score {sa} on the card, {sb} on the CPU")
    return swaps


def vector_segment_columns(corpus, base: np.ndarray, num_segments: int) -> list[dict]:
    """The three vector fields of ``base`` cut into the doc ranges of
    ``corpus.segment_arrays``, in the host layout convert.segment_from_numpy
    takes (int8 quantized per segment, as the builder quantizes a flushed
    segment; bf16 rounded on the device)."""
    from nrtsearch_tpu_torch.core.segment import pad_to_bucket
    from nrtsearch_tpu_torch.ops.knn import quantize_int8

    bounds = np.linspace(0, corpus.num_docs, num_segments + 1).astype(np.int64)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        capacity = pad_to_bucket(int(hi - lo))
        mat = np.zeros((capacity, base.shape[1]), np.float32)
        mat[: hi - lo] = base[lo:hi]
        present = np.zeros(capacity, bool)
        present[: hi - lo] = True
        norms = np.linalg.norm(mat, axis=1).astype(np.float32)
        q8, scale = quantize_int8(mat)
        cols = {}
        for name, fmt, _sim in VEC_FIELDS:
            cols[name] = {"values": q8 if fmt == "int8" else mat, "present": present,
                          "norms": norms, "fmt": fmt,
                          "scale": scale if fmt == "int8" else 1.0}
        out.append(cols)
    return out


def vector_field_defs():
    from nrtsearch_tpu_torch.schema import create_field_def

    fds = index_field_defs()
    for name, fmt, sim in VEC_FIELDS:
        fds[name] = create_field_def(name, {
            "type": "VECTOR", "vectorDimensions": VEC_DIMS, "vectorSimilarity": sim,
            "vectorIndexingOptions": fmt})
    return fds


def _vector_wire_fields():
    """The served index's fields: phase 10's with a stored body and the
    three vector fields. The wire's vectorIndexingOptions can name int8 (a
    quantized type) but not float16: vec_bf16 registers as f32, and its
    committed segments keep their bf16 columns (the column's format rules
    its search; new docs get f32 columns, as in the reference)."""
    from nrtsearch_tpu_torch.gen import pb

    fields = [pb.Field(name=n, **{k: (pb.FieldType.Value(v) if k == "type" else v)
                                  for k, v in spec.items()}) for n, spec in VEC_WIRE_FIELDS]
    for name, fmt, sim in VEC_FIELDS:
        f = pb.Field(name=name, type=pb.FieldType.VECTOR, vectorDimensions=VEC_DIMS,
                     vectorSimilarity=sim)
        if fmt == "int8":
            f.vectorIndexingOptions.type = "hnsw_scalar_quantized"
        fields.append(f)
    return fields


def phase_vector_ops(dev, seg, cpu_seg, queries, card: str) -> dict:
    """knn_search / knn_search_quantized on one segment for the five
    similarities and three formats, card against CPU (the plain run of the
    same inputs); p50 by cuda_ms beside the bytes bound. Returns per-format
    timings."""
    from nrtsearch_tpu_torch.ops import knn

    out = {}
    q1 = queries[:1]
    for name, fmt, _sim in VEC_FIELDS:
        col, ccol = seg.vectors[name], cpu_seg.vectors[name]
        mask, cmask = col.present & seg.live, ccol.present & cpu_seg.live
        qt, cq = torch.from_numpy(q1).to(dev), torch.from_numpy(q1)
        seen_rows = ccol.host_float()                  # dequantized or rounded rows
        seen_q = _bf16(q1) if fmt == "float16" else q1
        rows = col.values.shape[0]                     # the mask is read over these
        nbytes = (col.values.numel() * col.values.element_size() + 4 * rows + rows
                  + q1.nbytes + 100 * 12)
        ops = 2.0 * col.values.shape[0] * VEC_DIMS
        peak = {"float32": OPS_PER_S, "float16": TENSOR_OPS_PER_S, "int8": INT8_TOPS}[fmt]
        bound_ms, bound_by = bound(nbytes, ops, peak)
        times, swaps, worst = [], 0, 0.0
        for sim in knn.SIMILARITIES:
            if fmt == "int8":
                def op(c=col, m=mask, q=qt, sim=sim):
                    return knn.knn_search_quantized(c.values, c.scale, c.score_sq_norms, m, q,
                                                    similarity=sim, k=100)
                cpu_full = knn._quantized_scores(cq, ccol.values, ccol.scale,
                                                 ccol.score_sq_norms, sim)[0].numpy()
                cs, ci = knn.knn_search_quantized(ccol.values, ccol.scale, ccol.score_sq_norms,
                                                  cmask, cq, similarity=sim, k=100)
            else:
                def op(c=col, m=mask, q=qt, sim=sim):
                    return knn.knn_search(c.values, c.score_sq_norms, m, q,
                                          similarity=sim, k=100)
                cpu_full = knn._scores(cq, ccol.values, ccol.score_sq_norms, sim)[0].numpy()
                cs, ci = knn.knn_search(ccol.values, ccol.score_sq_norms, cmask, cq,
                                        similarity=sim, k=100)
            gs, gi = op()
            gs, gi = gs.cpu().numpy()[0], gi.cpu().numpy()[0]
            cs, ci = cs.numpy()[0], ci.numpy()[0]

            def tol_of(i, s, sim=sim):
                return VEC_ULPS * 2.0 ** -23 * float(_vec_scale(seen_q, seen_rows[i:i + 1],
                                                                sim, s)[0])

            swaps += _check_knn_lists(gi, gs, ci, cs, lambda i: float(cpu_full[i]), tol_of,
                                      f"ops {name} {sim}")
            worst = max(worst, float(np.max(np.abs(gs.astype(np.float64) - cs))))
            times.append(cuda_ms(op, reps=VEC_OP_REPS))
        p50 = float(np.median(times))
        whole = bound_ms * NUM_DOCS / seg.num_docs
        prof = profile_call(lambda: op(sim="l2_norm"))
        log(f"vectors ops: {fmt} l2_norm, one call traced: device busy "
            f"{prof['device_busy_ms']:.4f} ms in {prof['device_items']} device items; top "
            f"{json.dumps(prof['top'][:6])}")
        out[fmt] = {"ms": p50, "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": worst, "swaps": swaps}
        log(f"vectors ops: {fmt} {col.values.shape[0]} x {VEC_DIMS} segment, B=1 k=100: "
            f"p50 {p50:.4f} ms over the 5 similarities ({', '.join(f'{t:.4f}' for t in times)}),"
            f" bound {bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / p50:.1f}%; the 1M-doc "
            f"field {whole:.4f} ms), card vs CPU max |diff| {worst:.3g}, near-tie swaps "
            f"{swaps} | {card}")
    return out


def phase_knn_topk(dev, card: str) -> dict:
    """knn_topk at one segment of the vec cell (KNN_CELL_*: normalised
    random rows, every 997th masked, queries by rows): at B = 32 and B = 1
    against an f64 reference of the same inputs (ids equal but at
    near-ties, scores within VEC_ULPS of their scale S, eligible rows those
    of the plain version), its largest score difference from the plain
    version (segment_top_k_plain: cuBLAS sums each dot in another order)
    beside, p50 by cuda_ms beside its bound, the plain version and
    library_ms (torch.mm + masked_top_k). Returns the kernel's stats at
    B = 32."""
    from nrtsearch_tpu_torch.ops import knn
    from nrtsearch_tpu_torch.ops.topk import masked_top_k

    rows, dims, k = KNN_CELL_ROWS, KNN_CELL_DIMS, KNN_CELL_K
    g = torch.Generator(device=dev).manual_seed(SEED)
    values = torch.randn(rows, dims, generator=g, device=dev)
    values /= torch.linalg.vector_norm(values, dim=1, keepdim=True)
    sq = (values * values).sum(1)
    mask = torch.ones(rows, dtype=torch.bool, device=dev)
    mask[::997] = False
    out = {}
    for B in (KNN_CELL_B, 1):
        pick = torch.randint(0, rows, (B,), generator=g, device=dev)
        q = values[pick] + 0.02 * torch.randn(B, dims, generator=g, device=dev)

        def fused(q=q):
            return knn.fused_segment_top_k(values, sq, mask, q, similarity="dot_product", k=k)

        def plain(q=q):
            return knn.segment_top_k_plain(values, sq, mask, q, similarity="dot_product", k=k)

        def library(q=q):
            return masked_top_k(torch.mm(q, values.T), mask[None, :], k)

        (gs, gi, gh), (cs, _ci, ch) = fused(), plain()
        # the f64 reference: (1 + q.v) / 2, masked, its top k + 16 by score,
        # then (score desc, doc asc)
        ref = torch.empty((B, rows), dtype=torch.float64, device=dev)
        q64 = q.double()
        for lo in range(0, rows, 1 << 17):
            ref[:, lo:lo + (1 << 17)] = (1 + q64 @ values[lo:lo + (1 << 17)].double().T) / 2
        ref[:, ~mask] = float("-inf")
        cand = torch.topk(ref, k + 16, dim=1).indices
        cand_s = torch.gather(ref, 1, cand).cpu().numpy()
        cand = cand.cpu().numpy()
        torch.cuda.synchronize()
        if not (gh.cpu() == ch.cpu()[0]).all():
            raise AssertionError(f"knn_topk: eligible rows {gh.tolist()} against {ch.tolist()}")
        gs, gi, cs = (t.cpu().numpy() for t in (gs, gi, cs))
        q_np = q.cpu().numpy()
        swaps, worst = 0, 0.0
        for b in range(B):
            order = np.lexsort((cand[b], -cand_s[b]))[:k]
            r_i, r_s = cand[b][order], cand_s[b][order]
            docs = np.union1d(gi[b], r_i)
            rows_np = values[torch.as_tensor(docs, device=dev)].cpu().numpy()
            at = {int(d): i for i, d in enumerate(docs)}
            ref_of = (1 + rows_np.astype(np.float64) @ q_np[b].astype(np.float64)) / 2

            def tol_of(i, s, b=b, rows_np=rows_np, at=at):
                return VEC_ULPS * 2.0 ** -23 * float(
                    _vec_scale(q_np[b], rows_np[at[i]:at[i] + 1], "dot_product", s)[0])

            swaps += _check_knn_lists(gi[b], gs[b], r_i, r_s,
                                      lambda i, at=at, p=ref_of: float(p[at[i]]), tol_of,
                                      f"knn_topk B={B} query {b}")
            worst = max(worst, float(np.max(np.abs(gs[b].astype(np.float64) - cs[b]))))
        t_kernel = cuda_ms(fused, reps=KNN_CELL_REPS)
        t_plain = cuda_ms(plain, reps=KNN_CELL_REPS)
        t_lib = cuda_ms(library, reps=KNN_CELL_REPS)
        nbytes = rows * dims * 4 + rows * 1 + B * dims * 4 + B * k * 12
        ops = 2.0 * B * rows * dims
        bound_ms, bound_by = bound(nbytes, ops)
        out[B] = {"ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
                  "bytes": nbytes, "ops": ops, "max_abs_err": worst, "swaps": swaps,
                  "shape": f"[{rows}, {dims}] f32, B={B}, k={k}"}
        clock = ""
        if B == KNN_CELL_B:
            # the f32 rate at the clock the card holds under the kernel: the
            # data sheet's OPS_PER_S is at its highest SM clock
            c = out[B]["clock"] = sm_clock_under(fused)
            peak = OPS_PER_S * c["sm_mhz"] / c["sm_mhz_max"]
            rate = ops / (1e-3 * t_kernel)
            clock = (f"; under it the SM clock {c['sm_mhz']:.0f} MHz (lowest "
                     f"{c['sm_mhz_min']:.0f}, the card's highest {c['sm_mhz_max']:.0f}; "
                     f"{c['samples']} samples), {c['watts']:.0f} W: the products at "
                     f"{rate / 1e12:.1f} TFLOP/s, {100 * rate / peak:.1f}% of the f32 rate "
                     f"at that clock ({peak / 1e12:.1f} TFLOP/s)")
        log(f"vectors knn_topk: [{rows}, {dims}] f32 segment, B={B} k={k} dot_product: "
            f"{t_kernel:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{100 * bound_ms / t_kernel:.1f}%), plain {t_plain:.4f} ms, library (torch.mm "
            f"+ masked_top_k) {t_lib:.4f} ms; against the f64 reference within {VEC_ULPS} "
            f"ulps of S, near-tie swaps {swaps}; max |diff| from the plain version "
            f"{worst:.3g}{clock} | {card}")
    del values, sq, mask
    torch.cuda.empty_cache()
    return out[KNN_CELL_B]


def phase_vectors(dev, corpus, columns, singles, card: str) -> dict:
    """Phase 14 (see the module docstring): the 1M-doc index with three
    vector fields on the card; ops, the engine, the served node with the
    result tail, writes and a replica, each against the CPU. Returns the
    hybrid request's launches and the phase's measurements."""
    import shutil
    import tempfile

    from google.protobuf.json_format import ParseDict

    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.convert import segment_from_numpy
    from nrtsearch_tpu_torch.core.directory import commit_segments, open_commit
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.models.synthetic import clustered_vectors
    from nrtsearch_tpu_torch.ops import knn
    from nrtsearch_tpu_torch.query import parse_query

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="vectors_")
    nodes = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    try:
        # 0. the kNN kernel at one segment of the vec cell
        knn_stats = phase_knn_topk(dev, card) if dev.type == "cuda" else {}

        # 1. the index: phase 4's corpus and columns beside 1M clustered vectors
        t = time.perf_counter()
        base, queries = clustered_vectors(NUM_DOCS, VEC_DIMS, VEC_QUERIES + 4, seed=SEED)
        vcols = vector_segment_columns(corpus, base, SEGMENTS)
        segs = [segment_from_numpy(a, dev, doc_values=dv, vectors=vv) for a, dv, vv in zip(
            corpus.segment_arrays(SEGMENTS, positions=False),
            corpus.segment_doc_values(columns, SEGMENTS), vcols)]
        fds = vector_field_defs()
        s_card = Searcher(segs, fds)
        torch.cuda.synchronize()
        vec_bytes = sum(c.values.numel() * c.values.element_size()
                        for s in segs for c in s.vectors.values())
        log(f"vectors: {NUM_DOCS} x {VEC_DIMS} clustered vectors ({max(NUM_DOCS // 1000, 8)} "
            f"clusters, seed {SEED}) as {', '.join(f'{n} ({f}, {m})' for n, f, m in VEC_FIELDS)}"
            f" in {SEGMENTS} segments beside phase 4's text and columns: "
            f"{vec_bytes / 2**20:.1f} MiB of vectors on the card, built in "
            f"{time.perf_counter() - t:.1f} s")
        # the commit, and the same commit opened on the CPU (the plain runs)
        t = time.perf_counter()
        commit_dir = f"{root}/commit"
        commit_segments(segs, commit_dir, gen=1, version=1, primary_gen=1)
        _m, cpu_segs = open_commit(commit_dir, "cpu")
        s_cpu = Searcher(cpu_segs, fds)
        log(f"vectors: committed ({sum(os.path.getsize(os.path.join(commit_dir, f)) for f in os.listdir(commit_dir)) / 2**30:.3f} GiB)"
            f" and opened on the CPU in {time.perf_counter() - t:.1f} s")

        # 2. ops on one 250,000-doc segment
        ops = phase_vector_ops(dev, segs[0], cpu_segs[0], queries, card)

        # 3. the engine: Searcher.knn_search at B = 1
        qs = queries[:VEC_QUERIES]
        lat, answers = {}, {}
        fused0 = kernels.LAUNCHES["knn_topk"]
        for name, _fmt, _sim in VEC_FIELDS:
            s_card.knn_search(name, qs[0], 10)        # first call: cuBLAS handles
            for k in VEC_KS:
                ts, res = [], []
                for q in qs:
                    t = time.perf_counter()
                    res.append(s_card.knn_search(name, q, k))
                    ts.append(1e3 * (time.perf_counter() - t))
                lat[(name, k)] = ts
                answers[(name, k)] = res
        engine_launches = kernels.LAUNCHES["knn_topk"] - fused0
        if dev.type == "cuda" and engine_launches != (1 + len(VEC_KS) * len(qs)) * SEGMENTS:
            raise AssertionError(f"knn_topk: {engine_launches} launches for the f32 field's "
                                 f"{1 + len(VEC_KS) * len(qs)} searches over {SEGMENTS} "
                                 f"segments")
        kernels.reset_launch_counts()
        s_card.knn_search_batch("vec", qs, 100)
        torch.cuda.synchronize()
        per_batch = kernels.LAUNCHES["knn_topk"]
        with SyncCount() as sc:
            s_card.knn_search("vec", qs[0], 10)
        log(f"vectors engine: Searcher.knn_search B=1 over {SEGMENTS} segments, "
            + "; ".join(f"{n} k={k} p50 {np.median(lat[(n, k)]):.3f} ms p99 "
                        f"{np.percentile(lat[(n, k)], 99):.3f} ms" for n, _f, _s in VEC_FIELDS
                        for k in VEC_KS)
            + f"; host waits per query {sc.n}; knn_topk launches {engine_launches} on the "
            f"f32 field, {per_batch} per B={len(qs)} batch | {card}")

        # recall@10 of the f32 field against an f64 brute force (1.0 but at ties)
        b64 = base.astype(np.float64)
        sq64 = np.einsum("ij,ij->i", b64, b64)
        hits, ties = 0, 0
        for i, q in enumerate(qs):
            d2 = sq64 - 2.0 * (b64 @ q.astype(np.float64)) + float(q.astype(np.float64) @ q)
            exact = np.argsort(d2, kind="stable")[:10]
            got = [h.global_ord for h in answers[("vec", 10)][i].hits]
            miss = set(exact.tolist()) - set(got)
            hits += 10 - len(miss)
            for m in miss:
                # a tie: the missed doc's distance equals the card's 10th within f32 rounding
                if abs(d2[m] - d2[got[-1]]) > 8 * 2.0 ** -23 * (sq64[m] + float(q @ q)):
                    raise AssertionError(f"recall: query {i} misses doc {m} (d2 {d2[m]}) "
                                         f"for {got[-1]} (d2 {d2[got[-1]]})")
                ties += 1
        recall_f32 = hits / (10 * len(qs))

        # recall@10 of bf16 and int8 against the f32 column under their similarity
        def f32_top10(sim, q):
            cand = []
            qt = torch.from_numpy(q[None]).to(dev)
            for j, seg in enumerate(segs):
                c = seg.vectors["vec"]
                sq = c.sq_norms
                s_, i_ = knn.knn_search(c.values, sq, c.present & seg.live, qt,
                                        similarity=sim, k=10)
                cand += [(float(a), int(s_card.bases[j]) + int(b))
                         for a, b in zip(s_[0].cpu().numpy(), i_[0].cpu().numpy())]
            cand.sort(key=lambda x: (-x[0], x[1]))
            return {o for _s, o in cand[:10]}

        recall_q = {}
        for name, _fmt, sim in VEC_FIELDS[1:]:
            got = sum(len(f32_top10(sim, q) & {h.global_ord for h in answers[(name, 10)][i].hits})
                      for i, q in enumerate(qs))
            recall_q[name] = got / (10 * len(qs))
        log(f"vectors recall@10: vec (f32, l2) {recall_f32:.4f} against an f64 brute force "
            f"({ties} ties); vec_bf16 {recall_q['vec_bf16']:.4f} and vec_i8 "
            f"{recall_q['vec_i8']:.4f} against the f32 column under their similarity")
        if min(recall_q.values()) < 0.8:
            raise AssertionError(f"quantized recall {recall_q}")

        # filtered, and after a deleteByQuery, each held to the CPU copy
        names = columns["tag"][2]
        filt = {"termQuery": {"field": "tag", "textValue": names[7]}}
        tag_vals = columns["tag"][0]
        seg_bounds = np.linspace(0, NUM_DOCS, SEGMENTS + 1).astype(np.int64)
        deleted = [np.nonzero(tag_vals[lo:hi] == VEC_DBQ_TAG)[0]
                   for lo, hi in zip(seg_bounds[:-1], seg_bounds[1:])]
        s_card_del = Searcher([s.with_deletes(d) for s, d in zip(segs, deleted)], fds)
        s_cpu_del = Searcher([s.with_deletes(d) for s, d in zip(cpu_segs, deleted)], fds)
        fmt_of = {n: (f, m) for n, f, m in VEC_FIELDS}
        swaps = 0
        cond = 0.0
        t = time.perf_counter()
        for name, fmt, sim in VEC_FIELDS:
            for label, sc_, sp_, node in (
                    ("plain", s_card, s_cpu, None),
                    ("filtered", s_card, s_cpu, filt),
                    ("deleted", s_card_del, s_cpu_del, None)):
                for q in qs[:VEC_REPLAY]:
                    g = sc_.knn_search(name, q, 100, filter_node=parse_query(node) if node else None)
                    c = sp_.knn_search(name, q, 100, filter_node=parse_query(node) if node else None)
                    if g.total_hits != c.total_hits or not g.hits:
                        raise AssertionError(f"engine {name} {label}: totals {g.total_hits} "
                                             f"{c.total_hits}")
                    gi = [h.global_ord for h in g.hits]
                    ci = [h.global_ord for h in c.hits]
                    seen_q = _bf16(q[None])[0] if fmt == "float16" else q

                    def column_row(o, name=name, sp_=sp_):
                        j = int(np.searchsorted(s_card.bases, o, side="right") - 1)
                        return sp_.segments[j].vectors[name], o - int(s_card.bases[j])

                    def tol_of(o, s, sim=sim, seen_q=seen_q, column_row=column_row):
                        col, local = column_row(o)
                        return VEC_ULPS * 2.0 ** -23 * float(
                            _vec_scale(seen_q, col.host_row(local)[None], sim, s)[0])

                    def cpu_score(o, q=q, sim=sim, column_row=column_row):
                        # the CPU's score of one doc: its row alone through the plain run
                        col, local = column_row(o)
                        qt = torch.from_numpy(q[None])
                        row = col.values[local:local + 1]
                        if col.fmt == "int8":
                            sc = knn._quantized_scores(qt, row, col.scale,
                                                       col.score_sq_norms[local:local + 1], sim)
                        else:
                            sc = knn._scores(qt, row, col.score_sq_norms[local:local + 1], sim)
                        return float(sc[0, 0])

                    swaps += _check_knn_lists(gi, [h.score for h in g.hits], ci,
                                              [h.score for h in c.hits], cpu_score, tol_of,
                                              f"engine {name} {label}")
                    cond = max(cond, max(tol_of(o, sc) / (VEC_ULPS * 2.0 ** -23) / abs(sc)
                                         for o, sc in zip(ci[:10], [h.score for h in c.hits])))
                    if label == "deleted":
                        gone = {int(seg_bounds[j] + d) for j, dd in enumerate(deleted) for d in dd}
                        if gone & set(gi):
                            raise AssertionError(f"engine {name}: a deleted doc answers")
        log(f"vectors engine: {VEC_REPLAY} queries per field, plain, filtered on {names[7]} "
            f"and after deleting tag ordinal {VEC_DBQ_TAG} "
            f"({sum(len(d) for d in deleted)} docs), k=100, equal to the CPU copy (near-tie "
            f"swaps {swaps}; the CPU replay {time.perf_counter() - t:.1f} s)")
        del s_card_del, s_cpu_del

        # 4. served: a PRIMARY node on the card and a CPU node on the same commit
        state = f"{root}/state"
        primary, pc = _node(root, "primary", dev=dev, state=state)
        nodes.append((primary, pc))
        cpu_node, cc = _node(root, "cpu", dev=torch.device("cpu"), state=f"{root}/cpu_state")
        nodes.append((cpu_node, cc))
        index_dirs = []
        for node, client in ((primary, pc), (cpu_node, cc)):
            client.create_index(SERVED_INDEX)
            client.register_fields(pb.FieldDefRequest(indexName=SERVED_INDEX,
                                                      field=_vector_wire_fields()))
            index_dir = os.path.join(node.config.index_dir,
                                     node.global_state.index_ids[SERVED_INDEX])
            shutil.copytree(commit_dir, index_dir, dirs_exist_ok=True)
            index_dirs.append(index_dir)
            ls = pb.LiveSettingsV2Request(indexName=SERVED_INDEX)
            ls.liveSettings.maxMergedSegmentMB.value = 1
            ls.liveSettings.segmentsPerTier.value = 6
            ls.liveSettings.maxRefreshSec.value = 3600.0
            client.live_settings_v2(ls)
        shutil.rmtree(commit_dir)
        pc.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.PRIMARY,
                                            primaryGen=1))
        cc.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.STANDALONE))
        p_rt = primary.global_state.runtimes[SERVED_INDEX]
        discovery = f"{root}/primary.json"
        with open(discovery, "w") as f:
            json.dump({"host": "localhost", "port": primary.replication_port}, f)

        knn_rel = 2 * VEC_ULPS * 2.0 ** -23 * cond     # two clauses or a weight of 2

        def req(query=None, k=10, **kw):
            r = pb.SearchRequest(indexName=SERVED_INDEX, topHits=k, **kw)
            if query is not None:
                ParseDict(query, r.query)
            return r

        def knn_clause(r, field, q, k=10, filt=None):
            c = r.knn.add()
            c.field, c.k, c.num_candidates = field, k, 4 * k
            c.query_vector.extend(float(x) for x in q)
            if filt is not None:
                ParseDict(filt, c.filter)
            return r

        def multi(blender, q, text):
            r = req(k=20)
            rt_ = r.multiRetriever.retrievers.add()
            rt_.name = "bm25"
            ParseDict(_match_dict(text), rt_.textRetriever.query)
            rt_.textRetriever.topHits = 100
            rv = r.multiRetriever.retrievers.add()
            rv.name = "knn"
            rv.knnRetriever.knnQuery.field = "vec"
            rv.knnRetriever.knnQuery.k = 100
            rv.knnRetriever.knnQuery.num_candidates = 100
            rv.knnRetriever.knnQuery.query_vector.extend(float(x) for x in q)
            if blender == "raw":
                r.multiRetriever.blender.scorelessRawMerge.SetInParent()
            elif blender != "rrf":
                r.multiRetriever.blender.weightedScoreOrder.scoreMode = \
                    pb.WeightedScoreOrderBlender.ScoreMode.Value(blender)
            return r

        def rescored(kind, text, rescore_text):
            r = req(_match_dict(text), k=20)
            rs = r.rescorers.add()
            rs.windowSize = VEC_WINDOW
            if kind == "query":
                ParseDict(_match_dict(rescore_text), rs.queryRescorer.rescoreQuery)
                rs.queryRescorer.queryWeight = 0.7
                rs.queryRescorer.rescoreQueryWeight = 1.3
            else:
                rs.scriptRescorer.script.source = "_score * 2 + price / 1000"
            return r

        def drill_sideways(text):
            r = req({"booleanQuery": {"clauses": [
                {"occur": "MUST", "query": _match_dict(text)},
                {"occur": "FILTER", "query": {"termQuery": {"field": "tag",
                                                            "textValue": names[3]}}}]}}, k=20)
            f = r.facets.add()
            f.dim, f.topN = "tag", 10
            return r

        q_a, q_b = queries[VEC_QUERIES], queries[VEC_QUERIES + 1]
        requests = {
            "knn_only": lambda: knn_clause(req(k=10), "vec", q_a),
            "knn_only_bf16": lambda: knn_clause(req(k=10), "vec_bf16", q_b),
            "knn_only_i8_filtered": lambda: knn_clause(req(k=10), "vec_i8", q_a, filt=filt),
            "query_plus_knn": lambda: knn_clause(req(_match_dict(singles[0]), k=20), "vec", q_b,
                                                 k=20),
            "multi_rrf": lambda: multi("rrf", q_a, singles[1]),
            "multi_sum": lambda: multi("SUM", q_a, singles[1]),
            "multi_max": lambda: multi("MAX", q_b, singles[2]),
            "multi_raw": lambda: multi("raw", q_b, singles[2]),
            "query_rescorer": lambda: rescored("query", singles[3], singles[4][:2]),
            "script_rescorer": lambda: rescored("script", singles[5], None),
            "drill_sideways": lambda: drill_sideways(singles[6]),
        }
        text_rel = FUSED_REL

        def compare(name, g, c, ctx):
            """Card against CPU node: totals equal, ids equal but at near-ties
            (the two scores at a differing rank within the tolerance), scores
            within FUSED_REL (text: the card's fused path against the CPU's
            exact merge path) or knn_rel (kNN alone) relative, facets equal."""
            rel = knn_rel if name.startswith("knn_only") else max(text_rel, knn_rel)
            if g.totalHits.value != c.totalHits.value:
                raise AssertionError(f"{ctx}: totalHits {g.totalHits.value} {c.totalHits.value}")
            if len(g.hits) != len(c.hits) or not g.hits:
                raise AssertionError(f"{ctx}: {len(g.hits)} hits on the card, {len(c.hits)}")
            n_swaps = 0
            for r, (a, b) in enumerate(zip(g.hits, c.hits)):
                # a differing doc at a rank is a near-tie: both scores there agree
                tol = rel * max(abs(b.score), abs(a.score))
                if abs(a.score - b.score) > tol:
                    raise AssertionError(f"{ctx}: rank {r} score {a.score} / {b.score}")
                n_swaps += a.luceneDocId != b.luceneDocId
            gf = [(f.dim, [(lv.label, lv.value) for lv in f.labelValues]) for f in g.facetResult]
            cf = [(f.dim, [(lv.label, lv.value) for lv in f.labelValues]) for f in c.facetResult]
            if gf != cf:
                raise AssertionError(f"{ctx}: facets {gf} / {cf}")
            for a, b in zip(g.hits, c.hits):
                if a.luceneDocId == b.luceneDocId and dict(a.highlights) != dict(b.highlights):
                    raise AssertionError(f"{ctx}: highlights of {a.luceneDocId} differ")
            return n_swaps

        def served_round(label, which):
            lat_s, n_swaps = {}, 0
            for name in which:
                t = time.perf_counter()
                g = pc.search(requests[name]())
                lat_s[name] = 1e3 * (time.perf_counter() - t)
                n_swaps += compare(name, g, cc.search(requests[name]()), f"served {label} {name}")
            return lat_s, n_swaps

        pc.search(requests["knn_only"]())                   # the card's first search
        pc.search(requests["multi_rrf"]())
        served_lat, served_swaps = served_round("before writes", list(requests))
        # the hybrid request's launches, counted alone
        view = p_rt.searcher.packed_view("body")
        before = dict(view.path_counts)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        pc.search(requests["multi_rrf"]())
        torch.cuda.synchronize()
        hybrid_launches = dict(kernels.LAUNCHES)
        route = {k: view.path_counts[k] - before[k] for k in before}
        log(f"vectors served: the hybrid request (BM25 '{' '.join(singles[1])}' + kNN, RRF) "
            f"took the {route} route(s); kernel launches {hybrid_launches}")
        if route.get("fused", 0) and hybrid_launches.get("head_scores", 0) == 0:
            raise AssertionError("the hybrid's fused text retriever launched no head_scores")
        if not sum(hybrid_launches.values()):
            raise AssertionError("the hybrid request launched no kernel")
        log(f"vectors served: {len(requests)} requests equal to the CPU node (near-tie swaps "
            f"{served_swaps}; kNN scores within {knn_rel:.3g}, text within {text_rel} "
            f"relative): " + ", ".join(f"{n} {ms:.2f} ms" for n, ms in served_lat.items())
            + f" | {card}")

        # 5. writes: 2,000 docs with vectors in 4 rounds on both nodes
        new_vecs, _ = clustered_vectors(VEC_INGEST, VEC_DIMS, 0, seed=SEED + 14)
        docs = _served_ingest_docs(VEC_INGEST)
        for d, v in zip(docs, new_vecs):
            for name, _f, _s in VEC_FIELDS:
                d[name] = str([float(x) for x in v])
        t = time.perf_counter()
        per = VEC_INGEST // VEC_ROUNDS
        for r in range(VEC_ROUNDS):
            for client in (pc, cc):
                client.add_documents(_add_requests(docs[r * per:(r + 1) * per]))
                client.refresh(SERVED_INDEX)
        ingest_s = time.perf_counter() - t
        stats = [node.global_state.runtimes[SERVED_INDEX].stats() for node, _c in nodes]
        if stats[0]["merges"] == 0 or stats[0]["merges"] != stats[1]["merges"]:
            raise AssertionError(f"writes: merges {[s['merges'] for s in stats]}")
        layout = [[(s.num_docs, sorted(s.vectors)) for s in node.global_state.runtimes[
            SERVED_INDEX].searcher.segments] for node, _c in nodes]
        if layout[0] != layout[1]:
            raise AssertionError(f"writes: segments {layout}")
        highlight = req(_match_dict(["needle", "gamma"]), k=10)
        highlight.highlight.fields.append("body")
        highlight.highlight.settings.fragment_size.value = 40
        requests["highlight"] = lambda: highlight
        new_q = new_vecs[17] + 0.01
        requests["knn_new_docs"] = lambda: knn_clause(req(k=10), "vec", new_q)
        requests["knn_new_docs_i8"] = lambda: knn_clause(req(k=10), "vec_i8", new_q)
        requests["knn_new_docs_bf16"] = lambda: knn_clause(req(k=10), "vec_bf16", new_q)
        after_lat, after_swaps = served_round("after writes", list(requests))
        hl = pc.search(highlight)
        if not any(h.highlights["body"].fragments for h in hl.hits):
            raise AssertionError("highlight: no fragment")
        top_req = requests["knn_new_docs"]()
        top_req.retrieveFields.append("body")
        top = pc.search(top_req)
        if top.hits[0].fields["body"].fieldValue[0].textValue != docs[17]["body"]:
            raise AssertionError("writes: the ingested doc nearest its own vector does not lead")
        log(f"vectors writes: {VEC_INGEST} docs with vectors in {VEC_ROUNDS} rounds on both "
            f"nodes in {ingest_s:.1f} s, {stats[0]['merges']} merges carried vector columns; "
            f"{len(requests)} requests (highlights, kNN on the new docs) equal to the CPU node "
            f"(near-tie swaps {after_swaps}): "
            + ", ".join(f"{n} {ms:.2f} ms" for n, ms in after_lat.items()) + f" | {card}")

        # 6. a REPLICA of the vector commit on the card
        cc.close()
        cpu_node.stop()
        nodes.remove((cpu_node, cc))
        replica, rc = _node(root, "replica", dev=dev, state=state)
        nodes.append((replica, rc))
        t = time.perf_counter()
        rc.start_index(pb.StartIndexRequest(indexName=SERVED_INDEX, mode=pb.Mode.REPLICA,
                                            primaryDiscoveryFile=discovery))
        sync_s = time.perf_counter() - t
        for name in ("multi_rrf", "multi_sum", "query_plus_knn", "knn_only", "knn_only_bf16",
                     "knn_only_i8_filtered", "knn_new_docs", "highlight"):
            if _strip(rc.search(requests[name]())) != _strip(pc.search(requests[name]())):
                raise AssertionError(f"replica: {name} differs from the primary")
        peak = torch.cuda.max_memory_allocated(dev)
        seconds = time.perf_counter() - t_phase
        log(f"vectors replica: synced the vector commit in {sync_s:.2f} s and answers 8 "
            f"requests bit for bit as the primary; peak device memory {peak / 2**30:.3f} GiB "
            f"(phase start {mem0 / 2**30:.3f} GiB); phase {seconds:.1f} s | {card}")
        return {"launches": hybrid_launches, "ops": ops, "seconds": seconds, "peak": peak,
                "recall": recall_f32, "recall_q": recall_q,
                "stats": {"knn_topk": knn_stats},
                "engine_launches": {"knn_topk": engine_launches},
                "per_batch": {"knn_topk": per_batch}}
    finally:
        for node, client in nodes:
            client.close()
            node.stop()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 15. term positions, nested documents and the field types that need them
# ---------------------------------------------------------------------------

PHRASE_ULPS = 2            # card against the CPU copy (tests/test_torch_cuda.py)
PHRASE_ORACLE_REL = 1e-6   # exact phrases against the numpy f64 BM25 phrase score
PHRASE_REPS = 3
PHRASE_PRICE = (100.0, 900.0)   # config #3's price range (benchmarks/stress_deep_boolean.py)


def phrase_oracle(corpus, terms: list[int], doc_of: np.ndarray, k: int = TOP_K):
    """An exact phrase over the corpus's flat token sequence, in numpy,
    independent of the index: per doc the number of starts i with
    tokens[i + j] == terms[j] for every j inside one doc, scored by Lucene's
    BM25 phrase formula in f64 (the summed idf of the distinct terms, the
    phrase frequency as tf, the quantized length). Returns (scores [<=k],
    docs [<=k], total_hits), ordered by score desc, doc asc."""
    from nrtsearch_tpu_torch.utils.smallfloat import quantize_length

    tok, n = corpus.tokens, len(terms)
    m = tok[: len(tok) - n + 1] == terms[0]
    for j in range(1, n):
        m &= tok[j : len(tok) - n + 1 + j] == terms[j]
    starts = np.flatnonzero(m)
    d0 = doc_of[starts]
    d0 = d0[doc_of[starts + n - 1] == d0]
    freq = np.bincount(d0, minlength=corpus.num_docs).astype(np.float64)
    N = corpus.num_docs
    qlens = quantize_length(corpus.doc_lens.astype(np.int64)).astype(np.float64)
    avgdl = qlens.sum() / N
    idf = sum(np.log(1.0 + (N - int(corpus.term_lengths[t]) + 0.5)
                     / (int(corpus.term_lengths[t]) + 0.5)) for t in set(terms))
    docs = np.flatnonzero(freq)
    f = freq[docs]
    scores = idf * f / (f + 1.2 * (1.0 - 0.75 + 0.75 * qlens[docs] / avgdl))
    order = np.lexsort((docs, -scores))[:k]
    return scores[order], docs[order], len(docs)


def phrase_queries(corpus, rng) -> dict:
    """Phase 15's B = 1 queries by kind, drawn from the token sequence at
    seeded docs and offsets: (query dict, the exact phrase's term ids or
    None)."""
    starts = corpus.doc_starts

    def draw(n: int, gap: int = 1, lo: int = 0, hi: int = None) -> list[int]:
        while True:
            doc = int(rng.integers(0, corpus.num_docs))
            span = int(starts[doc + 1] - starts[doc]) - (n - 1) * gap
            off = int(rng.integers(0, span))
            toks = [int(corpus.tokens[starts[doc] + off + j * gap]) for j in range(n)]
            if all(lo <= t < (hi or corpus.vocab_size) for t in toks):
                return toks

    def phrase(toks, slop: int = 0) -> dict:
        return {"phraseQuery": {"field": "body", "terms": [str(t) for t in toks], "slop": slop}}

    out: dict[str, list] = {"exact2": [], "exact3": [], "widest": [], "sloppy": [],
                            "match_phrase": [], "phrase_prefix": [], "span_near": [],
                            "phrase_bm25": [], "phrase_filtered": []}
    for kind, n in (("exact2", 2), ("exact3", 3)):
        for _ in range(8):
            toks = draw(n)
            out[kind].append((phrase(toks), toks))
    out["widest"].append((phrase([0, 1]), [0, 1]))
    for n, gap, slop in ((2, 2, 1), (2, 3, 2), (3, 2, 3), (2, 4, 3)):
        out["sloppy"].append((phrase(draw(n, gap), slop), None))
    for n in (2, 2, 3, 3):
        out["match_phrase"].append(({"matchPhraseQuery": {
            "field": "body", "query": " ".join(str(t) for t in draw(n))}}, None))
    while len(out["phrase_prefix"]) < 4:
        # a last term of the vocabulary's longest length less its last
        # digit: at most 11 expansions, so the source doc's term is one
        a, b = draw(2, lo=10)
        if len(str(b)) == len(str(corpus.vocab_size - 1)):
            out["phrase_prefix"].append(({"matchPhrasePrefixQuery": {
                "field": "body", "query": f"{a} {str(b)[:-1]}"}}, None))
    for in_order in (True, False):
        # a mid-frequency and a rarer term: a host loop over a few hundred
        # candidates, as the reference runs it
        a, b = draw(1, lo=20, hi=200)[0], draw(1, lo=200, hi=5000)[0]
        out["span_near"].append(({"spanQuery": {"spanNearQuery": {"clauses": [
            {"spanTermQuery": {"field": "body", "textValue": str(a)}},
            {"spanTermQuery": {"field": "body", "textValue": str(b)}}],
            "slop": 40, "inOrder": in_order}}}, None))
    toks = draw(2)
    out["phrase_bm25"].append(({"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": phrase(toks)},
        {"occur": "SHOULD", "query": {"matchQuery": {"field": "body", "query": "3 17 112"}}}]}},
        None))
    toks = draw(2, hi=100)   # frequent terms: many docs, most inside the price range
    out["phrase_filtered"].append(({"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": phrase(toks)},
        {"occur": "FILTER", "query": {"rangeQuery": {
            "field": "price", "lower": str(PHRASE_PRICE[0]), "upper": str(PHRASE_PRICE[1])}}}]}},
        None))
    return out


def phase_phrases(dev, corpus, columns, card: str) -> dict:
    """Part A: the 1M-doc positional index on the card; every kind of
    positional query at B = 1, exact phrases against the numpy oracle, the
    others against the CPU copy of the same segments."""
    import dataclasses

    from nrtsearch_tpu_torch.convert import segment_from_numpy
    from nrtsearch_tpu_torch.core.searcher import Searcher
    from nrtsearch_tpu_torch.query import eval as qeval
    from nrtsearch_tpu_torch.query import parse_query

    import gc

    t_phase = time.perf_counter()
    gc.collect()   # earlier phases' searchers may sit in reference cycles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    arrays = corpus.segment_arrays(SEGMENTS)
    dvs = corpus.segment_doc_values(columns, SEGMENTS)
    card_segs = [segment_from_numpy(a, dev, doc_values=dv) for a, dv in zip(arrays, dvs)]
    cpu_segs = [segment_from_numpy(a, "cpu", doc_values=dv) for a, dv in zip(arrays, dvs)]
    del arrays
    fds = index_field_defs()
    s_card, s_cpu = Searcher(card_segs, fds), Searcher(cpu_segs, fds)
    n_pos = sum(len(s.fields["body"].positions) for s in card_segs)
    doc_of = np.repeat(np.arange(corpus.num_docs, dtype=np.int64), np.diff(corpus.doc_starts))
    build_s = time.perf_counter() - t
    queries = phrase_queries(corpus, np.random.default_rng(SEED + 15))

    # the positions go to the card with the first phrase query of a segment
    widest = parse_query(queries["widest"][0][0])
    s_card.search(widest, TOP_K)
    torch.cuda.synchronize()
    pos_bytes = sum(x.numel() * x.element_size() for s in card_segs
                    for x in s.fields["body"]._device_pos[:2])
    log(f"phrases: {n_pos} positions in {SEGMENTS} segments (CSR built in {build_s:.1f} s with "
        f"the CPU copy); {pos_bytes / 2**30:.3f} GiB of positions and offsets on the card "
        f"after pow2 padding | {card}")

    cands: list[int] = []
    orig_candidate_ids = qeval._candidate_ids

    def counted(ctx, mask):
        ids = orig_candidate_ids(ctx, mask)
        cands.append(int(ids.shape[0]))
        return ids

    qeval._candidate_ids = counted
    paths0 = dict(qeval.PHRASE_PATHS)
    lat: dict[str, list] = {k: [] for k in queries}
    per_query_cands: dict[str, list] = {k: [] for k in queries}
    swaps = 0
    worst_ulps = 0
    worst_rel = 0.0
    span_loop = []   # (seconds, candidates) of the span-near queries
    try:
        for kind, items in queries.items():
            for q, toks in items:
                node = parse_query(q)
                n0 = len(cands)
                times = []
                for _ in range(PHRASE_REPS):
                    t = time.perf_counter()
                    td = s_card.search(node, TOP_K)
                    times.append(time.perf_counter() - t)
                lat[kind].extend(times)
                per_query_cands[kind].append(sum(cands[n0:]) // PHRASE_REPS)
                if kind == "span_near":
                    span_loop.append((float(np.median(times)), per_query_cands[kind][-1]))
                if toks is not None:
                    ex = phrase_oracle(corpus, toks, doc_of)
                    if ex[2] == 0:
                        raise AssertionError(f"phrases {kind} {toks}: the oracle finds no doc")
                    swaps += _check_topk(td, ex, PHRASE_ORACLE_REL, f"phrases {kind} {toks}")
                    worst_rel = max(worst_rel, _max_rel(td, ex))
                    continue
                cpu = s_cpu.search(node, TOP_K)
                if ([h.global_ord for h in td.hits] != [h.global_ord for h in cpu.hits]
                        or (td.total_hits, td.relation) != (cpu.total_hits, cpu.relation)):
                    raise AssertionError(f"phrases {kind} {q}: differs from the CPU copy")
                if cpu.total_hits == 0:
                    raise AssertionError(f"phrases {kind} {q}: no hit")
                a = np.array([h.score for h in td.hits], np.float32).view(np.int32)
                b = np.array([h.score for h in cpu.hits], np.float32).view(np.int32)
                u = int(np.abs(a.astype(np.int64) - b).max(initial=0))
                if u > PHRASE_ULPS:
                    raise AssertionError(f"phrases {kind} {q}: {u} ulps from the CPU copy")
                worst_ulps = max(worst_ulps, u)
    finally:
        qeval._candidate_ids = orig_candidate_ids
    host = qeval.PHRASE_PATHS["host"] - paths0["host"]
    device = qeval.PHRASE_PATHS["device"] - paths0["device"]
    if host:
        raise AssertionError(f"phrases: {host} phrase verifications took the host loop")
    n_phrase = sum(len(queries[k]) for k in queries if k != "span_near")
    log(f"phrases: {sum(len(v) for v in queries.values())} queries x {PHRASE_REPS}; exact "
        f"phrases against the numpy oracle (hits and docs equal, scores within "
        f"{PHRASE_ORACLE_REL} rel, worst {worst_rel:.3g}, near-tie swaps {swaps}); the other "
        f"kinds equal to the CPU copy (scores within {worst_ulps} ulps); ops.phrase verified "
        f"each of the {n_phrase} phrase and phrase-prefix queries ({device} calls over "
        f"segments and repetitions), the host loop none")
    for kind, v in lat.items():
        ms = 1e3 * np.asarray(v)
        log(f"phrases {kind}: B=1 p50 {np.median(ms):.2f} ms, p99 {np.percentile(ms, 99):.2f} "
            f"ms (n={len(ms)}); candidates per query {per_query_cands[kind]} | {card}")
    per_cand = [1e6 * s / max(c, 1) for s, c in span_loop]
    log(f"phrases span_near: host loop {', '.join(f'{x:.1f}' for x in per_cand)} us per "
        f"candidate ({[c for _, c in span_loop]} candidates) | {card}")
    p50_w = 1e3 * float(np.median(lat["widest"]))
    prof = profile_call(lambda: s_card.search(widest, TOP_K))
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("phrases: the profiled phrase ran nothing on the device")
    log(f"profile: widest phrase (terms 0 1, {per_query_cands['widest'][0]} candidates), "
        f"device busy {prof['device_busy_ms']:.3f} ms in {prof['device_items']} device items "
        f"({100 * prof['device_busy_ms'] / p50_w:.1f}% of its p50 {p50_w:.2f} ms); top device "
        f"items {json.dumps(prof['top'][:6])} | {card}")
    waits = {}
    for kind in ("exact2", "widest", "sloppy", "phrase_prefix", "span_near", "phrase_filtered"):
        node = parse_query(queries[kind][0][0])
        with SyncCount() as sc:
            s_card.search(node, TOP_K)
            torch.cuda.synchronize()
        waits[kind] = sc.n
    peak = torch.cuda.max_memory_allocated(dev)
    seconds = time.perf_counter() - t_phase
    log(f"phrases: host waits per query {waits}; peak device memory {peak / 2**30:.3f} GiB "
        f"(phase start {mem0 / 2**30:.3f} GiB); part A {seconds:.1f} s | {card}")
    del s_card, s_cpu, card_segs, cpu_segs
    torch.cuda.empty_cache()
    return {"seconds": seconds, "peak": peak, "positions_bytes": pos_bytes}


NESTED_INDEX = "nested"
NESTED_PARENTS = 20_000
NESTED_CHUNKS = 4
NESTED_REPS = 5
NESTED_WORDS = ["good", "great", "bad", "slow", "fast", "tasty", "cold", "warm", "friendly",
                "rude", "clean", "noisy", "cheap", "pricey", "fresh"]
NESTED_TITLES = ["golden", "dragon", "good", "eats", "gourmet", "grill", "green", "garden",
                 "grand", "cafe", "blue", "moon", "diner", "burger", "barn", "noodle", "house"]
NESTED_CITIES = ["sf", "nyc", "la", "sea"]


def _nested_wire_fields() -> list:
    """A business with nested reviews (the reference's tests/test_nested.py
    shape), a title with a keyword child field and indexPrefixes, a POLYGON
    service area and a CONTEXT_SUGGEST name."""
    return [
        {"name": "biz_id", "type": "_ID", "store": True, "storeDocValues": True},
        {"name": "title", "type": "TEXT", "search": True, "store": True,
         "indexPrefixes": {"minChars": 2, "maxChars": 4},
         "childFields": [{"name": "kw", "type": "TEXT", "search": True, "analyzer": {
             "custom": {"tokenizer": {"name": "keyword"},
                        "tokenFilters": [{"name": "lowercase"}]}}}]},
        {"name": "area", "type": "POLYGON", "storeDocValues": True, "store": True},
        {"name": "sugg", "type": "CONTEXT_SUGGEST", "store": True},
        {"name": "reviews", "type": "OBJECT", "nestedDoc": True, "childFields": [
            {"name": "text", "type": "TEXT", "search": True, "store": True},
            {"name": "stars", "type": "INT", "storeDocValues": True, "store": True}]},
    ]


def _nested_docs(n: int) -> list[dict]:
    rng = np.random.default_rng(SEED + 16)
    docs = []
    for i in range(n):
        title = " ".join(NESTED_TITLES[int(j)] for j in rng.integers(0, len(NESTED_TITLES), 2))
        lat, lon, size = (float(rng.uniform(0, 50)), float(rng.uniform(0, 50)),
                          float(rng.uniform(1, 8)))
        rings = [[(lat, lon), (lat, lon + size), (lat + size, lon + size), (lat + size, lon),
                  (lat, lon)]]
        if i % 3 == 0:
            q = size / 4
            rings.append([(lat + q, lon + q), (lat + q, lon + 3 * q),
                          (lat + 3 * q, lon + 3 * q), (lat + 3 * q, lon + q), (lat + q, lon + q)])
        docs.append({
            "biz_id": f"b{i}", "title": title,
            "area": json.dumps({"type": "Polygon",
                                "coordinates": [[[x, y] for y, x in r] for r in rings]}),
            "sugg": json.dumps({"value": title, "weight": int(rng.integers(1, 100)),
                                "contexts": [NESTED_CITIES[int(rng.integers(0, 4))]]}),
            "reviews": [json.dumps({
                "text": " ".join(NESTED_WORDS[int(j)]
                                 for j in rng.integers(0, len(NESTED_WORDS), 5)),
                "stars": str(int(rng.integers(1, 6)))}) for _ in range(int(rng.integers(0, 5)))],
        })
    return docs


def _nested_requests(title: str) -> dict:
    """Part B's served request kinds, as functions making a SearchRequest;
    ``title`` (an ingested doc's) is the child-field term and the
    highlighted match-phrase."""
    from google.protobuf.json_format import ParseDict

    from nrtsearch_tpu_torch.gen import pb

    def req(query, k=20, fields=("biz_id",)):
        r = pb.SearchRequest(indexName=NESTED_INDEX, topHits=k, retrieveFields=list(fields))
        ParseDict(query, r.query)
        return r

    def nested(mode, text="good great"):
        return {"nestedQuery": {"path": "reviews", "scoreMode": mode, "query": {
            "matchQuery": {"field": "reviews.text", "query": text}}}}

    def inner_hits():
        r = req(nested("SUM", "friendly fresh"))
        ih = r.inner_hits["matched"]
        ih.query_nested_path = "reviews"
        ParseDict({"matchQuery": {"field": "reviews.text", "query": "friendly fresh"}},
                  ih.inner_query)
        ih.start_hit = 1
        ih.top_hits = 2
        ih.retrieve_fields.extend(["reviews.text", "reviews.stars"])
        return r

    def highlight():
        r = req({"matchPhraseQuery": {"field": "title", "query": title}},
                fields=("biz_id", "title"))
        ParseDict({"fields": ["title"]}, r.highlight)
        return r

    return {
        "nested_inner_hits": inner_hits,
        "nested_max": lambda: req(nested("MAX")),
        "nested_avg_range": lambda: req({"nestedQuery": {"path": "reviews", "scoreMode": "AVG",
                                                         "query": {"rangeQuery": {
                                                             "field": "reviews.stars",
                                                             "lower": "5"}}}}),
        "polygon": lambda: req({"geoPointQuery": {"field": "area", "point": {
            "latitude": 25.5, "longitude": 25.5}}}, fields=("biz_id", "area")),
        "completion": lambda: req({"completionQuery": {"field": "sugg", "text": "gre",
                                                       "contexts": ["sf", "la"]}},
                                  fields=("biz_id", "sugg")),
        "completion_fuzzy": lambda: req({"completionQuery": {"field": "sugg", "text": "grabd",
                                                             "queryType": "FUZZY_QUERY"}}),
        "prefix": lambda: req({"prefixQuery": {"field": "title", "prefix": "gou"}}),
        "child_field": lambda: req({"termQuery": {"field": "title.kw", "textValue": title}}),
        "phrase_highlight": highlight,
    }


def phase_nested(dev, card: str) -> dict:
    """Part B: nested documents and the new field types, served by a
    PRIMARY node on the card and held to a CPU node; a REPLICA synced from
    the primary."""
    import shutil
    import tempfile

    from google.protobuf.json_format import ParseDict

    from nrtsearch_tpu_torch.gen import pb

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="nrt_nested_")
    nodes = []
    try:
        state = f"{root}/state"
        primary, pc = _node(root, "primary", dev=dev, state=state)
        nodes.append((primary, pc))
        cpu_node, cc = _node(root, "cpu", dev=torch.device("cpu"), state=f"{root}/cpu_state")
        nodes.append((cpu_node, cc))
        for client in (pc, cc):
            client.create_index(NESTED_INDEX)
            client.register_fields(ParseDict({"indexName": NESTED_INDEX,
                                              "field": _nested_wire_fields()},
                                             pb.FieldDefRequest()))
            ls = pb.LiveSettingsV2Request(indexName=NESTED_INDEX)
            ls.liveSettings.maxRefreshSec.value = 3600.0
            client.live_settings_v2(ls)
        pc.start_index(pb.StartIndexRequest(indexName=NESTED_INDEX, mode=pb.Mode.PRIMARY,
                                            primaryGen=1))
        cc.start_index(pb.StartIndexRequest(indexName=NESTED_INDEX, mode=pb.Mode.STANDALONE))
        docs = _nested_docs(NESTED_PARENTS)
        n_children = sum(len(d["reviews"]) for d in docs)

        def add(docs_part):
            for d in docs_part:
                r = pb.AddDocumentRequest(indexName=NESTED_INDEX)
                for name, value in d.items():
                    r.fields[name].value.extend(value if isinstance(value, list) else [value])
                yield r

        t = time.perf_counter()
        bounds = np.linspace(0, NESTED_PARENTS, NESTED_CHUNKS + 1).astype(int)
        for client in (pc, cc):
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                client.add_documents(add(docs[lo:hi]))
                client.refresh(NESTED_INDEX)
        ingest_s = time.perf_counter() - t
        requests = _nested_requests(docs[0]["title"])

        def compare(label: str) -> dict:
            lat = {}
            for name, make in requests.items():
                got, want = pc.search(make()), cc.search(make())
                if _strip(got) != _strip(want):
                    raise AssertionError(f"nested {label}: {name} differs from the CPU node")
                if got.totalHits.value == 0:
                    raise AssertionError(f"nested {label}: {name} found nothing")
                times = []
                for _ in range(NESTED_REPS):
                    t = time.perf_counter()
                    pc.search(make())
                    times.append(time.perf_counter() - t)
                lat[name] = 1e3 * float(np.median(times))
            return lat

        lat = compare("served")
        inner = pc.search(requests["nested_inner_hits"]())
        if not any(h.innerHits["matched"].hits for h in inner.hits):
            raise AssertionError("nested: no inner hit answered")
        log(f"nested: {NESTED_PARENTS} parents with {n_children} nested children ingested "
            f"over gRPC on both nodes in {ingest_s:.1f} s; {len(requests)} request kinds equal "
            f"to the CPU node bit for bit; served p50 "
            + ", ".join(f"{n} {ms:.2f} ms" for n, ms in lat.items()) + f" | {card}")

        # a delete of parents (their blocks), then a forced merge
        gone = [f"b{i}" for i in range(0, NESTED_PARENTS, 10)]
        t = time.perf_counter()
        for client in (pc, cc):
            client.delete(_id_request(pb, gone))
            client.refresh(NESTED_INDEX)
            client.force_merge(NESTED_INDEX, 1)
            client.refresh(NESTED_INDEX)
        merge_s = time.perf_counter() - t
        lat2 = compare("after the delete and merge")
        ids = {h.fields["biz_id"].fieldValue[0].textValue
               for n in ("nested_max", "prefix", "polygon")
               for h in pc.search(requests[n]()).hits}
        if ids & set(gone):
            raise AssertionError("nested: a deleted parent answers")
        log(f"nested: {len(gone)} parents (and their children) deleted and the index "
            f"force-merged on both nodes in {merge_s:.1f} s; answers equal to the CPU node; "
            f"served p50 " + ", ".join(f"{n} {ms:.2f} ms" for n, ms in lat2.items())
            + f" | {card}")

        # a REPLICA on the card syncs from the primary
        cc.close()
        cpu_node.stop()
        nodes.remove((cpu_node, cc))
        pc.commit(NESTED_INDEX)
        discovery = f"{root}/primary.json"
        with open(discovery, "w") as f:
            json.dump({"host": "localhost", "port": primary.replication_port}, f)
        replica, rc = _node(root, "replica", dev=dev, state=state)
        nodes.append((replica, rc))
        t = time.perf_counter()
        rc.start_index(pb.StartIndexRequest(indexName=NESTED_INDEX, mode=pb.Mode.REPLICA,
                                            primaryDiscoveryFile=discovery))
        sync_s = time.perf_counter() - t
        for name in ("phrase_highlight", "nested_inner_hits", "nested_max"):
            if _strip(rc.search(requests[name]())) != _strip(pc.search(requests[name]())):
                raise AssertionError(f"nested replica: {name} differs from the primary")
        seconds = time.perf_counter() - t_phase
        log(f"nested replica: synced in {sync_s:.2f} s; the phrase and nested requests answer "
            f"bit for bit as the primary; part B {seconds:.1f} s | {card}")
        return {"seconds": seconds, "lat": lat}
    finally:
        for node, client in nodes:
            client.close()
            node.stop()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _id_request(pb, ids: list[str]):
    """One delete request naming ``ids`` (the reference's delete takes a
    single AddDocumentRequest with the _ID field's values)."""
    r = pb.AddDocumentRequest(indexName=NESTED_INDEX)
    r.fields["biz_id"].value.extend(ids)
    return r


# ---------------------------------------------------------------------------
# phase 16: virtual shards, phase 18: the standalone bucket API
# ---------------------------------------------------------------------------

MESH_SHARDS = (2, 4)
MESH_REL = 2e-5            # mesh against local (tests/test_virtual_shards_server.py:115)
MESH_REPS = 3
MESH_KERNELS = ("head_scores", "near_stages", "far_stage", "far_pair_stage", "gather_runs",
                "finish_mask")
MESH_KNN_REL = 1e-5        # kNN scores, mesh against the unsharded column


def _mesh_row(out, qi: int) -> tuple:
    """Row ``qi`` of a mesh answer as (scores, docs, hits) of its filled
    slots."""
    s, d, h = out
    ok = s[qi] > -np.inf
    return s[qi][ok], d[qi][ok].astype(np.int64), int(h[qi])


def _check_same_docs(td, s, d, total, rel: float, ctx: str) -> int:
    """``td`` against (scores, docs, hits): hits equal, scores rank by rank
    within ``rel``, docs equal but where the two scores at that rank are
    within ``rel`` (an order swap of f32 near-ties: the mesh's host impacts
    and the local path's device impacts may differ in the last bit).
    Returns the number of such swaps."""
    docs = np.array([h.global_ord for h in td.hits], np.int64)
    scores = np.array([h.score for h in td.hits], np.float32)
    if td.total_hits != total or td.relation != "EQUAL_TO" or len(docs) != len(d):
        raise AssertionError(f"{ctx}: hits {td.total_hits} ({td.relation}, {len(docs)} "
                             f"returned) vs {total} ({len(d)})")
    err = np.abs(scores - s) / np.maximum(np.abs(s), 1e-9)
    if len(err) and err.max() > rel:
        raise AssertionError(f"{ctx}: score rel err {err.max():.3g} > {rel}")
    if len(set(docs.tolist())) != len(docs):
        raise AssertionError(f"{ctx}: duplicate docs in the top-k")
    swaps = np.nonzero(docs != d)[0]
    for i in swaps:
        if abs(float(s[i]) - float(scores[i])) > rel * abs(float(s[i])):
            raise AssertionError(f"{ctx}: doc {docs[i]} != {d[i]} at rank {i}")
    return len(swaps)


def _with_search_devices(devices, fn):
    """``fn()`` with ``device.search_devices`` answering ``devices`` (the
    seam the engine counts its mesh devices by)."""
    from nrtsearch_tpu_torch import device as port_device

    real = port_device.search_devices
    port_device.search_devices = lambda: list(devices)
    try:
        return fn()
    finally:
        port_device.search_devices = real


def _timed(fn, reps: int) -> tuple[float, object]:
    """(p50 ms over ``reps`` calls, the last answer), synchronized."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return 1e3 * float(np.median(times)), out


def phase_mesh(dev, corpus, columns, searcher, singles, batch, node, card: str) -> dict:
    """Phase 16 (see the module docstring). Returns the mesh runs' launches
    and the phase's measurements."""
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.core.searcher import SortSpec
    from nrtsearch_tpu_torch.gen import pb
    from nrtsearch_tpu_torch.models.synthetic import clustered_vectors
    from nrtsearch_tpu_torch.ops import knn
    from nrtsearch_tpu_torch.parallel import DistributedKNN, make_search_mesh
    from nrtsearch_tpu_torch.query import parse_query

    t_phase = time.perf_counter()
    single_specs = [searcher.fast_query_spec(_match(q)) for q in singles]
    batch_specs = [searcher.fast_query_spec(_match(q)) for q in batch]
    paths = ("merge", "fused")

    def run(path: str, reps: int):
        """B=1 singles and the B=32 batch on ``path``: p50s and answers."""
        def go():
            lat1, ans1 = [], []
            for sp in single_specs:
                ms_, out = _timed(lambda: searcher.fast_search_batch([sp], TOP_K), reps)
                lat1.append(ms_)
                ans1.append(out[0])
            p32, ans32 = _timed(lambda: searcher.fast_search_batch(batch_specs, TOP_K), reps)
            return float(np.median(lat1)), p32, ans1, ans32
        return _with_path(path, go)

    # S = 1: the local path, the answers every mesh is held to
    searcher.dist_shards = 1
    local = {p: run(p, MESH_REPS) for p in paths}
    stats = {1: {p: local[p][:2] for p in paths}}
    log(f"mesh: S=1 (local path) p50 merge B=1 {local['merge'][0]:.2f} ms, B=32 "
        f"{local['merge'][1]:.2f} ms; fused B=1 {local['fused'][0]:.2f} ms, B=32 "
        f"{local['fused'][1]:.2f} ms | {card}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    swaps = 0
    per_request = {}
    for S in MESH_SHARDS:
        def on_mesh():
            searcher.dist_shards = S
            t = time.perf_counter()
            dist = searcher._distributed_state("body")
            torch.cuda.synchronize()
            rep_s = time.perf_counter() - t
            t = time.perf_counter()
            n_head = dist.attach_dense()
            torch.cuda.synchronize()
            dense_s = time.perf_counter() - t
            out = {p: run(p, MESH_REPS) for p in paths}
            return dist, rep_s, n_head, dense_s, out

        dist, rep_s, n_head, dense_s, out = _with_search_devices([dev] * S, on_mesh)
        if dist.mesh.shape != {"shard": S, "data": 1}:
            raise AssertionError(f"mesh {dist.mesh.shape} for S={S}")
        for qi in range(len(singles)):
            # merge mesh: the same docs, order and hits as the local merge path
            td = local["merge"][2][qi]
            got = out["merge"][2][qi]
            swaps += _check_same_docs(
                td, np.array([h.score for h in got.hits], np.float32),
                np.array([h.global_ord for h in got.hits], np.int64), got.total_hits,
                MESH_REL, f"mesh S={S} merge single {qi}")
            # fused mesh: exact hits, the fused contract against the local fused path
            gf = out["fused"][2][qi]
            swaps += _check_topk(local["fused"][2][qi], (
                np.array([h.score for h in gf.hits], np.float32),
                np.array([h.global_ord for h in gf.hits], np.int64), gf.total_hits),
                FUSED_REL, f"mesh S={S} fused single {qi}")
        for qi in range(len(batch)):
            got = out["merge"][3][qi]
            swaps += _check_same_docs(
                local["merge"][3][qi], np.array([h.score for h in got.hits], np.float32),
                np.array([h.global_ord for h in got.hits], np.int64), got.total_hits,
                MESH_REL, f"mesh S={S} merge batch {qi}")
            gf = out["fused"][3][qi]
            swaps += _check_topk(local["fused"][3][qi], (
                np.array([h.score for h in gf.hits], np.float32),
                np.array([h.global_ord for h in gf.hits], np.int64), gf.total_hits),
                FUSED_REL, f"mesh S={S} fused batch {qi}")
        stats[S] = {p: out[p][:2] for p in paths}
        stats[S]["repartition_s"] = rep_s
        stats[S]["bytes_per_shard"] = dist.device_bytes()
        log(f"mesh: S={S} on {dev} x {S}: repartition {rep_s:.2f} s, dense rows "
            f"({n_head} heads, residual {dist.dense_rows_lo is not None}) {dense_s:.2f} s, "
            f"{dist.device_bytes() / 2**20:.1f} MiB on the card per shard; p50 merge B=1 "
            f"{out['merge'][0]:.2f} ms, B=32 {out['merge'][1]:.2f} ms; fused B=1 "
            f"{out['fused'][0]:.2f} ms, B=32 {out['fused'][1]:.2f} ms | {card}")
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in MESH_KERNELS}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the mesh runs did not launch {missing}: {launches}")
    log(f"mesh: launches over the S=2 and S=4 runs {launches}; answers equal to the local "
        f"path (merge: docs and hits, scores within {MESH_REL}; fused: within {FUSED_REL}); "
        f"near-tie order swaps {swaps}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")

    # launches per request on the S=4 mesh
    def per_req():
        searcher.dist_shards = 4
        for path in paths:
            for label, specs in (("B=1", single_specs[:1]), ("B=32", batch_specs)):
                kernels.reset_launch_counts()
                _with_path(path,
                          lambda: searcher.fast_search_batch(specs, TOP_K))
                torch.cuda.synchronize()
                per_request[f"{path} {label}"] = {k: kernels.LAUNCHES[k] for k in MESH_KERNELS}
    _with_search_devices([dev] * 4, per_req)
    log(f"mesh: launches per request at S=4 {json.dumps(per_request)}")

    # filters, sorts and facets over the S=4 mesh (phase 9's columns)
    def general():
        searcher.dist_shards = 4
        return searcher._distributed_state("body")

    dist = _with_search_devices([dev] * 4, general)
    t = time.perf_counter()
    dist.attach_columns(searcher, ["price", "ts", "tag"])
    cols_s = time.perf_counter() - t
    names = columns["tag"][2]
    c3 = config3_singles(corpus, searcher)
    qs = [terms for _p, terms in c3]
    offs, lens, w, n_terms, run_len = dist.compile_text_queries(qs)
    price = {"rangeQuery": {"field": "price", "lower": "100", "upper": "900"}}
    tag = {"termQuery": {"field": "tag", "textValue": names[3]}}
    forms = {
        "price_filter_ts_desc_tag_facet": (
            dict(filters=[("price", ">=", 100.0), ("price", "<=", 900.0)],
                 sort=("ts", False, True), facet_fields=["tag"]),
            [price], SortSpec("ts", reverse=True)),
        "price_tag_filter_scored_tag_facet": (
            dict(filters=[("price", ">=", 100.0), ("price", "<=", 900.0),
                          ("tag", "ord==", names[3])], facet_fields=["tag"]),
            [price, tag], None),
    }
    general_ms = {}
    for name, (kw, filters, sort) in forms.items():
        general_ms[name], (sc, ids, hits, facets) = _timed(
            lambda: dist.search_general(offs, lens, w, n_terms, run_len=run_len, k=TOP_K, **kw),
            MESH_REPS)
        sc, ids, hits = (x.cpu().numpy() for x in (sc, ids, hits))
        labels = dist.facet_labels("tag")
        for qi, terms in enumerate(qs):
            node_q = parse_query({"booleanQuery": {"clauses": [
                {"occur": "MUST", "query": _match_dict(terms)},
                *({"occur": "FILTER", "query": f} for f in filters)]}})
            td = _with_path("merge",
                           lambda: searcher.search(node_q, TOP_K, sort=sort))
            s_q, d_q, h_q = _mesh_row((sc, ids, hits), qi)
            ctx = f"mesh general {name} query {qi}"
            if sort is not None:
                keys = np.array([h.sort_key for h in td.hits], np.float32)
                docs = np.array([h.global_ord for h in td.hits], np.int64)
                if td.total_hits != h_q or not np.array_equal(docs, d_q) or \
                        not np.array_equal(keys.view(np.int32), s_q.view(np.int32)):
                    raise AssertionError(f"{ctx}: sorted answer differs from Searcher.search")
            else:
                swaps += _check_same_docs(td, s_q, d_q, h_q, MESH_REL, ctx)
            _td, (want,) = _with_path("merge", lambda: searcher.fast_search_reduce(
                searcher.compile_batchable(node_q), TOP_K, [{"kind": "ordinal", "field": "tag"}]))
            got = {labels[o]: int(c) for o, c in enumerate(facets["tag"][qi]) if c}
            if got != {k: v for k, v in want.items() if v}:
                raise AssertionError(f"{ctx}: facet counts differ from fast_search_reduce")
    log(f"mesh: search_general at S=4 over price, ts, tag ({cols_s:.2f} s to lay the columns "
        f"out): {len(qs)} queries x {len(forms)} forms, hits, sort keys, docs and tag facet "
        f"counts equal to Searcher.search / fast_search_reduce; p50 "
        + ", ".join(f"{n} {v:.2f} ms" for n, v in general_ms.items()) + f" | {card}")
    searcher.dist_shards = 1

    # kNN over phase 14's 1M x 128 f32 vectors (l2_norm)
    t = time.perf_counter()
    base, vq = clustered_vectors(NUM_DOCS, VEC_DIMS, VEC_QUERIES + 4, seed=SEED)
    vq = vq[:VEC_QUERIES]
    dk = DistributedKNN.from_vectors(base, make_search_mesh(4, 1, [dev] * 4),
                                     similarity="l2_norm")
    knn_build_s = time.perf_counter() - t
    vecs = torch.from_numpy(base).to(dev)
    sq = torch.from_numpy((base * base).sum(-1)).to(dev)
    mask = torch.ones(NUM_DOCS, dtype=torch.bool, device=dev)
    qt = torch.from_numpy(vq).to(dev)
    knn_mesh_ms, (ms_, mi) = _timed(lambda: dk.search(vq, k=TOP_K), MESH_REPS)
    knn_local_ms, (ls, li) = _timed(lambda: knn.knn_search(vecs, sq, mask, qt,
                                                           similarity="l2_norm", k=TOP_K),
                                    MESH_REPS)
    ms_, mi, ls, li = (x.cpu().numpy() for x in (ms_, mi, ls, li))
    err = float(np.max(np.abs(ms_ - ls) / np.maximum(np.abs(ls), 1e-30)))
    if err > MESH_KNN_REL:
        raise AssertionError(f"mesh kNN scores rel err {err:.3g} > {MESH_KNN_REL}")
    tie = np.isclose(ms_, ls, rtol=MESH_KNN_REL, atol=0)
    if not ((mi == li) | tie).all():
        raise AssertionError("mesh kNN ids differ from knn_search away from ties")
    knn_swaps = int((mi != li).sum())
    del dk, vecs, sq, base
    log(f"mesh: DistributedKNN over {NUM_DOCS} x {VEC_DIMS} f32 (l2_norm) at S=4, built in "
        f"{knn_build_s:.1f} s: {VEC_QUERIES} queries, top {TOP_K} equal to knn_search "
        f"(scores within {err:.3g} relative, {knn_swaps} id swaps at ties); p50 B={VEC_QUERIES} "
        f"mesh {knn_mesh_ms:.2f} ms, unsharded {knn_local_ms:.2f} ms | {card}")

    # the served node: virtualShards 4 on [card] * 4, then 1, then 4 on one device
    server, client, rt = node

    def served_answers():
        return [_served_td(client.search(_request(_match_dict(q)))) for q in batch]

    def set_shards(n: int):
        client.live_settings(pb.LiveSettingsRequest(indexName=SERVED_INDEX, virtualShards=n))

    def sharded():
        set_shards(4)
        out = served_answers()
        if ("body", 4) not in rt.searcher._dist_cache:
            raise AssertionError("the served virtualShards=4 node built no mesh")
        return out

    served4 = _with_path("merge", lambda: _with_search_devices([dev] * 4, sharded))
    set_shards(1)
    served1 = _with_path("merge", served_answers)
    set_shards(4)
    served_local = _with_path("merge", served_answers)
    if rt.searcher._dist_cache:
        raise AssertionError("a one-device virtualShards=4 node built a mesh")
    set_shards(1)
    for qi, (a, b, c) in enumerate(zip(served4, served1, served_local)):
        swaps += _check_same_docs(b, np.array([h.score for h in a.hits], np.float32),
                                  np.array([h.global_ord for h in a.hits], np.int64),
                                  a.total_hits, MESH_REL, f"served virtualShards=4 single {qi}")
        if [(h.global_ord, h.score) for h in c.hits] != [(h.global_ord, h.score) for h in b.hits] \
                or c.total_hits != b.total_hits:
            raise AssertionError(f"served one-device virtualShards=4 single {qi} differs")
    log(f"mesh: served node, {len(batch)} singles at virtualShards 4 on {dev} x 4 equal to "
        f"virtualShards 1 (merge path; hits and docs, scores within {MESH_REL}); with one "
        f"search device virtualShards 4 serves on the local path, bit for bit | {card}")

    if torch.cuda.device_count() >= 2:
        n = min(4, torch.cuda.device_count())
        devs = [torch.device("cuda", i) for i in range(n)]

        def distinct():
            searcher.dist_shards = n
            return [searcher.fast_search_batch(batch_specs, TOP_K)
                    for _ in range(2)][-1]

        got = _with_path("merge", lambda: _with_search_devices(devs, distinct))
        for qi, td in enumerate(got):
            swaps += _check_same_docs(local["merge"][3][qi],
                                      np.array([h.score for h in td.hits], np.float32),
                                      np.array([h.global_ord for h in td.hits], np.int64),
                                      td.total_hits, MESH_REL, f"distinct cards batch {qi}")
        searcher.dist_shards = 1
        log(f"mesh: S={n} on {n} distinct cards: the B=32 batch equals the local path")
    else:
        log("mesh: distinct cards not run: torch.cuda.device_count() is "
            f"{torch.cuda.device_count()}")
    searcher.dist_shards = 1
    del dist
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"mesh: phase {seconds:.1f} s | {card}")
    return {"launches": launches, "per_request": per_request, "stats": stats,
            "seconds": seconds}


def phase_bucket_standalone(dev, searcher, singles, card: str) -> dict:
    """Phase 18 (see the module docstring). Returns the kernel's launches."""
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.ops import bucket_retrieval as br
    from nrtsearch_tpu_torch.ops.merge_scoring import _pow2

    t_phase = time.perf_counter()
    view = searcher.packed_view("body")
    index = view.index
    docs_h = index.doc_ids.cpu().numpy()
    imps_h = index.impacts.cpu().numpy()
    t = time.perf_counter()
    idx = br.BucketIndex.build(docs_h, imps_h, index.run_offsets, index.run_lengths,
                               capacity=_pow2(NUM_DOCS), bucket_docs=16384)
    build_s = time.perf_counter() - t
    queries = [[(r, w) for _t, w, runs in view.term_entries(list(q)) for r in runs]
               for q in singles]
    t = time.perf_counter()
    plan = br.plan_bucket_batch(idx, queries, index.run_offsets, max_terms=16)
    plan_s = time.perf_counter() - t
    tabs = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (plan.term_offs, plan.bounds, plan.weights, plan.n_terms)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    keys, top_docs, hits = br.bucket_search_topk(
        index.doc_ids, index.impacts, *tabs, tile=plan.tile, bucket_bits=idx.bucket_bits,
        k=TOP_K)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in ("bucket_rank", "bucket_rank_topk")}
    if launches != {"bucket_rank": 0, "bucket_rank_topk": 1}:
        raise AssertionError(f"bucket_search_topk launched {launches}")
    scores, d = br.decode_topk(keys.cpu().numpy(), top_docs.cpu().numpy(), plan.scales)
    t = time.perf_counter()
    ws, wd, wh = br.reference_bucket_search(docs_h, imps_h, idx, plan, TOP_K)
    oracle_s = time.perf_counter() - t
    if not (np.array_equal(scores.view(np.int32), ws.view(np.int32))
            and np.array_equal(d, wd) and np.array_equal(hits.cpu().numpy(), wh)):
        raise AssertionError("standalone bucket search differs from reference_bucket_search")
    ms_ = cuda_ms(lambda: br.bucket_search_topk(
        index.doc_ids, index.impacts, *tabs, tile=plan.tile, bucket_bits=idx.bucket_bits,
        k=TOP_K), reps=10)
    seconds = time.perf_counter() - t_phase
    log(f"bucket standalone: BucketIndex.build over the view's {index.doc_ids.shape[0]} "
        f"packed postings ({len(index.run_offsets)} runs, {idx.n_buckets} buckets of 16384 "
        f"docs) {build_s:.2f} s, plan_bucket_batch of {len(singles)} singles (T=16, "
        f"tile {plan.tile}) {plan_s:.3f} s; bucket_search_topk on the card equal to "
        f"reference_bucket_search on the host bit for bit (scores, docs, hits; oracle "
        f"{oracle_s:.1f} s); {ms_:.3f} ms per B={len(singles)} call, launches {launches}; "
        f"phase {seconds:.1f} s | {card}")
    return {"launches": launches, "ms": ms_, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 19: the flagship model
# ---------------------------------------------------------------------------

FLAGSHIP_BUCKET_DOCS = 16384       # bench.py BUCKET_DOCS
# bench.py DENSE_ROWS, DENSE_MIN_DF, DENSE_RESIDUAL (the dense tail keeps
# attach_dense's 32768-doc buckets, as bench.py does)
FLAGSHIP_DENSE = {"max_rows": 1024, "min_df": 2048, "residual": True}
FLAGSHIP_REPS = 5                  # B=32 calls per route for the p50
FLAGSHIP_CPU_B = 8                 # the batch held to the CPU copy
FLAGSHIP_ORACLE_QUANT = 4          # queries held to the numpy oracles of the quantized routes
FLAGSHIP_ULPS = 4                  # bucketed split against one batch
NATIVE_DOCS = 20_000


def _zipf_queries(corpus, rng, n: int, terms: int = TERMS_PER_QUERY) -> list[list[str]]:
    """``n`` queries of Zipf terms (as SyntheticCorpus.sample_queries draws
    them) from ``rng``."""
    ranks = np.arange(1, corpus.vocab_size + 1)
    p = 1.0 / ranks
    p /= p.sum()
    return [[str(t) for t in row] for row in rng.choice(corpus.vocab_size, (n, terms), p=p)]


def _host_rows(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_rows(got, want, rel: float, ctx: str, hits_lower: bool = False) -> int:
    """(scores, docs, hits) rows against (scores, docs, hits): hits equal
    (or, with ``hits_lower``, at most ``want``'s), scores rank by rank
    within ``rel`` (or an absolute bound per row when ``rel`` is an array),
    a doc different only where the two scores at that rank are that close.
    Returns the number of such near-tie swaps."""
    s, d, h = (_host_rows(x) for x in got)
    ws, wd, wh = (_host_rows(x) for x in want)
    swaps = 0
    for qi in range(len(wh)):
        bad_hits = h[qi] > wh[qi] if hits_lower else h[qi] != wh[qi]
        if bad_hits:
            raise AssertionError(f"{ctx} query {qi}: hits {h[qi]} vs {wh[qi]}")
        fin = np.isfinite(ws[qi])
        if not np.array_equal(np.isfinite(s[qi]), fin):
            raise AssertionError(f"{ctx} query {qi}: filled slots differ")
        tol = (rel[qi] if np.ndim(rel) else rel * np.abs(ws[qi][fin]))
        err = np.abs(s[qi][fin].astype(np.float64) - ws[qi][fin])
        if (err > tol).any():
            raise AssertionError(f"{ctx} query {qi}: score error {err.max():.3g} > tolerance")
        docs = d[qi][fin].astype(np.int64)
        if len(set(docs.tolist())) != len(docs):
            raise AssertionError(f"{ctx} query {qi}: duplicate docs")
        swaps += int((docs != wd[qi][fin]).sum())
    return swaps


def _dense_tail_tolerance(plan, row_max: np.ndarray, quanta: bool) -> np.ndarray:
    """Per query of a dense-tail plan: 8 f32 ulps of the largest score it
    can reach (the bf16 head products summed in another order, the tail
    share added), and with ``quanta`` one quantum (1 / scale) per tail term
    (against the numpy oracle, which rounds each term its own way). Head
    terms carry no quantum: their products are never quantized."""
    from nrtsearch_tpu_torch.ops.bucket_retrieval import QMAX

    top = np.abs(plan.W.astype(np.float64)) @ row_max
    q = 0.0
    if plan.tail is not None:
        top = top + np.where(plan.tail.n_terms > 0, QMAX / plan.tail.scales, 0.0)
        q = plan.tail.n_terms / plan.tail.scales
    return 8 * 2.0**-23 * top + (q if quanta else 0.0)


def _native_docs(corpus, n: int) -> list[dict]:
    """``n`` documents of the corpus's own token draws (term t as the word
    ``w<t>``), every 50th with a non-ASCII word (the Python analyzer's
    path into the accumulator)."""
    docs = []
    for i in range(n):
        toks = corpus.tokens[corpus.doc_starts[i] : corpus.doc_starts[i + 1]]
        text = " ".join(f"w{t}" for t in toks)
        docs.append({"body": text + (" café" if i % 50 == 0 else "")})
    return docs


def phase_native_builder(dev, corpus, card: str) -> dict:
    """The builder over NATIVE_DOCS documents with the native accumulator
    and with NRT_NATIVE=0: the extension must load, the segments must be
    equal."""
    from nrtsearch_tpu_torch import native_ext
    from nrtsearch_tpu_torch.core.segment import SegmentBuilder

    docs = _native_docs(corpus, NATIVE_DOCS)
    if native_ext.get() is None:
        raise AssertionError("the native extension did not load")

    def build(flag: str):
        native_ext._module, native_ext._tried = None, False
        try:
            def run():
                b = SegmentBuilder(body_field_defs(), dev)
                if (b._native is not None) != (flag == "1"):
                    raise AssertionError(f"NRT_NATIVE={flag}: native {b._native}")
                t = time.perf_counter()
                for d in docs:
                    b.add_document(d)
                seg = b.flush()
                torch.cuda.synchronize()
                return seg, time.perf_counter() - t
            return _with_env("NRT_NATIVE", flag, run)
        finally:
            native_ext._module, native_ext._tried = None, False

    (a, ta), (p, tp) = build("1"), build("0")
    if native_ext.get() is None:
        raise AssertionError("the native extension did not load again")
    x, y = a.fields["body"], p.fields["body"]
    same = (x.terms == y.terms and x.postings_len == y.postings_len
            and x.sum_doc_lens == y.sum_doc_lens and x.doc_count == y.doc_count
            and all(np.array_equal(getattr(x, f), getattr(y, f))
                    for f in ("offsets", "lengths", "positions", "position_offsets"))
            and all(torch.equal(getattr(x, f), getattr(y, f))
                    for f in ("doc_ids", "freqs", "doc_lens")))
    if not same:
        raise AssertionError("native and Python builders packed different segments")
    log(f"flagship: builder over {NATIVE_DOCS} docs ({x.postings_len} postings, "
        f"{len(x.positions)} positions, {len(x.terms)} terms): native accumulator "
        f"{ta:.2f} s, NRT_NATIVE=0 {tp:.2f} s ({tp / ta:.1f}x); segments equal | {card}")
    return {"native_s": ta, "python_s": tp}


def phase_flagship(dev, corpus, card: str) -> dict:
    """Phase 19 (see the module docstring). Returns the routes' launches
    and the phase's measurements."""
    import dataclasses

    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.models import flagship
    from nrtsearch_tpu_torch.ops import bucket_retrieval as br
    from nrtsearch_tpu_torch.ops import dense_head

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    model = corpus.to_model(dev)
    torch.cuda.synchronize()
    mem_model = torch.cuda.memory_allocated(dev) - mem0
    build = {"model": time.perf_counter() - t}
    t = time.perf_counter()
    model.attach_bucket(FLAGSHIP_BUCKET_DOCS)
    build["bucket"] = time.perf_counter() - t
    t = time.perf_counter()
    model.attach_dense(**FLAGSHIP_DENSE)
    torch.cuda.synchronize()
    build["dense"] = time.perf_counter() - t
    mem_dense = torch.cuda.memory_allocated(dev) - mem0 - mem_model
    idx = model.dense_idx
    log(f"flagship: SyntheticCorpus({NUM_DOCS}, {VOCAB}, {DRAWS}, seed={SEED}).to_model "
        f"{build['model']:.2f} s: {int(model.doc_ids.shape[0])} postings slots, D "
        f"{model.capacity}, {mem_model / 2**30:.3f} GiB on the card; attach_bucket("
        f"{FLAGSHIP_BUCKET_DOCS}) {build['bucket']:.2f} s (host bounds); attach_dense"
        f"({FLAGSHIP_DENSE}) {build['dense']:.2f} s: {idx.n_rows} head rows (Hp "
        f"{idx.rows.shape[0]}), {mem_dense / 2**30:.3f} GiB of rows on the card | {card}")

    rng = np.random.default_rng(SEED + 19)
    singles = _zipf_queries(corpus, rng, 8)
    batch = _zipf_queries(corpus, rng, BATCH)
    # the bucketed batch: 31 light queries of tail terms beside one heavy
    # query of the four most frequent terms, so the width split engages
    tail_terms = [str(t) for t in range(corpus.vocab_size)
                  if 0 < corpus.term_lengths[t] < FLAGSHIP_DENSE["min_df"]]
    light = [[tail_terms[int(i)] for i in rng.choice(len(tail_terms), TERMS_PER_QUERY)]
             for _ in range(BATCH - 1)]
    bucketed = light + [["0", "1", "2", "3"]]

    def run_search(qs):
        return [_host_rows(x) for x in model.search(model.compile_queries(qs), TOP_K)]

    def run_bucket(qs):
        plan = model.plan_bucket(qs)
        keys, docs, hits = model.serve_bucket_batch(plan, TOP_K)
        s, d = br.decode_topk(keys.cpu().numpy(), docs.cpu().numpy(), plan.scales)
        return s, d, hits.cpu().numpy()

    def run_dense_tail(qs):
        return dense_head.decode_packed(model.serve_dense_batch(model.plan_dense(qs), TOP_K),
                                        TOP_K)

    def run_dense_merge(qs):
        return dense_head.decode_packed2(
            model.serve_dense_merge(model.plan_dense_merge(qs), TOP_K), TOP_K)

    def run_fused(qs):
        return dense_head.decode_packed2(
            model.serve_dense_fused(model.plan_dense_merge(qs), TOP_K), TOP_K)

    runs = {"search": run_search, "bucket": run_bucket,
            "dense_tail": run_dense_tail, "dense_merge": run_dense_merge, "fused": run_fused}
    for fn in runs.values():        # warm-up: first calls allocate
        fn(batch[:2])

    # the main path's run: every route at B=1 and B=32, and the bucketed
    # batch, with the launch counters reset just before and read just after
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    timing, per_route, ran32, answers = {}, {}, {}, {}
    branch0 = dict(dense_head.WINDOW_BRANCH)
    for name, fn in runs.items():
        before = dict(kernels.LAUNCHES)
        lat1 = []
        for q in singles:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn([q])
            lat1.append(time.perf_counter() - t)
        mid = dict(kernels.LAUNCHES)
        lat32 = []
        for _ in range(FLAGSHIP_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            answers[name] = fn(batch)
            lat32.append(time.perf_counter() - t)
        timing[name] = (1e3 * float(np.median(lat1)), 1e3 * float(np.median(lat32)))
        per_route[name] = {k: kernels.LAUNCHES[k] - before.get(k, 0) for k in kernels.LAUNCHES}
        ran32[name] = sorted(k for k in kernels.LAUNCHES if kernels.LAUNCHES[k] > mid.get(k, 0))
    split = model.compile_queries_bucketed(bucketed)
    split_out = [(ix, [_host_rows(x) for x in model.search(qb, TOP_K)]) for qb, ix in split]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    branches = {k: dense_head.WINDOW_BRANCH[k] - branch0[k] for k in branch0}
    missing = [k for k in KERNEL_SOURCES
               if k not in VECTOR_KERNELS and launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the flagship routes: {missing}")
    if len(split) != 2:
        raise AssertionError(f"the bucketed batch did not split: {[ix for _q, ix in split]}")

    # the index bytes on the card each route holds: the postings and
    # impacts, the head rows (and their maxima and
    # residual rows where the route reads them; the dense tails stream all
    # the head rows per call, the fused route only the rows a batch uses)
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    postings = nbytes(model.doc_ids, model.impacts)
    held = {"search": postings, "bucket": postings,
             "dense_tail": postings + nbytes(idx.rows),
             "dense_merge": postings + nbytes(idx.rows, idx.row_max),
             "fused": postings + nbytes(idx.rows, idx.rows_lo, idx.row_max)}

    # profiles: one traced B=32 call per route, which must launch what the
    # route's B=32 calls launched, each kernel showing in the trace; its
    # peak working bytes beyond the index
    busy, peak = {}, {}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        busy[name] = profile_call(lambda: fn(batch))
        peak[name] = torch.cuda.max_memory_allocated(dev) - base
        if busy[name]["kernels"] != ran32[name]:
            raise AssertionError(f"the traced {name} call launched {busy[name]['kernels']}, "
                                 f"its B={BATCH} calls {ran32[name]}")
    for name in runs:
        b1, b32 = timing[name]
        pr = busy[name]
        if pr["device_busy_ms"] <= 0:
            raise AssertionError(f"the traced {name} call ran nothing on the device")
        log(f"flagship route {name}: B=1 p50 {b1:.2f} ms ({len(singles)} singles), B={BATCH} "
            f"p50 {b32:.2f} ms ({FLAGSHIP_REPS} calls); traced B={BATCH} call: device busy "
            f"{pr['device_busy_ms']:.3f} ms ({100 * pr['device_busy_ms'] / b32:.1f}% of the "
            f"p50) in {pr['device_items']} items, its kernels {pr['kernels']} all in the "
            f"trace, top {json.dumps(pr['top'][:4])}; launches "
            f"{ {k: v for k, v in per_route[name].items() if v} }; card bytes: index held "
            f"{held[name] / 2**30:.3f} GiB, B={BATCH} peak working "
            f"{peak[name] / 2**20:.1f} MiB | {card}")

    # ---- the answers ---------------------------------------------------
    t_check = time.perf_counter()
    sub = batch[:FLAGSHIP_CPU_B]
    cpu = corpus.to_model("cpu")
    if not torch.equal(cpu.impacts.view(torch.int32), model.impacts.cpu().view(torch.int32)):
        raise AssertionError("the card's impacts differ from the CPU copy's")
    cpu.bucket_idx = model.bucket_idx
    cpu.dense_idx = dataclasses.replace(idx, rows=idx.rows.cpu(), rows_lo=idx.rows_lo.cpu(),
                                        row_max=idx.row_max.cpu())
    swaps = {}
    # search: bit-equal to the CPU copy on the accelerator branch's plain
    # versions, and to the numpy BM25 within MERGE_REL
    card_s = run_search(sub)
    qb = cpu.compile_queries(sub)
    cpu_s = [_host_rows(x) for x in flagship.bm25_search_step(
        cpu.doc_ids, cpu.impacts, *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            qb.term_offsets, qb.term_lengths, qb.term_weights, qb.n_terms)),
        run_len=qb.run_len, k=TOP_K, use_pallas=True)]
    if not (np.array_equal(card_s[0].view(np.int32), cpu_s[0].view(np.int32))
            and np.array_equal(card_s[1], cpu_s[1]) and np.array_equal(card_s[2], cpu_s[2])):
        raise AssertionError("flagship search on the card differs from the CPU copy")
    ex = [corpus.exact_topk(q, TOP_K, raw_lengths=True) for q in sub]
    width = TOP_K
    ex_rows = (np.stack([np.pad(e[0], (0, width - len(e[0])), constant_values=-np.inf)
                         for e in ex]),
               np.stack([np.pad(e[1], (0, width - len(e[1])), constant_values=-1) for e in ex]),
               np.array([e[2] for e in ex]))
    swaps["search_numpy"] = _check_rows(card_s, ex_rows, MERGE_REL, "search vs numpy BM25")
    # the bucketed split: every query's answer as in one batch
    one = run_search(bucketed)
    for ix, out in split_out:
        swaps["bucketed"] = swaps.get("bucketed", 0) + _check_rows(
            out, [x[ix] for x in one], 2 * FLAGSHIP_ULPS * 2.0**-23, "bucketed split")
    # bucket: integer keys, equal to the CPU copy and to the numpy oracle
    bp = model.plan_bucket(sub)
    kc, dc, hc = (x.cpu().numpy() for x in model.serve_bucket_batch(bp, TOP_K))
    kp, dp, hp = (x.numpy() for x in cpu.serve_bucket_batch(bp, TOP_K))
    filled = kc != br.I32_MIN
    if not (np.array_equal(kc, kp) and np.array_equal(hc, hp)
            and np.array_equal(dc[filled], dp[filled])):
        raise AssertionError("bucket route on the card differs from the CPU copy")
    oq = sub[:FLAGSHIP_ORACLE_QUANT]
    op = model.plan_bucket(oq)
    t = time.perf_counter()
    docs_h, imps_h = model.host_postings()
    ws, wd, wh = br.reference_bucket_search(docs_h, imps_h, model.bucket_idx, op, TOP_K)
    oracle_s = time.perf_counter() - t
    got = run_bucket(oq)
    if not (np.array_equal(got[0].view(np.int32), ws.view(np.int32))
            and np.array_equal(got[1], wd) and np.array_equal(got[2], wh)):
        raise AssertionError("bucket route differs from reference_bucket_search")
    # dense head + bucket tail: the CPU copy and reference_dense_search
    row_max = idx.row_max.double().cpu().numpy()
    dp_ = model.plan_dense(sub)
    # the same rank keys on both: only the head's sums differ
    tol = _dense_tail_tolerance(dp_, row_max, quanta=False)
    swaps["dense_tail"] = _check_rows(
        dense_head.decode_packed(model.serve_dense_batch(dp_, TOP_K), TOP_K),
        dense_head.decode_packed(cpu.serve_dense_batch(dp_, TOP_K), TOP_K), tol,
        "dense tail vs CPU copy")
    t = time.perf_counter()
    dq = model.plan_dense(oq)
    want = dense_head.reference_dense_search(docs_h, imps_h, idx, model.bucket_entries(oq),
                                             model.offsets, model.lengths, TOP_K)
    oracle_s += time.perf_counter() - t
    swaps["dense_tail_numpy"] = _check_rows(run_dense_tail(oq), want,
                                            _dense_tail_tolerance(dq, row_max, quanta=True),
                                            "dense tail vs reference_dense_search")
    # dense head + merge tail and the fused path: the CPU copy within the
    # fused contract; the window branch and the exact flags printed
    mp = model.plan_dense_merge(sub)
    flags = {}
    for name, fn in (("dense_merge", "serve_dense_merge"), ("fused", "serve_dense_fused")):
        a = dense_head.decode_packed2(getattr(model, fn)(mp, TOP_K), TOP_K)
        b = dense_head.decode_packed2(getattr(cpu, fn)(mp, TOP_K), TOP_K)
        same_flags = np.array_equal(a[3], b[3])
        swaps[name] = _check_rows(a[:3], b[:3], CPU_GPU_FUSED_REL, f"{name} vs CPU copy",
                                  hits_lower=not same_flags)
        flags[name] = (int(a[3].sum()), int(b[3].sum()))
    check_s = time.perf_counter() - t_check

    native = phase_native_builder(dev, corpus, card)
    del model, cpu, idx
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"flagship: answers held: search bit-equal to the CPU copy (B={FLAGSHIP_CPU_B}) and "
        f"within {MERGE_REL} of the numpy BM25; the bucketed batch split "
        f"{[len(ix) for _q, ix in split]} as one batch answers; bucket bit-equal to the CPU "
        f"copy and reference_bucket_search ({FLAGSHIP_ORACLE_QUANT} queries); dense tail "
        f"within 8 ulps of its reach of the CPU copy, plus one quantum per tail term of "
        f"reference_dense_search; dense "
        f"merge and fused within {CPU_GPU_FUSED_REL} of the CPU copy (exact flags card/cpu "
        f"{flags}); dense-merge window branch over the run {branches}; near-tie swaps "
        f"{swaps}; checks {check_s:.1f} s (numpy oracles {oracle_s:.1f} s) | {card}")
    log(f"flagship: launches over the routes' run {launches}; phase {seconds:.1f} s | {card}")
    return {"launches": launches, "per_route": per_route, "timing": timing,
            "busy": {k: v["device_busy_ms"] for k, v in busy.items()}, "build": build,
            "bytes": {"model": mem_model, "dense_rows": mem_dense, "held": held, "peak": peak}, "native": native,
            "seconds": seconds}


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from nrtsearch_tpu_torch import kernels
    from nrtsearch_tpu_torch.device import exact_cuda_matmul, resolve_device
    from nrtsearch_tpu_torch.ops import dense_fused, merge_scoring

    dev = resolve_device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(dev)} | {card} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}")
    exact_cuda_matmul()
    log(f"device: bf16 mm with f32 out on CUDA: {dense_fused.cuda_bf16_mm_f32_out()}")

    # 2. build
    t = time.perf_counter()
    so = kernels.build()
    kernels._library()
    log(f"build: {so.name} in {time.perf_counter() - t:.2f} s (nvcc {kernels.BUILD_INFO['seconds']:.2f} s)")
    for line in kernels.BUILD_INFO["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"build: {line.strip()}")

    # 4 (before 3: the main path's tail width and first batch pick the
    # timed merge shapes)
    corpus, columns, searcher = phase_index(dev, NUM_DOCS, VOCAB, DRAWS, SEGMENTS)
    log(f"index: torch.cuda.memory_allocated {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
    main_n = fused_tail_width(searcher)
    singles, batches = sample_search_queries(corpus)
    offs, _lens, _w, run_len = batch_plan(searcher, batches[0])
    batch_n = offs.shape[1] * run_len

    # 3. kernels vs twins
    widths = sorted({1 << p for p in range(15, 20)} | {main_n, batch_n})
    stats = phase_kernels(dev, widths, batch_n)
    stats.update(phase_accel_kernels(dev, searcher, batches[0]))
    torch.cuda.empty_cache()

    # 5. search on the main path
    kernels.reset_launch_counts()
    syncs0 = (dense_fused.HOST_SYNCS["window_certificate"],
              merge_scoring.HOST_SYNCS["hierarchical_topk"])
    branch0 = merge_branches()
    res = phase_search(corpus, searcher, singles, batches)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    syncs = (dense_fused.HOST_SYNCS["window_certificate"] - syncs0[0],
             merge_scoring.HOST_SYNCS["hierarchical_topk"] - syncs0[1])
    branches = _branch_delta(branch0)
    log(f"search: launches {launches}")
    log(f"search: specs by path {res['paths']}; host syncs window {syncs[0]}, "
        f"hierarchical_topk {syncs[1]}; window branch {dense_fused.WINDOW_BRANCH}; "
        f"merge branch {branches}")
    missing = [k for k in KERNEL_SOURCES
               if k not in BUCKET_KERNELS + DENSE_TAIL_KERNELS + VECTOR_KERNELS
               and launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if res["paths"]["fused"] == 0 or res["paths"]["merge"] == 0:
        raise AssertionError(f"both paths must serve: {res['paths']}")
    if any(b != {"alt": 1, "plain": 0} for b in res["batch_branches"]):
        raise AssertionError(f"a B=32 batch left the alternating branch: {res['batch_branches']}")
    p50_1 = 1e3 * float(np.median(res["lat1"]))
    p50_32 = 1e3 * float(np.median(res["lat32"]))
    log(f"search: p50 latency B=1 {p50_1:.2f} ms (n={len(res['lat1'])}), B=32 "
        f"{p50_32:.2f} ms (n={len(res['lat32'])}) | {card}")
    per_batch = launches_per_batch(searcher, singles[0], batches[0])
    prof = profile_batch(searcher, batches[0])
    log(f"profile: first B={BATCH} batch, device busy {prof['device_busy_ms']:.3f} ms "
        f"({100 * prof['device_busy_ms'] / p50_32:.1f}% of the B={BATCH} p50; traced wall "
        f"{prof['traced_wall_ms']:.3f} ms); top device items {json.dumps(prof['top'])} | {card}")
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiled batch ran nothing on the device")
    one = profile_call(lambda: searcher.search(_match(singles[0]), TOP_K))
    log(f"profile: fused B=1 single, device busy {one['device_busy_ms']:.3f} ms in "
        f"{one['device_items']} device items ({100 * one['device_busy_ms'] / p50_1:.1f}% of "
        f"the B=1 p50; traced wall {one['traced_wall_ms']:.3f} ms); top device items "
        f"{json.dumps(one['top'][:6])} | {card}")
    if one["device_busy_ms"] <= 0:
        raise AssertionError("the profiled single ran nothing on the device")

    # 6. against the independent numpy answer
    ex = phase_exact(corpus, res)
    log(f"exact: 8 singles within {FUSED_REL} (worst {ex['fused_rel']:.3g}), "
        f"conjunction {res['conj']} hits {ex['conj_hits']} exact, scores within "
        f"{MERGE_REL} (worst {ex['merge_rel']:.3g}); near-tie doc swaps {ex['swaps']}")

    # 7. ingest on the card
    ing = phase_ingest(dev)
    log(f"ingest: {ing['docs']} docs, {ing['queries_checked']} queries; merge bit-equal, "
        f"fused within {CPU_GPU_FUSED_REL} between cuda and cpu")

    # 8. the bucket path
    bucket = phase_bucket(dev, searcher, singles, batches, card)
    stats.update(bucket["stats"])
    launches.update(bucket["launches"])
    per_batch.update(bucket["per_batch"])

    # 9. config #3 on the same index, then the commit round trip
    config3 = phase_config3(corpus, columns, searcher, batches[0], card)
    phase_commit(dev)

    # 10. the served path: the port's gRPC server on the same index, and
    # 12. the general evaluator on that node, before its ingest
    def general(server, client, rt, index_dir):
        return phase_general(dev, corpus, columns, server, client, rt, index_dir, card)

    served = phase_served(dev, corpus, columns, searcher, singles, batches[0], card,
                          general=general)
    general_launches = served["general"]["launches"]

    # 11. replication: a PRIMARY and a REPLICA of the same index on the card
    replication = phase_replication(dev, corpus, columns, searcher, singles, batches[0], card)

    # 13. the write path: deletes, upserts and doc-value updates on a node
    # over the same index, every path on the deleted index, a replica
    write = phase_write(dev, corpus, columns, searcher, singles, batches, card)

    # 14. vector search and the result tail: three vector fields beside the
    # same corpus, kNN, the served hybrid and result tail, writes, a replica
    vectors = phase_vectors(dev, corpus, columns, singles, card)
    stats.update(vectors["stats"])
    launches.update(vectors["engine_launches"])
    per_batch.update(vectors["per_batch"])

    # 15. term positions: positional queries on the 1M-doc index, then
    # nested documents and the field types that need positions, served
    phrases = phase_phrases(dev, corpus, columns, card)
    nested = phase_nested(dev, card)
    log(f"phase 15: {phrases['seconds'] + nested['seconds']:.1f} s | {card}")

    # 16. virtual shards on meshes of one card, also through a served node
    # over the same index; 18. the standalone bucket API
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="mesh_")
    server = client = None
    try:
        server, client, rt, _index_dir = start_served(dev, searcher, root, singles, card)
        node = (server, client, rt)
        mesh = phase_mesh(dev, corpus, columns, searcher, singles, batches[0], node, card)
    finally:
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
        server = client = rt = node = None
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    standalone = phase_bucket_standalone(dev, searcher, singles, card)

    # 19. the flagship model: its five routes at bench.py's configuration,
    # and the segment builder's native accumulator
    flagship = phase_flagship(dev, corpus, card)

    table = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        st = stats[name]
        bound_ms, bound_by = bound(st["bytes"], st["ops"], st.get("ops_per_s", OPS_PER_S))
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": st["max_abs_err"],
            "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": st.get("library_ms"),
            "library": LIBRARY[name], "share_of_bound": bound_ms / st["ms"],
            "launches_per_batch": per_batch[name], "shape": st["shape"],
            "launches_config3": config3["launches"].get(name, 0),
            "launches_per_config3_request": config3["per_request"].get(name, 0),
            "launches_served": served["launches"].get(name, 0),
            "launches_replica": replication["launches"].get(name, 0),
            "launches_general": general_launches.get(name, 0),
            "launches_write": write["launches"].get(name, 0),
            "launches_vectors": vectors["launches"].get(name, 0),
            "launches_mesh": mesh["launches"].get(name, 0),
            "launches_bucket_standalone": standalone["launches"].get(name, 0),
            "launches_flagship": flagship["launches"].get(name, 0),
        })
        if name == "head_scores":
            table[-1].update({k: st[k] for k in ("parent_ms", "index_select_ms", "max_rel_err",
                                                 "max_exact_rel_err", "shapes")})
        log(f"table {name} {st['shape']}: {st['ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {100 * bound_ms / st['ms']:.1f}%), plain {st['plain_ms']:.4f} ms, "
            f"library {st.get('library_ms')} ({LIBRARY[name]})"
            + (f", parent's sequence {st['parent_ms']:.4f} ms, index_select "
               f"{st['index_select_ms']:.4f} ms" if "parent_ms" in st else "")
            + f"; launches {launches[name]}, "
            f"{per_batch[name]} per batch, {config3['launches'].get(name, 0)} in config #3 "
            f"({config3['per_request'].get(name, 0)} per column request), "
            f"{served['launches'].get(name, 0)} served, "
            f"{replication['launches'].get(name, 0)} served by the replica, "
            f"{general_launches.get(name, 0)} in the general phase, "
            f"{write['launches'].get(name, 0)} on the deleted index, "
            f"{vectors['launches'].get(name, 0)} in the hybrid request, "
            f"{mesh['launches'].get(name, 0)} on the meshes, "
            f"{standalone['launches'].get(name, 0)} in the standalone bucket search, "
            f"{flagship['launches'].get(name, 0)} on the flagship routes | {card}")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
