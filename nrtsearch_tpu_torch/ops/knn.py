"""Vector search: batched brute-force similarity products (+ IVF
partitioning) on torch tensors (counterpart: nrtsearch_tpu/ops/knn.py).

Replaces Lucene's HNSW graph walk (reference: VectorFieldDef.java:91-94)
with one [B, dims] x [dims, D] product per segment: exact results, recall@k
= 1.0 by construction. IVF (cluster pruning) probes the top clusters and
scores their members exactly. The reference computes the product outside
any Pallas kernel (``lax.dot_general``); here it is a torch product, and the
top-k goes through ``ops/topk.py`` so that ties prefer the lower doc id, as
``lax.top_k`` does.

Similarity -> score mappings match Lucene's VectorSimilarityFunction:

    l2_norm:            1 / (1 + ||q - v||^2)
    dot_product:        (1 + q.v) / 2
    cosine / normalized_cosine: (1 + cos(q, v)) / 2
    max_inner_product:  q.v >= 0 ? q.v + 1 : 1 / (1 - q.v)

Storage formats and their products, each with f32 (or exact int32)
accumulation as the reference's ``preferred_element_type``:

- float32: an f32 product (TF32 off on the card, ``device.exact_cuda_matmul``);
- float16 (bf16 storage): the queries round to bf16 and the product of two
  bf16 operands accumulates in f32 with an f32 output (on the card
  ``torch.mm(..., out_dtype=torch.float32)``, on the CPU an f32 product of
  the bf16 values, whose products are exact in f32); norms are measured in
  the rounded space (``rounded_sq_norms``);
- int8: each query row quantizes with its own scale and the product is int8
  x int8 -> int32: ``torch._int_mm`` on the card, which needs more than 16
  rows and k, n multiples of 8 (query rows pad to 32, dims with zeros to a
  multiple of 8: zeros change no dot product); on the CPU an f64 product of
  the int8 values, exact while 127^2 * dims < 2^53. Norms are those of the
  quantized vectors (``quantized_sq_norms``).

The per-column squared norms have the same value on every query: the
port's ``VectorColumn`` computes them once, on the device, when the column
is built or loaded, where the reference recomputes them per query.

``knn_search_batch`` is the engine's kNN path (``Searcher.knn_search_batch``,
and ``Searcher.knn_search`` as its batch of one): per segment one product of
all B queries against the column's rows and a masked top k, then the
segments' candidates merge on the device by (score desc, global doc id
asc), Lucene's order, with no host sync; ``batch_to_host`` is its one read
of the results to the host, counted in ``KNN_READBACKS``.

The per-segment step (``segment_top_k``) of an f32 column on the card is
one hand-written kernel (``kernels.knn_topk``, csrc/knn_topk.cu): the f32
products on the FFMA units, the score, the mask and each block's top k of
each query in one pass, writing only those candidates, which one
``torch.topk`` reduces to the segment's top k; a k past the kernel's
buffer (``kernels.KNN_MAX_K``) takes more passes, each below the last
one's k-th key. ``segment_top_k_plain`` (``_scores`` + ``masked_top_k``)
serves CPU tensors, bf16 and int8 columns. ``KNN_SEGMENTS`` counts the
segments on each route.
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch import kernels
from nrtsearch_tpu_torch.device import exact_cuda_matmul, on_cuda, resolve_device, scalar_f32
from nrtsearch_tpu_torch.ops.dense_fused import _mm as bf16_mm_f32
from nrtsearch_tpu_torch.ops.topk import f32_from_order_keys, f32_order_keys, \
    lowest_index_keys, masked_top_k, topk_f32_total_order, topk_lowest_index

SIMILARITIES = (
    "l2_norm", "dot_product", "cosine", "normalized_cosine", "max_inner_product",
)

# torch._int_mm's shape rules on CUDA: more than 16 rows, k and n multiples of 8
INT_MM_MIN_ROWS = 32
INT_MM_MULTIPLE = 8

# reads of the kNN path's results to the host (``batch_to_host``): one per
# batch; a plain counter dict, as the ops' HOST_SYNCS
KNN_READBACKS: dict[str, int] = {"results": 0}
# segments through the kernel (``fused``) and through ``segment_top_k_plain``
KNN_SEGMENTS: dict[str, int] = {"fused": 0, "plain": 0}


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if on_cuda(a):
        exact_cuda_matmul()
    return torch.mm(a, b)


def pad_dims(x: torch.Tensor) -> torch.Tensor:
    """``x`` [n, dims] with zero columns up to a multiple of 8 (itself when
    dims already is one)."""
    extra = (-x.shape[1]) % INT_MM_MULTIPLE
    if not extra:
        return x
    return torch.nn.functional.pad(x, (0, extra))


def _int8_dots(qq: torch.Tensor, q_values: torch.Tensor) -> torch.Tensor:
    """Exact int32 [B, D] dots of int8 [B, dims] and int8 [D, dims]."""
    if not on_cuda(qq):
        return torch.mm(qq.to(torch.float64), q_values.to(torch.float64).T).to(torch.int32)
    B, D = qq.shape[0], q_values.shape[0]
    if D % INT_MM_MULTIPLE:
        raise ValueError(f"int8 kNN on the card needs a doc count that is a multiple "
                         f"of {INT_MM_MULTIPLE} (vector columns' rows are), got {D}")
    rows = max(INT_MM_MIN_ROWS, B + (-B) % INT_MM_MULTIPLE)
    a = torch.zeros((rows, qq.shape[1]), dtype=torch.int8, device=qq.device)
    a[:B] = qq
    return torch._int_mm(pad_dims(a), pad_dims(q_values).T)[:B]


def rounded_sq_norms(values: torch.Tensor) -> torch.Tensor:
    """Squared norms of bf16 rows measured in the rounded space, f32 (the
    reference's ``_scores`` bf16 branch)."""
    vf = values.float()
    return torch.sum(vf * vf, dim=1)


def quantized_sq_norms(q_values: torch.Tensor, scale: float) -> torch.Tensor:
    """Squared norms of int8 rows in the quantized space, f32: an exact
    int32 sum times the scale twice (the reference's ``v_sq_hat``)."""
    v32 = q_values.to(torch.int32)
    s = np.float32(scale)
    return torch.sum(v32 * v32, dim=1, dtype=torch.int32).to(torch.float32) * s * s


def _transform(dots, q_sq, q_norm_of, vec_sq_norms, similarity: str):
    """Score mapping of [B, D] dots (``q_norm_of()`` gives [B, 1] query
    norms; a lambda, so only cosine computes them)."""
    if similarity == "l2_norm":
        d2 = torch.clamp_min(q_sq + vec_sq_norms[None, :] - 2.0 * dots, 0.0)
        return 1.0 / (1.0 + d2)
    if similarity == "dot_product":
        return (1.0 + dots) / 2.0
    if similarity in ("cosine", "normalized_cosine"):
        v_norm = torch.sqrt(vec_sq_norms)[None, :]
        cos = dots / torch.clamp_min(q_norm_of() * v_norm, 1e-30)
        return (1.0 + cos) / 2.0
    if similarity == "max_inner_product":
        return torch.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))
    raise ValueError(f"unknown similarity {similarity!r}")


def _scores(queries: torch.Tensor, vectors: torch.Tensor, vec_sq_norms: torch.Tensor,
            similarity: str) -> torch.Tensor:
    """Similarity scores [B, D] from one product. For a bf16 matrix
    ``vec_sq_norms`` are its rounded-space norms (``rounded_sq_norms``), and
    the queries round to bf16 first, as in the reference."""
    if vectors.dtype == torch.bfloat16:
        qb = queries.to(torch.bfloat16)
        dots = bf16_mm_f32(qb, vectors.T)
        # as the reference's jitted program computes them: the bf16 queries
        # squared and summed in f32, the sum rounded to bf16, its root in f32
        qf = qb.float()
        q_sq = torch.sum(qf * qf, dim=1, keepdim=True).to(torch.bfloat16).float()
    else:
        dots = _f32_mm(queries, vectors.T)
        q_sq = torch.sum(queries * queries, dim=1, keepdim=True)
    return _transform(dots, q_sq, lambda: torch.sqrt(q_sq), vec_sq_norms, similarity)


def quantize_int8(vectors: np.ndarray) -> tuple[np.ndarray, float]:
    """Symmetric scalar quantization: q = round(v / scale), clipped, with
    the scale from the 99.9% quantile of |v| (the reference's, on the host,
    bit for bit)."""
    if not vectors.size:
        return np.zeros_like(vectors, dtype=np.int8), 1.0
    peak = float(np.quantile(np.abs(vectors), 0.999))
    if peak <= 0:
        peak = float(np.abs(vectors).max()) or 1.0
    scale = peak / 127.0
    q = np.clip(np.round(vectors / scale), -127, 127).astype(np.int8)
    return q, scale


def _quantized_scores(queries: torch.Tensor, q_values: torch.Tensor, scale: float,
                      v_sq_hat: torch.Tensor, similarity: str) -> torch.Tensor:
    """Scores from int8-stored vectors: each query row quantizes with its
    own scale, the dot is int8 x int8 -> int32, and ``v_sq_hat`` are the
    quantized-space norms (``quantized_sq_norms``)."""
    q_peak = torch.amax(torch.abs(queries), dim=1, keepdim=True)
    one = torch.ones((), dtype=torch.float32, device=queries.device)
    # a 0-d divisor: CUDA divides by a Python number through its reciprocal
    q_scale = torch.where(q_peak > 0, q_peak / scalar_f32(127.0, queries.device), one)
    qq = torch.clamp(torch.round(queries / q_scale), -127, 127).to(torch.int8)
    dots_i = _int8_dots(qq, q_values)
    dots = dots_i.to(torch.float32) * (q_scale * np.float32(scale))
    if similarity == "l2_norm":
        q_sq = torch.sum(queries * queries, dim=1, keepdim=True)
        return _transform(dots, q_sq, None, v_sq_hat, similarity)
    if similarity in ("cosine", "normalized_cosine"):
        q_norm = torch.sqrt(torch.sum(queries * queries, dim=1, keepdim=True))
        v_norm = torch.sqrt(torch.clamp_min(v_sq_hat, 1e-30))[None, :]
        cos = dots / torch.clamp_min(q_norm * v_norm, 1e-30)
        return (1.0 + cos) / 2.0
    return _transform(dots, None, None, v_sq_hat, similarity)


def fused_route(values: torch.Tensor, scale: float | None = None) -> bool:
    """Whether ``segment_top_k`` takes the kernel: f32 rows on the card."""
    return scale is None and values.dtype == torch.float32 and on_cuda(values)


def segment_top_k(values: torch.Tensor, score_sq_norms: torch.Tensor, mask: torch.Tensor,
                  queries: torch.Tensor, *, similarity: str, k: int,
                  scale: float | None = None):
    """The per-segment step of every kNN entry point: the top k of the
    queries [B, dims] against ``values`` [rows, dims] where ``mask`` holds,
    by (score desc, id asc). ``mask`` is read over its first ``rows``
    entries, so a segment's [capacity] mask and a column's [rows] mask both
    serve. The kernel (``fused_segment_top_k``) where ``fused_route`` says
    so, else ``segment_top_k_plain``; counted in ``KNN_SEGMENTS``. Returns
    (scores [B, k], ids [B, k] int64, matches: the eligible rows, [B] from
    the kernel, [1] from the plain version)."""
    if fused_route(values, scale):
        KNN_SEGMENTS["fused"] += 1
        return fused_segment_top_k(values, score_sq_norms, mask, queries,
                                   similarity=similarity, k=k)
    KNN_SEGMENTS["plain"] += 1
    return segment_top_k_plain(values, score_sq_norms, mask, queries, similarity=similarity,
                               k=k, scale=scale)


def fused_segment_top_k(values: torch.Tensor, score_sq_norms: torch.Tensor,
                        mask: torch.Tensor, queries: torch.Tensor, *, similarity: str,
                        k: int):
    """``segment_top_k`` of f32 rows on the card by the kernel
    (``kernels.knn_topk``), the queries' squared sums taken as ``_scores``
    takes them: each block's top k of each query, then the top k of the
    [B, blocks * k] candidates by one ``torch.topk`` (their int64 keys order
    as (score desc, id asc)). A k past ``kernels.KNN_MAX_K`` takes passes
    of at most that many, each pass's ceiling the last one's k-th key."""
    rows = values.shape[0]
    B = queries.shape[0]
    if k > rows:
        raise ValueError(f"k={k} must not exceed the width {rows}")
    q = queries.to(torch.float32).contiguous()
    q_sq = None
    if similarity in ("l2_norm", "cosine", "normalized_cosine"):
        q_sq = torch.sum(queries * queries, dim=1, keepdim=True).reshape(-1)
    v_sq, m = score_sq_norms[:rows].contiguous(), mask[:rows].contiguous()
    if B == 0 or k == 0:
        return (torch.empty((B, k), dtype=torch.float32, device=values.device),
                torch.empty((B, k), dtype=torch.int64, device=values.device),
                m.sum(dtype=torch.int32).expand(B))
    tops, ceiling, part = [], None, None
    for done in range(0, k, kernels.KNN_MAX_K):
        kp = min(kernels.KNN_MAX_K, k - done)
        cands, p = kernels.knn_topk(values, v_sq, m, q, q_sq, similarity, kp, ceiling)
        part = p if part is None else part
        tops.append(torch.topk(cands.view(B, -1), kp, dim=1).values)
        ceiling = tops[-1][:, -1].contiguous() if kp < k - done else None
    top = tops[0] if len(tops) == 1 else torch.cat(tops, dim=1)
    # the keys of ``lowest_index_keys``: the order key above, 2^32 - 1 - id below
    low = (1 << 32) - 1
    return (f32_from_order_keys((top >> 32).to(torch.int32)), low - (top & low),
            part.sum(dtype=torch.int32).expand(B))


def segment_top_k_plain(values: torch.Tensor, score_sq_norms: torch.Tensor,
                        mask: torch.Tensor, queries: torch.Tensor, *, similarity: str,
                        k: int, scale: float | None = None):
    """The plain per-segment step: one product of the queries [B, dims]
    against ``values`` [rows, dims] (``_scores``, or ``_quantized_scores``
    when ``scale`` is given: int8 storage), and the top k where ``mask``
    holds (``masked_top_k``: ties to the lower id). Returns (scores [B, k],
    ids [B, k] int64, matches [1])."""
    if scale is None:
        scores = _scores(queries, values, score_sq_norms, similarity)
    else:
        scores = _quantized_scores(queries, values, scale, score_sq_norms, similarity)
    return masked_top_k(scores, mask[None, :values.shape[0]], k)


def knn_search_quantized(q_values: torch.Tensor, scale: float, v_sq_hat: torch.Tensor,
                         mask: torch.Tensor, queries: torch.Tensor, *, similarity: str,
                         k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over int8 [D, dims] vectors (``v_sq_hat``: their quantized-space
    squared norms), where ``mask`` holds (``segment_top_k``). Returns
    (scores [B, k], ids [B, k] int64)."""
    top_s, top_i, _ = segment_top_k(q_values, v_sq_hat, mask, queries,
                                    similarity=similarity, k=k, scale=scale)
    return top_s, top_i


def knn_search(vectors: torch.Tensor, vec_sq_norms: torch.Tensor, mask: torch.Tensor,
               queries: torch.Tensor, *, similarity: str,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over f32 or bf16 [D, dims] vectors (``vec_sq_norms`` as
    ``_scores`` takes them), where ``mask`` holds (``segment_top_k``).
    Returns (scores [B, k], ids [B, k] int64); ties to the lower id."""
    top_s, top_i, _ = segment_top_k(vectors, vec_sq_norms, mask, queries,
                                    similarity=similarity, k=k)
    return top_s, top_i


def knn_search_batch(columns, masks, bases, queries, *, similarity: str, k: int,
                     rank: int = 1) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top k of a batch of queries over a snapshot's segments.

    ``columns`` are the segments' ``VectorColumn``s of one field, ``masks``
    their bool masks (present & live & the filter, [rows] or [capacity]),
    ``bases`` the global doc id of each column's first row, ``queries`` f32
    [B, dims] (host or device). Per segment ``segment_top_k``: one product
    of all B queries against the column's rows and the masked top min(k,
    rows), ties to the lower doc id. The
    candidates merge on the first column's device into the top min(k,
    candidates) by (score desc, global doc id asc); ``rank`` -1 orders the
    merge by score ascending and 0 by doc id alone (a negative or zero
    boost, applied to the scores by the caller). No host sync.

    Returns device tensors, batch first: (scores f32 [B, k'], global docs
    int64 [B, k'], total hits int64 [B]); a slot past a query's hits has
    score -inf."""
    dev = columns[0].values.device
    on_dev: dict = {}
    cand_s, cand_d = [], []
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for col, mask, base in zip(columns, masks, bases):
        d = col.values.device
        q = on_dev.get(d)
        if q is None:
            q = on_dev[d] = torch.as_tensor(queries, dtype=torch.float32, device=d)
        top_s, top_i, n = segment_top_k(
            col.values, col.score_sq_norms, mask, q, similarity=similarity, k=min(k, col.rows),
            scale=col.scale if col.fmt == "int8" else None)
        cand_s.append(top_s.to(dev, non_blocking=True))
        cand_d.append((top_i + int(base)).to(dev, non_blocking=True))
        hits = hits + n.to(dev, torch.int64, non_blocking=True)[0]
    s, docs = torch.cat(cand_s, dim=1), torch.cat(cand_d, dim=1)
    valid = s > float("-inf")
    if rank > 0:
        order = f32_order_keys(s)
    else:
        order = f32_order_keys(-s) if rank < 0 else torch.zeros_like(s, dtype=torch.int32)
    lowest = torch.full((), torch.iinfo(torch.int32).min, dtype=torch.int32, device=dev)
    keys = lowest_index_keys(torch.where(valid, order, lowest), docs)
    pos = torch.topk(keys, min(k, s.shape[1]), dim=1).indices
    return (torch.gather(s, 1, pos), torch.gather(docs, 1, pos),
            hits.expand(s.shape[0]).clone())


def batch_to_host(scores: torch.Tensor, docs: torch.Tensor,
                  hits: torch.Tensor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``knn_search_batch``'s results on the host in one read (counted in
    ``KNN_READBACKS``): (scores f32 [B, k], docs int64 [B, k], hits int64
    [B])."""
    k = scores.shape[1]
    packed = torch.cat([scores.view(torch.int32).to(torch.int64), docs, hits[:, None]],
                       dim=1).cpu().numpy()
    KNN_READBACKS["results"] += 1
    return (packed[:, :k].astype(np.int32).view(np.float32), packed[:, k:2 * k],
            packed[:, 2 * k])


# ---------------------------------------------------------------------------
# IVF: coarse k-means partitioning for very large corpora
# ---------------------------------------------------------------------------


def kmeans_fit(vectors: np.ndarray, n_clusters: int, iters: int = 10, seed: int = 0,
               device: str | torch.device = "cuda") -> np.ndarray:
    """Lloyd iterations on ``device`` from ``n_clusters`` seeded picks ->
    centroids [C, dims] (numpy)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(vectors), size=n_clusters, replace=False)
    centroids = torch.as_tensor(np.asarray(vectors[idx], np.float32), device=dev)
    data = torch.as_tensor(np.asarray(vectors, np.float32), device=dev)
    data_sq = torch.sum(data * data, dim=1)[:, None]
    for _ in range(iters):
        d = (data_sq - 2.0 * _f32_mm(data, centroids.T)
             + torch.sum(centroids * centroids, dim=1)[None, :])
        assign = torch.argmin(d, dim=1)
        one_hot = torch.nn.functional.one_hot(assign, n_clusters).to(torch.float32)
        sums = _f32_mm(one_hot.T, data)
        counts = one_hot.sum(dim=0)[:, None]
        centroids = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), centroids)
    return centroids.cpu().numpy()


def _ivf_search_step(blocks, block_sq, block_ids, centroids, c_sq, queries, *,
                     similarity: str, k: int, nprobe: int):
    """Centroid probe -> gather member blocks -> exact scores -> top-k."""
    c_scores = _scores(queries, centroids, c_sq, similarity)
    _, top_c = topk_lowest_index(c_scores, nprobe)        # [B, nprobe]
    sub = blocks[top_c]                                   # [B, np, cap, dims]
    sub_sq = block_sq[top_c]                              # [B, np, cap]
    sub_ids = block_ids[top_c]                            # [B, np, cap]
    if on_cuda(queries):
        exact_cuda_matmul()
    dots = torch.einsum("bd,bpcd->bpc", queries, sub)
    q_sq = torch.sum(queries * queries, dim=1)[:, None, None]
    if similarity == "l2_norm":
        scores = 1.0 / (1.0 + torch.clamp_min(q_sq + sub_sq - 2.0 * dots, 0.0))
    elif similarity == "dot_product":
        scores = (1.0 + dots) / 2.0
    elif similarity in ("cosine", "normalized_cosine"):
        cos = dots / torch.clamp_min(torch.sqrt(q_sq) * torch.sqrt(sub_sq), 1e-30)
        scores = (1.0 + cos) / 2.0
    elif similarity == "max_inner_product":
        scores = torch.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))
    else:
        raise ValueError(f"unknown similarity {similarity!r}")
    B = queries.shape[0]
    neg = torch.full((), float("-inf"), dtype=torch.float32, device=queries.device)
    flat_s = torch.where((sub_ids >= 0).reshape(B, -1), scores.reshape(B, -1), neg)
    flat_i = sub_ids.reshape(B, -1)
    top_s, pos = topk_f32_total_order(flat_s, k)
    top_i = torch.gather(flat_i, 1, pos)
    # padding slots carry id -1 at -inf; clamp so callers that index with
    # the ids never see the sentinel (the scores mark invalid rows)
    return top_s, torch.clamp_min(top_i, 0)


class IVFIndex:
    """Inverted-file vector index on ``device``: probe the top clusters,
    score their members exactly. Clusters are padded to one capacity (at
    most 4x the mean; larger clusters spill into more blocks that share the
    centroid) and stacked [n_blocks, cap, dims], so a probe is one gather
    and one product. The layout is the reference's, built on the host."""

    def __init__(self, vectors: np.ndarray, n_clusters: int, similarity: str,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.similarity = similarity
        vectors = np.asarray(vectors, np.float32)
        self.centroids = kmeans_fit(vectors, n_clusters, seed=seed, device=self.device)
        d = (
            np.sum(vectors * vectors, axis=1)[:, None]
            - 2.0 * vectors @ self.centroids.T
            + np.sum(self.centroids * self.centroids, axis=1)[None, :]
        )
        assign = np.argmin(d, axis=1)
        counts = np.bincount(assign, minlength=n_clusters)
        mean = max(int(np.ceil(counts.sum() / max(n_clusters, 1))), 1)
        cap = max(min(int(counts.max()), 4 * mean), 1)
        dims = vectors.shape[1]
        order = np.argsort(assign, kind="stable")        # docs by cluster, doc order kept
        starts = np.concatenate([[0], np.cumsum(counts)])
        block_docs: list[np.ndarray] = []
        centroid_of_block = []
        for c in range(n_clusters):
            docs = order[starts[c]:starts[c + 1]]
            for start in range(0, max(len(docs), 1), cap):
                block_docs.append(docs[start:start + cap])
                centroid_of_block.append(c)
        n_blocks = len(block_docs)
        blocks = np.zeros((n_blocks, cap, dims), np.float32)
        block_ids = np.full((n_blocks, cap), -1, np.int32)
        for bi, docs in enumerate(block_docs):
            blocks[bi, :len(docs)] = vectors[docs]
            block_ids[bi, :len(docs)] = docs
        put = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.blocks = put(blocks)
        self.block_sq = put((blocks * blocks).sum(-1).astype(np.float32))
        self.block_ids = put(block_ids.astype(np.int64))
        block_centroids = self.centroids[centroid_of_block].astype(np.float32)
        self.n_blocks = n_blocks
        self.cap = cap
        self.centroids_dev = put(block_centroids)
        self.c_sq = put(np.sum(block_centroids * block_centroids, axis=1).astype(np.float32))

    def search(self, queries: np.ndarray, k: int, nprobe: int = 8):
        """Approximate top-k. Returns (scores [B, k], ids [B, k]) as numpy."""
        nprobe = min(nprobe, self.n_blocks)
        k_eff = min(k, nprobe * self.cap)
        s, i = _ivf_search_step(
            self.blocks, self.block_sq, self.block_ids, self.centroids_dev, self.c_sq,
            torch.as_tensor(np.asarray(queries, np.float32), device=self.device),
            similarity=self.similarity, k=k_eff, nprobe=nprobe,
        )
        s, i = s.cpu().numpy(), i.cpu().numpy().astype(np.int32)
        if k_eff < k:
            s = np.pad(s, ((0, 0), (0, k - k_eff)), constant_values=-np.inf)
            i = np.pad(i, ((0, 0), (0, k - k_eff)))
        return s, i
