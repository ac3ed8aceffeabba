"""Doc-sharded, batch-sharded search over a (shard, data) grid of devices
(counterpart: nrtsearch_tpu/parallel/distributed.py).

Mesh axes, as the reference's:

- ``shard``: the corpus is partitioned round-robin by doc ord into document
  shards (global ord = local * S + shard), one per grid row: the
  re-expression of the reference's virtual shards
  (MyIndexSearcher.slicesForShards). Each shard scores its docs with the
  port's merge or fused path, then the candidates merge into one top k.
- ``data``: the padded query batch is split into ``data`` slices, slice j
  served by grid column j.

The reference is one SPMD program over its mesh (``shard_map`` with an
``all_gather`` top-k merge and a ``psum`` of hit counts). The port keeps its
single-controller model: one process drives every device of the grid, with
no ``torch.distributed``. It launches every shard's work before it reads
anything back, so that shards on distinct cards overlap; then each shard's
top k moves to the grid's first device of its column and the merge is a
stable sort by global ord and the lowest-index top k there (ties by doc
ascending, as the reference's ``lax.top_k`` over the ord-sorted candidates).
A grid may repeat one device: that is the port's analogue of the reference's
8 virtual host devices, how CPU tests run a (4, 2) mesh on ``[cpu] * 8`` and
how one card runs S shards.

The host repartition (a lexsort per shard, host impacts) is the reference's
numpy, so each shard's postings are bit-equal to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch import device as _device
from nrtsearch_tpu_torch.ops.bm25 import lucene_idf
from nrtsearch_tpu_torch.ops.merge_scoring import merge_score_topk, plan_runs
from nrtsearch_tpu_torch.ops.topk import topk_f32_total_order, topk_lowest_index

_I32_MAX = 2**31 - 1


@dataclass
class SearchMesh:
    """A (shard, data) grid of torch devices (the reference's ``Mesh``)."""

    devices: np.ndarray   # object [S, data] of torch.device

    @property
    def shape(self) -> dict:
        return {"shard": self.devices.shape[0], "data": self.devices.shape[1]}

    @property
    def on_cuda(self) -> bool:
        """Every device a card: the merge takes its accelerator branch (the
        reference: every mesh device a TPU)."""
        return all(d.type == "cuda" for d in self.devices.flat)


def make_search_mesh(
    n_devices: int | None = None, data_parallel: int | None = None,
    devices: Sequence[torch.device] | None = None,
) -> SearchMesh:
    """A (shard, data) grid over the first ``n_devices`` of ``devices``
    (default ``device.search_devices()``); ``data_parallel`` defaults to 2
    when the count is even and above 1 (the reference's
    distributed.py:34-43)."""
    if devices is None:
        devices = _device.search_devices()
    n = n_devices or len(devices)
    devs = list(devices[:n])
    if len(devs) < n:
        raise ValueError(f"{n} devices asked for, {len(devs)} available")
    if data_parallel is None:
        data_parallel = 2 if n % 2 == 0 and n > 1 else 1
    grid = np.empty((n // data_parallel, data_parallel), dtype=object)
    for i, d in enumerate(devs[: grid.size]):
        grid.flat[i] = torch.device(d)
    return SearchMesh(grid)


def _place(mesh: SearchMesh, arrays) -> list[list[torch.Tensor]]:
    """Per-shard host arrays (numpy or CPU tensors) -> [S][data] device
    tensors: shard s's array on every device of grid row s, one copy per
    distinct device."""
    out = []
    for s in range(mesh.shape["shard"]):
        host = torch.as_tensor(np.ascontiguousarray(arrays[s])) \
            if isinstance(arrays[s], np.ndarray) else arrays[s]
        copies: dict = {}
        row = []
        for dev in mesh.devices[s]:
            if dev not in copies:
                copies[dev] = host.to(dev)
            row.append(copies[dev])
        out.append(row)
    return out


def _slices(mesh: SearchMesh, B: int) -> list[tuple[int, int]]:
    """The batch rows of each grid column: B splits into ``data`` equal
    slices (B must be a multiple of ``data``)."""
    data = mesh.shape["data"]
    if B % data:
        raise ValueError(f"batch {B} is not a multiple of the data axis {data}")
    per = B // data
    return [(j * per, (j + 1) * per) for j in range(data)]


def _merge_candidates(scores, ids, hits, k: int, dev: torch.device, by_ord: bool = True):
    """Cross-shard merge of per-shard [b, k] top-k lists (global ids),
    gathered on ``dev``: the reference's all_gather + top-k
    (distributed.py:46-68). With ``by_ord`` the candidates are first sorted
    stably by global ord (-inf entries last), so the lowest-index top-k
    breaks ties by doc ascending; hits are summed over shards. Returns
    (scores [b, k], ids [b, k], hits [b])."""
    cand_s = torch.cat([s.to(dev, non_blocking=True) for s in scores], dim=1)
    cand_i = torch.cat([i.to(dev, non_blocking=True) for i in ids], dim=1)
    if by_ord:
        key = torch.where(cand_s > float("-inf"), cand_i,
                          torch.full((), _I32_MAX, dtype=cand_i.dtype, device=dev))
        order = torch.sort(key, dim=1, stable=True).indices
        cand_s = torch.gather(cand_s, 1, order)
        cand_i = torch.gather(cand_i, 1, order)
        top_s, pos = topk_lowest_index(cand_s, k)
    else:
        top_s, pos = topk_f32_total_order(cand_s, k)
    top_i = torch.gather(cand_i, 1, pos)
    total = None
    if hits is not None:
        total = hits[0].to(dev, non_blocking=True)
        for h in hits[1:]:
            total = total + h.to(dev, non_blocking=True)
    return top_s, top_i, total


def _cat_columns(parts: list[torch.Tensor]) -> torch.Tensor:
    """The data columns' results, in batch order, on the first column's
    device."""
    dev = parts[0].device
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim=0)


def _local_search(post_docs, post_impacts, offs, lens, weights, n_terms, *,
                  run_len: int, k: int, use_pallas: bool):
    """One shard's merge search (the reference's distributed.py:71-83):
    the port's merge_score_topk on the shard's device (its accelerator
    branch on CUDA)."""
    dev = post_docs.device
    return merge_score_topk(
        post_docs, post_impacts,
        torch.as_tensor(offs, device=dev), torch.as_tensor(lens, device=dev),
        torch.as_tensor(weights, device=dev), torch.as_tensor(n_terms, device=dev),
        run_len=run_len, k=k, use_pallas=use_pallas,
    )


def _local_dense(rows, rows_lo, post_docs, post_impacts, W, row_idx, n_req,
                 r_offs, r_lens, r_w, *, run_len: int, k: int, has_head: bool,
                 has_tail: bool):
    """One shard's fused dense search over its own head rows (the
    reference's distributed.py:86-124): ``dense_fused_topk`` with
    ``prune=False`` (the merged hit count carries no lower-bound flag, so
    every shard takes the exact combine) and zero ``row_max`` (only the
    window certificate reads it). On CUDA that is kernel #1 and the merge
    tail. Returns the shard's (scores, docs, hits)."""
    from nrtsearch_tpu_torch.ops.dense_fused import dense_fused_topk

    dev = rows.device

    def t(x):
        return torch.as_tensor(x, device=dev)

    packed = dense_fused_topk(
        rows, torch.zeros((rows.shape[0],), dtype=torch.float32, device=dev),
        post_docs, post_impacts, t(W), t(row_idx), t(n_req),
        t(r_offs), t(r_lens), t(r_w), rows_lo=rows_lo,
        k=k, has_head=has_head, has_tail=has_tail, run_len=run_len, prune=False,
    )
    scores = packed[:, :k].view(torch.float32)
    # empty slots carry doc -1: clamp so the global-ord map stays valid
    # (they sort last by their -inf score regardless)
    docs = torch.clamp(packed[:, k : 2 * k], min=0)
    return scores, docs, packed[:, 2 * k]


def _repartition(entry_term, entry_doc, entry_impact, V: int, S: int):
    """Round-robin repartition of flat postings entries into per-shard
    doc-sorted runs (the reference's numpy, distributed.py:245-263 and 181-194).
    Returns (post_docs [S, P], post_impacts [S, P], term_offsets [S, V],
    term_lengths [S, V])."""
    shard = (entry_doc % S).astype(np.int32)
    local_doc = (entry_doc // S).astype(np.int32)
    p_local_max = int(np.bincount(shard, minlength=S).max()) if len(shard) else 1
    p_pad = _pad_pow2(p_local_max + 16384)
    post_docs = np.zeros((S, p_pad), np.int32)
    post_impacts = np.zeros((S, p_pad), np.float32)
    term_offsets = np.zeros((S, V), np.int64)
    term_lengths = np.zeros((S, V), np.int32)
    for s in range(S):
        sel = shard == s
        t_s, d_s, i_s = entry_term[sel], local_doc[sel], entry_impact[sel]
        order = np.lexsort((d_s, t_s))
        t_s, d_s, i_s = t_s[order], d_s[order], i_s[order]
        post_docs[s, : len(d_s)] = d_s
        post_impacts[s, : len(i_s)] = i_s
        u, start, count = np.unique(t_s, return_index=True, return_counts=True)
        term_offsets[s, u] = start
        term_lengths[s, u] = count
    return post_docs, post_impacts, term_offsets, term_lengths


def _plan_shards(offs, lens, weights):
    """Per-shard run tables [S, B, R] at one shared run_len and R (the
    largest over shards), so every shard runs one shape (the reference's
    distributed.py:335-352)."""
    S, B = offs.shape[:2]
    planned = [plan_runs(offs[s], lens[s], weights[s]) for s in range(S)]
    run_len = max(p[3] for p in planned)
    if any(p[3] != run_len for p in planned):
        planned = [plan_runs(offs[s], lens[s], weights[s], force_run_len=run_len)
                   for s in range(S)]
    R = max(p[0].shape[1] for p in planned)
    out_offs = np.zeros((S, B, R), np.int32)
    out_lens = np.zeros((S, B, R), np.int32)
    out_w = np.zeros((S, B, R), np.float32)
    for s, (o, ln, w, _) in enumerate(planned):
        out_offs[s, :, : o.shape[1]] = o
        out_lens[s, :, : ln.shape[1]] = ln
        out_w[s, :, : w.shape[1]] = w
    return out_offs, out_lens, out_w, run_len


class DistributedBM25:
    """Doc-sharded, query-batch-sharded BM25 retrieval over a mesh (the
    reference's distributed.py:126-838)."""

    def __init__(self, mesh: SearchMesh, post_docs: np.ndarray, post_impacts: np.ndarray,
                 term_offsets: np.ndarray, term_lengths: np.ndarray,
                 doc_freq_global: np.ndarray, num_docs_total: int, shard_capacity: int,
                 k1: float = 1.2, b: float = 0.75, avgdl: float = 1.0):
        self.mesh = mesh
        self.shard_count = mesh.shape["shard"]
        # host postings are kept for the dense-row build (attach_dense);
        # query-time work never touches them
        self.post_docs_host = post_docs
        self.post_impacts_host = post_impacts
        self.post_docs = _place(mesh, post_docs)        # [S][data] int32 [P]
        self.post_impacts = _place(mesh, post_impacts)  # [S][data] f32 [P]
        self.term_offsets_host = term_offsets
        self.term_lengths_host = term_lengths
        self.doc_freq_global = doc_freq_global
        self.num_docs_total = num_docs_total
        self.shard_capacity = shard_capacity
        self.k1, self.b, self.avgdl = k1, b, avgdl
        self.vocab: dict[str, int] = {}
        self.columns: dict[str, dict] = {}
        self.dense_attached = False   # attach_dense has run
        self.dense_rows = None
        self.dense_rows_lo = None
        self.dense_head_pos: dict[int, int] = {}

    def device_bytes(self) -> int:
        """Bytes of this mesh's device tensors per shard (postings, dense
        rows and columns of grid column 0)."""
        n = 0
        for s in range(self.shard_count):
            ts = [self.post_docs[s][0], self.post_impacts[s][0]]
            if self.dense_rows is not None:
                ts.append(self.dense_rows[s][0])
            if self.dense_rows_lo is not None:
                ts.append(self.dense_rows_lo[s][0])
            for col in self.columns.values():
                ts += [col["values"][s][0], col["present"][s][0]]
            n += sum(t.numel() * t.element_size() for t in ts)
        return n // self.shard_count

    @classmethod
    def build(cls, corpus, mesh: SearchMesh) -> "DistributedBM25":
        """Partition a SyntheticCorpus (or any object with its packed
        postings arrays) round-robin into shards (the reference's
        distributed.py:143-207)."""
        S = mesh.shape["shard"]
        V = corpus.vocab_size
        avgdl = float(corpus.doc_lens.sum() / max(corpus.num_docs, 1))
        k1, b = 1.2, 0.75
        d_pad = _pad_pow2(int(np.ceil(corpus.num_docs / S)))
        entry_term = np.zeros(len(corpus.post_docs), np.int32)
        for t in range(V):
            off, ln = corpus.term_offsets[t], corpus.term_lengths[t]
            entry_term[off : off + ln] = t
        # precomputed impacts (global avgdl, Lucene collection stats)
        dl = corpus.doc_lens[corpus.post_docs]
        f = corpus.post_freqs
        entry_impact = (f / (f + k1 * (1.0 - b + b * dl / avgdl))).astype(np.float32)
        parts = _repartition(entry_term, np.asarray(corpus.post_docs, np.int64),
                             entry_impact, V, S)
        df = np.zeros(V, np.int64)
        df[: len(corpus.term_lengths)] = corpus.term_lengths
        return cls(mesh, *parts, doc_freq_global=df, num_docs_total=corpus.num_docs,
                   shard_capacity=d_pad, avgdl=avgdl)

    @classmethod
    def from_searcher(cls, searcher, field: str, mesh: SearchMesh) -> "DistributedBM25":
        """Place a real index's segments onto the mesh (the reference's
        distributed.py:209-298): the packed view's postings, with a global
        term dictionary across segments and live-folded host impacts,
        re-partitioned round-robin by global doc ord, as the reference
        bin-packs segments into virtual shards
        (MyIndexSearcher.slicesForShards)."""
        view = searcher.packed_view(field)
        if view.total_len == 0:
            raise ValueError(f"field {field!r} has no postings to distribute")
        vocab: dict[str, int] = {}
        entry_term_parts, entry_doc_parts, entry_imp_parts = [], [], []
        for idx, tfi, _run_base in view.seg_entries:
            base = int(searcher.bases[idx])
            seg = searcher.segments[idx]
            inv = [None] * len(tfi.terms)
            for term, tid in tfi.terms.items():
                inv[tid] = term
            gids = np.empty(len(inv), np.int32)
            for tid, term in enumerate(inv):
                gid = vocab.get(term)
                if gid is None:
                    gid = len(vocab)
                    vocab[term] = gid
                gids[tid] = gid
            # entries are laid out in tid order (the segment builder packs them so)
            entry_term_parts.append(np.repeat(gids, tfi.lengths[: len(inv)]))
            hd = tfi.host_doc_ids()
            entry_doc_parts.append(hd.astype(np.int64) + base)
            hf = tfi.freqs[: tfi.postings_len].cpu().numpy()
            dl = tfi.doc_lens.cpu().numpy()
            him = hf / (hf + view.k1 * (1.0 - view.b + view.b * dl[hd] / view.avgdl))
            entry_imp_parts.append(np.where(seg.host_live[hd], him, 0.0).astype(np.float32))
        entry_term = np.concatenate(entry_term_parts)
        entry_doc = np.concatenate(entry_doc_parts)
        entry_impact = np.concatenate(entry_imp_parts)
        V = len(vocab)
        df = np.zeros(V, np.int64)
        np.add.at(df, entry_term, 1)
        S = mesh.shape["shard"]
        d_pad = _pad_pow2(-(-int(searcher.max_doc) // S))
        dist = cls(mesh, *_repartition(entry_term, entry_doc, entry_impact, V, S),
                   doc_freq_global=df, num_docs_total=view.doc_count,
                   shard_capacity=d_pad, k1=view.k1, b=view.b, avgdl=view.avgdl)
        dist.vocab = vocab
        return dist

    def compile_text_queries(self, queries: Sequence[Sequence[str]], max_terms: int = 8):
        """String-term queries (the from_searcher path): terms map through
        the global vocab; unknown terms contribute nothing."""
        tid_queries = [[self.vocab[t] for t in q if t in self.vocab] for q in queries]
        return self.compile_queries(tid_queries, max_terms)

    def compile_queries(self, queries: Sequence[Sequence[int]], max_terms: int = 8):
        """Term-id queries -> per-shard [S, B, R] run tables, n_terms [S, B]
        and run_len (the reference's distributed.py:316-352)."""
        S = self.term_offsets_host.shape[0]
        B = len(queries)
        offs = np.zeros((S, B, max_terms), np.int64)
        lens = np.zeros((S, B, max_terms), np.int32)
        weights = np.zeros((S, B, max_terms), np.float32)
        n_terms = np.zeros((S, B), np.int32)
        for qi, qterms in enumerate(queries):
            n_terms[:, qi] = min(len(qterms), max_terms)
            for ti, term in enumerate(list(qterms)[:max_terms]):
                t = int(term)
                df = int(self.doc_freq_global[t])
                if df == 0:
                    continue
                w = lucene_idf(self.num_docs_total, df)
                offs[:, qi, ti] = self.term_offsets_host[:, t]
                lens[:, qi, ti] = self.term_lengths_host[:, t]
                weights[:, qi, ti] = w
        out_offs, out_lens, out_w, run_len = _plan_shards(offs, lens, weights)
        return out_offs, out_lens, out_w, n_terms, run_len

    # -- the merge mesh ------------------------------------------------------------

    def search(self, offs, lens, weights, n_terms, *, run_len: int, k: int = 10):
        """One distributed merge search (the reference's
        distributed.py:807-838). Returns (scores [B, k], global ids [B, k],
        hits [B]) on the grid's first device."""
        S = self.shard_count
        use_pallas = self.mesh.on_cuda
        local = [[_local_search(self.post_docs[s][j], self.post_impacts[s][j],
                                offs[s, b0:b1], lens[s, b0:b1], weights[s, b0:b1],
                                n_terms[s, b0:b1], run_len=run_len, k=k,
                                use_pallas=use_pallas)
                  for s in range(S)]
                 for j, (b0, b1) in enumerate(_slices(self.mesh, offs.shape[1]))]
        return self._merge_columns(local, k)

    def _merge_columns(self, local, k: int):
        """Per column j, the shards' (scores, local docs, hits) -> the merge
        on grid[0, j]; then the columns in batch order."""
        S = self.shard_count
        cols = []
        for j, shards in enumerate(local):
            ids = [d.to(torch.int32) * S + s for s, (_sc, d, _h) in enumerate(shards)]
            cols.append(_merge_candidates([sc for sc, _d, _h in shards], ids,
                                          [h for _sc, _d, h in shards], k,
                                          self.mesh.devices[0, j]))
        return tuple(_cat_columns([c[i] for c in cols]) for i in range(3))

    # -- the dense mesh --------------------------------------------------------------

    def attach_dense(self, *, max_rows: int = 1024, min_df: int | None = None,
                     residual: bool = True) -> int:
        """Per-shard dense head rows (the reference's
        distributed.py:358-409): the global head terms (df >= min_df, the
        top max_rows by df), each shard writing its own postings into bf16
        [Hp, cap] impact rows, so virtual shards add head capacity.
        ``residual`` also builds the Dekker residual rows. Returns the head
        row count."""
        S, V = self.term_lengths_host.shape
        if min_df is None:
            min_df = max(256, self.num_docs_total // 512)
        df = self.doc_freq_global
        cand = np.nonzero(df[:V] >= min_df)[0]
        cand = cand[np.argsort(-df[cand], kind="stable")][:max_rows]
        H = len(cand)
        self.dense_head_pos = {int(t): i for i, t in enumerate(cand)}
        self.dense_min_df = int(min_df)
        self.dense_attached = True
        self.dense_rows = self.dense_rows_lo = None
        if H == 0:
            return 0
        Hp = max(8, -(-H // 8) * 8)
        cap = self.shard_capacity
        hi_rows, lo_rows = [], []
        for s in range(S):
            rows = np.zeros((Hp, cap), np.float32)
            docs_s = self.post_docs_host[s]
            imps_s = self.post_impacts_host[s]
            for i, t in enumerate(cand):
                off = int(self.term_offsets_host[s, t])
                ln = int(self.term_lengths_host[s, t])
                if ln:
                    rows[i, docs_s[off : off + ln]] = imps_s[off : off + ln]
            f32 = torch.from_numpy(rows)
            hi = f32.to(torch.bfloat16)
            hi_rows.append(hi)
            if residual:
                lo_rows.append((f32 - hi.float()).to(torch.bfloat16))
        self.dense_rows = _place(self.mesh, hi_rows)
        if residual:
            self.dense_rows_lo = _place(self.mesh, lo_rows)
        return H

    def compile_dense_queries(self, queries: Sequence[Sequence[int]], max_terms: int = 8):
        """Term-id queries -> (W [B, U], row_idx [U], n_req [B], per-shard
        tail tables [S, B, R], run_len, has_head, has_tail) for
        ``search_dense`` (the reference's distributed.py:411-493): head
        terms take the shared global rows, tail terms per-shard merge runs
        as in ``compile_queries``."""
        S = self.term_offsets_host.shape[0]
        B = len(queries)
        used: dict[int, int] = {}
        per_q: list[list[tuple[int, float]]] = []
        tail_qs: list[list[tuple[int, float]]] = []
        for qterms in queries:
            merged: dict[int, float] = {}
            for term in list(qterms)[:max_terms]:
                t = int(term)
                dfv = int(self.doc_freq_global[t]) if t < len(self.doc_freq_global) else 0
                if dfv == 0:
                    continue
                merged[t] = merged.get(t, 0.0) + lucene_idf(self.num_docs_total, dfv)
            slots: list[tuple[int, float]] = []
            tq: list[tuple[int, float]] = []
            for t, w in merged.items():
                r = self.dense_head_pos.get(t)
                if r is not None:
                    if r not in used:
                        used[r] = len(used)
                    slots.append((used[r], w))
                else:
                    tq.append((t, w))
            per_q.append(slots)
            tail_qs.append(tq)
        has_head = bool(used)
        U = 8
        while U < max(len(used), 1):
            U <<= 1
        W = np.zeros((B, U), np.float32)
        row_idx = np.zeros(U, np.int32)
        for r, slot in used.items():
            row_idx[slot] = r
        for qi, slots in enumerate(per_q):
            for slot, w in slots:
                W[qi, slot] += w
        has_tail = any(tail_qs)
        T = max(max((len(t) for t in tail_qs), default=1), 1)
        if has_tail:
            offs = np.zeros((S, B, T), np.int64)
            lens = np.zeros((S, B, T), np.int32)
            weights = np.zeros((S, B, T), np.float32)
            for qi, tq in enumerate(tail_qs):
                for ti, (t, w) in enumerate(tq):
                    offs[:, qi, ti] = self.term_offsets_host[:, t]
                    lens[:, qi, ti] = self.term_lengths_host[:, t]
                    weights[:, qi, ti] = w
            r_offs, r_lens, r_w, run_len = _plan_shards(offs, lens, weights)
        else:
            r_offs = np.zeros((S, B, 1), np.int32)
            r_lens = np.zeros((S, B, 1), np.int32)
            r_w = np.zeros((S, B, 1), np.float32)
            run_len = 0
        n_req = np.ones(B, np.int32)
        return W, row_idx, n_req, r_offs, r_lens, r_w, run_len, has_head, has_tail

    def search_dense(self, W, row_idx, n_req, r_offs, r_lens, r_w, *, run_len: int,
                     k: int = 10, has_head: bool, has_tail: bool):
        """One distributed fused dense search of plain OR text queries (the
        reference's distributed.py:495-552). Returns (scores [B, k], global
        ids [B, k] with -1 at empty slots, hits [B])."""
        if self.dense_rows is None or not has_head:
            raise ValueError("attach_dense found no head rows")
        S = self.shard_count
        local = []
        for j, (b0, b1) in enumerate(_slices(self.mesh, W.shape[0])):
            local.append([_local_dense(
                self.dense_rows[s][j],
                None if self.dense_rows_lo is None else self.dense_rows_lo[s][j],
                self.post_docs[s][j], self.post_impacts[s][j],
                W[b0:b1], row_idx, n_req[b0:b1], r_offs[s, b0:b1], r_lens[s, b0:b1],
                r_w[s, b0:b1], run_len=run_len, k=k, has_head=has_head,
                has_tail=has_tail) for s in range(S)])
        ts, ti, th = self._merge_columns(local, k)
        return ts, torch.where(ts == float("-inf"), -1, ti), th

    # -- filters, sort and facets over the mesh --------------------------------------

    def attach_columns(self, searcher, fields: Sequence[str]) -> None:
        """Doc-value columns on the mesh, laid out with the postings'
        round-robin map; ORDINAL columns get a global ordinal dictionary
        (the sorted union over segments) (the reference's
        distributed.py:556-616)."""
        S = self.shard_count
        cap = self.shard_capacity
        max_doc = int(searcher.max_doc)
        doc_ord = np.arange(max_doc, dtype=np.int64)
        sh, loc = doc_ord % S, doc_ord // S
        for field in fields:
            ord_terms_union: list[str] = []
            seen: dict[str, int] = {}
            is_ordinal = False
            for seg in searcher.segments:
                dv = seg.doc_values.get(field)
                if dv is not None and dv.ord_terms is not None:
                    is_ordinal = True
                    for t in dv.ord_terms:
                        if t not in seen:
                            seen[t] = 1
                            ord_terms_union.append(t)
            ord_terms_union.sort()
            gidx = {t: i for i, t in enumerate(ord_terms_union)}
            vals = np.full(max_doc, -1.0 if is_ordinal else np.nan, np.float64)
            present = np.zeros(max_doc, bool)
            for idx, seg in enumerate(searcher.segments):
                dv = seg.doc_values.get(field)
                if dv is None:
                    continue
                base = int(searcher.bases[idx])
                n = seg.num_docs
                hp = dv.host_present[:n]
                if is_ordinal:
                    remap = np.array([gidx[t] for t in (dv.ord_terms or [])], np.int64)
                    hv = dv.host_values[:n].astype(np.int64)
                    safe = np.clip(hv, 0, max(len(remap) - 1, 0))
                    v = np.where(hp & (len(remap) > 0), remap[safe], -1)
                else:
                    v = dv.host_values[:n].astype(np.float64)
                vals[base : base + n] = np.where(hp, v, vals[base : base + n])
                present[base : base + n] = hp
            grid_v = np.zeros((S, cap), np.float32)
            grid_p = np.zeros((S, cap), bool)
            grid_v[sh, loc] = np.where(present, vals, 0.0).astype(np.float32)
            grid_p[sh, loc] = present
            self.columns[field] = {
                "values": _place(self.mesh, grid_v),
                "present": _place(self.mesh, grid_p),
                "ord_terms": ord_terms_union if is_ordinal else None,
            }

    def search_general(self, offs, lens, weights, n_terms, *, run_len: int, k: int = 10,
                       filters: Sequence[tuple] = (), sort: tuple | None = None,
                       facet_fields: Sequence[str] = ()):
        """Filtered, doc-value-sorted and faceted retrieval over the mesh
        (the reference's distributed.py:618-802). ``filters``: (field, op,
        value), op in {'<=', '>=', '==', 'ord=='}; ``sort``: (field,
        ascending, missing_last). Each shard gates its postings through its
        filter mask and ranks by its sort keys inside merge_score_topk; a
        facet counts each shard's matched docs per ordinal (the posting
        runs' union, score > 0), summed over shards; the candidates merge
        as in ``search``. Returns (rank values [B, k], global ids [B, k],
        hits [B], {facet field: counts int32 [B, n_ords] on the host})."""
        S = self.shard_count
        use_pallas = self.mesh.on_cuda
        filter_specs = []
        for field, op, value in filters:
            col = self.columns[field]
            if op == "ord==":
                value = float((col["ord_terms"] or []).index(value))
                op = "=="
            filter_specs.append((col, op, float(value)))
        sort_col = self.columns[sort[0]] if sort is not None else None
        facet_cols = [self.columns[f] for f in facet_fields]
        facet_sizes = tuple(len(c["ord_terms"] or []) for c in facet_cols)
        if any(n == 0 for n in facet_sizes):
            raise ValueError("facet fields must be ORDINAL columns")
        flip = sort is not None and bool(sort[1])

        def shard(s: int, j: int, b0: int, b1: int):
            docs_t, imps_t = self.post_docs[s][j], self.post_impacts[s][j]
            dev = docs_t.device
            mask = None
            for col, op, value in filter_specs:
                cv, cp = col["values"][s][j], col["present"][s][j]
                if op == "<=":
                    m = cv <= value
                elif op == ">=":
                    m = cv >= value
                else:
                    m = cv == value
                m = m & cp
                mask = m if mask is None else (mask & m)
            sort_keys = None
            ascending = True
            if sort is not None:
                sv, sp = sort_col["values"][s][j], sort_col["present"][s][j]
                ascending, missing_last = bool(sort[1]), bool(sort[2])
                missing = float("inf") if missing_last == ascending else float("-inf")
                sort_keys = torch.where(sp, sv, missing)
            t_offs = torch.as_tensor(offs[s, b0:b1], device=dev)
            t_lens = torch.as_tensor(lens[s, b0:b1], device=dev)
            t_w = torch.as_tensor(weights[s, b0:b1], device=dev)
            scores, docs, hits = merge_score_topk(
                docs_t, imps_t, t_offs, t_lens, t_w,
                torch.as_tensor(n_terms[s, b0:b1], device=dev),
                run_len=run_len, k=k, use_pallas=use_pallas,
                filter_mask=mask, sort_keys=sort_keys, sort_ascending=ascending,
            )
            counts = []
            if facet_sizes:
                # each query's matched docs: the union of this shard's runs
                B, R = t_offs.shape
                i_idx = torch.arange(run_len, device=dev)
                pos = t_offs[:, :, None].to(torch.int64) + i_idx
                valid = i_idx < t_lens[:, :, None]
                pos = torch.clamp(pos, 0, docs_t.shape[0] - 1)
                g_docs = docs_t[pos]
                g_imp = imps_t[pos] * (t_w[:, :, None] != 0.0)
                hit = valid & (g_imp > 0.0)
                cap = self.shard_capacity
                flat_doc = torch.where(hit, g_docs, cap - 1).reshape(B, -1).to(torch.int64)
                matched = torch.zeros((B, cap), dtype=torch.int32, device=dev)
                matched.scatter_reduce_(1, flat_doc, hit.reshape(B, -1).to(torch.int32),
                                        reduce="amax")
                matched = matched > 0
                if mask is not None:
                    matched = matched & mask[None, :]
                for col, n_ords in zip(facet_cols, facet_sizes):
                    fv, fp = col["values"][s][j], col["present"][s][j]
                    ords = fv.to(torch.int32)
                    ok = matched & fp[None, :] & (ords[None, :] >= 0)
                    slot = torch.clamp(ords, 0, n_ords - 1).to(torch.int64)
                    c = torch.zeros((B, n_ords), dtype=torch.int32, device=dev)
                    c.scatter_add_(1, slot[None, :].expand(B, cap), ok.to(torch.int32))
                    counts.append(c)
            # merge_score_topk returns the true keys: an ascending sort ranks
            # by the negated key through the merge, then flips back
            if flip:
                scores = torch.where(scores > float("-inf"), -scores, float("-inf"))
            return scores, docs, hits, counts

        cols = []
        facet_parts = []
        for j, (b0, b1) in enumerate(_slices(self.mesh, offs.shape[1])):
            shards = [shard(s, j, b0, b1) for s in range(S)]
            dev0 = self.mesh.devices[0, j]
            ids = [d.to(torch.int32) * S + s for s, (_sc, d, _h, _c) in enumerate(shards)]
            ts, ti, th = _merge_candidates([x[0] for x in shards], ids,
                                           [x[2] for x in shards], k, dev0)
            if flip:
                ts = torch.where(ts > float("-inf"), -ts, float("-inf"))
            cols.append((ts, ti, th))
            col_counts = []
            for f in range(len(facet_sizes)):
                total = shards[0][3][f].to(dev0, non_blocking=True)
                for x in shards[1:]:
                    total = total + x[3][f].to(dev0, non_blocking=True)
                col_counts.append(total)
            facet_parts.append(col_counts)
        scores, ids, hits = (_cat_columns([c[i] for c in cols]) for i in range(3))
        facets = {f: _cat_columns([p[i] for p in facet_parts]).cpu().numpy()
                  for i, f in enumerate(facet_fields)}
        return scores, ids, hits, facets

    def facet_labels(self, field: str) -> list[str]:
        return list(self.columns[field]["ord_terms"] or [])


def _local_knn(vectors, sq_norms, mask, queries, *, similarity: str, k: int):
    """One shard's exact kNN (the reference's distributed.py:841-858)."""
    from nrtsearch_tpu_torch.ops.knn import knn_search

    return knn_search(vectors, sq_norms, mask,
                      torch.as_tensor(queries, device=vectors.device),
                      similarity=similarity, k=k)


class DistributedKNN:
    """Exact vector search over the mesh (the reference's
    distributed.py:862-943): vectors sharded in contiguous blocks of
    ``shard_capacity`` docs (global id = local + shard * capacity), the
    query batch split over ``data``, each shard's exact top k merged by
    score with ties to the lower global id."""

    def __init__(self, mesh: SearchMesh, vectors, sq_norms, mask, shard_capacity: int,
                 similarity: str = "dot_product"):
        self.mesh = mesh
        self.vectors = _place(mesh, vectors)      # [S][data] f32 [cap, dims]
        self.sq_norms = _place(mesh, sq_norms)    # [S][data] f32 [cap]
        self.mask = _place(mesh, mask)            # [S][data] bool [cap]
        self.shard_capacity = shard_capacity
        self.similarity = similarity

    @classmethod
    def from_vectors(cls, vecs: np.ndarray, mesh: SearchMesh, mask: np.ndarray | None = None,
                     similarity: str = "dot_product") -> "DistributedKNN":
        n_shards = mesh.shape["shard"]
        N, dims = vecs.shape
        cap = _pad_pow2(-(-N // n_shards), minimum=8)
        padded = np.zeros((n_shards, cap, dims), np.float32)
        pmask = np.zeros((n_shards, cap), bool)
        m = np.ones(N, bool) if mask is None else np.asarray(mask, bool)
        for s in range(n_shards):
            lo, hi = s * cap, min((s + 1) * cap, N)
            if hi > lo:
                padded[s, : hi - lo] = vecs[lo:hi]
                pmask[s, : hi - lo] = m[lo:hi]
        sq = (padded * padded).sum(-1)
        return cls(mesh, padded, sq, pmask, cap, similarity)

    def search(self, queries: np.ndarray, k: int = 10):
        """Distributed exact kNN. Returns (scores [B, k], global ids [B, k])
        on the grid's first device."""
        q = np.asarray(queries, np.float32)
        S = self.mesh.shape["shard"]
        cols = []
        for j, (b0, b1) in enumerate(_slices(self.mesh, q.shape[0])):
            parts = [_local_knn(self.vectors[s][j], self.sq_norms[s][j], self.mask[s][j],
                                q[b0:b1], similarity=self.similarity, k=k)
                     for s in range(S)]
            ids = [i + s * self.shard_capacity for s, (_sc, i) in enumerate(parts)]
            ts, ti, _ = _merge_candidates([sc for sc, _i in parts], ids, None, k,
                                          self.mesh.devices[0, j], by_ord=False)
            cols.append((ts, ti))
        return tuple(_cat_columns([c[i] for c in cols]) for i in range(2))


def _pad_pow2(n: int, minimum: int = 128) -> int:
    b = minimum
    while b < max(n, 1):
        b <<= 1
    return b
