"""Build and bind the port's hand-written CUDA kernels.

At first use nvcc compiles every ``csrc/*.cu`` file into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/kernels_<hash>.so csrc/*.cu

The library goes into ``nrtsearch_tpu_torch/_build/`` under a name keyed by a
hash of the sources and flags, and is loaded with ctypes: pointers and the
stream are ``c_void_p``, ints ``c_int`` (a postings length ``c_longlong``).
Every C entry point launches on the
current torch stream and returns ``cudaGetLastError()``; the wrappers below
raise when it is not 0. A failed build raises with nvcc's stderr.

The build and the binding run once per process under ``_BUILD_LOCK``: the
server's threads (the gRPC pool, the batcher's workers) may reach their
first kernel together, and must not run nvcc twice into one file.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show that its main path went through the kernels.
The counters are plain dicts: under concurrent searches an increment can be
lost, so counts taken while threads search are lower bounds.
The wrappers take CUDA tensors only; the plain torch twins live beside their
callers (ops/dense_fused.py, ops/bitonic_merge.py, ops/merge_scoring.py,
ops/bucket_retrieval.py, ops/knn.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES = {
    "head_scores": 0, "near_stages": 0, "far_stage": 0,
    "gather_runs": 0, "far_pair_stage": 0, "finish_mask": 0,
    "bucket_rank": 0, "bucket_rank_topk": 0, "knn_topk": 0,
}
# near_stages: the largest tile (2^14 pairs, 128 KB of shared memory)
NEAR_MAX_TILE = 16384
# finish_mask: stream entries per block, the scan's halo (max_seg - 1 for a
# power-of-two max_seg) included, doubled while the halo passes half of it;
# 16 entries per thread (4096: 256 threads, measured faster than 8192), at
# most 512 threads (the kernel's launch bound). A longer scan takes the wide
# kernel: 2048 outputs per block beside the halo, all in shared memory.
FINISH_WINDOW = 4096
FINISH_PER_THREAD = 16
FINISH_MAX_WINDOW = 512 * FINISH_PER_THREAD
FINISH_WIDE_TILE = 2048
MAX_SHARED_BYTES = 232_448   # what one Hopper block may use
# bucket_rank: slots per query (a doc's posting count must fit bits 20-24
# of its accumulator), the smallest bucket (rows written as 16-byte vectors)
# and the largest (15-bit ids)
BUCKET_MAX_SLOTS = 16
BUCKET_MIN_BITS = 2
BUCKET_MAX_BITS = 15
# knn_topk (csrc/knn_topk.cu): rows per tile, queries per block, candidates
# buffered per query, and so the most one launch keeps of each query
KNN_TILE_ROWS = 384
KNN_QUERIES = 32
KNN_CAP = 256
KNN_MAX_K = KNN_CAP - 32
KNN_SIMILARITY = {"l2_norm": 0, "dot_product": 1, "cosine": 2, "normalized_cosine": 2,
                  "max_inner_product": 3}
# ptxas register / shared-memory report of the last build (nvcc's stderr)
BUILD_INFO = {"log": "", "seconds": 0.0, "path": ""}

_lib = None
_BUILD_LOCK = threading.RLock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile csrc/*.cu into the keyed shared library (once per source
    hash) and return its path. Raises with nvcc's stderr on failure."""
    with _BUILD_LOCK:
        return _build_locked()


def _build_locked() -> Path:
    import time

    so = library_path()
    if so.exists():
        BUILD_INFO["path"] = str(so)
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, so)
    BUILD_INFO.update(
        log=proc.stderr, seconds=time.perf_counter() - t0, path=str(so)
    )
    return so


def _library():
    if _lib is None:
        with _BUILD_LOCK:
            if _lib is None:
                _bind(build())
    return _lib


def _bind(so: Path) -> None:
    global _lib
    lib = ctypes.CDLL(str(so))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nrt_head_scores.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.nrt_near_stages.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp]
    lib.nrt_far_stage.argtypes = [vp, vp, ci, ci, ci, ci, vp]
    lib.nrt_far_pair_stage.argtypes = [vp, vp, ci, ci, ci, ci, vp]
    lib.nrt_gather_runs.argtypes = [vp, vp, cll, vp, vp, vp, vp, vp,
                                    ci, ci, ci, ci, vp]
    lib.nrt_finish_mask.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                    ci, ci, vp]
    lib.nrt_bucket_rank.argtypes = [vp, vp, cll, vp, vp, vp, vp, vp,
                                    ci, ci, ci, ci, ci, vp]
    lib.nrt_bucket_rank_topk.argtypes = [vp, vp, cll, vp, vp, vp, vp, vp, vp,
                                         ci, ci, ci, ci, ci, ci, vp]
    lib.nrt_knn_topk.argtypes = [vp, cll, vp, vp, vp, vp, vp, vp, vp, vp,
                                 ci, ci, ci, ci, ci, ci, ci, vp]
    for fn in (lib.nrt_head_scores, lib.nrt_near_stages, lib.nrt_far_stage,
               lib.nrt_far_pair_stage, lib.nrt_gather_runs,
               lib.nrt_finish_mask, lib.nrt_bucket_rank, lib.nrt_bucket_rank_topk,
               lib.nrt_knn_topk):
        fn.restype = ci
    lib.nrt_error_string.argtypes = [ci]
    lib.nrt_error_string.restype = ctypes.c_char_p
    _lib = lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(kernel: str, fn, device: torch.device, *args) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = lib.nrt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({err})")
    LAUNCHES[kernel] += 1


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def head_scores(rows: torch.Tensor, rows_lo: torch.Tensor | None, idx: torch.Tensor,
                w_hi: torch.Tensor, w_lo: torch.Tensor | None, need_count: bool
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """bf16 rows [Hp, D] (and residual rows_lo), int32 idx [U], bf16 w_hi
    (and w_lo) [B, U] -> f32 S [B, D] = w_hi·rows[idx] + w_hi·rows_lo[idx]
    + w_lo·rows[idx] + w_lo·rows_lo[idx] (only the first term without
    rows_lo) and, when ``need_count``, f32 C [B, D] = (W != 0)·(rows[idx] > 0),
    in one launch that never writes rows[idx]
    (``ops/dense_fused.head_scores_plain`` is the plain version). Any U: the
    kernel streams its weights through a window of shared memory; a B or D
    its grid cannot cover fails the launch (csrc/head_scores.cu)."""
    _check(rows, "rows", torch.bfloat16, 2)
    _check(idx, "idx", torch.int32, 1)
    _check(w_hi, "w_hi", torch.bfloat16, 2)
    if (rows_lo is None) != (w_lo is None):
        raise ValueError("rows_lo and w_lo come together")
    ins = [rows, idx, w_hi]
    if rows_lo is not None:
        _check(rows_lo, "rows_lo", torch.bfloat16, 2)
        _check(w_lo, "w_lo", torch.bfloat16, 2)
        if rows_lo.shape != rows.shape or w_lo.shape != w_hi.shape:
            raise ValueError(f"rows_lo {tuple(rows_lo.shape)} and w_lo {tuple(w_lo.shape)} "
                             f"must match rows {tuple(rows.shape)} and w_hi {tuple(w_hi.shape)}")
        ins += [rows_lo, w_lo]
    if len({t.device for t in ins}) != 1:
        raise ValueError("all head_scores inputs must be on one device")
    Hp, D = rows.shape
    B, U = w_hi.shape
    if idx.shape[0] != U:
        raise ValueError(f"idx has {idx.shape[0]} entries, w_hi {U} columns")
    if D % 8 or any(t.data_ptr() % 16 for t in (rows, rows_lo) if t is not None):
        raise ValueError(f"rows need D % 8 == 0 and 16-byte alignment (D={D})")
    if max(Hp, B, U, D) >= 2**31:
        raise ValueError(f"head_scores shape beyond int32: Hp={Hp} B={B} U={U} D={D}")
    dev = rows.device
    S = torch.empty((B, D), dtype=torch.float32, device=dev)
    C = torch.empty((B, D), dtype=torch.float32, device=dev) if need_count else None
    if B == 0 or D == 0:
        return S, C
    if U == 0:
        S.zero_()
        if C is not None:
            C.zero_()
        return S, C
    lib = _library()
    _launch("head_scores", lib.nrt_head_scores, dev,
            rows.data_ptr(), None if rows_lo is None else rows_lo.data_ptr(),
            idx.data_ptr(), w_hi.data_ptr(), None if w_lo is None else w_lo.data_ptr(),
            S.data_ptr(), None if C is None else C.data_ptr(), Hp, U, B, D)
    return S, C


def _check_pairs(docs: torch.Tensor, contribs: torch.Tensor) -> tuple[int, int]:
    _check(docs, "docs", torch.int32, 2)
    _check(contribs, "contribs", torch.float32, 2)
    if docs.shape != contribs.shape or docs.device != contribs.device:
        raise ValueError("docs and contribs must match in shape and device")
    B, N = docs.shape
    if not _pow2(N) or N >= 2**31 or B > 65535:
        raise ValueError(f"unsupported merge shape {tuple(docs.shape)}")
    return B, N


def near_stages(docs: torch.Tensor, contribs: torch.Tensor, d0: int,
                tile: int, m: int = 0) -> None:
    """Stages d0, d0/2, ..., 1 in place, one block per ``tile`` pairs
    (4 <= tile <= NEAR_MAX_TILE; rows moved as 16-byte vectors)."""
    B, N = _check_pairs(docs, contribs)
    if not (_pow2(tile) and 4 <= tile <= NEAR_MAX_TILE and _pow2(d0)
            and 2 * d0 <= tile and N % tile == 0):
        raise ValueError(f"bad near_stages tiling: N={N} tile={tile} d0={d0}")
    if docs.data_ptr() % 16 or contribs.data_ptr() % 16:
        raise ValueError("near_stages needs 16-byte aligned docs and contribs")
    if B == 0:
        return
    lib = _library()
    _launch("near_stages", lib.nrt_near_stages, docs.device,
            docs.data_ptr(), contribs.data_ptr(), B, N, tile, d0, m)


def far_stage(docs: torch.Tensor, contribs: torch.Tensor, d: int,
              m: int = 0) -> None:
    """One compare-exchange stage at distance d, in place."""
    B, N = _check_pairs(docs, contribs)
    if not (_pow2(d) and 2 * d <= N):
        raise ValueError(f"bad far_stage distance d={d} for N={N}")
    if B == 0:
        return
    lib = _library()
    _launch("far_stage", lib.nrt_far_stage, docs.device,
            docs.data_ptr(), contribs.data_ptr(), B, N, d, m)


def far_pair_stage(docs: torch.Tensor, contribs: torch.Tensor, d: int,
                   m: int = 0) -> None:
    """Stages d and d/2 in one pass, in place."""
    B, N = _check_pairs(docs, contribs)
    if not (_pow2(d) and d >= 2 and 2 * d <= N):
        raise ValueError(f"bad far_pair_stage distance d={d} for N={N}")
    if B == 0:
        return
    lib = _library()
    _launch("far_pair_stage", lib.nrt_far_pair_stage, docs.device,
            docs.data_ptr(), contribs.data_ptr(), B, N, d, m)


def gather_runs(post_docs: torch.Tensor, post_impacts: torch.Tensor,
                offs: torch.Tensor, lens: torch.Tensor, weights: torch.Tensor,
                run_len: int, alternating: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, R] run tables -> docs int32 [B, R, run_len], contribs f32
    (``ops/merge_scoring.gather_runs_twin`` is the plain version)."""
    _check(post_docs, "post_docs", torch.int32, 1)
    _check(post_impacts, "post_impacts", torch.float32, 1)
    _check(offs, "offs", torch.int32, 2)
    _check(lens, "lens", torch.int32, 2)
    _check(weights, "weights", torch.float32, 2)
    if post_docs.shape != post_impacts.shape:
        raise ValueError("post_docs and post_impacts must match in shape")
    if not offs.shape == lens.shape == weights.shape:
        raise ValueError("offs, lens and weights must match in shape")
    if len({t.device for t in (post_docs, post_impacts, offs, lens, weights)}) != 1:
        raise ValueError("all gather_runs inputs must be on one device")
    B, R = offs.shape
    if not 0 < run_len < 2**31 or B * R * run_len >= 2**40:
        raise ValueError(f"unsupported gather shape B={B} R={R} run_len={run_len}")
    dev = post_docs.device
    out_docs = torch.empty((B, R, run_len), dtype=torch.int32, device=dev)
    out_contribs = torch.empty((B, R, run_len), dtype=torch.float32, device=dev)
    if B * R == 0:
        return out_docs, out_contribs
    lib = _library()
    _launch("gather_runs", lib.nrt_gather_runs, dev,
            post_docs.data_ptr(), post_impacts.data_ptr(), post_docs.shape[0],
            offs.data_ptr(), lens.data_ptr(), weights.data_ptr(),
            out_docs.data_ptr(), out_contribs.data_ptr(), B, R, run_len,
            int(alternating))
    return out_docs, out_contribs


def scan_halo(max_seg: int) -> int:
    """How far back the segmented scan reaches: 1 + 2 + 4 + ... over its
    distances d < max_seg."""
    halo, d = 0, 1
    while d < max_seg:
        halo += d
        d <<= 1
    return halo


def finish_mask(docs: torch.Tensor, contribs: torch.Tensor,
                n_terms: torch.Tensor, max_seg: int,
                require_all: bool) -> torch.Tensor:
    """[B, N] merged stream -> f32 [B, N] masked per-doc sums
    (``ops/merge_scoring.finish_mask_twin`` is the plain version)."""
    _check(docs, "docs", torch.int32, 2)
    _check(contribs, "contribs", torch.float32, 2)
    _check(n_terms, "n_terms", torch.int32, 1)
    if docs.shape != contribs.shape or len({docs.device, contribs.device,
                                            n_terms.device}) != 1:
        raise ValueError("docs and contribs must match in shape, all on one device")
    B, N = docs.shape
    if n_terms.shape[0] != B or N >= 2**31 or B > 65535:
        raise ValueError(f"unsupported finish shape {tuple(docs.shape)}, "
                         f"n_terms {tuple(n_terms.shape)}")
    tile, halo, smem = finish_plan(max_seg, require_all)
    out = torch.empty((B, N), dtype=torch.float32, device=docs.device)
    if B * N == 0:
        return out
    lib = _library()
    _launch("finish_mask", lib.nrt_finish_mask, docs.device,
            docs.data_ptr(), contribs.data_ptr(), n_terms.data_ptr(),
            out.data_ptr(), B, N, tile, halo, max_seg, int(require_all), smem)
    return out


def finish_plan(max_seg: int, require_all: bool) -> tuple[int, int, int]:
    """(tile, halo, smem) of finish_mask's blocks: output entries, the
    scan's reach before them, dynamic shared memory. A window (tile + halo)
    of at most FINISH_MAX_WINDOW entries runs the register kernel, a longer
    one the wide kernel (csrc/finish_mask.cu picks it by the window).
    Raises when a block would need more than MAX_SHARED_BYTES."""
    if max_seg < 1:
        raise ValueError(f"max_seg must be positive, got {max_seg}")
    halo = scan_halo(max_seg)
    window = FINISH_WINDOW
    while 2 * halo > window:
        window *= 2
    if window <= FINISH_MAX_WINDOW:
        return window - halo, halo, finish_smem_bytes(window, max_seg, require_all)
    window = FINISH_WIDE_TILE + halo
    smem = 4 * (window + 1) + 8 * window * (2 if require_all else 1)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"finish_mask: max_seg={max_seg} reaches back {halo} entries and "
            f"needs {smem} bytes of shared memory per block (at most "
            f"{MAX_SHARED_BYTES})")
    return FINISH_WIDE_TILE, halo, smem


def _pad(n: int) -> int:
    return n + (n >> 4)


def finish_smem_bytes(window: int, max_seg: int, require_all: bool) -> int:
    """Dynamic shared memory of one finish_mask block (csrc/finish_mask.cu
    ``smem_bytes``): the window's docs and next doc, its contribs (then its
    outputs), and two buffers per warp of the entries handed to the next
    warp, each padded with one word per 16."""
    span = 1
    while 2 * span < max_seg:
        span *= 2
    span = min(span, 32 * FINISH_PER_THREAD)
    warps = window // (32 * FINISH_PER_THREAD)
    return 4 * (_pad(window + 1) + _pad(window)
                + 2 * warps * _pad(span) * (2 if require_all else 1))


def _bucket_shape(post_docs: torch.Tensor, post_impacts: torch.Tensor,
                  toffs: torch.Tensor, bounds: torch.Tensor, wts: torch.Tensor,
                  n_terms: torch.Tensor, bucket_bits: int) -> tuple[int, int, int]:
    """(B, T, m) of the bucket kernels' inputs, or raises on what they do
    not take."""
    _check(post_docs, "post_docs", torch.int32, 1)
    _check(post_impacts, "post_impacts", torch.float32, 1)
    _check(toffs, "toffs", torch.int32, 2)
    _check(bounds, "bounds", torch.int32, 3)
    _check(wts, "wts", torch.float32, 2)
    _check(n_terms, "n_terms", torch.int32, 1)
    if post_docs.shape != post_impacts.shape:
        raise ValueError("post_docs and post_impacts must match in shape")
    if post_docs.data_ptr() % 16 or post_impacts.data_ptr() % 16:
        raise ValueError("bucket_rank reads the postings as 16-byte vectors: "
                         "post_docs and post_impacts must be 16-byte aligned")
    B, T, m1 = bounds.shape
    if toffs.shape != (B, T) or wts.shape != (B, T) or n_terms.shape != (B,) or m1 < 2:
        raise ValueError(f"toffs {tuple(toffs.shape)}, wts {tuple(wts.shape)}, n_terms "
                         f"{tuple(n_terms.shape)} and bounds {tuple(bounds.shape)} must "
                         f"be [B, T], [B] and [B, T, m+1]")
    if len({t.device for t in (post_docs, post_impacts, toffs, bounds, wts, n_terms)}) != 1:
        raise ValueError("all bucket_rank inputs must be on one device")
    m = m1 - 1
    if not 0 < T <= BUCKET_MAX_SLOTS:
        raise ValueError(f"bucket_rank takes 1..{BUCKET_MAX_SLOTS} slots, got T={T}")
    if not BUCKET_MIN_BITS <= bucket_bits <= BUCKET_MAX_BITS:
        raise ValueError(f"bucket_rank takes bucket_bits in {BUCKET_MIN_BITS}.."
                         f"{BUCKET_MAX_BITS}, got {bucket_bits}")
    if B * m >= 2**31:
        raise ValueError(f"B * m = {B * m} exceeds the kernel's grid")
    return B, T, m


def bucket_rank(post_docs: torch.Tensor, post_impacts: torch.Tensor,
                toffs: torch.Tensor, bounds: torch.Tensor, wts: torch.Tensor,
                n_terms: torch.Tensor, bucket_bits: int,
                require_all: bool) -> torch.Tensor:
    """[B, T] / [B, T, m+1] bucket plan tables -> int32 [B, m * 2^bucket_bits]
    rank keys in global doc order, the postings summed straight into each
    (query, bucket) row's shared-memory accumulator
    (``ops/bucket_retrieval.bucket_rank_plain`` is the plain version)."""
    B, T, m = _bucket_shape(post_docs, post_impacts, toffs, bounds, wts, n_terms,
                            bucket_bits)
    rank = torch.empty((B, m << bucket_bits), dtype=torch.int32, device=post_docs.device)
    if B == 0:
        return rank
    lib = _library()
    _launch("bucket_rank", lib.nrt_bucket_rank, post_docs.device,
            post_docs.data_ptr(), post_impacts.data_ptr(), post_docs.shape[0],
            toffs.data_ptr(), bounds.data_ptr(), wts.data_ptr(), n_terms.data_ptr(),
            rank.data_ptr(), B, T, m, bucket_bits, int(require_all))
    return rank


def bucket_rank_topk(post_docs: torch.Tensor, post_impacts: torch.Tensor,
                     toffs: torch.Tensor, bounds: torch.Tensor, wts: torch.Tensor,
                     n_terms: torch.Tensor, bucket_bits: int, require_all: bool,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The inputs of ``bucket_rank`` -> (int64 [B, m * kk] candidates, int32
    [B] hits), kk = min(k, 2^bucket_bits): each (query, bucket) row's top kk
    rank keys by (key desc, doc asc), I32_MIN docs included, as
    ``ops/topk.lowest_index_keys`` of (key, global doc), in no order within
    the row; hits counts each query's keys other than I32_MIN. The dense
    keys are never written (``ops/bucket_retrieval.bucket_rank_topk_plain``
    is the plain version)."""
    B, T, m = _bucket_shape(post_docs, post_impacts, toffs, bounds, wts, n_terms,
                            bucket_bits)
    if k < 1:
        raise ValueError(f"bucket_rank_topk needs k >= 1, got {k}")
    kk = min(k, 1 << bucket_bits)
    dev = post_docs.device
    cands = torch.empty((B, m * kk), dtype=torch.int64, device=dev)
    hits = torch.zeros((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return cands, hits
    lib = _library()
    _launch("bucket_rank_topk", lib.nrt_bucket_rank_topk, dev,
            post_docs.data_ptr(), post_impacts.data_ptr(), post_docs.shape[0],
            toffs.data_ptr(), bounds.data_ptr(), wts.data_ptr(), n_terms.data_ptr(),
            cands.data_ptr(), hits.data_ptr(), B, T, m, bucket_bits, int(require_all), kk)
    return cands, hits


_SM_COUNT: dict[int, int] = {}


def knn_topk_grid(rows: int, B: int, device: torch.device) -> int:
    """Row-tile blocks per 32-query tile of knn_topk: one block per SM over
    the query tiles, at most one per tile of KNN_TILE_ROWS rows."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    tiles = -(-rows // KNN_TILE_ROWS)
    q_tiles = -(-B // KNN_QUERIES)
    return max(1, min(tiles, _SM_COUNT[idx] // q_tiles))


def knn_topk(values: torch.Tensor, v_sq: torch.Tensor, mask: torch.Tensor,
             queries: torch.Tensor, q_sq: torch.Tensor | None, similarity: str, k: int,
             ceiling: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 rows [rows, dims] (any row stride), their squared norms [rows]
    (read for l2_norm and cosine), bool mask [rows], f32 queries [B, dims]
    and, for l2_norm and cosine, their squared sums q_sq [B] -> (cands int64
    [B, G, k], part_hits int32 [G]): over the G blocks' shares of the rows,
    each block's top k of each query in descending order, as the keys
    ``ops/topk.lowest_index_keys`` of the f32 order keys of ops/knn.py
    ``_transform`` of the f32 dots (-inf where the mask is false) and the
    row ids (INT64_MIN past a block's rows), and each block's count of
    eligible rows. With ``ceiling`` (int64 [B]) only keys below a query's
    ceiling count. The top k of a query's [G * k] candidates is its top k of
    the segment (``ops/knn.fused_segment_top_k``). One launch
    (csrc/knn_topk.cu) after a fill of the thresholds the blocks publish; no
    [B, rows] array is written."""
    if values.device.type != "cuda":
        raise ValueError(f"values must be a CUDA tensor, got {values.device}")
    if values.dtype != torch.float32 or values.dim() != 2 or values.stride(1) != 1:
        raise ValueError(f"values must be f32 [rows, dims] with unit column stride, got "
                         f"{values.dtype} {tuple(values.shape)} strides {values.stride()}")
    rows, dims = values.shape
    _check(v_sq, "v_sq", torch.float32, 1)
    _check(mask, "mask", torch.bool, 1)
    _check(queries, "queries", torch.float32, 2)
    if similarity not in KNN_SIMILARITY:
        raise ValueError(f"unknown similarity {similarity!r}")
    need_sq = similarity in ("l2_norm", "cosine", "normalized_cosine")
    if need_sq:
        if q_sq is None:
            raise ValueError(f"{similarity} needs the queries' squared sums q_sq")
        _check(q_sq, "q_sq", torch.float32, 1)
    B = queries.shape[0]
    if ceiling is not None:
        _check(ceiling, "ceiling", torch.int64, 1)
    if v_sq.shape[0] < rows or mask.shape[0] != rows or queries.shape[1] != dims or (
            need_sq and q_sq.shape[0] != B) or (ceiling is not None and ceiling.shape[0] != B):
        raise ValueError(f"v_sq {tuple(v_sq.shape)}, mask {tuple(mask.shape)}, queries "
                         f"{tuple(queries.shape)} do not fit values {tuple(values.shape)}")
    if len({t.device for t in (values, v_sq, mask, queries)}) != 1:
        raise ValueError("all knn_topk inputs must be on one device")
    if not 1 <= k <= rows or rows >= 2**31 or B < 1:
        raise ValueError(f"k={k} must lie in [1, the width {rows}] (< 2^31), B={B} >= 1")
    if k > KNN_MAX_K:
        raise ValueError(f"knn_topk keeps at most {KNN_MAX_K} candidates a query, got k={k}")
    dev = values.device
    if mask.data_ptr() % 4:     # the kernel copies the mask 4 bytes at a time
        mask = mask.clone()
    G = knn_topk_grid(rows, B, dev)
    cands = torch.empty((B, G, k), dtype=torch.int64, device=dev)
    part = torch.empty((G,), dtype=torch.int32, device=dev)
    g_thr = torch.full((B,), -2**63, dtype=torch.int64, device=dev)
    ld = values.stride(0)
    vec = dims % 4 == 0 and ld % 4 == 0 and values.data_ptr() % 16 == 0 \
        and queries.data_ptr() % 16 == 0
    lib = _library()
    _launch("knn_topk", lib.nrt_knn_topk, dev,
            values.data_ptr(), ld, v_sq.data_ptr(), mask.data_ptr(), queries.data_ptr(),
            q_sq.data_ptr() if need_sq else None,
            ceiling.data_ptr() if ceiling is not None else None, cands.data_ptr(),
            part.data_ptr(), g_thr.data_ptr(), rows, dims, B, k, KNN_SIMILARITY[similarity], G,
            int(vec))
    return cands, part
