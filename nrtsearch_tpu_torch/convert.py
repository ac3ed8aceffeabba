"""Carry index state into the port: numpy arrays -> a port ``Segment``.

``segment_from_numpy`` takes one segment's arrays for one text field, as
plain numpy (a reference segment's arrays through ``np.asarray``, or
``models.synthetic.SyntheticCorpus.segment_arrays``), and places them on
``device``:

- ``terms`` (term -> term id), ``offsets`` int64 [T], ``lengths`` int32 [T]
- ``doc_ids`` int32 [P_pad], ``freqs`` f32 [P_pad], ``postings_len``
- ``doc_lens`` f32 [capacity] (quantized), ``sum_doc_lens``, ``doc_count``
- ``live`` bool [capacity], ``host_live`` bool [num_docs]
- ``num_docs``, ``capacity``, ``stored`` (list of row dicts)
- optionally ``positions`` int32 (flat) and ``position_offsets`` int64
  [postings_len + 1]: the term positions, a CSR over postings entries (kept
  on the host, as the builder keeps them)

``doc_values`` (optional) maps a field name to its column's host arrays:
``kind`` (a ``DocValueKind`` or its value), ``values`` [capacity] (int64 for
LONG, f64 for DOUBLE, int32 ordinals with -1 where absent), ``present`` bool
[capacity], and for ORDINAL columns ``ord_terms`` (sorted); multi-valued
columns add ``mv_offsets`` / ``mv_values``.

``vectors`` (optional) maps a VECTOR field to its column's host arrays:
``values`` [capacity, dims] (f32, or int8 for the ``int8`` format; a
``float16`` column's bf16 values as f32), ``present`` bool [capacity],
``norms`` f32 [capacity] (of the original f32 vectors), ``fmt`` and
``scale``. The column's squared norms are computed on ``device``.

``batched_bm25_from_numpy`` carries a flagship model across (the reference
``BatchedBM25``'s arrays through ``np.asarray``), ``dense_head_from_numpy`` a
reference ``DenseHeadIndex`` (its bf16 rows, residual rows, row maxima, head
ids and tail bucket bounds), so that both packages score the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch.core.segment import (
    Segment, TextFieldIndex, VectorColumn, doc_value_column, new_seg_id,
)
from nrtsearch_tpu_torch.device import resolve_device
from nrtsearch_tpu_torch.schema.fields import DocValueKind


def segment_from_numpy(arrays: dict, device: str | torch.device,
                       field: str = "body", doc_values: dict | None = None,
                       vectors: dict | None = None) -> Segment:
    """A port Segment holding ``arrays`` as field ``field`` (and the
    ``doc_values`` and ``vectors`` columns) on ``device``."""
    dev = resolve_device(device)

    def put(name, dtype):
        return torch.as_tensor(np.array(arrays[name], dtype=dtype), device=dev)

    host_live = np.asarray(arrays["host_live"], bool)
    tfi = TextFieldIndex(
        terms=dict(arrays["terms"]),
        offsets=np.asarray(arrays["offsets"], np.int64),
        lengths=np.asarray(arrays["lengths"], np.int32),
        doc_ids=put("doc_ids", np.int32),
        freqs=put("freqs", np.float32),
        doc_lens=put("doc_lens", np.float32),
        sum_doc_lens=int(arrays["sum_doc_lens"]),
        doc_count=int(arrays["doc_count"]),
        postings_len=int(arrays["postings_len"]),
        positions=(np.asarray(arrays["positions"], np.int32)
                   if arrays.get("positions") is not None else None),
        position_offsets=(np.asarray(arrays["position_offsets"], np.int64)
                          if arrays.get("positions") is not None else None),
    )
    columns = {
        name: doc_value_column(
            DocValueKind(col["kind"]), np.asarray(col["values"]),
            np.asarray(col["present"], bool), dev, col.get("ord_terms"),
            col.get("mv_offsets"), col.get("mv_values"),
        )
        for name, col in (doc_values or {}).items()
    }
    vector_columns = {name: _vector_column(col, dev) for name, col in (vectors or {}).items()}
    num_docs = int(arrays["num_docs"])
    return Segment(
        seg_id=new_seg_id("_np"),
        num_docs=num_docs,
        capacity=int(arrays["capacity"]),
        fields={field: tfi},
        stored=list(arrays["stored"]),
        live=put("live", np.bool_),
        host_live=host_live,
        del_count=int(num_docs - host_live.sum()),
        doc_values=columns,
        vectors=vector_columns,
    )


def _vector_column(col: dict, dev: torch.device) -> VectorColumn:
    fmt = col.get("fmt", "float32")
    values = np.array(col["values"], np.int8 if fmt == "int8" else np.float32)
    t = torch.as_tensor(values, device=dev)
    return VectorColumn(
        values=t.to(torch.bfloat16) if fmt == "float16" else t,
        present=torch.as_tensor(np.array(col["present"], bool), device=dev),
        host_norms=np.array(col["norms"], np.float32),
        fmt=fmt,
        scale=float(col.get("scale", 1.0)),
    )


def _bf16_tensor(a, dev: torch.device) -> torch.Tensor:
    """A numpy bfloat16 array as a bf16 tensor on ``dev`` (moved through
    its bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name != "bfloat16":
        raise ValueError(f"expected bfloat16 rows, got {a.dtype}")
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(dev)


def batched_bm25_from_numpy(*, terms: dict, offsets, lengths, doc_ids, freqs, doc_lens,
                            live, num_docs_real: int, device: str | torch.device,
                            k1: float = 1.2, b: float = 0.75):
    """A port ``models.flagship.BatchedBM25`` over a flagship model's
    arrays (numpy) on ``device``; its impacts are computed there."""
    from nrtsearch_tpu_torch.models.flagship import BatchedBM25

    return BatchedBM25(
        terms=dict(terms), offsets=np.asarray(offsets, np.int64),
        lengths=np.asarray(lengths, np.int32), doc_ids=np.asarray(doc_ids, np.int32),
        freqs=np.asarray(freqs, np.float32), doc_lens=np.asarray(doc_lens, np.float32),
        live=np.asarray(live, bool), num_docs_real=int(num_docs_real), k1=k1, b=b,
        device=device,
    )


def dense_head_from_numpy(*, rows, rows_lo, row_max, head_ids, tail_bounds,
                          tail_max_impact, bucket_bits: int, capacity: int, min_df: int,
                          device: str | torch.device):
    """A port ``ops.dense_head.DenseHeadIndex`` holding a dense head index's
    arrays: bf16 ``rows`` [Hp, D] (and ``rows_lo`` or None), f32 ``row_max``
    [Hp], int32 ``head_ids`` [H], and the tail's bucket bounds [V, m+1] and
    per-term impact bounds [V] at ``bucket_bits``."""
    from nrtsearch_tpu_torch.ops.bucket_retrieval import BucketIndex
    from nrtsearch_tpu_torch.ops.dense_head import DenseHeadIndex

    dev = resolve_device(device)
    head_ids = np.asarray(head_ids, np.int32)
    bounds = np.asarray(tail_bounds, np.int32)
    return DenseHeadIndex(
        rows=_bf16_tensor(rows, dev),
        head_ids=head_ids,
        head_pos={int(t): i for i, t in enumerate(head_ids)},
        tail=BucketIndex(int(bucket_bits), bounds.shape[1] - 1, bounds,
                         np.asarray(tail_max_impact, np.float32)),
        capacity=int(capacity),
        min_df=int(min_df),
        row_max=torch.from_numpy(np.array(row_max, np.float32)).to(dev),
        rows_lo=None if rows_lo is None else _bf16_tensor(rows_lo, dev),
    )
