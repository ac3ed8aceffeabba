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
