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

``doc_values`` (optional) maps a field name to its column's host arrays:
``kind`` (a ``DocValueKind`` or its value), ``values`` [capacity] (int64 for
LONG, f64 for DOUBLE, int32 ordinals with -1 where absent), ``present`` bool
[capacity], and for ORDINAL columns ``ord_terms`` (sorted); multi-valued
columns add ``mv_offsets`` / ``mv_values``.
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch.core.segment import (
    Segment, TextFieldIndex, doc_value_column, new_seg_id,
)
from nrtsearch_tpu_torch.device import resolve_device
from nrtsearch_tpu_torch.schema.fields import DocValueKind


def segment_from_numpy(arrays: dict, device: str | torch.device,
                       field: str = "body", doc_values: dict | None = None) -> Segment:
    """A port Segment holding ``arrays`` as field ``field`` (and the
    ``doc_values`` columns) on ``device``."""
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
    )
    columns = {
        name: doc_value_column(
            DocValueKind(col["kind"]), np.asarray(col["values"]),
            np.asarray(col["present"], bool), dev, col.get("ord_terms"),
            col.get("mv_offsets"), col.get("mv_values"),
        )
        for name, col in (doc_values or {}).items()
    }
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
    )
