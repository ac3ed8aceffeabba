"""Immutable index segments on torch tensors (counterpart:
nrtsearch_tpu/core/segment.py).

A segment holds, per searchable text field, one flat ``doc_ids``/``freqs``
pair with a per-term ``[offset, length]`` table, the byte-quantized field
length per doc (utils/smallfloat.py, for BM25 parity), a live-docs mask and
a host row store for stored fields. Device arrays are padded to power-of-two
buckets, as in the reference.

This slice builds TEXT and _ID fields. Doc values, vectors, nested
documents, child fields, prefix fields, polygons and suggest fields raise
``NotImplementedError`` (ROADMAP item 10). Term positions are not kept: no
ported path reads them yet.
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from nrtsearch_tpu_torch.schema.fields import FieldDef, FieldType
from nrtsearch_tpu_torch.utils.smallfloat import quantize_length

_SEG_COUNTER = itertools.count()
_SEG_TOKEN = uuid.uuid4().hex[:8]


def new_seg_id(suffix: str = "") -> str:
    """Globally unique segment id: seg_<process-token>_<n>[suffix]."""
    return f"seg_{_SEG_TOKEN}_{next(_SEG_COUNTER)}{suffix}"


def pad_to_bucket(n: int, minimum: int = 128) -> int:
    """Next power-of-two bucket >= n (>= minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


@dataclass(frozen=True)
class TextFieldIndex:
    """Inverted index for one field within one segment.

    ``terms`` maps term -> term id; ``offsets[tid]``/``lengths[tid]`` (host)
    locate the term's postings run inside ``doc_ids``/``freqs`` (device).
    ``doc_lens`` is the quantized field length per doc (f32 on device)."""

    terms: dict[str, int]
    offsets: np.ndarray      # host int64 [T]
    lengths: np.ndarray      # host int32 [T]
    doc_ids: torch.Tensor    # device int32 [P_pad], padding = 0
    freqs: torch.Tensor      # device float32 [P_pad]
    doc_lens: torch.Tensor   # device float32 [D_pad], quantized lengths
    sum_doc_lens: int        # sum of quantized lengths (for avgdl)
    doc_count: int           # docs that have this field
    postings_len: int        # valid prefix of doc_ids/freqs

    def lookup(self, term: str) -> tuple[int, int]:
        """(offset, length) of a term's postings, (0, 0) if absent."""
        tid = self.terms.get(term)
        if tid is None:
            return 0, 0
        return int(self.offsets[tid]), int(self.lengths[tid])

    def doc_freq(self, term: str) -> int:
        tid = self.terms.get(term)
        return 0 if tid is None else int(self.lengths[tid])


@dataclass(frozen=True)
class Segment:
    """One immutable segment: device tensors + host dictionaries."""

    seg_id: str
    num_docs: int
    capacity: int                     # padded doc dimension of device arrays
    fields: dict[str, TextFieldIndex]
    stored: list[dict]                # host row store, len == num_docs
    live: torch.Tensor                # device bool [capacity]
    host_live: np.ndarray             # host bool [num_docs]
    del_count: int = 0

    @property
    def live_doc_count(self) -> int:
        return self.num_docs - self.del_count

    @property
    def device(self) -> torch.device:
        return self.live.device


_INDEXED_TYPES = (FieldType.TEXT, FieldType.ID)


class SegmentBuilder:
    """Accumulates analyzed documents in host memory; ``flush()`` packs them
    into a Segment on ``device``. The pure-Python layout of the reference's
    builder: term ids in first-seen order, postings doc-ascending."""

    def __init__(self, field_defs: dict[str, FieldDef], device: torch.device):
        for name, fd in field_defs.items():
            if fd.raw.get("childFields"):
                raise NotImplementedError(
                    f"field {name!r}: child fields are not ported yet (ROADMAP item 10)"
                )
        self.field_defs = field_defs
        self.device = device
        self.num_docs = 0
        # field -> term -> [(doc, freq)]
        self._postings: dict[str, dict[str, list]] = {}
        self._doc_lens: dict[str, list[int]] = {}
        self._stored: list[dict] = []

    def add_document(self, doc: dict[str, Any]) -> int:
        """Add one parsed document (field name -> raw value or list of
        values); returns its local doc id."""
        return self._add_flat(doc)

    def _add_flat(self, doc: dict[str, Any]) -> int:
        doc_id = self.num_docs
        stored_row: dict[str, Any] = {}
        parsed_fields = []
        for name, value in doc.items():
            fd = self.field_defs.get(name)
            if fd is None:
                raise KeyError(f"unregistered field: {name!r}")
            if fd.type not in _INDEXED_TYPES or fd.index_prefixes is not None:
                raise NotImplementedError(
                    f"field {name!r} of type {fd.type.value}: only TEXT and _ID "
                    "fields are ported yet (ROADMAP item 10)"
                )
            values = value if isinstance(value, (list, tuple)) else [value]
            if len(values) > 1 and not fd.multi_valued:
                raise ValueError(f"field {name!r} is not multiValued")
            parsed_fields.append((fd, [fd.parse_doc_value(v) for v in values]))
        self.num_docs += 1
        for fd, parsed in parsed_fields:
            if fd.search:
                self._index_text(fd, doc_id, [str(v) for v in parsed])
            if fd.store:
                stored_row[fd.name] = parsed if fd.multi_valued else parsed[0]
        self._stored.append(stored_row)
        return doc_id

    def _index_text(self, fd: FieldDef, doc_id: int, values: list[str]) -> None:
        lens = self._doc_lens.setdefault(fd.name, [])
        while len(lens) < doc_id:
            lens.append(0)
        post = self._postings.setdefault(fd.name, {})
        freqs: dict[str, int] = {}
        total = 0
        for v in values:
            for tok in fd.index_tokens(v):
                freqs[tok.text] = freqs.get(tok.text, 0) + 1
                total += 1
        for term, tf in freqs.items():
            post.setdefault(term, []).append((doc_id, tf))
        lens.append(total)

    def flush(self, seg_id: Optional[str] = None) -> Optional[Segment]:
        if self.num_docs == 0:
            return None
        capacity = pad_to_bucket(self.num_docs)
        fields = {
            name: self._pack_text_field(name, post, capacity)
            for name, post in self._postings.items()
        }
        live = np.zeros(capacity, dtype=bool)
        live[: self.num_docs] = True
        return Segment(
            seg_id=seg_id or new_seg_id(),
            num_docs=self.num_docs,
            capacity=capacity,
            fields=fields,
            stored=self._stored,
            live=torch.as_tensor(live, device=self.device),
            host_live=np.ones(self.num_docs, dtype=bool),
        )

    def _pack_text_field(
        self, field_name: str, post: dict[str, list], capacity: int
    ) -> TextFieldIndex:
        terms = {}
        offsets = np.zeros(len(post), dtype=np.int64)
        lengths = np.zeros(len(post), dtype=np.int32)
        total = sum(len(p) for p in post.values())
        # slack so a run gather starting near the end never clamps
        p_pad = pad_to_bucket(total + 16384)
        doc_ids = np.zeros(p_pad, dtype=np.int32)
        freqs = np.zeros(p_pad, dtype=np.float32)
        cursor = 0
        for tid, (term, plist) in enumerate(post.items()):
            terms[term] = tid
            offsets[tid] = cursor
            lengths[tid] = len(plist)
            arr = np.asarray(plist, dtype=np.int64).reshape(-1, 2)
            doc_ids[cursor : cursor + len(plist)] = arr[:, 0]
            freqs[cursor : cursor + len(plist)] = arr[:, 1]
            cursor += len(plist)
        lens_list = self._doc_lens.get(field_name, [])
        lens = np.zeros(capacity, dtype=np.int64)
        lens[: len(lens_list)] = lens_list
        qlens = quantize_length(lens).astype(np.float32)
        return TextFieldIndex(
            terms=terms,
            offsets=offsets,
            lengths=lengths,
            doc_ids=torch.as_tensor(doc_ids, device=self.device),
            freqs=torch.as_tensor(freqs, device=self.device),
            doc_lens=torch.as_tensor(qlens, device=self.device),
            sum_doc_lens=int(quantize_length(lens[: self.num_docs]).sum()),
            doc_count=int(np.count_nonzero(lens[: self.num_docs])),
            postings_len=total,
        )
