"""Immutable index segments on torch tensors (counterpart:
nrtsearch_tpu/core/segment.py).

A segment holds, per searchable text field, one flat ``doc_ids``/``freqs``
pair with a per-term ``[offset, length]`` table, the byte-quantized field
length per doc (utils/smallfloat.py, for BM25 parity), a live-docs mask and
a host row store for stored fields. Device arrays are padded to power-of-two
buckets, as in the reference.

A segment also holds one doc-value column per field that stores doc values
(``DocValueColumn``): LONG (also INT, BOOLEAN and DATE_TIME), DOUBLE (also
FLOAT) and ORDINAL (ATOM, TEXT, _ID) kinds, single- or multi-valued (CSR).

The builder takes TEXT, _ID, ATOM and the numeric field types. LAT_LON,
POLYGON, VECTOR, suggest, nested (OBJECT), child and prefix fields raise
``NotImplementedError`` (ROADMAP item 10; item 12 for vectors). Term
positions are not kept: no ported path reads them yet.
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

import numpy as np
import torch

from nrtsearch_tpu_torch.schema.fields import DocValueKind, FieldDef, FieldType
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
class DocValueColumn:
    """Columnar doc values for one field within one segment.

    Single-valued: ``values`` is [capacity]; ``present`` is a bool mask.
    Multi-valued: CSR layout, ``mv_offsets`` [num_docs + 1] into
    ``mv_values``, and ``values`` holds each doc's first (smallest) value.
    ORDINAL columns carry the host ordinal dictionary (``ord_terms``)."""

    kind: DocValueKind
    values: torch.Tensor              # device [capacity]
    present: torch.Tensor             # device bool [capacity]
    host_values: np.ndarray
    host_present: np.ndarray
    ord_terms: Optional[list[str]] = None       # ordinal -> term
    ord_index: Optional[dict[str, int]] = None  # term -> ordinal
    mv_offsets: Optional[np.ndarray] = None     # host int32 [num_docs + 1]
    mv_values: Optional[np.ndarray] = None      # host values (multi-valued)


@dataclass(frozen=True)
class VectorColumn:
    """A vector column as the on-disk format holds it. No ported path
    searches vectors yet (ROADMAP item 12); ``core/directory.py`` carries
    them through a load and a save."""

    values: torch.Tensor   # device [capacity, dims]: f32 | int8 (see fmt)
    present: torch.Tensor  # device bool [capacity]
    host_norms: np.ndarray
    fmt: str = "float32"
    scale: float = 1.0


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
    doc_values: dict[str, DocValueColumn] = dc_field(default_factory=dict)
    del_gen: int = 0                  # bumped per delete batch (Lucene del-gen)
    vectors: dict[str, VectorColumn] = dc_field(default_factory=dict)
    suggest: dict = dc_field(default_factory=dict)

    @property
    def live_doc_count(self) -> int:
        return self.num_docs - self.del_count

    @property
    def device(self) -> torch.device:
        return self.live.device


def numeric_device_array(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """Device representation of a numeric column (counterpart:
    ``SegmentBuilder._numeric_device_array``): an int64 or f64 column goes
    down as f32 where f32 holds every value exactly, as f64 otherwise."""
    if host.dtype in (np.int64, np.float64):
        f32 = host.astype(np.float32)
        if np.array_equal(f32.astype(host.dtype), host):
            return torch.as_tensor(f32, device=device)
    return torch.as_tensor(host.astype(np.float64), device=device)


def doc_value_column(
    kind: DocValueKind, host_values: np.ndarray, host_present: np.ndarray,
    device: torch.device, ord_terms: Optional[list[str]] = None,
    mv_offsets: Optional[np.ndarray] = None, mv_values: Optional[np.ndarray] = None,
) -> DocValueColumn:
    """A column from its host arrays: LONG and DOUBLE values through
    ``numeric_device_array``, ORDINAL values as they are (int32)."""
    if kind in (DocValueKind.LONG, DocValueKind.DOUBLE):
        values = numeric_device_array(host_values, device)
    elif kind == DocValueKind.ORDINAL:
        values = torch.as_tensor(host_values, device=device)
    else:
        raise NotImplementedError(
            f"{kind.value} doc values are not ported yet (ROADMAP item 10)"
        )
    return DocValueColumn(
        kind=kind,
        values=values,
        present=torch.as_tensor(host_present, device=device),
        host_values=host_values,
        host_present=host_present,
        ord_terms=ord_terms,
        ord_index={t: i for i, t in enumerate(ord_terms)} if ord_terms else None,
        mv_offsets=mv_offsets,
        mv_values=mv_values,
    )


_BUILT_TYPES = (
    FieldType.TEXT, FieldType.ID, FieldType.ATOM, FieldType.BOOLEAN,
    FieldType.LONG, FieldType.INT, FieldType.DATE_TIME, FieldType.DOUBLE,
    FieldType.FLOAT,
)


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
        self._dv: dict[str, list] = {}          # field -> [(doc, value)]
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
            if fd.type not in _BUILT_TYPES or fd.index_prefixes is not None:
                item = 12 if fd.type == FieldType.VECTOR else 10
                raise NotImplementedError(
                    f"field {name!r} of type {fd.type.value}: not ported yet "
                    f"(ROADMAP item {item})"
                )
            values = value if isinstance(value, (list, tuple)) else [value]
            if len(values) > 1 and not fd.multi_valued:
                raise ValueError(f"field {name!r} is not multiValued")
            parsed_fields.append((fd, [fd.parse_doc_value(v) for v in values]))
        self.num_docs += 1
        for fd, parsed in parsed_fields:
            if fd.search and fd.is_text:
                self._index_text(fd, doc_id, [str(v) for v in parsed])
            if fd.store_doc_values:
                self._dv.setdefault(fd.name, []).extend((doc_id, p) for p in parsed)
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
        doc_values = {
            name: self._pack_doc_values(self.field_defs[name], vals, capacity)
            for name, vals in self._dv.items()
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
            doc_values=doc_values,
        )

    def _pack_doc_values(self, fd: FieldDef, vals: list, capacity: int) -> DocValueColumn:
        """One column in the reference's layout (nrtsearch_tpu/core/segment.py
        ``_pack_doc_values``): ordinals in sorted term order, -1 where a doc
        has no value; multi-valued columns keep each doc's values sorted in
        CSR arrays and its first value in the single-valued column."""
        kind = fd.doc_value_kind
        present = np.zeros(capacity, dtype=bool)
        n = self.num_docs
        ord_terms = None
        if kind == DocValueKind.ORDINAL:
            # ordinals are sort-consistent (Lucene SortedDocValues)
            ord_terms = sorted({str(v) for _, v in vals})
            ord_index = {t: i for i, t in enumerate(ord_terms)}
            vals = [(doc, ord_index[str(v)]) for doc, v in vals]
            host = np.full(capacity, -1, dtype=np.int32)
        elif kind == DocValueKind.LONG:
            host = np.zeros(capacity, dtype=np.int64)
        else:
            host = np.zeros(capacity, dtype=np.float64)
        if not fd.multi_valued:
            for doc, v in vals:
                host[doc] = v
                present[doc] = True
            return doc_value_column(kind, host, present, self.device, ord_terms)
        per_doc: dict[int, list] = {}
        for doc, v in vals:
            per_doc.setdefault(doc, []).append(v)
        mv_offsets = np.zeros(n + 1, dtype=np.int32)
        mv_vals: list = []
        for d in range(n):
            vs = sorted(per_doc.get(d, []))
            mv_vals.extend(vs)
            mv_offsets[d + 1] = len(mv_vals)
            if vs:
                host[d] = vs[0]
                present[d] = True
        return doc_value_column(kind, host, present, self.device, ord_terms,
                                mv_offsets, np.asarray(mv_vals, dtype=host.dtype))

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
