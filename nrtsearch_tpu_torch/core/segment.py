"""Immutable index segments on torch tensors (counterpart:
nrtsearch_tpu/core/segment.py).

A segment holds, per searchable text field, one flat ``doc_ids``/``freqs``
pair with a per-term ``[offset, length]`` table, the byte-quantized field
length per doc (utils/smallfloat.py, for BM25 parity), a live-docs mask and
a host row store for stored fields. Device arrays are padded to power-of-two
buckets, as in the reference.

A segment also holds one doc-value column per field that stores doc values
(``DocValueColumn``): LONG (also INT, BOOLEAN and DATE_TIME), DOUBLE (also
FLOAT) and ORDINAL (ATOM, TEXT, _ID) kinds, single- or multi-valued (CSR),
and LAT_LON: f32 [capacity, 2] (lat, lon) on the device, as the reference
keeps it, and the f64 values on the host.

Segments are immutable: a delete makes a new segment with the same seg_id,
the next del_gen and a new live mask (``with_deletes``), a doc-value update
a new ``_dv`` segment with new columns (``with_doc_value_updates``); both
share the postings and everything else they do not change.

A VECTOR field is one ``VectorColumn`` per segment: f32, bf16 or int8
[capacity, dims] on the device, with its squared norms computed once when
the column is made.

Term positions are a CSR over postings entries, held on the host as in the
reference (``positions`` / ``position_offsets``); ``ops.phrase`` uploads a
field's positions to the device on its first phrase query. The builder
takes every field type the reference's does: POLYGON columns (one GeoJSON
polygon per doc as NaN-separated rings, f32 [capacity, V, 2]),
CONTEXT_SUGGEST entries (host lists), OBJECT ``nestedDoc`` values (child
documents placed before their parent, with the ``_nested_path`` ORDINAL
doc value), child fields fanned out from their parent, and the hidden
``<field>._index_prefix`` companion of an ``indexPrefixes`` field.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import uuid
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

import numpy as np
import torch

from nrtsearch_tpu_torch import native_ext
from nrtsearch_tpu_torch.schema.fields import (
    DocValueKind, FieldDef, FieldType, parse_geojson_polygon,
)
from nrtsearch_tpu_torch.utils.smallfloat import quantize_length

# the nested-document doc value (the reference's
# SegmentBuilder.NESTED_PATH_FIELD / ROOT_PATH); Lucene block-join order:
# children BEFORE their parent
NESTED_PATH_FIELD = "_nested_path"
ROOT_PATH = "_root"

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
    ``doc_lens`` is the quantized field length per doc (f32 on device).
    ``positions`` / ``position_offsets`` are the term positions, a CSR over
    postings entries on the host (None where the field kept none)."""

    terms: dict[str, int]
    offsets: np.ndarray      # host int64 [T]
    lengths: np.ndarray      # host int32 [T]
    doc_ids: torch.Tensor    # device int32 [P_pad], padding = 0
    freqs: torch.Tensor      # device float32 [P_pad]
    doc_lens: torch.Tensor   # device float32 [D_pad], quantized lengths
    sum_doc_lens: int        # sum of quantized lengths (for avgdl)
    doc_count: int           # docs that have this field
    postings_len: int        # valid prefix of doc_ids/freqs
    positions: Optional[np.ndarray] = None           # host int32, flat
    position_offsets: Optional[np.ndarray] = None    # host int64 [postings_len + 1]

    def host_doc_ids(self) -> np.ndarray:
        """The postings' doc ids on the host (int32 [postings_len]), read
        once from the device and cached (the reference keeps this copy)."""
        cached = getattr(self, "_host_doc_ids", None)
        if cached is None:
            cached = self.doc_ids[: self.postings_len].cpu().numpy()
            object.__setattr__(self, "_host_doc_ids", cached)
        return cached

    def entry_index(self, term: str, doc: int) -> int:
        """Postings entry index of (term, doc), -1 if absent (host lookup)."""
        tid = self.terms.get(term)
        if tid is None:
            return -1
        off, ln = int(self.offsets[tid]), int(self.lengths[tid])
        run = self.host_doc_ids()[off : off + ln]
        i = int(np.searchsorted(run, doc))
        if i < ln and run[i] == doc:
            return off + i
        return -1

    def positions_of(self, term: str, doc: int) -> np.ndarray:
        e = self.entry_index(term, doc)
        if e < 0 or self.positions is None:
            return np.empty(0, np.int32)
        return self.positions[self.position_offsets[e] : self.position_offsets[e + 1]]

    def lookup(self, term: str) -> tuple[int, int]:
        """(offset, length) of a term's postings, (0, 0) if absent."""
        tid = self.terms.get(term)
        if tid is None:
            return 0, 0
        return int(self.offsets[tid]), int(self.lengths[tid])

    def doc_freq(self, term: str) -> int:
        tid = self.terms.get(term)
        return 0 if tid is None else int(self.lengths[tid])

    def sorted_terms(self) -> np.ndarray:
        """The vocabulary in sorted order, built on the first multi-term
        query and cached on the (immutable) field index."""
        cached = getattr(self, "_sorted_terms", None)
        if cached is None:
            cached = np.sort(np.array(list(self.terms), dtype=object))
            object.__setattr__(self, "_sorted_terms", cached)
        return cached

    def terms_with_prefix(self, prefix: str, limit: int) -> list[str]:
        """Up to ``limit`` vocabulary terms starting with ``prefix``, in
        lexicographic order (a binary search over ``sorted_terms``)."""
        st = self.sorted_terms()
        if not prefix:
            return list(st[: max(limit, 0)])
        lo = int(np.searchsorted(st, prefix, side="left"))
        out: list[str] = []
        for i in range(lo, len(st)):
            if len(out) >= limit or not st[i].startswith(prefix):
                break
            out.append(st[i])
        return out


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
    """One vector field's column in one segment (counterpart:
    ``nrtsearch_tpu/core/segment.py`` ``VectorColumn``).

    ``values`` is [capacity, dims] on the device: f32, bf16 (the
    ``float16`` format) or int8 (``round(v / scale)``); ``host_norms`` are
    the L2 norms of the original f32 vectors. The squared norms every query
    reads are computed once, on the device, when the column is made:
    ``sq_norms`` (exact, ``host_norms ** 2`` in f32, for the exact vector
    query) and ``score_sq_norms`` (those the format scores with: exact for
    f32, the rounded rows' for bf16, the quantized rows' for int8), where
    the reference rebuilds and uploads them on every query."""

    values: torch.Tensor   # device [capacity, dims]: f32 | bf16 | int8 (see fmt)
    present: torch.Tensor  # device bool [capacity]
    host_norms: np.ndarray
    fmt: str = "float32"
    scale: float = 1.0
    sq_norms: torch.Tensor = dc_field(init=False, repr=False, compare=False)
    score_sq_norms: torch.Tensor = dc_field(init=False, repr=False, compare=False)

    def __post_init__(self):
        from nrtsearch_tpu_torch.ops.knn import quantized_sq_norms, rounded_sq_norms

        sq = torch.as_tensor((self.host_norms ** 2).astype(np.float32),
                             device=self.values.device)
        if self.fmt == "int8":
            score_sq = quantized_sq_norms(self.values, self.scale)
        elif self.fmt == "float16":
            score_sq = rounded_sq_norms(self.values)
        else:
            score_sq = sq
        object.__setattr__(self, "sq_norms", sq)
        object.__setattr__(self, "score_sq_norms", score_sq)

    @property
    def dims(self) -> int:
        return int(self.values.shape[1])

    def device_float(self) -> torch.Tensor:
        """The dequantized f32 [capacity, dims] matrix on the device (a new
        tensor per call for bf16 and int8 columns, as the reference's)."""
        if self.fmt == "int8":
            return self.values.to(torch.float32) * np.float32(self.scale)
        return self.values.to(torch.float32)

    def host_float(self) -> np.ndarray:
        """The dequantized f32 host matrix (the whole column: merge)."""
        return _dequantize(self.values.cpu(), self.fmt, self.scale)

    def host_present(self) -> np.ndarray:
        return self.present.cpu().numpy()

    def host_row(self, local: int) -> np.ndarray:
        """One doc's dequantized f32 vector: a copy of that row alone
        (fetch), equal to ``host_float()[local]``."""
        return _dequantize(self.values[local].cpu(), self.fmt, self.scale)


def _dequantize(values: torch.Tensor, fmt: str, scale: float) -> np.ndarray:
    """A host tensor of stored values as the reference's ``host_float``
    gives them: int8 times the scale, bf16 and f32 as f32."""
    if fmt == "int8":
        return values.numpy().astype(np.float32) * scale
    return values.to(torch.float32).numpy()


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

    def parent_positions(self) -> Optional[np.ndarray]:
        """Sorted local ids of parent (root) docs, None if no nesting info
        (a segment made from arrays may carry none); cached, as the
        segment is immutable."""
        if "_parents" in self.__dict__:
            return self.__dict__["_parents"]
        dv = self.doc_values.get(NESTED_PATH_FIELD)
        root_ord = dv.ord_index.get(ROOT_PATH) if dv is not None and dv.ord_index else None
        parents = (None if root_ord is None
                   else np.nonzero(dv.host_values[: self.num_docs] == root_ord)[0])
        object.__setattr__(self, "_parents", parents)
        return parents

    def with_doc_value_updates(self, updates: dict[str, dict[int, Any]]) -> "Segment":
        """Copy-on-write doc-value updates (the reference's
        ``Segment.with_doc_value_updates``). LONG and DOUBLE columns only;
        each new column goes down through ``numeric_device_array``, so an
        updated value can move it from f32 to f64 on the device. The result
        carries a NEW seg_id, so persistence and replication treat it as a
        fresh immutable segment."""
        new_dv = dict(self.doc_values)
        for field, per_doc in updates.items():
            dv = new_dv.get(field)
            if dv is None or dv.kind not in (DocValueKind.LONG, DocValueKind.DOUBLE):
                raise ValueError(f"field {field!r} is not a numeric doc-values field")
            host = dv.host_values.copy()
            present = dv.host_present.copy()
            for local, value in per_doc.items():
                host[local] = value
                present[local] = True
            new_dv[field] = dataclasses.replace(
                dv,
                values=numeric_device_array(host, self.device),
                present=torch.as_tensor(present, device=self.device),
                host_values=host,
                host_present=present,
            )
        return dataclasses.replace(self, doc_values=new_dv, seg_id=new_seg_id("_dv"))

    def with_deletes(self, deleted_local_ids: np.ndarray) -> "Segment":
        """A new segment with more docs marked deleted: the same seg_id, the
        next del_gen, and a live mask rebuilt on the segment's device (the
        postings and columns are shared, not copied).

        Deleting a parent also deletes its nested children (Lucene block-join
        delete semantics: blocks live and die together)."""
        deleted_local_ids = np.asarray(deleted_local_ids, dtype=np.int64)
        parents = self.parent_positions()
        if parents is not None and len(parents):
            expanded = set(int(d) for d in deleted_local_ids)
            for d in deleted_local_ids:
                idx = int(np.searchsorted(parents, int(d)))
                if idx < len(parents) and parents[idx] == d:
                    start = int(parents[idx - 1]) + 1 if idx > 0 else 0
                    expanded.update(range(start, int(d)))
            deleted_local_ids = np.asarray(sorted(expanded), dtype=np.int64)
        host_live = self.host_live.copy()
        host_live[deleted_local_ids] = False
        live = np.zeros(self.capacity, dtype=bool)
        live[: self.num_docs] = host_live
        return dataclasses.replace(
            self,
            live=torch.as_tensor(live, device=self.device),
            host_live=host_live,
            del_count=int(self.num_docs - host_live.sum()),
            del_gen=self.del_gen + 1,
        )


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
    elif kind in (DocValueKind.LAT_LON, DocValueKind.POLYGON):
        values = torch.as_tensor(host_values.astype(np.float32), device=device)
    else:
        raise ValueError(f"no doc-value column of kind {kind.value}")
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


def vector_column(mat: np.ndarray, present: np.ndarray, fmt: str,
                  device: torch.device) -> VectorColumn:
    """A column from the f32 host matrix: int8 through ``quantize_int8``
    (its scale from this matrix), bf16 by rounding on the device."""
    norms = np.linalg.norm(mat, axis=1)
    scale = 1.0
    if fmt == "int8":
        from nrtsearch_tpu_torch.ops.knn import quantize_int8

        q, scale = quantize_int8(mat)
        values = torch.as_tensor(q, device=device)
    elif fmt == "float16":
        values = torch.as_tensor(mat, device=device).to(torch.bfloat16)
    else:
        values = torch.as_tensor(mat, device=device)
    return VectorColumn(
        values=values,
        present=torch.as_tensor(present, device=device),
        host_norms=norms.astype(np.float32),
        fmt=fmt,
        scale=scale,
    )


class SegmentBuilder:
    """Accumulates analyzed documents in host memory; ``flush()`` packs them
    into a Segment on ``device``. The reference's layout: term ids in
    first-seen order, postings doc-ascending, each entry's positions in the
    order the analyzer gave them.

    When the native extension loads (``native_ext.get()``), a text field's
    postings accumulate in its C++ ``PostingsAccumulator``, as in the
    reference's builder: ``add_text`` tokenizes ASCII values of a TEXT field
    with the default analyzer in C++; other analyzers, non-ASCII values and
    the ``_index_prefix`` companions analyze in Python and feed it through
    ``add_terms``. Otherwise (``NRT_NATIVE=0``, no toolchain) the postings
    are Python lists. Both give the same arrays."""

    NESTED_PATH_FIELD = NESTED_PATH_FIELD
    ROOT_PATH = ROOT_PATH
    # position gap between the values of a multi-valued field (reference:
    # PosIncGapAnalyzerWrapper; Lucene's default gap semantics)
    POSITION_GAP = 100

    def __init__(self, field_defs: dict[str, FieldDef], device: torch.device):
        if NESTED_PATH_FIELD not in field_defs:
            field_defs = {
                **field_defs,
                NESTED_PATH_FIELD: FieldDef(
                    name=NESTED_PATH_FIELD, type=FieldType.ATOM, store_doc_values=True,
                ),
            }
        self.field_defs = field_defs
        self.device = device
        # non-OBJECT parents fan their values out to each child field, which
        # indexes them under its own analyzer; sorted so a parent's fan-out
        # lands before its children's own (prefix order = ancestor order)
        self._copy_children: list[tuple[str, list[str]]] = sorted(
            (name, [f"{name}.{c['name']}" for c in fd.raw["childFields"]])
            for name, fd in field_defs.items()
            if fd.type != FieldType.OBJECT and fd.raw.get("childFields")
        )
        self.num_docs = 0
        # field -> term -> [(doc, freq, positions)] (the pure-Python path)
        self._postings: dict[str, dict[str, list]] = {}
        # the native extension, or None; field -> its PostingsAccumulator
        self._native = native_ext.get()
        self._acc: dict[str, Any] = {}
        # field -> packed postings from a merge (``set_text_arrays``)
        self._text_arrays: dict[str, tuple] = {}
        self._doc_lens: dict[str, list[int]] = {}
        self._dv: dict[str, list] = {}          # field -> [(doc, value)]
        # field -> [(doc, f32 vector)] or, from a merge, [(docs, rows)]
        self._vectors: dict[str, list] = {}
        self._suggest: dict[str, list] = {}     # field -> [(doc, text, weight, contexts)]
        self._stored: list[dict] = []

    def add_document(self, doc: dict[str, Any]) -> int:
        """Add one parsed document (field name -> raw value or list of
        values); returns its local doc id.

        OBJECT fields with ``nestedDoc`` expand into child documents indexed
        immediately before the parent (Lucene block order), each with dotted
        field names (``path.subfield``) and a ``_nested_path`` doc value of
        its path; the parent gets ``_nested_path = _root``."""
        nested_children: list[tuple[str, dict]] = []
        flat_doc: dict[str, Any] = {}
        for name, value in doc.items():
            fd = self.field_defs.get(name)
            if fd is not None and fd.type == FieldType.OBJECT and fd.raw.get("nestedDoc"):
                for v in (value if isinstance(value, (list, tuple)) else [value]):
                    nested_children.append((name, json.loads(v) if isinstance(v, str)
                                            else dict(v)))
            else:
                flat_doc[name] = value
        for path, child in nested_children:
            child_doc = {f"{path}.{k}": v for k, v in child.items()}
            child_doc[NESTED_PATH_FIELD] = path
            self._add_flat(child_doc)
        flat_doc[NESTED_PATH_FIELD] = ROOT_PATH
        return self._add_flat(flat_doc)

    def _add_flat(self, doc: dict[str, Any]) -> int:
        for parent, children in self._copy_children:
            if parent in doc:
                for c in children:
                    doc.setdefault(c, doc[parent])
        doc_id = self.num_docs
        stored_row: dict[str, Any] = {}
        parsed_fields = []
        for name, value in doc.items():
            fd = self.field_defs.get(name)
            if fd is None:
                raise KeyError(f"unregistered field: {name!r}")
            values = value if isinstance(value, (list, tuple)) else [value]
            if (len(values) > 1 and not fd.multi_valued
                    and fd.type not in (FieldType.LAT_LON, FieldType.VECTOR)):
                raise ValueError(f"field {name!r} is not multiValued")
            if fd.type == FieldType.VECTOR:
                # a raw number list (one vector) or a single json string
                parsed = fd.parse_vector(
                    values if len(values) > 1 and not isinstance(values[0], str)
                    else values[0])
            elif fd.type == FieldType.LAT_LON:
                parsed = [(float(values[0]), float(values[1]))]
            elif fd.type == FieldType.CONTEXT_SUGGEST:
                parsed = [_suggest_entry(v) for v in values]
            elif fd.type == FieldType.POLYGON:
                # one GeoJSON polygon per doc (reference: PolygonfieldDef
                # .parseDocumentField rejects more than one value)
                if len(values) > 1:
                    raise ValueError("polygon length cannot be more than 1.")
                parsed = parse_geojson_polygon(values[0])[0]
            else:
                parsed = [fd.parse_doc_value(v) for v in values]
            parsed_fields.append((fd, parsed, values))
        self.num_docs += 1
        for fd, parsed, values in parsed_fields:
            if fd.type == FieldType.VECTOR:
                self._vectors.setdefault(fd.name, []).append((doc_id, parsed))
                if fd.store:
                    stored_row[fd.name] = parsed.tolist()
                continue
            if fd.type == FieldType.LAT_LON:
                self._dv.setdefault(fd.name, []).append((doc_id, parsed[0]))
                if fd.store:
                    stored_row[fd.name] = list(parsed[0])
                continue
            if fd.type == FieldType.CONTEXT_SUGGEST:
                self._suggest.setdefault(fd.name, []).extend(
                    (doc_id, *entry) for entry in parsed)
                if fd.store:
                    stored_row[fd.name] = list(values)
                continue
            if fd.type == FieldType.POLYGON:
                self._dv.setdefault(fd.name, []).append((doc_id, parsed))
                if fd.store:
                    stored_row[fd.name] = json.loads(parsed)
                continue
            if fd.search and fd.is_text:
                self._index_text(fd, doc_id, [str(v) for v in parsed])
            if fd.store_doc_values:
                self._dv.setdefault(fd.name, []).extend((doc_id, p) for p in parsed)
            if fd.store:
                stored_row[fd.name] = parsed if fd.multi_valued else parsed[0]
        self._stored.append(stored_row)
        return doc_id

    def _index_text(self, fd: FieldDef, doc_id: int, values: list[str]) -> None:
        """Postings with positions: each value's tokens at their analyzer
        positions, ``POSITION_GAP`` past the previous value's last one. An
        ``indexPrefixes`` field also indexes each token's [min, max]-char
        prefixes into the hidden ``<field>._index_prefix`` field at the
        same positions (reference: PrefixFieldDef). With the native
        accumulator each value goes in as it is analyzed, so a term's
        positions keep the values' order."""
        acc = self._accumulator(fd.name) if self._native is not None else None
        native_tok = (acc is not None and fd.type == FieldType.TEXT
                      and fd.index_analyzer is None and fd.index_prefixes is None)
        positions: dict[str, list[int]] = {}
        prefixes: dict[str, list[int]] = {}
        total = 0
        base = 0
        for v in values:
            cnt = acc.add_text(doc_id, v, base) if native_tok else -1
            if cnt >= 0:
                total += cnt
                base += cnt + self.POSITION_GAP
                continue
            if acc is not None:
                positions = {}
            max_pos = 0
            for tok in fd.index_tokens(v):
                pos = base + tok.position
                positions.setdefault(tok.text, []).append(pos)
                if fd.index_prefixes is not None:
                    lo, hi = fd.index_prefixes
                    for plen in range(lo, min(hi, len(tok.text)) + 1):
                        prefixes.setdefault(tok.text[:plen], []).append(pos)
                max_pos = max(max_pos, tok.position + 1)
                total += 1
            if acc is not None:
                acc.add_terms(doc_id, positions)
            base += max_pos + self.POSITION_GAP
        self._add_postings(fd.name, doc_id, {} if acc is not None else positions, total)
        if prefixes:
            self._add_postings(f"{fd.name}._index_prefix", doc_id, prefixes,
                               sum(len(p) for p in prefixes.values()))

    def _accumulator(self, name: str):
        acc = self._acc.get(name)
        if acc is None:
            acc = self._acc[name] = self._native.PostingsAccumulator()
        return acc

    def _add_postings(self, name: str, doc_id: int, positions: dict, length: int) -> None:
        """The doc's field length, and its postings: into the field's native
        accumulator when it has one, else the Python lists."""
        lens = self._doc_lens.setdefault(name, [])
        while len(lens) < doc_id:
            lens.append(0)
        lens.append(length)
        if self._native is not None:
            self._accumulator(name).add_terms(doc_id, positions)
            return
        post = self._postings.setdefault(name, {})
        for term, plist in positions.items():
            post.setdefault(term, []).append((doc_id, len(plist), plist))

    def set_text_arrays(self, name: str, terms: list[str], lengths: np.ndarray,
                        doc_ids: np.ndarray, freqs: np.ndarray,
                        positions: np.ndarray, position_offsets: np.ndarray,
                        doc_lens: list[int]) -> None:
        """Packed postings for one field (a merge's): per term in id order
        its run length, then per entry its doc, freq and positions (CSR)."""
        self._text_arrays[name] = (terms, lengths, doc_ids, freqs, positions,
                                   position_offsets)
        self._doc_lens[name] = doc_lens

    def flush(self, seg_id: Optional[str] = None) -> Optional[Segment]:
        if self.num_docs == 0:
            return None
        capacity = pad_to_bucket(self.num_docs)
        fields = {
            name: self._pack_text_arrays(name, capacity, *_postings_arrays(post))
            for name, post in self._postings.items()
        }
        for name, acc in self._acc.items():
            fields[name] = self._pack_text_field_native(name, acc, capacity)
        for name, arrays in self._text_arrays.items():
            fields[name] = self._pack_text_arrays(name, capacity, *arrays)
        doc_values = {
            name: self._pack_doc_values(self.field_defs[name], vals, capacity)
            for name, vals in self._dv.items()
        }
        vectors = {
            name: self._pack_vectors(self.field_defs[name], vals, capacity)
            for name, vals in self._vectors.items()
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
            vectors=vectors,
            suggest={k: list(v) for k, v in self._suggest.items()},
        )

    def _pack_vectors(self, fd: FieldDef, vals: list, capacity: int) -> VectorColumn:
        """One vector column (the reference's ``_pack_vectors``): an f32
        [capacity, dims] matrix, zero where a doc has no vector, stored in
        the field's format; norms of the f32 rows."""
        mat = np.zeros((capacity, fd.dims), dtype=np.float32)
        present = np.zeros(capacity, dtype=bool)
        for doc, vec in vals:
            mat[doc] = vec
            present[doc] = True
        return vector_column(mat, present, getattr(fd, "vector_format", "float32"),
                             self.device)

    def _pack_doc_values(self, fd: FieldDef, vals: list, capacity: int) -> DocValueColumn:
        """One column in the reference's layout (nrtsearch_tpu/core/segment.py
        ``_pack_doc_values``): ordinals in sorted term order, -1 where a doc
        has no value; multi-valued columns keep each doc's values sorted in
        CSR arrays and its first value in the single-valued column."""
        kind = fd.doc_value_kind
        present = np.zeros(capacity, dtype=bool)
        n = self.num_docs
        ord_terms = None
        if kind == DocValueKind.LAT_LON:
            host = np.zeros((capacity, 2), dtype=np.float64)
            for doc, (lat, lon) in vals:
                host[doc] = (lat, lon)
                present[doc] = True
            return doc_value_column(kind, host, present, self.device)
        if kind == DocValueKind.POLYGON:
            return self._pack_polygons(vals, capacity, present)
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

    def _pack_text_field_native(self, field_name: str, acc, capacity: int) -> TextFieldIndex:
        """A native accumulator's packed arrays in the layout of
        ``_pack_text_arrays``; an entry's position offsets are the running
        sum of the freqs (each token occurrence holds one position)."""
        names, _offs_b, lens_b, docs_b, freqs_b, pos_b = acc.finish()
        freqs = np.frombuffer(freqs_b, np.int32)
        pos_offsets = np.zeros(len(freqs) + 1, np.int64)
        np.cumsum(freqs, out=pos_offsets[1:])
        return self._pack_text_arrays(
            field_name, capacity, names, np.frombuffer(lens_b, np.int32).copy(),
            np.frombuffer(docs_b, np.int32), freqs.astype(np.float32),
            np.frombuffer(pos_b, np.int32).copy(), pos_offsets)

    def _pack_text_arrays(self, field_name: str, capacity: int, terms: list[str],
                          lengths: np.ndarray, docs: np.ndarray, freqs: np.ndarray,
                          positions: np.ndarray, position_offsets: np.ndarray
                          ) -> TextFieldIndex:
        total = len(docs)
        offsets = np.zeros(len(terms), dtype=np.int64)
        if len(terms) > 1:
            np.cumsum(lengths[:-1], out=offsets[1:])
        # slack so a run gather starting near the end never clamps
        p_pad = pad_to_bucket(total + 16384)
        doc_ids = np.zeros(p_pad, dtype=np.int32)
        doc_ids[:total] = docs
        pfreqs = np.zeros(p_pad, dtype=np.float32)
        pfreqs[:total] = freqs
        lens_list = self._doc_lens.get(field_name, [])
        lens = np.zeros(capacity, dtype=np.int64)
        lens[: len(lens_list)] = lens_list
        qlens = quantize_length(lens).astype(np.float32)
        return TextFieldIndex(
            terms={t: i for i, t in enumerate(terms)},
            offsets=offsets,
            lengths=np.asarray(lengths, dtype=np.int32),
            doc_ids=torch.as_tensor(doc_ids, device=self.device),
            freqs=torch.as_tensor(pfreqs, device=self.device),
            doc_lens=torch.as_tensor(qlens, device=self.device),
            sum_doc_lens=int(quantize_length(lens[: self.num_docs]).sum()),
            doc_count=int(np.count_nonzero(lens[: self.num_docs])),
            postings_len=total,
            positions=np.asarray(positions, dtype=np.int32),
            position_offsets=np.asarray(position_offsets, dtype=np.int64),
        )

    def _pack_polygons(self, vals: list, capacity: int, present: np.ndarray) -> DocValueColumn:
        """POLYGON column (the reference's ``_pack_polygons``): f32
        [capacity, V_pad, 2] of ring-closed, NaN-separated vertices (outer
        ring, then holes), so point containment is one parity count over
        the whole column (``ops.masks.doc_polygons_contain_point``). The
        GeoJSON strings ride doc-indexed in ``ord_terms`` for fetch."""
        per_doc = {doc: (geojson, parse_geojson_polygon(geojson)[1]) for doc, geojson in vals}

        def _flat(rings):
            pts: list[tuple[float, float]] = []
            for ring in rings:
                pts.extend(ring)
                if ring[0] != ring[-1]:
                    pts.append(ring[0])  # close the ring
                pts.append((np.nan, np.nan))  # separator: no cross-ring edge
            return pts

        flats = {d: _flat(rings) for d, (_, rings) in per_doc.items()}
        v_pad = pad_to_bucket(max((len(p) for p in flats.values()), default=1), minimum=8)
        arr = np.full((capacity, v_pad, 2), np.nan, dtype=np.float32)
        geojsons = [""] * self.num_docs
        for d, pts in flats.items():
            arr[d, : len(pts)] = np.asarray(pts, dtype=np.float32)
            present[d] = True
            geojsons[d] = per_doc[d][0]
        return doc_value_column(DocValueKind.POLYGON, arr, present, self.device, geojsons)


def _suggest_entry(v) -> tuple[str, float, list]:
    """(text, weight, contexts) of one CONTEXT_SUGGEST value: a JSON object
    with ``value``, ``weight`` and ``contexts``, or plain text (weight 1)."""
    if isinstance(v, str) and v.lstrip().startswith("{"):
        d = json.loads(v)
        return (str(d.get("value", "")), float(d.get("weight", 1.0)),
                list(d.get("contexts", [])))
    return (str(v), 1.0, [])


def _postings_arrays(post: dict[str, list]) -> tuple:
    """A builder's term -> [(doc, freq, positions)] lists as packed arrays:
    terms in first-seen order, run lengths, docs, freqs and the positions
    CSR over the entries."""
    terms = list(post)
    lengths = np.fromiter((len(post[t]) for t in terms), np.int32, len(terms))
    entries = [e for t in terms for e in post[t]]
    n = len(entries)
    docs = np.fromiter((e[0] for e in entries), np.int32, n)
    freqs = np.fromiter((e[1] for e in entries), np.float32, n)
    pos_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter((len(e[2]) for e in entries), np.int64, n), out=pos_offsets[1:])
    positions = np.fromiter(itertools.chain.from_iterable(e[2] for e in entries),
                            np.int32, int(pos_offsets[-1]))
    return terms, lengths, docs, freqs, positions, pos_offsets
