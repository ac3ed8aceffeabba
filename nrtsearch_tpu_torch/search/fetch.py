"""Copy of ``nrtsearch_tpu/search/fetch.py``, kept whole but for the vector
branch: the port's vector columns live on the device, so a vector field's
fetch reads the hit's presence bit and copies its row alone, where the
reference read ``np.asarray(vc.present)`` (which a CUDA tensor refuses) and
copied the segment's whole matrix to the host for every hit; the values
are the same. Every other read here is of host arrays (stored rows, ``host_values``,
``host_present``, CSR arrays). Script fields run the port's ``script.expr``:
called with a numpy score, as here, it hands back a numpy array.

Field fetch: fill hits with stored fields / doc values / virtual fields.

Reference: SearchHandler.FillDocsTask (SearchHandler.java:1114) +
LoadedDocValues converters (server/doc/LoadedDocValues.java). Fetch is host
work over the segment's host-resident stored rows and doc-value columns.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from nrtsearch_tpu_torch.core.searcher import Hit, Searcher
from nrtsearch_tpu_torch.schema.fields import DocValueKind, FieldDef, FieldType


def _references_score(fd: FieldDef) -> bool:
    """Whether a virtual/runtime field's script reads the hit's ``_score``.

    For the built-in expression language the source is tokenized and
    ``_score`` must appear as an exact identifier (a doc-value field named
    e.g. ``quality_score`` must NOT force the per-hit path). Plugin script
    langs can't be tokenized here, so a conservative substring test stands
    in; their engines see the untouched source either way."""
    src = fd.script_source or ""
    if "_score" not in src:
        return False
    if fd.script_lang in (None, "", "js", "expression"):
        try:
            from nrtsearch_tpu_torch.script.expr import _tokenize

            return "_score" in _tokenize(src)
        except ValueError:
            return True
    return True


def _compiled_script(fd: FieldDef):
    """Compile a virtual/runtime field's script once per FieldDef, honoring
    its script lang (plugin engines included)."""
    fn = getattr(fd, "_compiled_script_fn", None)
    if fn is None:
        from nrtsearch_tpu_torch.script.expr import compile_expression

        fn = compile_expression(fd.script_source or "0", fd.script_lang or "")
        object.__setattr__(fd, "_compiled_script_fn", fn)
    return fn


def fetch_field_values(
    searcher: Searcher,
    hit: Hit,
    field_name: str,
    field_defs: dict[str, FieldDef],
    virtual_values: Optional[dict[str, np.ndarray]] = None,
) -> Optional[list[Any]]:
    """All values of one field for one hit, or None if absent."""
    seg = searcher.segments[hit.segment_idx]
    local = hit.local_id
    if virtual_values and field_name in virtual_values:
        return [float(virtual_values[field_name][hit.global_ord])]
    fd = field_defs.get(field_name)
    if fd is not None and fd.type in (FieldType.VIRTUAL, FieldType.RUNTIME):
        src = fd.script_source or "0"
        if _references_score(fd):
            # score-dependent virtual field: evaluate at this hit with its
            # relevance score bound (reference: VirtualFieldDef binds
            # DoubleValues score — NrtsearchServerTest virtual_field_w_score)
            fn = _compiled_script(fd)
            v = np.asarray(fn(
                _HitScriptDocValues(seg, local),
                np.asarray([np.float32(hit.score)]),
            ))
            return [float(v.reshape(-1)[0])]
        col = virtual_field_column(searcher, hit.segment_idx, fd)
        return [float(col[local])]
    # stored first (like the reference's stored-field preference for source)
    if fd is not None and fd.store:
        row = seg.stored[local]
        if field_name in row:
            v = row[field_name]
            return list(v) if isinstance(v, list) and fd.multi_valued else (
                v if isinstance(v, list) and fd.type == FieldType.VECTOR else
                v if isinstance(v, list) and fd.type == FieldType.LAT_LON else
                [v] if not isinstance(v, list) else v
            )
    dv = seg.doc_values.get(field_name)
    if dv is not None:
        if not dv.host_present[local] and dv.mv_offsets is None:
            return None
        if dv.mv_offsets is not None:
            lo, hi = dv.mv_offsets[local], dv.mv_offsets[local + 1]
            vals = dv.mv_values[lo:hi]
            if dv.kind == DocValueKind.ORDINAL:
                return [dv.ord_terms[int(o)] for o in vals]
            return [v.item() for v in vals]
        if dv.kind == DocValueKind.ORDINAL:
            return [dv.ord_terms[int(dv.host_values[local])]]
        if dv.kind == DocValueKind.LAT_LON:
            return [tuple(dv.host_values[local])]
        if dv.kind == DocValueKind.POLYGON:
            import json as _json

            return [_json.loads(dv.ord_terms[local])]
        return [dv.host_values[local].item()]
    vc = seg.vectors.get(field_name)
    if vc is not None:
        if not bool(vc.present[local]):
            return None
        return [vc.host_row(local).tolist()]
    if fd is None:
        raise KeyError(f"unknown field: {field_name!r}")
    row = seg.stored[local]
    if field_name in row:
        v = row[field_name]
        return v if isinstance(v, list) else [v]
    return None


class _HitScriptDocValues:
    """One-row doc-value view for per-hit script evaluation."""

    def __init__(self, segment, local: int):
        self._segment = segment
        self._local = local

    def __contains__(self, name: str) -> bool:
        return name in self._segment.doc_values

    def __getitem__(self, name: str):
        dv = self._segment.doc_values[name]
        present = bool(np.asarray(dv.host_present[self._local]))
        val = float(np.asarray(dv.host_values[self._local])) if present else 0.0
        return np.asarray([np.float32(val)])


def virtual_field_column(searcher: Searcher, segment_idx: int, fd: FieldDef) -> np.ndarray:
    """Schema-level VIRTUAL/RUNTIME field column (lazy, cached per searcher).

    Reference: VirtualFieldDef / runtime script fields — js-expression scripts
    over doc values (SURVEY.md §2.5). Evaluated vectorized over the whole
    segment once, cached on the immutable searcher snapshot.
    """
    cache = getattr(searcher, "_virtual_cache", None)
    if cache is None:
        cache = {}
        searcher._virtual_cache = cache
    key = (segment_idx, fd.name)
    if key not in cache:
        from nrtsearch_tpu_torch.query.eval import _ScriptDocValues

        seg = searcher.segments[segment_idx]
        fn = _compiled_script(fd)
        vals = np.asarray(fn(_ScriptDocValues(seg), np.zeros(seg.capacity, np.float32)))
        if vals.ndim == 0:
            vals = np.full(seg.capacity, float(vals), np.float32)
        cache[key] = vals
    return cache[key]


def fill_hit_fields_pb(
    pb_hit,
    searcher: Searcher,
    hit: Hit,
    retrieve_fields: Sequence[str],
    field_defs: dict[str, FieldDef],
    pb,
    virtual_values: Optional[dict[str, np.ndarray]] = None,
) -> None:
    """Populate a SearchResponse.Hit proto's fields map."""
    for name in retrieve_fields:
        values = fetch_field_values(searcher, hit, name, field_defs, virtual_values)
        comp = pb_hit.fields[name]  # creates entry (even when absent, like ref)
        if values is None:
            continue
        fd = field_defs.get(name)
        for v in values:
            fv = comp.fieldValue.add()
            _set_field_value(fv, v, fd, pb)


def _set_field_value(fv, v: Any, fd: Optional[FieldDef], pb) -> None:
    if fd is not None:
        t = fd.type
        if t == FieldType.VECTOR and isinstance(v, (list, tuple)):
            fv.vectorValue.value.extend(float(x) for x in v)
            return
        if t == FieldType.LAT_LON and isinstance(v, (list, tuple)):
            fv.latLngValue.latitude = float(v[0])
            fv.latLngValue.longitude = float(v[1])
            return
        if t == FieldType.POLYGON and isinstance(v, dict):
            # GeoJSON struct, like the reference's PolygonfieldDef
            # getStoredFieldValue (structValue)
            fv.structValue.update(v)
            return
        if t == FieldType.BOOLEAN:
            fv.booleanValue = str(v).lower() in ("true", "1")
            return
        if t == FieldType.INT:
            fv.intValue = int(v)
            return
        if t == FieldType.LONG:
            fv.longValue = int(v)
            return
        if t == FieldType.FLOAT:
            fv.floatValue = float(v)
            return
        if t == FieldType.DOUBLE:
            fv.doubleValue = float(v)
            return
        if t == FieldType.DATE_TIME:
            fv.dateTimeValue = int(v) if not isinstance(v, str) else fd.parse_doc_value(v)
            return
    if isinstance(v, bool):
        fv.booleanValue = v
    elif isinstance(v, int):
        fv.longValue = v
    elif isinstance(v, float):
        fv.doubleValue = v
    else:
        fv.textValue = str(v)
