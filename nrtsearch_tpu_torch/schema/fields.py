"""Copy of ``nrtsearch_tpu/schema/fields.py``, kept whole: the port imports
nothing of the JAX package, not even its backend-free modules.

Field type definitions.

Each field type declares its capabilities (the reference expresses these as
interfaces in server/field/properties/: Sortable, TermQueryable, RangeQueryable,
VectorQueryable, ...) and how raw request values are parsed into:

- index tokens (inverted-index terms, for searchable text/atom fields),
- a doc value (columnar device array cell, for filter/sort/facet/collector),
- a stored value (host-side row storage for field fetch).

Built-in types mirror FieldDefCreator.java:48-75: ATOM, TEXT, BOOLEAN, LONG,
INT, DOUBLE, FLOAT, LAT_LON, DATE_TIME, _ID, VECTOR, CONTEXT_SUGGEST, OBJECT,
VIRTUAL, RUNTIME. This module implements the scalar/text/id/vector core;
OBJECT (nested), VIRTUAL and RUNTIME land with the query-algebra layer.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import Any, Callable, Optional

import numpy as np

from nrtsearch_tpu_torch.analysis import Analyzer, Token, get_analyzer


class FieldType(str, Enum):
    ATOM = "ATOM"
    TEXT = "TEXT"
    BOOLEAN = "BOOLEAN"
    LONG = "LONG"
    INT = "INT"
    DOUBLE = "DOUBLE"
    FLOAT = "FLOAT"
    LAT_LON = "LAT_LON"
    POLYGON = "POLYGON"
    DATE_TIME = "DATE_TIME"
    ID = "_ID"
    VECTOR = "VECTOR"
    CONTEXT_SUGGEST = "CONTEXT_SUGGEST"
    OBJECT = "OBJECT"
    VIRTUAL = "VIRTUAL"
    RUNTIME = "RUNTIME"


# Doc-value storage classes understood by the columnar segment format.
class DocValueKind(str, Enum):
    NONE = "NONE"
    LONG = "LONG"          # int64 column (also bool/date millis)
    DOUBLE = "DOUBLE"      # float64 column
    ORDINAL = "ORDINAL"    # int32 ordinal column + host term dictionary
    VECTOR = "VECTOR"      # float32 [num_docs, dims] matrix
    LAT_LON = "LAT_LON"    # float64 [num_docs, 2]
    POLYGON = "POLYGON"    # float32 [num_docs, V, 2] NaN-separated closed rings;
                           # the raw GeoJSON strings ride in ord_terms (doc-indexed)


@dataclass
class FieldDef:
    """One registered field. Immutable once the index holds documents."""

    name: str
    type: FieldType
    search: bool = False          # build inverted postings
    store: bool = False           # keep original value for fetch
    store_doc_values: bool = False
    multi_valued: bool = False
    sort: bool = False
    facet: Optional[str] = None   # None | "FLAT" | "NUMERIC_RANGE" | "SORTED_SET_DOC_VALUES"
    index_analyzer: Optional[Analyzer] = None
    search_analyzer: Optional[Analyzer] = None
    # VECTOR options
    dims: int = 0
    similarity: str = "cosine"    # l2_norm | dot_product | cosine | normalized_cosine | max_inner_product
    # storage format (reference: VectorFieldDef.java:91-94 HNSW scalar
    # quantization): float32 | float16 | int8 (scalar-quantized, 4x smaller)
    vector_format: str = "float32"
    # materialized prefix companion (reference: PrefixFieldDef.java:33,
    # luceneserver.proto IndexPrefixes: prefixes of length [min, max] are
    # indexed into a hidden "<name>._index_prefix" postings field so prefix
    # queries in range are SINGLE term lookups)
    index_prefixes: Optional[tuple] = None    # (min_chars, max_chars)
    # text scoring similarity (reference: SimilarityCreator, default BM25;
    # "boolean" = constant per-term scores, expressed as BM25 with k1=0)
    text_similarity: str = "BM25"
    sim_k1: float = 1.2
    sim_b: float = 0.75
    # DATE_TIME options
    date_time_format: Optional[str] = None
    # VIRTUAL / RUNTIME
    script_source: Optional[str] = None
    script_lang: Optional[str] = None
    # ATOM: values longer than this are not indexed (doc values still stored)
    ignore_above: int = 0
    # ATOM normalizer (analysis.proto Normalizer; applied to indexed terms,
    # ordinal doc values, and query terms)
    normalizer: Optional[Analyzer] = None
    # raw proto options kept for introspection / stats
    raw: dict = dc_field(default_factory=dict)

    # -- capability traits (server/field/properties/) ------------------------

    @property
    def is_text(self) -> bool:
        return self.type in (FieldType.TEXT, FieldType.ATOM, FieldType.ID)

    @property
    def term_queryable(self) -> bool:
        return self.search and self.is_text or self.type in (
            FieldType.BOOLEAN, FieldType.INT, FieldType.LONG,
        )

    @property
    def range_queryable(self) -> bool:
        return self.doc_value_kind in (DocValueKind.LONG, DocValueKind.DOUBLE)

    @property
    def sortable(self) -> bool:
        return self.store_doc_values and self.doc_value_kind in (
            DocValueKind.LONG, DocValueKind.DOUBLE, DocValueKind.ORDINAL,
        )

    @property
    def vector_queryable(self) -> bool:
        return self.type == FieldType.VECTOR

    @property
    def quantized(self) -> bool:
        return self.vector_format == "int8"

    @property
    def doc_value_kind(self) -> DocValueKind:
        if not self.store_doc_values and self.type != FieldType.VECTOR:
            return DocValueKind.NONE
        return {
            FieldType.ATOM: DocValueKind.ORDINAL,
            FieldType.TEXT: DocValueKind.ORDINAL,
            FieldType.ID: DocValueKind.ORDINAL,
            FieldType.BOOLEAN: DocValueKind.LONG,
            FieldType.LONG: DocValueKind.LONG,
            FieldType.INT: DocValueKind.LONG,
            FieldType.DATE_TIME: DocValueKind.LONG,
            FieldType.DOUBLE: DocValueKind.DOUBLE,
            FieldType.FLOAT: DocValueKind.DOUBLE,
            FieldType.VECTOR: DocValueKind.VECTOR,
            FieldType.LAT_LON: DocValueKind.LAT_LON,
            FieldType.POLYGON: DocValueKind.POLYGON,
            FieldType.CONTEXT_SUGGEST: DocValueKind.NONE,
            FieldType.OBJECT: DocValueKind.NONE,
            FieldType.VIRTUAL: DocValueKind.NONE,
            FieldType.RUNTIME: DocValueKind.NONE,
        }[self.type]

    # -- value parsing --------------------------------------------------------

    def index_tokens(self, value: str) -> list[Token]:
        """Analyze a raw value into index terms (searchable fields only)."""
        if self.type == FieldType.TEXT:
            analyzer = self.index_analyzer or get_analyzer("standard")
            return analyzer.analyze(value)
        # ATOM / _ID: single untokenized term (keyword semantics)
        if self.ignore_above and len(value) > self.ignore_above:
            return []  # Field.ignoreAbove: skip indexing oversized keywords
        value = self.normalize_value(value)
        return [Token(value, 0, 0, len(value))]

    def query_terms(self, text: str) -> list[str]:
        if self.type == FieldType.TEXT:
            analyzer = self.search_analyzer or self.index_analyzer or get_analyzer("standard")
            return analyzer.terms(text)
        return [self.normalize_value(text)]

    def normalize_value(self, value: str) -> str:
        """Apply the field's normalizer (identity without one). The whole
        value is one token (keyword tokenizer implied)."""
        if self.normalizer is None:
            return value
        toks = self.normalizer.analyze(value)
        return toks[0].text if toks else value

    def parse_doc_value(self, value: str) -> Any:
        """Parse one raw request value into its typed doc value."""
        t = self.type
        if t in (FieldType.INT, FieldType.LONG):
            return int(value)
        if t in (FieldType.FLOAT, FieldType.DOUBLE):
            return float(value)
        if t == FieldType.BOOLEAN:
            return 1 if str(value).lower() in ("true", "1", "yes") else 0
        if t == FieldType.DATE_TIME:
            return self._parse_datetime_millis(value)
        if t in (FieldType.LAT_LON, FieldType.POLYGON):
            return value  # parsed at the document level
        return self.normalize_value(str(value))

    def parse_vector(self, value: Any) -> np.ndarray:
        if isinstance(value, str):
            import json

            value = json.loads(value)
        vec = np.asarray(value, dtype=np.float32)
        if vec.shape != (self.dims,):
            raise ValueError(
                f"field {self.name!r}: vector has shape {vec.shape}, expected ({self.dims},)"
            )
        return vec

    def _parse_datetime_millis(self, value: str) -> int:
        fmt = self.date_time_format
        if fmt == "epoch_millis" or fmt is None:
            try:
                return int(value)
            except ValueError:
                pass
        if fmt and fmt not in ("epoch_millis", "strict_date_optional_time"):
            # Java SimpleDateFormat-ish pattern -> strptime best-effort
            py_fmt = (
                fmt.replace("yyyy", "%Y").replace("MM", "%m").replace("dd", "%d")
                .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S")
            )
            dt = _dt.datetime.strptime(value, py_fmt).replace(tzinfo=_dt.timezone.utc)
            return int(dt.timestamp() * 1000)
        dt = _dt.datetime.fromisoformat(value)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        return int(dt.timestamp() * 1000)


# ---------------------------------------------------------------------------
# Registry (FieldDefCreator equivalent; plugin-extensible)
# ---------------------------------------------------------------------------

_FIELD_FACTORIES: dict[str, Callable[[str, dict], FieldDef]] = {}


def register_field_type(type_name: str, factory: Callable[[str, dict], FieldDef]) -> None:
    _FIELD_FACTORIES[type_name] = factory


def _vector_format(opts) -> str:
    """vectorIndexingOptions -> storage format. Accepts the plain format name
    ("int8", "float16") or the reference-shaped dict/string
    ({"type": "hnsw_scalar_quantized", "quantizedBits": 8} — any quantized
    type maps to int8 brute-force storage here, VectorFieldDef.java:91-94)."""
    if not opts:
        return "float32"
    if isinstance(opts, dict):
        t = str(opts.get("type", "")).lower()
        if "quantized" in t:
            return "int8"
        return _vector_format(opts.get("format", ""))
    s = str(opts).lower()
    if "int8" in s or "quantized" in s or "byte" in s:
        return "int8"
    if "float16" in s or "fp16" in s or "half" in s:
        return "float16"
    return "float32"


def create_field_def(name: str, spec: dict) -> FieldDef:
    """Build a FieldDef from a proto-shaped Field dict (luceneserver.proto Field).

    Recognized keys mirror the reference's Field message: type, search, store,
    storeDocValues, multiValued, sort, facet, analyzer/indexAnalyzer/
    searchAnalyzer, vectorDimensions, vectorSimilarity, dateTimeFormat.
    """
    type_name = spec.get("type", "TEXT")
    if type_name in _FIELD_FACTORIES:
        return _FIELD_FACTORIES[type_name](name, spec)
    ftype = FieldType(type_name)

    def _normalizer(spec_n) -> Optional[Analyzer]:
        if spec_n is None:
            return None
        from nrtsearch_tpu_torch.analysis.analyzers import get_normalizer

        return get_normalizer(spec_n)

    def _analyzer(key: str) -> Optional[Analyzer]:
        a = spec.get(key) or spec.get("analyzer")
        if a is None:
            return None
        if isinstance(a, str):
            return get_analyzer(a)
        if isinstance(a, dict):
            if "predefined" in a:
                return get_analyzer(a["predefined"])
            if "custom" in a:
                from nrtsearch_tpu_torch.analysis.analyzers import _DEFAULT_REGISTRY

                return _DEFAULT_REGISTRY.from_custom(a["custom"])
        raise ValueError(f"bad analyzer spec for field {name!r}: {a!r}")

    fd = FieldDef(
        name=name,
        type=ftype,
        search=bool(spec.get("search", ftype == FieldType.ID)),
        store=bool(spec.get("store", False)),
        store_doc_values=bool(spec.get("storeDocValues", ftype == FieldType.ID)),
        multi_valued=bool(spec.get("multiValued", False)),
        sort=bool(spec.get("sort", False)),
        facet=spec.get("facet"),
        index_analyzer=_analyzer("indexAnalyzer"),
        search_analyzer=_analyzer("searchAnalyzer"),
        normalizer=_normalizer(spec.get("normalizer")),
        dims=int(spec.get("vectorDimensions", 0)),
        similarity=spec.get("vectorSimilarity", "cosine"),
        vector_format=_vector_format(spec.get("vectorIndexingOptions")),
        date_time_format=spec.get("dateTimeFormat"),
        ignore_above=int(spec.get("ignoreAbove", 0)),
        script_source=(spec.get("script") or {}).get("source")
        if isinstance(spec.get("script"), dict)
        else spec.get("script"),
        script_lang=(spec.get("script") or {}).get("lang")
        if isinstance(spec.get("script"), dict)
        else None,
        index_prefixes=(
            (
                int(spec["indexPrefixes"].get("minChars", 2)),
                int(spec["indexPrefixes"].get("maxChars", 5)),
            )
            if isinstance(spec.get("indexPrefixes"), dict)
            else None
        ),
        raw=dict(spec),
    )
    sim_name = spec.get("similarity", "") or "BM25"
    sim_params = spec.get("similarityParams", {}) or {}
    fd.text_similarity = sim_name
    if sim_name.lower() == "boolean":
        fd.sim_k1 = 0.0  # tf/(tf + 0) == 1: constant per-term contribution
    else:
        fd.sim_k1 = float(sim_params.get("k1", 1.2))
        fd.sim_b = float(sim_params.get("b", 0.75))
    if fd.type == FieldType.VECTOR and fd.dims <= 0:
        raise ValueError(f"VECTOR field {name!r} requires vectorDimensions > 0")
    if fd.vector_format not in ("float32", "float16", "int8"):
        raise ValueError(
            f"field {name!r}: unknown vector format {fd.vector_format!r} "
            "(float32 | float16 | int8)"
        )
    if fd.sort and not fd.store_doc_values:
        # sorting requires a doc-values column, as in the reference
        fd.store_doc_values = True
    return fd


def parse_geojson_polygon(value: Any) -> tuple[str, list[list[tuple[float, float]]]]:
    """Parse a GeoJSON polygon into (canonical json string, rings).

    Rings are lists of (lat, lon) pairs; the first ring is the outer shell,
    the rest are holes. Accepts Polygon, single-polygon MultiPolygon, and
    Feature wrappers — the subset Lucene's Polygon.fromGeoJSON handles for
    the reference's POLYGON field (field/PolygonfieldDef.java:
    parseDocumentField rejects multi-polygons too). GeoJSON coordinate order
    is [lon, lat]."""
    import json as _json

    try:
        obj = _json.loads(value) if isinstance(value, str) else value
    except ValueError:
        raise ValueError(f"Invalid geojson {value!r}") from None
    if not isinstance(obj, dict):
        raise ValueError(f"Invalid geojson {value!r}")
    if obj.get("type") == "Feature":
        obj = obj.get("geometry") or {}
    t = obj.get("type")
    if t == "Polygon":
        polys = [obj.get("coordinates") or []]
    elif t == "MultiPolygon":
        polys = obj.get("coordinates") or []
        if len(polys) > 1:
            raise ValueError("Multipolygon not supported")
    else:
        raise ValueError(f"Invalid geojson type: {t!r}")
    if not polys or not polys[0] or not polys[0][0]:
        raise ValueError("Invalid geojson: polygon has no rings")
    try:
        rings = [
            [(float(pt[1]), float(pt[0])) for pt in ring] for ring in polys[0]
        ]
    except (TypeError, IndexError, ValueError):
        raise ValueError(f"Invalid geojson coordinates in {value!r}") from None
    if any(len(r) < 3 for r in rings):
        raise ValueError("Invalid geojson: ring needs at least 3 points")
    return _json.dumps(obj), rings
