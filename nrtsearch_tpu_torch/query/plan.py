"""Copy of ``nrtsearch_tpu/query/plan.py``, kept whole: the port imports
nothing of the JAX package, not even its backend-free modules.

Query plan nodes and the proto-dict -> plan parser.

The node set mirrors the reference's proto Query oneof (search.proto:722-760
in the reference; our proto/yelp/nrtsearch/search.proto). ``parse_query`` accepts the
proto-JSON dict shape so JSON test resources and pb-to-dict both feed it.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import Any, Optional, Sequence


class Occur(str, Enum):
    MUST = "MUST"
    FILTER = "FILTER"
    SHOULD = "SHOULD"
    MUST_NOT = "MUST_NOT"


@dataclass(frozen=True)
class QueryNode:
    boost: float = 1.0


@dataclass(frozen=True)
class MatchAllNode(QueryNode):
    pass


@dataclass(frozen=True)
class TermQueryNode(QueryNode):
    field: str = ""
    text: Optional[str] = None        # text/atom/_id term
    long_value: Optional[int] = None  # numeric exact match
    double_value: Optional[float] = None
    bool_value: Optional[bool] = None


@dataclass(frozen=True)
class TermInSetNode(QueryNode):
    field: str = ""
    texts: tuple[str, ...] = ()
    long_values: tuple[int, ...] = ()
    double_values: tuple[float, ...] = ()


@dataclass(frozen=True)
class MatchQueryNode(QueryNode):
    field: str = ""
    query: str = ""
    operator: str = "SHOULD"          # SHOULD (or) | MUST (and)
    minimum_number_should_match: int = 0
    analyzer: Optional[str] = None
    fuzzy_max_edits: int = 0          # >0: expand terms within edit distance
    fuzzy_prefix_length: int = 0
    fuzzy_max_expansions: int = 50


@dataclass(frozen=True)
class MultiMatchQueryNode(QueryNode):
    fields: tuple[str, ...] = ()
    query: str = ""
    field_boosts: tuple[float, ...] = ()
    operator: str = "SHOULD"
    minimum_number_should_match: int = 0
    # reference MultiMatchQuery.MatchType: BEST_FIELDS (dis-max, default),
    # PHRASE_PREFIX (per-field MatchPhrasePrefix, dis-max), CROSS_FIELDS
    # (term-centric best-field scoring)
    match_type: str = "BEST_FIELDS"
    tie_breaker: float = 0.0
    slop: int = 0
    max_expansions: int = 50


@dataclass(frozen=True)
class MatchPhrasePrefixQueryNode(QueryNode):
    """Phrase whose last analyzed term matches by prefix (reference:
    query/MatchPhrasePrefixQuery.java -> Lucene MultiPhrasePrefixQuery)."""

    field: str = ""
    query: str = ""
    slop: int = 0
    analyzer: Optional[str] = None
    max_expansions: int = 50


@dataclass(frozen=True)
class PhraseQueryNode(QueryNode):
    field: str = ""
    terms: tuple[str, ...] = ()
    slop: int = 0


@dataclass(frozen=True)
class MatchPhraseQueryNode(QueryNode):
    field: str = ""
    query: str = ""
    slop: int = 0


@dataclass(frozen=True)
class RangeQueryNode(QueryNode):
    field: str = ""
    lower: Optional[float] = None
    upper: Optional[float] = None
    lower_exclusive: bool = False
    upper_exclusive: bool = False


@dataclass(frozen=True)
class ExistsQueryNode(QueryNode):
    field: str = ""


@dataclass(frozen=True)
class PrefixQueryNode(QueryNode):
    field: str = ""
    prefix: str = ""
    max_expansions: int = 128


@dataclass(frozen=True)
class FuzzyQueryNode(QueryNode):
    field: str = ""
    text: str = ""
    max_edits: int = 2
    prefix_length: int = 0
    max_expansions: int = 50


@dataclass(frozen=True)
class WildcardQueryNode(QueryNode):
    field: str = ""
    pattern: str = ""
    max_expansions: int = 128


@dataclass(frozen=True)
class ConstantScoreNode(QueryNode):
    filter: Optional[QueryNode] = None


@dataclass(frozen=True)
class CrossIndexQueryNode(QueryNode):
    """Join against another index (reference: CrossIndexQuery ->
    JoinUtil.createJoinQuery). Resolved by the server into a
    ResolvedJoinNode before evaluation (needs global state)."""

    index: str = ""
    primary_field: str = ""
    secondary_field: str = ""
    query: Optional[QueryNode] = None
    score_mode: str = "JOIN_SCORE_UNSET"
    max_terms: int = 0


@dataclass(frozen=True)
class ResolvedJoinNode(QueryNode):
    """CrossIndexQueryNode after the secondary-index search: join values of
    ``field`` with their aggregated scores."""

    field: str = ""
    values: tuple = ()          # join values (str or number)
    value_scores: tuple = ()    # aggregated score per value (parallel)
    constant_score: bool = False  # JOIN_SCORE_NONE


@dataclass(frozen=True)
class SpanClause:
    """One span source: a literal term, a multi-term expansion, or a nested
    span-near group.

    ``kind`` is "term" (text is the term), one of "prefix" / "wildcard" /
    "fuzzy" / "regexp" / "term_range" (text is the pattern / lower bound;
    expanded against the segment's term dictionary at eval time), or "near"
    (``near`` holds a nested SpanNearNode whose matches become this clause's
    spans — reference: SpanNearQuery.clauses accepts any SpanQuery,
    search.proto:622-631)."""

    kind: str
    field: str
    text: str
    max_edits: int = 2        # fuzzy
    prefix_length: int = 0    # fuzzy
    max_expansions: int = 50
    upper: str = ""           # term_range upper bound ("" = open)
    include_lower: bool = True   # term_range
    include_upper: bool = True   # term_range
    near: Optional["SpanNearNode"] = None  # kind == "near"


@dataclass(frozen=True)
class SpanNearNode(QueryNode):
    """Clause spans within ``slop`` positions, optionally in order
    (reference: search.proto SpanNearQuery -> Lucene SpanNearQuery)."""

    clauses: tuple[SpanClause, ...] = ()
    slop: int = 0
    in_order: bool = False


@dataclass(frozen=True)
class DisjunctionMaxNode(QueryNode):
    """Best disjunct's score + tieBreaker * the rest (Lucene DisMaxQuery)."""

    disjuncts: tuple[QueryNode, ...] = ()
    tie_breaker: float = 0.0


@dataclass(frozen=True)
class MinScoreNode(QueryNode):
    """Docs whose inner score is >= min_score (reference: MinScoreQuery)."""

    query: Optional[QueryNode] = None
    min_score: float = 0.0


@dataclass(frozen=True)
class FunctionFilterNode(QueryNode):
    """Docs with a positive script score (reference: FunctionFilterQuery)."""

    expression: str = "0"


@dataclass(frozen=True)
class ExactVectorQueryNode(QueryNode):
    """Exact vector-similarity scoring of every doc with the field
    (reference: query/vector/ExactVectorQuery.java)."""

    field: str = ""
    query_vector: tuple[float, ...] = ()


@dataclass(frozen=True)
class GeoBoundingBoxNode(QueryNode):
    field: str = ""
    min_lat: float = -90.0
    max_lat: float = 90.0
    min_lon: float = -180.0
    max_lon: float = 180.0


@dataclass(frozen=True)
class GeoRadiusNode(QueryNode):
    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    radius_meters: float = 0.0


@dataclass(frozen=True)
class BooleanClause:
    occur: Occur
    node: QueryNode


@dataclass(frozen=True)
class BooleanQueryNode(QueryNode):
    clauses: tuple[BooleanClause, ...] = ()
    minimum_number_should_match: int = 0


@dataclass(frozen=True)
class FunctionScoreNode(QueryNode):
    """Function-scored wrapper (reference: MultiFunctionScoreQuery subset).

    ``expression`` is a js-expression-subset string over doc values and
    ``_score`` (reference: server/script/js/JsScriptEngine.java compiles the
    same language to bytecode; we compile it to a jax expression)."""

    query: Optional[QueryNode] = None
    expression: str = "_score"


@dataclass(frozen=True)
class DecaySpec:
    """Distance-decay scoring spec (reference:
    query/multifunction/DecayFilterFunction.java + GeoPointDecayFilterFunction
    .java). ``scale``/``offset`` are meters (parsed from "10", "5 km",
    "7 mi"); origin is a (lat, lon) point."""

    field: str
    decay_type: str            # EXPONENTIAL | LINEAR | GUASSIAN
    origin: tuple[float, float]
    scale: float               # meters (user scale; adjusted per decay type at eval)
    offset: float = 0.0
    decay: float = 0.5


@dataclass(frozen=True)
class FilterFunctionSpec:
    """One weighted scoring function, optionally gated by a filter query
    (reference: query/multifunction/FilterFunction.java)."""

    filter: Optional[QueryNode] = None
    weight: float = 1.0
    script: Optional[str] = None      # js-expression over doc values + _score
    decay: Optional[DecaySpec] = None


@dataclass(frozen=True)
class MultiFunctionScoreNode(QueryNode):
    """Combine inner-query scores with weighted filter functions (reference:
    query/multifunction/MultiFunctionScoreQuery.java)."""

    query: Optional[QueryNode] = None
    functions: tuple[FilterFunctionSpec, ...] = ()
    score_mode: str = "SCORE_MODE_MULTIPLY"
    boost_mode: str = "BOOST_MODE_MULTIPLY"
    min_score: float = 0.0
    min_excluded: bool = False


@dataclass(frozen=True)
class PolygonSpec:
    """One query polygon: outer ring + holes, (lat, lon) points."""

    points: tuple[tuple[float, float], ...] = ()
    holes: tuple[tuple[tuple[float, float], ...], ...] = ()


@dataclass(frozen=True)
class GeoPolygonNode(QueryNode):
    """Docs whose LAT_LON point lies inside any of the polygons
    (reference: GeoPolygonQuery, search.proto message GeoPolygonQuery)."""

    field: str = ""
    polygons: tuple[PolygonSpec, ...] = ()


@dataclass(frozen=True)
class PolygonContainsNode(QueryNode):
    """Docs whose indexed POLYGON field contains the query point
    (reference: GeoPointQuery against PolygonfieldDef)."""

    field: str = ""
    lat: float = 0.0
    lon: float = 0.0


@dataclass(frozen=True)
class CompletionQueryNode(QueryNode):
    """Context-suggest completion (reference: CompletionQuery + MyContextQuery)."""

    field: str = ""
    text: str = ""
    fuzzy: bool = False
    contexts: tuple[str, ...] = ()


@dataclass(frozen=True)
class NestedQueryNode(QueryNode):
    """Block-join query on nested child docs, scores aggregated to parents."""

    path: str = ""
    query: Optional[QueryNode] = None
    score_mode: str = "NONE"  # NONE | AVG | MAX | SUM | MIN (proto3 default NONE)


@dataclass(frozen=True)
class KnnQueryNode(QueryNode):
    field: str = ""
    query_vector: tuple[float, ...] = ()
    k: int = 10
    num_candidates: int = 0
    filter: Optional[QueryNode] = None


# ---------------------------------------------------------------------------
# Parser: proto-JSON dict -> plan
# ---------------------------------------------------------------------------


def _parse_distance(s: Any) -> float:
    """'10km' / '500m' / '3mi' / number -> meters."""
    if isinstance(s, (int, float)):
        return float(s)
    raw = s
    s = str(s).strip().lower()
    try:
        for suffix, mult in (("km", 1000.0), ("mi", 1609.344), ("m", 1.0)):
            if s.endswith(suffix):
                return float(s[: -len(suffix)]) * mult
        return float(s)
    except ValueError:
        raise ValueError(f"Invalid distance {raw!r}") from None


def parse_query(q: dict) -> QueryNode:
    """Parse a proto-JSON-shaped Query dict into plan nodes.

    Mirrors QueryNodeMapper.getQueryNode's oneof switch
    (reference server/query/QueryNodeMapper.java:171-204).
    """
    if not q:
        return MatchAllNode()
    boost = float(q.get("boost", 0) or 0) or 1.0

    if "matchAllQuery" in q:
        return MatchAllNode(boost=boost)
    if "termQuery" in q:
        t = q["termQuery"]
        return TermQueryNode(
            boost=boost,
            field=t["field"],
            text=t.get("textValue"),
            long_value=_first_int(t, "longValue", "intValue"),
            double_value=_first_float(t, "doubleValue", "floatValue"),
            bool_value=t.get("booleanValue"),
        )
    if "termInSetQuery" in q:
        t = q["termInSetQuery"]
        texts = tuple((t.get("textTerms") or {}).get("terms", []))
        longs = tuple(
            int(v)
            for v in (t.get("longTerms") or {}).get("terms", [])
            + (t.get("intTerms") or {}).get("terms", [])
        )
        doubles = tuple(
            float(v)
            for v in (t.get("doubleTerms") or {}).get("terms", [])
            + (t.get("floatTerms") or {}).get("terms", [])
        )
        return TermInSetNode(
            boost=boost, field=t["field"], texts=texts, long_values=longs,
            double_values=doubles,
        )
    if "matchQuery" in q:
        m = q["matchQuery"]
        fz = m.get("fuzzyParams") or {}
        return MatchQueryNode(
            boost=boost,
            field=m["field"],
            query=m.get("query", ""),
            operator="MUST" if m.get("operator") in ("MUST", "MUST_MATCH") else "SHOULD",
            minimum_number_should_match=int(m.get("minimumNumberShouldMatch", 0)),
            analyzer=_analyzer_name(m.get("analyzer")),
            fuzzy_max_edits=int(fz.get("maxEdits", 0)),
            fuzzy_prefix_length=int(fz.get("prefixLength", 0)),
            fuzzy_max_expansions=int(fz.get("maxExpansions", 50)),
        )
    if "multiMatchQuery" in q:
        m = q["multiMatchQuery"]
        fields = tuple(m.get("fields", []))
        boosts_map = m.get("fieldBoosts", {})
        boosts = tuple(float(boosts_map.get(f, 1.0)) for f in fields)
        return MultiMatchQueryNode(
            boost=boost,
            fields=fields,
            query=m.get("query", ""),
            field_boosts=boosts,
            operator="MUST" if m.get("operator") == "MUST" else "SHOULD",
            minimum_number_should_match=int(m.get("minimumNumberShouldMatch", 0)),
            match_type=str(m.get("type", "BEST_FIELDS")),
            tie_breaker=float(m.get("tieBreakerMultiplier", 0.0)),
            slop=int(m.get("slop", 0)),
            max_expansions=int(m.get("maxExpansions", 0) or 50),
        )
    if "matchPhrasePrefixQuery" in q:
        m = q["matchPhrasePrefixQuery"]
        return MatchPhrasePrefixQueryNode(
            boost=boost,
            field=m["field"],
            query=m.get("query", ""),
            slop=int(m.get("slop", 0)),
            analyzer=_analyzer_name(m.get("analyzer")),
            max_expansions=int(m.get("maxExpansions", 0) or 50),
        )
    if "phraseQuery" in q:
        p = q["phraseQuery"]
        return PhraseQueryNode(
            boost=boost, field=p["field"], terms=tuple(p.get("terms", [])),
            slop=int(p.get("slop", 0)),
        )
    if "matchPhraseQuery" in q:
        p = q["matchPhraseQuery"]
        return MatchPhraseQueryNode(
            boost=boost, field=p["field"], query=p.get("query", ""),
            slop=int(p.get("slop", 0)),
        )
    if "rangeQuery" in q:
        r = q["rangeQuery"]
        lower = r.get("lower")
        upper = r.get("upper")
        return RangeQueryNode(
            boost=boost,
            field=r["field"],
            lower=float(lower) if lower not in (None, "") else None,
            upper=float(upper) if upper not in (None, "") else None,
            lower_exclusive=bool(r.get("lowerExclusive", False)),
            upper_exclusive=bool(r.get("upperExclusive", False)),
        )
    if "existsQuery" in q:
        return ExistsQueryNode(boost=boost, field=q["existsQuery"]["field"])
    if "prefixQuery" in q:
        p = q["prefixQuery"]
        return PrefixQueryNode(
            boost=boost, field=p["field"], prefix=p.get("prefix", ""),
            max_expansions=int(
                p.get("maxExpansions", 0) or p.get("rewriteTopTermsSize", 0)
                or 128
            ),
        )
    if "geoBoundingBoxQuery" in q:
        g = q["geoBoundingBoxQuery"]
        tl, br = g.get("topLeft", {}), g.get("bottomRight", {})
        return GeoBoundingBoxNode(
            boost=boost,
            field=g["field"],
            min_lat=float(br.get("latitude", -90)),
            max_lat=float(tl.get("latitude", 90)),
            min_lon=float(tl.get("longitude", -180)),
            max_lon=float(br.get("longitude", 180)),
        )
    if "geoRadiusQuery" in q:
        g = q["geoRadiusQuery"]
        c = g.get("center", {})
        return GeoRadiusNode(
            boost=boost,
            field=g["field"],
            lat=float(c.get("latitude", 0)),
            lon=float(c.get("longitude", 0)),
            radius_meters=_parse_distance(g.get("radius", "0m")),
        )
    if "fuzzyQuery" in q:
        f = q["fuzzyQuery"]
        return FuzzyQueryNode(
            boost=boost, field=f["field"], text=f.get("text", ""),
            max_edits=int(f.get("maxEdits", 2)),
            prefix_length=int(f.get("prefixLength", 0)),
            max_expansions=int(
                f.get("maxExpansions", 0) or f.get("rewriteTopTermsSize", 0)
                or 50
            ),
        )
    if "wildcardQuery" in q:
        w = q["wildcardQuery"]
        return WildcardQueryNode(
            boost=boost, field=w["field"],
            pattern=w.get("text") or w.get("pattern", ""),
            max_expansions=int(
                w.get("maxExpansions", 0) or w.get("rewriteTopTermsSize", 0)
                or 128
            ),
        )
    if "constantScoreQuery" in q:
        return ConstantScoreNode(
            boost=boost, filter=parse_query(q["constantScoreQuery"].get("filter", {}))
        )
    if "booleanQuery" in q:
        b = q["booleanQuery"]
        clauses = tuple(
            BooleanClause(
                occur=Occur(c.get("occur", "SHOULD")),
                node=parse_query(c.get("query", {})),
            )
            for c in b.get("clauses", [])
        )
        return BooleanQueryNode(
            boost=boost,
            clauses=clauses,
            minimum_number_should_match=int(b.get("minimumNumberShouldMatch", 0)),
        )
    if "functionScoreQuery" in q:
        f = q["functionScoreQuery"]
        return FunctionScoreNode(
            boost=boost,
            query=parse_query(f.get("query", {})),
            expression=(f.get("script") or {}).get("source", "_score"),
        )
    if "spanQuery" in q:
        return _parse_span(q["spanQuery"], boost)
    if "crossIndexQuery" in q:
        x = q["crossIndexQuery"]
        if not x.get("index"):
            raise ValueError("CrossIndexQuery.index must not be empty")
        if not x.get("primaryField"):
            raise ValueError("CrossIndexQuery.primary_field must not be empty")
        if not x.get("secondaryField"):
            raise ValueError("CrossIndexQuery.secondary_field must not be empty")
        if "query" not in x:
            raise ValueError("CrossIndexQuery.query must be set")
        return CrossIndexQueryNode(
            boost=boost,
            index=x["index"],
            primary_field=x["primaryField"],
            secondary_field=x["secondaryField"],
            query=parse_query(x["query"]),
            score_mode=str(x.get("scoreMode", "JOIN_SCORE_UNSET")),
            max_terms=int(x.get("maxTerms", 0)),
        )
    if "disjunctionMaxQuery" in q:
        d = q["disjunctionMaxQuery"]
        return DisjunctionMaxNode(
            boost=boost,
            disjuncts=tuple(parse_query(sub) for sub in d.get("disjuncts", [])),
            tie_breaker=float(d.get("tieBreakerMultiplier", 0.0)),
        )
    if "minScoreQuery" in q:
        m = q["minScoreQuery"]
        return MinScoreNode(
            boost=boost,
            query=parse_query(m.get("query", {})),
            min_score=float(m.get("minScore", 0.0)),
        )
    if "functionFilterQuery" in q:
        f = q["functionFilterQuery"]
        return FunctionFilterNode(
            boost=boost,
            expression=(f.get("script") or {}).get("source", "0"),
        )
    if "exactVectorQuery" in q:
        e = q["exactVectorQuery"]
        return ExactVectorQueryNode(
            boost=boost,
            field=e["field"],
            query_vector=tuple(float(x) for x in e.get("queryFloatVector", [])),
        )
    if "multiFunctionScoreQuery" in q:
        m = q["multiFunctionScoreQuery"]
        funcs = []
        for f in m.get("functions", []):
            decay = None
            script = None
            if "decayFunction" in f:
                d = f["decayFunction"]
                gp = d.get("geoPoint") or {}
                decay = DecaySpec(
                    field=d.get("fieldName", ""),
                    decay_type=str(d.get("decayType", "DECAY_TYPE_EXPONENTIAL")),
                    origin=(
                        float(gp.get("latitude", 0.0)),
                        float(gp.get("longitude", 0.0)),
                    ),
                    scale=_parse_distance(d.get("scale", "1")),
                    offset=_parse_distance(d["offset"]) if d.get("offset") else 0.0,
                    decay=float(d.get("decay", 0.5)),
                )
            elif "script" in f:
                script = (f.get("script") or {}).get("source", "_score")
            # proto3 zero weight means unspecified -> 1.0 (FilterFunction.build)
            weight = float(f.get("weight", 0.0)) or 1.0
            funcs.append(
                FilterFunctionSpec(
                    filter=parse_query(f["filter"]) if f.get("filter") else None,
                    weight=weight,
                    script=script,
                    decay=decay,
                )
            )
        return MultiFunctionScoreNode(
            boost=boost,
            query=parse_query(m.get("query", {})),
            functions=tuple(funcs),
            score_mode=str(m.get("scoreMode", "SCORE_MODE_MULTIPLY")),
            boost_mode=str(m.get("boostMode", "BOOST_MODE_MULTIPLY")),
            min_score=float(m.get("minScore", 0.0)),
            min_excluded=bool(m.get("minExcluded", False)),
        )
    if "geoPointQuery" in q:
        g = q["geoPointQuery"]
        pt = g.get("point") or {}
        return PolygonContainsNode(
            boost=boost,
            field=g["field"],
            lat=float(pt.get("latitude", 0.0)),
            lon=float(pt.get("longitude", 0.0)),
        )
    if "geoPolygonQuery" in q:
        g = q["geoPolygonQuery"]

        def _ring(points):
            return tuple(
                (float(p.get("latitude", 0)), float(p.get("longitude", 0)))
                for p in points
            )

        polygons = tuple(
            PolygonSpec(
                points=_ring(poly.get("points", [])),
                holes=tuple(
                    _ring(h.get("points", [])) for h in poly.get("holes", [])
                ),
            )
            for poly in g.get("polygons", [])
        )
        if not polygons:
            raise ValueError("GeoPolygonQuery must contain at least one polygon")
        return GeoPolygonNode(boost=boost, field=g["field"], polygons=polygons)
    if "completionQuery" in q:
        c = q["completionQuery"]
        return CompletionQueryNode(
            boost=boost, field=c["field"], text=c.get("text", ""),
            fuzzy=c.get("queryType") == "FUZZY_QUERY" or bool(c.get("fuzzy")),
            contexts=tuple(c.get("contexts", [])),
        )
    if "nestedQuery" in q:
        n = q["nestedQuery"]
        return NestedQueryNode(
            boost=boost,
            path=n.get("path", ""),
            query=parse_query(n.get("query", {})),
            score_mode=n.get("scoreMode", "NONE"),
        )
    if "knnQuery" in q or "knn" in q:
        kq = q.get("knnQuery") or q.get("knn")
        return KnnQueryNode(
            boost=boost,
            field=kq["field"],
            query_vector=tuple(float(v) for v in kq.get("queryVector", [])),
            k=int(kq.get("k", 10)),
            num_candidates=int(kq.get("numCandidates", 0)),
            filter=parse_query(kq["filter"]) if kq.get("filter") else None,
        )
    raise ValueError(f"unsupported query: {sorted(q.keys())}")


def _parse_span_clause(sq: dict) -> SpanClause:
    if "spanTermQuery" in sq:
        t = sq["spanTermQuery"]
        return SpanClause("term", t.get("field", ""), t.get("textValue", ""))
    if "spanMultiTermQuery" in sq:
        w = sq["spanMultiTermQuery"]
        if "prefixQuery" in w:
            p = w["prefixQuery"]
            return SpanClause(
                "prefix", p["field"], p.get("prefix", ""),
                max_expansions=int(p.get("maxExpansions", 0) or 50),
            )
        if "wildcardQuery" in w:
            p = w["wildcardQuery"]
            return SpanClause(
                "wildcard", p["field"], p.get("pattern", ""),
                max_expansions=int(p.get("maxExpansions", 0) or 50),
            )
        if "fuzzyQuery" in w:
            p = w["fuzzyQuery"]
            return SpanClause(
                "fuzzy", p["field"], p.get("text", ""),
                max_edits=int(p.get("maxEdits", 0) or 2),
                prefix_length=int(p.get("prefixLength", 0)),
                max_expansions=int(p.get("maxExpansions", 0) or 50),
            )
        if "regexpQuery" in w:
            p = w["regexpQuery"]
            return SpanClause("regexp", p["field"], p.get("text", ""))
        if "termRangeQuery" in w:
            p = w["termRangeQuery"]
            return SpanClause(
                "term_range", p["field"], p.get("lowerTerm", ""),
                upper=p.get("upperTerm", ""),
                include_lower=bool(p.get("includeLower", False)),
                include_upper=bool(p.get("includeUpper", False)),
            )
        raise ValueError("spanMultiTermQuery requires a wrapped query")
    if "spanNearQuery" in sq:
        inner = _parse_span(sq, 1.0)
        field = inner.clauses[0].field if inner.clauses else ""
        return SpanClause("near", field, "", near=inner)
    raise ValueError("empty spanQuery")


def _parse_span(sq: dict, boost: float) -> QueryNode:
    if "spanNearQuery" in sq:
        n = sq["spanNearQuery"]
        clauses = tuple(_parse_span_clause(c) for c in n.get("clauses", []))
        if not clauses:
            raise ValueError("spanNearQuery requires at least one clause")
        fields = {c.field for c in clauses}
        if len(fields) > 1:
            raise ValueError(f"span clauses must share one field, got {fields}")
        return SpanNearNode(
            boost=boost, clauses=clauses,
            slop=int(n.get("slop", 0)), in_order=bool(n.get("inOrder", False)),
        )
    # a bare term / multi-term span is a one-clause near
    return SpanNearNode(boost=boost, clauses=(_parse_span_clause(sq),))


def _analyzer_name(a: Any) -> Optional[str]:
    if isinstance(a, str):
        return a
    if isinstance(a, dict):
        return a.get("predefined")
    return None


def _first_int(d: dict, *keys: str) -> Optional[int]:
    for k in keys:
        if k in d and d[k] is not None:
            return int(d[k])
    return None


def _first_float(d: dict, *keys: str) -> Optional[float]:
    for k in keys:
        if k in d and d[k] is not None:
            return float(d[k])
    return None


def validate_fields(node: QueryNode, field_defs: dict) -> None:
    """Fail loudly on unknown field references anywhere in a query tree.

    The reference resolves every leaf's FieldDef up front and throws
    IllegalArgumentException for unknown names (QueryNodeMapper.java
    getFieldDef calls); a silent zero-hit answer hides typos. CrossIndex
    inner queries are skipped — they bind to the SECONDARY index and are
    validated when that index executes them.
    """
    import dataclasses

    if isinstance(node, CrossIndexQueryNode):
        for name in (node.primary_field,):
            if name and name not in field_defs:
                raise ValueError(f"unknown field {name!r} in query")
        return  # node.query validates against the secondary index
    f = getattr(node, "field", None)
    if isinstance(f, str) and f and f not in field_defs:
        raise ValueError(f"unknown field {f!r} in query")
    fields = getattr(node, "fields", None)   # multiMatch
    if isinstance(fields, (tuple, list)):
        for name in fields:
            if isinstance(name, str) and name and name not in field_defs:
                raise ValueError(f"unknown field {name!r} in query")

    def _walk(value):
        if isinstance(value, QueryNode):
            validate_fields(value, field_defs)
        elif isinstance(value, (tuple, list)):
            for v in value:
                _walk(v)
        elif dataclasses.is_dataclass(value) and not isinstance(value, type):
            # BooleanClause / SpanClause / FilterFunctionSpec wrappers
            for sub in dataclasses.fields(value):
                _walk(getattr(value, sub.name))

    if dataclasses.is_dataclass(node):
        for fld in dataclasses.fields(node):
            if fld.name in ("field", "fields"):
                continue
            _walk(getattr(node, fld.name))
