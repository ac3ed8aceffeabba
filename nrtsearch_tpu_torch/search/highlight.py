"""Copy of ``nrtsearch_tpu/search/highlight.py``, kept whole, its imports
pointed at the port.

Highlighting: positions-driven fragments with weighted scoring.

Reference: server/highlights/NRTFastVectorHighlighter.java (+ HighlightSettings,
HighlightFetchTask — 1,185 LoC pkg). The reference's fast-vector highlighter
builds a FieldQuery (term weights + phrase structure), matches it against the
index's term vectors, groups matches into fragments, and orders fragments by
their accumulated weight. Here the fetch stage re-analyzes the stored text
(token positions + offsets play the term-vector role; analysis is cheap host
work over one document), then follows the same pipeline:

1. extract per-field term weights (query boosts) + PHRASES from the query
   (phrases must match as consecutive positions — a lone term inside a phrase
   query never highlights, matching FVH's FieldPhraseList semantics);
2. match tokens/position-runs, producing weighted spans;
3. group spans into fragments of ~fragment_size chars;
4. score fragments by total span weight with a distinct-term diversity bonus
   (the WeightedFragInfo totalBoost analogue) and order when score_ordered.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from nrtsearch_tpu_torch.analysis import Analyzer, get_analyzer
from nrtsearch_tpu_torch.query import plan as qp


@dataclass
class HighlightSettings:
    pre_tag: str = "<em>"
    post_tag: str = "</em>"
    fragment_size: int = 100
    max_fragments: int = 5
    score_ordered: bool = True


@dataclass
class HighlightQuery:
    """Field-scoped match structure extracted from a query tree (the
    FieldQuery analogue): weighted single terms, position-consecutive
    phrases, and prefix patterns."""

    term_weights: dict = field(default_factory=dict)    # term -> weight
    phrases: list = field(default_factory=list)          # [(weight, (t1, t2...))]
    prefixes: dict = field(default_factory=dict)         # prefix -> weight

    def __bool__(self) -> bool:
        return bool(self.term_weights or self.phrases or self.prefixes)

    # back-compat with set-style callers/tests
    def update_terms(self, terms, weight: float = 1.0) -> None:
        for t in terms:
            self.term_weights[t] = max(self.term_weights.get(t, 0.0), weight)


def build_highlight_query(
    node: qp.QueryNode, field_name: str
) -> HighlightQuery:
    """Collect the query structure targeting one field."""
    hq = HighlightQuery()

    def walk(n: qp.QueryNode, boost: float = 1.0) -> None:
        w = boost * float(getattr(n, "boost", 1.0) or 1.0)
        if isinstance(n, qp.MatchQueryNode) and n.field == field_name:
            hq.update_terms(n.query.lower().split(), w)
        elif isinstance(n, qp.TermQueryNode) and n.field == field_name and n.text:
            hq.update_terms([n.text], w)
        elif isinstance(n, qp.PhraseQueryNode) and n.field == field_name:
            hq.phrases.append((w * len(n.terms), tuple(n.terms)))
        elif isinstance(n, qp.MatchPhraseQueryNode) and n.field == field_name:
            terms = tuple(n.query.lower().split())
            if len(terms) == 1:
                hq.update_terms(terms, w)
            else:
                hq.phrases.append((w * len(terms), terms))
        elif isinstance(n, qp.PrefixQueryNode) and n.field == field_name:
            hq.prefixes[n.prefix] = max(hq.prefixes.get(n.prefix, 0.0), w)
        elif isinstance(n, qp.BooleanQueryNode):
            for c in n.clauses:
                if c.occur != qp.Occur.MUST_NOT:
                    walk(c.node, w)
        elif isinstance(n, qp.FunctionScoreNode) and n.query is not None:
            walk(n.query, w)
        elif isinstance(n, qp.MultiMatchQueryNode) and field_name in n.fields:
            hq.update_terms(n.query.lower().split(), w)

    walk(node)
    return hq


def query_terms_for_field(node: qp.QueryNode, field_name: str) -> set[str]:
    """Flat term view (kept for callers that only need membership)."""
    hq = build_highlight_query(node, field_name)
    out = set(hq.term_weights)
    for _, terms in hq.phrases:
        out.update(terms)
    out.update(p + "*" for p in hq.prefixes)
    return out


@dataclass
class _Span:
    start: int
    end: int
    weight: float
    key: str  # distinct-term identity for the diversity bonus


def _match_spans(tokens, hq: HighlightQuery) -> list[_Span]:
    """Weighted match spans over analyzed tokens.

    Phrases match only when their terms occupy CONSECUTIVE positions
    (FieldPhraseList semantics) and produce one span covering the whole
    phrase; their terms do not highlight individually unless also present
    as single terms in the query."""
    spans: list[_Span] = []
    # position -> token index runs (analyzers may emit position gaps)
    by_pos: dict[int, list[int]] = {}
    for i, tok in enumerate(tokens):
        by_pos.setdefault(tok.position, []).append(i)

    for weight, terms in hq.phrases:
        first = terms[0]
        for i, tok in enumerate(tokens):
            if tok.text != first:
                continue
            end_tok = tok
            pos = tok.position
            ok = True
            for t_next in terms[1:]:
                pos += 1
                nxt = [
                    tokens[j] for j in by_pos.get(pos, [])
                    if tokens[j].text == t_next
                ]
                if not nxt:
                    ok = False
                    break
                end_tok = nxt[0]
            if ok:
                spans.append(_Span(
                    tok.start_offset, end_tok.end_offset, weight,
                    "p:" + " ".join(terms),
                ))

    for tok in tokens:
        w = hq.term_weights.get(tok.text)
        if w is not None:
            spans.append(_Span(tok.start_offset, tok.end_offset, w, tok.text))
            continue
        for prefix, pw in hq.prefixes.items():
            if tok.text.startswith(prefix):
                spans.append(_Span(
                    tok.start_offset, tok.end_offset, pw, prefix + "*"
                ))
                break
    spans.sort(key=lambda s: (s.start, -(s.end - s.start)))
    # drop spans nested inside an earlier (longer) span — a phrase span
    # subsumes its terms' individual spans
    out: list[_Span] = []
    covered_end = -1
    for s in spans:
        if s.end <= covered_end:
            continue
        if out and s.start < covered_end:  # overlapping: keep the longer
            continue
        out.append(s)
        covered_end = s.end
    return out


def highlight_text(
    text: str,
    terms,  # HighlightQuery | set[str] (legacy)
    settings: HighlightSettings,
    analyzer: Optional[Analyzer] = None,
) -> list[str]:
    """Best fragments of ``text`` with matched spans wrapped in tags."""
    if not text or not terms:
        return []
    if not isinstance(terms, HighlightQuery):
        hq = HighlightQuery()
        hq.update_terms({t for t in terms if not t.endswith("*")})
        hq.prefixes = {t[:-1]: 1.0 for t in terms if t.endswith("*")}
    else:
        hq = terms
    analyzer = analyzer or get_analyzer("standard")
    tokens = analyzer.analyze(text)
    spans = _match_spans(tokens, hq)
    if not spans:
        return []

    # group spans into fragments of ~fragment_size chars
    frags: list[list[_Span]] = []
    for s in spans:
        if frags and s.start - frags[-1][0].start < settings.fragment_size:
            frags[-1].append(s)
        else:
            frags.append([s])

    def frag_score(ms: list[_Span]) -> float:
        # accumulated span weight + distinct-term diversity bonus
        # (FVH WeightedFragInfo: fragments matching MORE DIFFERENT terms
        # outrank repeats of one term)
        total = sum(s.weight for s in ms)
        distinct = len({s.key for s in ms})
        return total + float(distinct)

    if settings.score_ordered:
        frags.sort(key=frag_score, reverse=True)
    frags = frags[: settings.max_fragments]

    out = []
    for ms in frags:
        fs = ms[0].start
        fe = max(s.end for s in ms)
        # expand fragment window around the matches
        half = max((settings.fragment_size - (fe - fs)) // 2, 0)
        lo = max(0, fs - half)
        hi = min(len(text), fe + half)
        # snap to word boundaries
        while lo > 0 and not text[lo - 1].isspace():
            lo -= 1
        while hi < len(text) and not text[hi].isspace():
            hi += 1
        frag = text[lo:hi]
        # insert tags right-to-left so offsets stay valid
        for s in sorted(ms, key=lambda m: m.start, reverse=True):
            a, b = s.start - lo, s.end - lo
            if 0 <= a < b <= len(frag):
                frag = (
                    frag[:a] + settings.pre_tag + frag[a:b]
                    + settings.post_tag + frag[b:]
                )
        out.append(frag)
    return out
