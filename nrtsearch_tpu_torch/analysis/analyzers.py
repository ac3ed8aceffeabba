"""Copy of ``nrtsearch_tpu/analysis/analyzers.py``, kept whole: the port imports
nothing of the JAX package, not even its backend-free modules.

Analyzer implementations.

Clean-room equivalents of the predefined analyzers the reference exposes
(reference: server/analysis/AnalyzerCreator.java — predefined names like
``standard``, ``classic``, ``keyword``, ``whitespace``, ``simple``, ``stop``,
``english``) plus custom chains from analysis.proto:36-76.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Token:
    """A single analyzed token with its position (for phrase queries)."""

    text: str
    position: int
    start_offset: int = 0
    end_offset: int = 0


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------

# legacy regex (kept for filters that want plain alnum runs)
_STANDARD_RE = re.compile(r"[^\W_]+", re.UNICODE)
_WHITESPACE_RE = re.compile(r"\S+")
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)
# keeps word-internal apostrophes ("l'avion" is one token, as UAX#29 does via
# MidLetter) so the elision filter can strip the article
_WORD_APOS_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)*", re.UNICODE)


def _regex_tokenize(pattern: re.Pattern, text: str) -> list[Token]:
    out = []
    for pos, m in enumerate(pattern.finditer(text)):
        out.append(Token(m.group(0), pos, m.start(), m.end()))
    return out


# --- UAX#29 word segmentation (Lucene StandardTokenizer parity) -------------
#
# The reference's StandardTokenizer implements Unicode UAX#29 word-break
# rules (lucene StandardTokenizerImpl JFlex grammar). The rules that change
# token identity vs a plain alnum-run scan:
#   WB6/7  : letter (MidLetter | MidNumLet | ') letter   -> joins
#            ("can't", "example.com", "a:b" stay one token)
#   WB11/12: digit (MidNum | MidNumLet | ') digit        -> joins
#            ("3.14", "1,000,000", "1'000")
#   WB9/10 : letters and digits join directly ("x86")
#   WB13a/b: ExtendNumLet '_' joins everything adjacent ("foo_bar")
#   CJK    : each ideograph / hiragana char is its OWN token; katakana
#            runs join (WB13)
# Mirrored by the C++ ASCII fast path (native/nrt_tokenize.cpp) — index-time
# and query-time segmentation MUST agree or phrase positions break.

_WB_AL, _WB_NUM, _WB_EXT, _WB_KATA, _WB_IDEO, _WB_HIRA, _WB_OTHER = range(7)
_MIDLETTER = {":", "·", "·", "："}
_MIDNUM = {",", ";", "，", "；"}
_MIDNUMLET = {".", "．"}
_SQ = {"'", "’", "＇"}


def _wb_class(c: str) -> int:
    o = ord(c)
    if o < 128:  # ASCII fast path, mirrors the C++ extension
        if c.isalnum():
            return _WB_NUM if c.isdigit() else _WB_AL
        return _WB_EXT if c == "_" else _WB_OTHER
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF or \
            0xF900 <= o <= 0xFAFF or 0x20000 <= o <= 0x2FA1F:
        return _WB_IDEO
    if 0x3040 <= o <= 0x309F:
        return _WB_HIRA
    if 0x30A0 <= o <= 0x30FF or 0x31F0 <= o <= 0x31FF or 0xFF66 <= o <= 0xFF9D:
        return _WB_KATA
    import unicodedata

    cat = unicodedata.category(c)
    if cat.startswith("L") or cat == "Nl":
        return _WB_AL
    if cat == "Nd" or cat == "No":
        return _WB_NUM
    if cat == "Pc":
        return _WB_EXT
    if cat in ("Mn", "Mc", "Me"):
        return _WB_AL  # combining marks extend the current word (WB4)
    return _WB_OTHER


_WORD_CLASSES = (_WB_AL, _WB_NUM, _WB_EXT, _WB_KATA)


def standard_tokenizer(text: str) -> list[Token]:
    out: list[Token] = []
    n = len(text)
    i = 0
    pos = 0
    while i < n:
        c = text[i]
        cls = _wb_class(c)
        if cls == _WB_IDEO or cls == _WB_HIRA:
            out.append(Token(c, pos, i, i + 1))
            pos += 1
            i += 1
            continue
        if cls not in _WORD_CLASSES:
            i += 1
            continue
        j = i
        has_alnum = cls != _WB_EXT
        prev_cls = cls
        j += 1
        while j < n:
            cj = text[j]
            cls_j = _wb_class(cj)
            if cls_j in _WORD_CLASSES:
                if cls_j == _WB_IDEO:
                    break
                # katakana only joins katakana or ExtendNumLet (WB13/13a/b)
                if (cls_j == _WB_KATA) != (prev_cls == _WB_KATA) and \
                        _WB_EXT not in (cls_j, prev_cls):
                    break
                has_alnum = has_alnum or cls_j != _WB_EXT
                prev_cls = cls_j if cls_j != _WB_EXT else prev_cls
                j += 1
                continue
            # mid-character join: one mid char with word chars on BOTH sides
            if j + 1 < n:
                nxt = _wb_class(text[j + 1])
                if (
                    cj in _SQ or cj in _MIDNUMLET or cj in _MIDLETTER
                ) and prev_cls == _WB_AL and nxt == _WB_AL:
                    j += 1
                    continue
                if (
                    cj in _SQ or cj in _MIDNUMLET or cj in _MIDNUM
                ) and prev_cls == _WB_NUM and nxt == _WB_NUM:
                    j += 1
                    continue
            break
        if has_alnum:
            out.append(Token(text[i:j], pos, i, j))
            pos += 1
        i = j
    return out


def whitespace_tokenizer(text: str) -> list[Token]:
    return _regex_tokenize(_WHITESPACE_RE, text)


def letter_tokenizer(text: str) -> list[Token]:
    return _regex_tokenize(_LETTER_RE, text)


def keyword_tokenizer(text: str) -> list[Token]:
    return [Token(text, 0, 0, len(text))] if text else []


def word_apostrophe_tokenizer(text: str) -> list[Token]:
    return _regex_tokenize(_WORD_APOS_RE, text)


TOKENIZERS: dict[str, Callable[[str], list[Token]]] = {
    "standard": standard_tokenizer,
    "classic": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "letter": letter_tokenizer,
    "keyword": keyword_tokenizer,
    "word_apostrophe": word_apostrophe_tokenizer,
}

# ---------------------------------------------------------------------------
# Token filters
# ---------------------------------------------------------------------------

ENGLISH_STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


def lowercase_filter(tokens: list[Token]) -> list[Token]:
    return [Token(t.text.lower(), t.position, t.start_offset, t.end_offset) for t in tokens]


def make_stop_filter(stopwords: Iterable[str]) -> Callable[[list[Token]], list[Token]]:
    stops = frozenset(stopwords)

    def stop_filter(tokens: list[Token]) -> list[Token]:
        # Positions are preserved (holes where stopwords were), matching
        # Lucene's position-increment behavior for phrase queries.
        return [t for t in tokens if t.text not in stops]

    return stop_filter


def ascii_folding_filter(tokens: list[Token]) -> list[Token]:
    import unicodedata

    def fold(s: str) -> str:
        return "".join(
            c for c in unicodedata.normalize("NFKD", s) if not unicodedata.combining(c)
        )

    return [Token(fold(t.text), t.position, t.start_offset, t.end_offset) for t in tokens]


def make_length_filter(min_len: int, max_len: int) -> Callable[[list[Token]], list[Token]]:
    def length_filter(tokens: list[Token]) -> list[Token]:
        return [t for t in tokens if min_len <= len(t.text) <= max_len]

    return length_filter


def make_synonym_filter(
    synonyms: dict[str, Sequence[str]]
) -> Callable[[list[Token]], list[Token]]:
    """Flat (non-graph) synonym expansion: adds synonyms at the same position.

    Reference equivalent: SynonymV2GraphFilterFactory (server/analysis/).
    """

    def synonym_filter(tokens: list[Token]) -> list[Token]:
        out = []
        for t in tokens:
            out.append(t)
            for syn in synonyms.get(t.text, ()):
                out.append(Token(syn, t.position, t.start_offset, t.end_offset))
        return out

    return synonym_filter


def porter_stem_filter(tokens: list[Token]) -> list[Token]:
    from nrtsearch_tpu_torch.analysis.porter import porter_stem

    return [Token(porter_stem(t.text), t.position, t.start_offset, t.end_offset) for t in tokens]


def uppercase_filter(tokens: list[Token]) -> list[Token]:
    return [Token(t.text.upper(), t.position, t.start_offset, t.end_offset) for t in tokens]


def trim_filter(tokens: list[Token]) -> list[Token]:
    return [Token(t.text.strip(), t.position, t.start_offset, t.end_offset) for t in tokens]


def reverse_filter(tokens: list[Token]) -> list[Token]:
    return [Token(t.text[::-1], t.position, t.start_offset, t.end_offset) for t in tokens]


def remove_duplicates_filter(tokens: list[Token]) -> list[Token]:
    """Drop tokens identical to another token at the same position
    (Lucene RemoveDuplicatesTokenFilter)."""
    seen: set[tuple[int, str]] = set()
    out = []
    for t in tokens:
        key = (t.position, t.text)
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def make_truncate_filter(length: int) -> Callable[[list[Token]], list[Token]]:
    def truncate_filter(tokens: list[Token]) -> list[Token]:
        return [
            Token(t.text[:length], t.position, t.start_offset, t.end_offset)
            for t in tokens
        ]

    return truncate_filter


def make_stemmer_filter(stem) -> Callable[[list[Token]], list[Token]]:
    def stem_filter(tokens: list[Token]) -> list[Token]:
        return [
            Token(stem(t.text), t.position, t.start_offset, t.end_offset)
            for t in tokens
        ]

    return stem_filter


def make_elision_filter(articles) -> Callable[[list[Token]], list[Token]]:
    """Strip a leading article + apostrophe (Lucene ElisionFilter:
    "l'avion" -> "avion")."""
    arts = frozenset(articles)

    def elision_filter(tokens: list[Token]) -> list[Token]:
        out = []
        for t in tokens:
            text = t.text
            for apo in ("'", "’"):
                i = text.find(apo)
                if 0 < i and text[:i].lower() in arts:
                    text = text[i + 1 :]
                    break
            out.append(Token(text, t.position, t.start_offset, t.end_offset))
        return out

    return elision_filter


def make_shingle_filter(
    min_size: int, max_size: int, sep: str = " "
) -> Callable[[list[Token]], list[Token]]:
    """Token n-grams (Lucene ShingleFilter); unigrams are kept."""

    def shingle_filter(tokens: list[Token]) -> list[Token]:
        out = list(tokens)
        for n in range(max(min_size, 2), max_size + 1):
            for i in range(len(tokens) - n + 1):
                window = tokens[i : i + n]
                out.append(
                    Token(
                        sep.join(t.text for t in window),
                        window[0].position,
                        window[0].start_offset,
                        window[-1].end_offset,
                    )
                )
        out.sort(key=lambda t: (t.position, t.end_offset))
        return out

    return shingle_filter


def make_ngram_filter(
    min_gram: int, max_gram: int, edge: bool = False
) -> Callable[[list[Token]], list[Token]]:
    """Character (edge-)n-grams (Lucene NGram/EdgeNGramTokenFilter)."""

    def ngram_filter(tokens: list[Token]) -> list[Token]:
        out = []
        for t in tokens:
            starts = (0,) if edge else range(len(t.text))
            for s in starts:
                for n in range(min_gram, max_gram + 1):
                    if s + n <= len(t.text):
                        out.append(
                            Token(
                                t.text[s : s + n], t.position,
                                t.start_offset + s, t.start_offset + s + n,
                            )
                        )
        return out

    return ngram_filter


_WD_SPLIT_RE = re.compile(
    # case transitions + digit runs, Lucene splitOnCaseChange semantics: an
    # uppercase run followed by lowercase splits BEFORE its last uppercase
    # ("XMLHttpRequest" -> XML, Http, Request)
    r"[A-Z]+(?![a-z])|[A-Z][a-z]+|[a-z]+|[0-9]+"
)


def make_word_delimiter_filter(
    preserve_original: bool = False,
) -> Callable[[list[Token]], list[Token]]:
    """Split on intra-word delimiters, case transitions, and letter/digit
    boundaries (Lucene WordDelimiterGraphFilter's common defaults)."""

    def word_delimiter_filter(tokens: list[Token]) -> list[Token]:
        # Lucene WordDelimiterGraphFilter position semantics: each split
        # part occupies its own position (first part at the token's
        # position, each further part +1) and downstream tokens shift by
        # the inserted count; with preserveOriginal the original token sits
        # at the first part's position (posInc 0 between them).
        out = []
        delta = 0
        for t in tokens:
            pos = t.position + delta
            parts = _WD_SPLIT_RE.findall(t.text)
            if not parts or (len(parts) == 1 and parts[0] == t.text):
                # unsplit token: emit once (preserveOriginal adds the
                # original only when the token actually changed)
                out.append(Token(t.text, pos, t.start_offset, t.end_offset))
                continue
            if preserve_original:
                out.append(Token(t.text, pos, t.start_offset, t.end_offset))
            for i, p in enumerate(parts):
                out.append(Token(p, pos + i, t.start_offset, t.end_offset))
            delta += max(len(parts) - 1, 0)
        return out

    return word_delimiter_filter


def _lang_stop_filter(lang: str) -> Callable[[list[Token]], list[Token]]:
    from nrtsearch_tpu_torch.analysis.lang import STOPWORDS

    return make_stop_filter(STOPWORDS[lang])


TOKEN_FILTERS: dict[str, Callable[[list[Token]], list[Token]]] = {
    "lowercase": lowercase_filter,
    "uppercase": uppercase_filter,
    "asciifolding": ascii_folding_filter,
    "stop": make_stop_filter(ENGLISH_STOP_WORDS),
    "porterstem": porter_stem_filter,
    "trim": trim_filter,
    "reverse": reverse_filter,
    "removeDuplicates": remove_duplicates_filter,
}

# ---------------------------------------------------------------------------
# Char filters
# ---------------------------------------------------------------------------


def html_strip_char_filter(text: str) -> str:
    """Drop tags and decode character entities (Lucene HTMLStripCharFilter:
    '&amp;' becomes '&', which the tokenizer then treats as punctuation —
    it must NOT surface as a token 'amp')."""
    import html

    return html.unescape(re.sub(r"<[^>]*>", " ", text))


def make_mapping_char_filter(mappings) -> Callable[[str], str]:
    """"a=>b" character/string mappings (Lucene MappingCharFilter)."""
    pairs = []
    for m in mappings:
        src, _, dst = m.partition("=>")
        pairs.append((src, dst))
    pairs.sort(key=lambda p: -len(p[0]))  # longest-match-first

    def mapping_char_filter(text: str) -> str:
        for src, dst in pairs:
            text = text.replace(src, dst)
        return text

    return mapping_char_filter


def make_pattern_replace_char_filter(pattern: str, replacement: str) -> Callable[[str], str]:
    rx = re.compile(pattern)

    def pattern_replace_char_filter(text: str) -> str:
        return rx.sub(replacement, text)

    return pattern_replace_char_filter


CHAR_FILTERS: dict[str, Callable[[str], str]] = {
    "htmlStrip": html_strip_char_filter,
}

# ---------------------------------------------------------------------------
# Analyzer
# ---------------------------------------------------------------------------


@dataclass
class Analyzer:
    """char filters -> tokenizer -> token filters (analysis.proto:36-76)."""

    name: str
    tokenizer: Callable[[str], list[Token]] = standard_tokenizer
    char_filters: list[Callable[[str], str]] = field(default_factory=list)
    token_filters: list[Callable[[list[Token]], list[Token]]] = field(default_factory=list)

    def analyze(self, text: str) -> list[Token]:
        for cf in self.char_filters:
            text = cf(text)
        tokens = self.tokenizer(text)
        for tf in self.token_filters:
            tokens = tf(tokens)
        return tokens

    def terms(self, text: str) -> list[str]:
        return [t.text for t in self.analyze(text)]


def make_conditional_filter(
    condition_name: str, params: dict,
    filters: list,
) -> Callable[[list[Token]], list[Token]]:
    """Apply ``filters`` only to tokens failing the condition (reference:
    analysis.proto ConditionalTokenFilter; the reference's only condition is
    protectedTerm — protected tokens pass through unfiltered)."""
    if condition_name != "protectedTerm":
        raise KeyError(f"unknown conditional-filter condition: {condition_name!r}")
    raw = params.get("terms", ())
    protected = frozenset(
        t.strip() for t in (raw.split(",") if isinstance(raw, str) else raw)
    )

    def conditional_filter(tokens: list[Token]) -> list[Token]:
        out = []
        for t in tokens:
            if t.text in protected:
                out.append(t)
                continue
            filtered = [t]
            for f in filters:
                filtered = f(filtered)
            out.extend(filtered)
        return out

    return conditional_filter


def _predefined() -> dict[str, Analyzer]:
    from nrtsearch_tpu_torch.analysis.lang import (
        ELISION_ARTICLES, LANGUAGE_NAMES, LANGUAGES, STOPWORDS,
    )

    out = {
        "standard": Analyzer("standard", standard_tokenizer, [], [lowercase_filter]),
        "classic": Analyzer("classic", standard_tokenizer, [], [lowercase_filter]),
        "simple": Analyzer("simple", letter_tokenizer, [], [lowercase_filter]),
        "whitespace": Analyzer("whitespace", whitespace_tokenizer, [], []),
        "keyword": Analyzer("keyword", keyword_tokenizer, [], []),
        "stop": Analyzer(
            "stop", letter_tokenizer, [], [lowercase_filter, TOKEN_FILTERS["stop"]]
        ),
    }
    # per-language analyzers under both the plain ("french") and Lucene-style
    # ("fr.French") names (reference: AnalyzerCreator resolves
    # org.apache.lucene.analysis.<lang>.<Name>Analyzer by the short form)
    for code, (lucene_name, stem) in LANGUAGES.items():
        filters: list = []
        if code in ELISION_ARTICLES:
            filters.append(make_elision_filter(ELISION_ARTICLES[code]))
        filters.append(lowercase_filter)
        filters.append(make_stop_filter(STOPWORDS[code]))
        filters.append(make_stemmer_filter(stem))
        an = Analyzer(
            LANGUAGE_NAMES[code], word_apostrophe_tokenizer, [], filters
        )
        out[LANGUAGE_NAMES[code]] = an
        out[lucene_name] = an
    return out


class AnalyzerRegistry:
    """Name -> Analyzer registry, plugin-extensible.

    Reference equivalent: AnalyzerCreator with AnalysisPlugin extensions.
    """

    def __init__(self) -> None:
        self._analyzers: dict[str, Analyzer] = _predefined()

    def get(self, name: str) -> Analyzer:
        try:
            return self._analyzers[name]
        except KeyError:
            raise KeyError(
                f"unknown analyzer {name!r}; known: {sorted(self._analyzers)}"
            ) from None

    def register(self, analyzer: Analyzer) -> None:
        self._analyzers[analyzer.name] = analyzer

    def from_custom(self, spec: dict) -> Analyzer:
        """Build a custom analyzer from a proto-shaped dict.

        Shape mirrors analysis.proto CustomAnalyzer: ``{"tokenizer": {"name":
        ...}, "tokenFilters": [{"name": ..., "params": {...}}, ...],
        "charFilters": [...], "conditionalTokenFilters": [{"condition":
        {"name": ..., "params": ...}, "tokenFilters": [...]}]}``. Params
        arrive as strings (proto map<string, string>); list-valued params
        (stopwords, articles, mappings) accept comma-separated strings.
        """
        tok_spec = spec.get("tokenizer") or {"name": "standard"}
        tokenizer = TOKENIZERS[tok_spec.get("name", "standard")]
        char_filters = [
            _make_char_filter(cf["name"], cf.get("params", {}))
            for cf in spec.get("charFilters", [])
        ]
        token_filters = [
            _make_token_filter(tf["name"], tf.get("params", {}))
            for tf in spec.get("tokenFilters", [])
        ]
        for ctf in spec.get("conditionalTokenFilters", []):
            cond = ctf.get("condition", {})
            inner = [
                _make_token_filter(tf["name"], tf.get("params", {}))
                for tf in ctf.get("tokenFilters", [])
            ]
            token_filters.append(
                make_conditional_filter(
                    cond.get("name", ""), cond.get("params", {}), inner
                )
            )
        return Analyzer(spec.get("name", "custom"), tokenizer, char_filters, token_filters)


def _listy(value) -> list[str]:
    """proto params are map<string, string>: lists ride as comma-separated."""
    if isinstance(value, str):
        return [v.strip() for v in value.split(",") if v.strip()]
    return list(value)


def _make_token_filter(name: str, params: dict):
    """Token-filter factory (reference: AnalyzerCreator token-filter names
    resolved through Lucene's TokenFilterFactory registry)."""
    if name == "stop":
        if "stopwords" in params:
            return make_stop_filter(_listy(params["stopwords"]))
        from nrtsearch_tpu_torch.analysis.lang import STOPWORDS

        lang = params.get("language", "en")
        return make_stop_filter(STOPWORDS.get(lang, ENGLISH_STOP_WORDS))
    if name == "length":
        return make_length_filter(
            int(params.get("min", 0)), int(params.get("max", 1 << 30))
        )
    if name == "synonym":
        syn = params.get("synonyms", {})
        if isinstance(syn, str):
            # "a=>b,c" pairs, comma-separated groups via ";"
            table: dict[str, list[str]] = {}
            for group in syn.split(";"):
                src, _, dsts = group.partition("=>")
                if src.strip():
                    table[src.strip()] = [d.strip() for d in dsts.split(",") if d.strip()]
            syn = table
        return make_synonym_filter(syn)
    if name == "truncate":
        return make_truncate_filter(int(params.get("length", 10)))
    if name == "elision":
        from nrtsearch_tpu_torch.analysis.lang import ELISION_ARTICLES

        if "articles" in params:
            return make_elision_filter(_listy(params["articles"]))
        return make_elision_filter(ELISION_ARTICLES["fr"])
    if name == "shingle":
        return make_shingle_filter(
            int(params.get("minShingleSize", 2)),
            int(params.get("maxShingleSize", 2)),
        )
    if name == "edgeNGram":
        return make_ngram_filter(
            int(params.get("minGramSize", 1)),
            int(params.get("maxGramSize", 2)), edge=True,
        )
    if name == "nGram":
        return make_ngram_filter(
            int(params.get("minGramSize", 1)),
            int(params.get("maxGramSize", 2)), edge=False,
        )
    if name in ("wordDelimiter", "wordDelimiterGraph"):
        po = str(params.get("preserveOriginal", "0")).lower() in ("1", "true")
        return make_word_delimiter_filter(preserve_original=po)
    if name in ("snowballPorter", "stemmer"):
        from nrtsearch_tpu_torch.analysis.lang import LANGUAGE_NAMES, LANGUAGES

        lang = params.get("language", "English").lower()
        code = next(
            (c for c, n in LANGUAGE_NAMES.items() if n == lang or c == lang),
            None,
        )
        if code is None:
            raise KeyError(f"no stemmer for language {lang!r}")
        return make_stemmer_filter(LANGUAGES[code][1])
    try:
        return TOKEN_FILTERS[name]
    except KeyError:
        raise KeyError(
            f"unknown token filter {name!r}; known: "
            f"{sorted(TOKEN_FILTERS) + ['stop', 'length', 'synonym', 'truncate', 'elision', 'shingle', 'edgeNGram', 'nGram', 'wordDelimiter', 'snowballPorter']}"
        ) from None


def _make_char_filter(name: str, params: dict):
    if name == "mapping":
        # no strip: whitespace in the replacement is significant ("-=> ")
        raw = params.get("mappings", [])
        mappings = raw.split(",") if isinstance(raw, str) else list(raw)
        return make_mapping_char_filter([m for m in mappings if m])
    if name == "patternReplace":
        return make_pattern_replace_char_filter(
            params.get("pattern", ""), params.get("replacement", "")
        )
    try:
        return CHAR_FILTERS[name]
    except KeyError:
        raise KeyError(
            f"unknown char filter {name!r}; known: "
            f"{sorted(CHAR_FILTERS) + ['mapping', 'patternReplace']}"
        ) from None


_DEFAULT_REGISTRY = AnalyzerRegistry()


def get_analyzer(name: str) -> Analyzer:
    return _DEFAULT_REGISTRY.get(name)


def register_analyzer(analyzer: Analyzer) -> None:
    _DEFAULT_REGISTRY.register(analyzer)


# ---------------------------------------------------------------------------
# Normalizers (ATOM fields; analysis.proto Normalizer/CustomNormalizer)
# ---------------------------------------------------------------------------

_PREDEFINED_NORMALIZERS = {
    "lowercase": Analyzer("lowercase", keyword_tokenizer, [], [lowercase_filter]),
}


def get_normalizer(spec) -> Analyzer:
    """Resolve a Normalizer spec: a predefined name (str) or a proto-shaped
    dict ({"predefined": ...} | {"custom": {charFilters, tokenFilters}}).
    The keyword tokenizer is implied — the whole value is one token."""
    if isinstance(spec, str):
        name = spec
    elif "predefined" in spec:
        name = spec["predefined"]
    else:
        custom = spec.get("custom", {})
        char_filters = [
            _make_char_filter(cf["name"], cf.get("params", {}))
            for cf in custom.get("charFilters", [])
        ]
        token_filters = [
            _make_token_filter(tf["name"], tf.get("params", {}))
            for tf in custom.get("tokenFilters", [])
        ]
        return Analyzer("custom_normalizer", keyword_tokenizer, char_filters, token_filters)
    try:
        return _PREDEFINED_NORMALIZERS[name]
    except KeyError:
        raise KeyError(
            f"unknown normalizer {name!r}; known: {sorted(_PREDEFINED_NORMALIZERS)}"
        ) from None
