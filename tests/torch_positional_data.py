"""Shared data of the port's positional and nested parity tests
(tests/test_torch_phrase.py, tests/test_torch_nested.py) and of their card
cases in tests/test_torch_cuda.py: seeded documents, field specs and
queries as dicts. It imports neither package, so the card tests take it
without the reference.
"""

import json

import numpy as np
from google.protobuf.json_format import MessageToDict, ParseDict

from nrtsearch_tpu_torch.gen import pb

# -- phrases and spans ----------------------------------------------------------

VOCAB = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta", "alps", "alto"]
SPECS = {
    "id": {"type": "_ID", "store": True, "storeDocValues": True},
    "t": {"type": "TEXT", "search": True, "store": True},
    "mv": {"type": "TEXT", "search": True, "multiValued": True},
    "price": {"type": "FLOAT", "storeDocValues": True},
}


def phrase_docs(seed: int = 11, n: int = 360) -> list[dict]:
    """Docs over a 10-word vocabulary (so phrases recur): a TEXT ``t``, a
    multi-valued TEXT ``mv`` and a FLOAT ``price``."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = [VOCAB[int(j)] for j in rng.integers(0, len(VOCAB), int(rng.integers(3, 30)))]
        mv = [" ".join(VOCAB[int(j)] for j in rng.integers(0, 4, int(rng.integers(1, 4))))
              for _ in range(int(rng.integers(1, 3)))]
        docs.append({"id": str(i), "t": " ".join(words), "mv": mv,
                     "price": str(round(float(rng.uniform(0, 100)), 2))})
    return docs


def build(writer, docs, waves=3):
    """Add ``docs`` in ``waves`` refreshes (one segment each)."""
    bounds = np.linspace(0, len(docs), waves + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        writer.add_documents([dict(d) for d in docs[lo:hi]])
        writer.refresh()
    return writer.segments


def ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def span(*clauses, slop=0, in_order=True):
    return {"spanNearQuery": {"clauses": list(clauses), "slop": slop, "inOrder": in_order}}


def span_term(text, field="t"):
    return {"spanTermQuery": {"field": field, "textValue": text}}


PHRASE_QUERIES = {
    "phrase2": {"phraseQuery": {"field": "t", "terms": ["alpha", "beta"]}},
    "phrase3": {"phraseQuery": {"field": "t", "terms": ["beta", "gamma", "alpha"]}},
    "phrase_repeat": {"phraseQuery": {"field": "t", "terms": ["eps", "eps"]}},
    "phrase_sloppy1": {"phraseQuery": {"field": "t", "terms": ["alpha", "gamma"], "slop": 1}},
    "phrase_sloppy3": {"phraseQuery": {"field": "t", "terms": ["delta", "alpha", "zeta"],
                                       "slop": 3}},
    "phrase_absent": {"phraseQuery": {"field": "t", "terms": ["alpha", "omega"]}},
    "match_phrase": {"matchPhraseQuery": {"field": "t", "query": "Gamma DELTA"}},
    "match_phrase_slop": {"matchPhraseQuery": {"field": "t", "query": "eta theta", "slop": 2}},
    "phrase_prefix": {"matchPhrasePrefixQuery": {"field": "t", "query": "alpha al"}},
    "phrase_prefix_sloppy": {"matchPhrasePrefixQuery": {"field": "t", "query": "beta e",
                                                        "slop": 2}},
    "phrase_prefix_one": {"matchPhrasePrefixQuery": {"field": "t", "query": "ze"}},
    "phrase_prefix_none": {"matchPhrasePrefixQuery": {"field": "t", "query": "alpha qq"}},
    "multi_match_pp": {"multiMatchQuery": {"fields": ["t", "mv"], "query": "alpha be",
                                           "type": "PHRASE_PREFIX"}},
    "span_in_order": {"spanQuery": span(span_term("alpha"), span_term("beta"), slop=1)},
    "span_unordered": {"spanQuery": span(span_term("gamma"), span_term("alpha"), slop=0,
                                          in_order=False)},
    "span_nested": {"spanQuery": span(span(span_term("alpha"), span_term("beta")), span_term("gamma"),
                                       slop=2)},
    "span_prefix": {"spanQuery": span(
        {"spanMultiTermQuery": {"prefixQuery": {"field": "t", "prefix": "al"}}},
        span_term("eta"), slop=1)},
    "phrase_in_boolean": {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": {"phraseQuery": {"field": "t", "terms": ["alpha", "beta"]}}},
        {"occur": "SHOULD", "query": {"matchQuery": {"field": "t", "query": "gamma theta"}}},
        {"occur": "FILTER", "query": {"rangeQuery": {"field": "price", "lower": "20",
                                                     "upper": "80"}}},
    ]}},
    "multivalued_gap": {"phraseQuery": {"field": "mv", "terms": ["delta", "alpha"]}},
    "multivalued_in": {"phraseQuery": {"field": "mv", "terms": ["alpha", "beta"]}},
}


OPS_CASES = {
    "exact2": (["alpha", "beta"], [0, 1], 0, (), 0),
    "exact3": (["beta", "gamma", "alpha"], [0, 1, 2], 0, (), 0),
    "repeat": (["eps", "eps"], [0, 1], 0, (), 0),
    "slop1": (["alpha", "gamma"], [0, 1], 1, (), 0),
    "slop2": (["delta", "alpha", "zeta"], [0, 1, 2], 2, (), 0),
    "slop3": (["theta", "eta"], [0, 1], 3, (), 0),
    "gap_offsets": (["alpha", "beta"], [0, 2], 0, (), 0),
    "prefix_exact": (["alpha"], [0], 0, ("alps", "alto", "alpha"), 1),
    "prefix_sloppy": (["beta", "gamma"], [0, 1], 2, ("eps", "eta"), 2),
    "absent_term": (["alpha", "omega"], [0, 1], 0, (), 0),
    "empty_expansions": (["alpha"], [0], 0, ("omega",), 1),
}


def candidates(seg, kind: str) -> np.ndarray:
    """Candidate doc ids for ``run_phrase``: every doc, or doc 0 and a few."""
    if kind == "all":
        return np.arange(seg.num_docs)
    # doc 0 and a short list: most of the padded window is INT_MAX pads,
    # which point the scatter at doc 0 (the collision trap)
    return np.array([0, 3, 7, 8, 40, 41, seg.num_docs - 1])


# -- nested documents, POLYGON, CONTEXT_SUGGEST, child and prefix fields --------

INDEX = "biz"
PARENTS = 80
WORDS = ["good", "great", "bad", "slow", "fast", "tasty", "cold", "warm", "friendly", "rude"]
TITLES = ["golden dragon", "good eats", "gourmet grill", "green garden", "grand cafe",
          "blue moon diner", "burger barn", "noodle house"]
CITIES = ["sf", "nyc", "la"]
FIELDS = [
    {"name": "biz_id", "type": "_ID", "store": True, "storeDocValues": True},
    {"name": "title", "type": "TEXT", "search": True, "store": True,
     "indexPrefixes": {"minChars": 2, "maxChars": 4},
     "childFields": [{"name": "kw", "type": "TEXT", "search": True, "analyzer": {"custom": {
         "tokenizer": {"name": "keyword"}, "tokenFilters": [{"name": "lowercase"}]}}}]},
    {"name": "area", "type": "POLYGON", "storeDocValues": True, "store": True},
    {"name": "sugg", "type": "CONTEXT_SUGGEST", "store": True},
    {"name": "reviews", "type": "OBJECT", "nestedDoc": True, "childFields": [
        {"name": "text", "type": "TEXT", "search": True, "store": True},
        {"name": "stars", "type": "INT", "storeDocValues": True, "store": True}]},
]


def nested_field_defs(create) -> dict:
    """The schema flattened to dotted names, as the servers' index state
    flattens it."""
    out = {}

    def register(name, spec):
        out[name] = create(name, spec)
        for child in spec.get("childFields") or []:
            register(f"{name}.{child['name']}", child)

    for spec in FIELDS:
        register(spec["name"], {k: v for k, v in spec.items() if k != "name"})
    return out


def square(lat, lon, size, hole=False) -> str:
    ring = [(lat, lon), (lat, lon + size), (lat + size, lon + size), (lat + size, lon),
            (lat, lon)]
    rings = [ring]
    if hole:
        q = size / 4
        rings.append([(lat + q, lon + q), (lat + q, lon + 3 * q), (lat + 3 * q, lon + 3 * q),
                      (lat + 3 * q, lon + q), (lat + q, lon + q)])
    return json.dumps({"type": "Polygon", "coordinates": [
        [[x, y] for y, x in r] for r in rings]})


def nested_docs(seed: int = 5) -> list[dict]:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(PARENTS):
        title = TITLES[int(rng.integers(0, len(TITLES)))]
        d = {
            "biz_id": f"b{i}",
            "title": title,
            "area": square(float(rng.integers(0, 20)), float(rng.integers(0, 20)),
                            float(rng.integers(2, 8)), hole=bool(i % 3 == 0)),
            "sugg": json.dumps({"value": title, "weight": int(rng.integers(1, 50)),
                                "contexts": [CITIES[int(rng.integers(0, 3))]]}),
            "reviews": [json.dumps({
                "text": " ".join(WORDS[int(j)] for j in rng.integers(0, len(WORDS), 4)),
                "stars": str(int(rng.integers(1, 6)))}) for _ in range(int(rng.integers(0, 5)))],
        }
        docs.append(d)
    return docs


def nested(mode: str, text: str = "good great") -> dict:
    return {"nestedQuery": {"path": "reviews", "scoreMode": mode,
                            "query": {"matchQuery": {"field": "reviews.text", "query": text}}}}


NESTED_QUERIES = {
    "match_all": {"matchAllQuery": {}},
    "title": {"matchQuery": {"field": "title", "query": "good dragon"}},
    "child_field_term": {"termQuery": {"field": "title.kw", "textValue": "good eats"}},
    "child_field_match": {"matchQuery": {"field": "title.kw", "query": "Golden Dragon"}},
    "prefix_companion": {"prefixQuery": {"field": "title", "prefix": "gou"}},
    "prefix_short": {"prefixQuery": {"field": "title", "prefix": "g"}},
    "prefix_long": {"prefixQuery": {"field": "title", "prefix": "golde"}},
    "phrase": {"matchPhraseQuery": {"field": "title", "query": "green garden"}},
    "nested_range": {"nestedQuery": {"path": "reviews", "query": {"rangeQuery": {
        "field": "reviews.stars", "lower": "4"}}}},
    "nested_in_boolean": {"booleanQuery": {"clauses": [
        {"occur": "MUST", "query": nested("MAX", "friendly")},
        {"occur": "SHOULD", "query": {"matchQuery": {"field": "title", "query": "grill"}}}]}},
    "polygon_in": {"geoPointQuery": {"field": "area", "point": {"latitude": 5.5,
                                                                 "longitude": 6.5}}},
    "polygon_corner": {"geoPointQuery": {"field": "area", "point": {"latitude": 21.0,
                                                                     "longitude": 2.0}}},
    "completion": {"completionQuery": {"field": "sugg", "text": "go"}},
    "completion_contexts": {"completionQuery": {"field": "sugg", "text": "g",
                                                "contexts": ["sf", "la"]}},
    "completion_fuzzy": {"completionQuery": {"field": "sugg", "text": "grabd",
                                             "queryType": "FUZZY_QUERY"}},
}


def add_requests(docs):
    for d in docs:
        req = pb.AddDocumentRequest(indexName=INDEX)
        for name, value in d.items():
            req.fields[name].value.extend(value if isinstance(value, list) else [value])
        yield req


def plain(resp) -> dict:
    resp = type(resp).FromString(resp.SerializeToString())
    resp.ClearField("diagnostics")
    resp.searchState.ClearField("timestamp")
    return MessageToDict(resp)


def request(query: dict, **kw) -> pb.SearchRequest:
    req = pb.SearchRequest(indexName=INDEX, topHits=kw.pop("topHits", 20),
                           retrieveFields=kw.pop("retrieveFields", ["biz_id"]), **kw)
    ParseDict(query, req.query)
    return req


def inner_hits_request() -> pb.SearchRequest:
    req = request(nested("SUM"))
    ih = req.inner_hits["good_reviews"]
    ih.query_nested_path = "reviews"
    ParseDict({"matchQuery": {"field": "reviews.text", "query": "good great"}}, ih.inner_query)
    ih.start_hit = 1
    ih.top_hits = 2
    ih.retrieve_fields.extend(["reviews.text", "reviews.stars"])
    all_kids = req.inner_hits["all"]
    all_kids.query_nested_path = "reviews"
    all_kids.top_hits = 5
    return req


def highlight_request() -> pb.SearchRequest:
    req = request({"matchPhraseQuery": {"field": "title", "query": "green garden"}},
                  retrieveFields=["biz_id", "title"])
    ParseDict({"fields": ["title"], "settings": {"preTags": ["<b>"], "postTags": ["</b>"]}},
              req.highlight)
    return req


SERVED = {
    "inner_hits": inner_hits_request,
    "nested_avg": lambda: request(nested("AVG")),
    "polygon": lambda: request(NESTED_QUERIES["polygon_in"],
                               retrieveFields=["biz_id", "area"]),
    "completion": lambda: request(NESTED_QUERIES["completion"],
                                  retrieveFields=["biz_id", "sugg"]),
    "completion_fuzzy": lambda: request(NESTED_QUERIES["completion_fuzzy"]),
    "prefix": lambda: request(NESTED_QUERIES["prefix_companion"]),
    "child_field": lambda: request(NESTED_QUERIES["child_field_match"]),
    "phrase_highlight": highlight_request,
}
