"""The native postings accumulator in the port (native_ext.py,
csrc/host/nrt_tokenize.cpp) and the segment builder's path through it.

The C++ source is a byte-for-byte copy of the reference's
native/nrt_tokenize.cpp. The port's builder over the same documents (ASCII
and non-ASCII text, multi-valued fields, a custom analyzer, an
indexPrefixes field, nested children, fields with no tokens) packs exactly
the arrays of its own pure-Python path (NRT_NATIVE=0) and of the
reference's builder: term ids, offsets, lengths, doc ids, freqs, positions,
position offsets and quantized field lengths are equal, no tolerance.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from nrtsearch_tpu import native_ext as ref_native_ext
from nrtsearch_tpu.core.segment import SegmentBuilder as RefBuilder
from nrtsearch_tpu.schema.fields import create_field_def as ref_create
from nrtsearch_tpu_torch import native_ext
from nrtsearch_tpu_torch.core.segment import SegmentBuilder
from nrtsearch_tpu_torch.schema import create_field_def

REPO = Path(__file__).resolve().parent.parent

SPECS = {
    "body": {"type": "TEXT", "search": True, "multiValued": True},
    "en": {"type": "TEXT", "search": True, "analyzer": "english"},
    "title": {"type": "TEXT", "search": True,
              "indexPrefixes": {"minChars": 2, "maxChars": 4}},
    "tag": {"type": "ATOM", "search": True, "storeDocValues": True},
    "reviews": {"type": "OBJECT", "nestedDoc": True, "multiValued": True,
                "childFields": [{"name": "text", "type": "TEXT", "search": True}]},
    "reviews.text": {"type": "TEXT", "search": True},
}
WORDS = ["alpha", "Beta", "gamma", "can't", "3.14", "école", "naïve", "x86", "foo_bar",
         "delta", "Ünïcode", "1,000", "e-mail", "U.S.A"]


def _docs(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)

    def text(m):
        return " ".join(rng.choice(WORDS, m))

    out = []
    for i in range(n):
        doc = {"body": [text(int(rng.integers(0, 12))) for _ in range(rng.integers(1, 4))],
               "en": text(5), "title": text(3), "tag": str(rng.choice(WORDS))}
        if i % 3 == 0:
            doc["reviews"] = [json.dumps({"text": text(4)}) for _ in range(i % 4)]
        out.append(doc)
    return out


@pytest.fixture()
def fresh_native(monkeypatch):
    """native_ext's cached module reset, and restored after the test."""
    monkeypatch.setattr(native_ext, "_module", None)
    monkeypatch.setattr(native_ext, "_tried", False)
    return monkeypatch


def _port_segment(docs, native: bool, monkeypatch):
    monkeypatch.setattr(native_ext, "_module", None)
    monkeypatch.setattr(native_ext, "_tried", False)
    monkeypatch.setenv("NRT_NATIVE", "1" if native else "0")
    b = SegmentBuilder({n: create_field_def(n, s) for n, s in SPECS.items()},
                       torch.device("cpu"))
    assert (b._native is not None) == native
    for d in docs:
        b.add_document(d)
    return b.flush()


def _arrays(tfi) -> dict:
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return {"terms": list(tfi.terms.items()), "offsets": host(tfi.offsets),
            "lengths": host(tfi.lengths), "positions": host(tfi.positions),
            "position_offsets": host(tfi.position_offsets),
            "doc_ids": host(tfi.doc_ids)[: tfi.postings_len],
            "freqs": host(tfi.freqs)[: tfi.postings_len], "doc_lens": host(tfi.doc_lens),
            "sums": (tfi.sum_doc_lens, tfi.doc_count, tfi.postings_len)}


def _assert_same(a, b, ctx):
    assert sorted(a.fields) == sorted(b.fields), ctx
    for name in a.fields:
        x, y = _arrays(a.fields[name]), _arrays(b.fields[name])
        for key in x:
            if isinstance(x[key], np.ndarray):
                np.testing.assert_array_equal(x[key], y[key], err_msg=f"{ctx} {name} {key}")
            else:
                assert x[key] == y[key], (ctx, name, key)


def test_cpp_source_is_the_reference_copy():
    port = REPO / "nrtsearch_tpu_torch" / "csrc" / "host" / "nrt_tokenize.cpp"
    assert port.read_bytes() == (REPO / "native" / "nrt_tokenize.cpp").read_bytes()
    assert native_ext._SRC == port


def test_native_builder_equals_python_and_reference(fresh_native):
    docs = _docs(600)
    native = _port_segment(docs, True, fresh_native)
    python = _port_segment(docs, False, fresh_native)
    assert {"body", "en", "title", "title._index_prefix", "reviews.text"} <= set(native.fields)
    _assert_same(native, python, "native vs python")
    # the reference's builder loads its own build of the extension
    fresh_native.setenv("NRT_NATIVE", "1")
    if ref_native_ext._module is None:
        fresh_native.setattr(ref_native_ext, "_tried", False)
    ref = RefBuilder({n: ref_create(n, s) for n, s in SPECS.items()})
    assert ref._native is not None
    for d in docs:
        ref.add_document(d)
    _assert_same(native, ref.flush(), "port vs reference")


def test_native_module_is_the_ports_own(fresh_native):
    """The extension loads from the port's build directory, not from the
    reference's, and the name it registers under is left as it was."""
    import sys

    before = sys.modules.get("nrt_native")
    mod = native_ext.get()
    assert mod is not None
    assert Path(mod.__file__).parent == native_ext._BUILD_DIR
    assert sys.modules.get("nrt_native") is before
    acc = mod.PostingsAccumulator()
    assert acc.add_text(0, "Hello hello world", 0) == 3
    assert acc.add_text(1, "naïve", 0) == -1
    names, _offs, lens, docs, freqs, pos = acc.finish()
    assert names == ["hello", "world"]
    assert np.frombuffer(freqs, np.int32).tolist() == [2, 1]
    assert np.frombuffer(pos, np.int32).tolist() == [0, 1, 2]


def test_nrt_native_0_and_failed_build_take_the_python_builder(fresh_native, tmp_path):
    fresh_native.setenv("NRT_NATIVE", "0")
    assert native_ext.get() is None
    fresh_native.setattr(native_ext, "_tried", False)
    fresh_native.delenv("NRT_NATIVE")
    # no library yet and a source g++ cannot compile: the build fails
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    fresh_native.setattr(native_ext, "_SRC", bad)
    fresh_native.setattr(native_ext, "_BUILD_DIR", tmp_path / "build")
    assert native_ext.get() is None
    assert not list((tmp_path / "build").glob("*.tmp"))
    b = SegmentBuilder({"body": create_field_def("body", SPECS["body"])},
                       torch.device("cpu"))
    assert b._native is None
    b.add_document({"body": "gamma delta"})
    assert b.flush().fields["body"].terms == {"gamma": 0, "delta": 1}
    assert os.environ.get("NRT_NATIVE") is None
