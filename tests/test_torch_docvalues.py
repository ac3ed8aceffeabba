"""Doc values and the committed index on disk: the port against the JAX
reference, on the CPU.

- The port's ``SegmentBuilder`` packs every doc-value kind (LONG, INT,
  FLOAT, DOUBLE, DATE_TIME, BOOLEAN, ATOM ordinals; single- and
  multi-valued) as the reference's does: values, presence, ordinal
  dictionaries, CSR arrays, and the f32-or-f64 device choice.
- A directory the reference committed (text, LONG above 2^24, DOUBLE,
  FLOAT, ATOM, multi-valued, deletes) opens in the port with equal arrays,
  and a directory the port committed opens in the reference.
"""

import random

import numpy as np
import pytest
import torch

from nrtsearch_tpu.schema.fields import create_field_def as ref_create_field_def
from nrtsearch_tpu_torch.core import directory as port_dir
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.schema import create_field_def

FIELDS = {
    "id": {"type": "_ID", "store": True},
    "body": {"type": "TEXT", "search": True, "store": True},
    "big": {"type": "LONG", "storeDocValues": True},        # > 2^24: an f64 column
    "small": {"type": "LONG", "storeDocValues": True},      # f32-exact
    "i": {"type": "INT", "storeDocValues": True, "store": True},
    "d": {"type": "DOUBLE", "storeDocValues": True},        # not f32-exact: f64
    "f": {"type": "FLOAT", "storeDocValues": True},         # f32-exact
    "flag": {"type": "BOOLEAN", "storeDocValues": True},
    "when": {"type": "DATE_TIME", "storeDocValues": True, "dateTimeFormat": "epoch_millis"},
    "tag": {"type": "ATOM", "storeDocValues": True},
    "kw": {"type": "ATOM", "search": True, "storeDocValues": True},
    "mtag": {"type": "ATOM", "storeDocValues": True, "multiValued": True},
    "mnum": {"type": "LONG", "storeDocValues": True, "multiValued": True},
    "mdbl": {"type": "DOUBLE", "storeDocValues": True, "multiValued": True},
}
DV_FIELDS = sorted(n for n, s in FIELDS.items() if s.get("storeDocValues") or s["type"] == "_ID")


def _docs(ids, rng):
    """Each doc leaves out some fields, so presence masks differ."""
    out = []
    for i in ids:
        doc = {"id": str(i), "body": " ".join(rng.choices(["red", "green", "blue", "tan"], k=3)),
               "big": str((1 << 25) + 7 * i), "tag": f"t{rng.randrange(9)}",
               "kw": rng.choice(["Alpha", "beta", "gamma"])}
        if rng.random() < 0.8:
            doc["small"] = str(rng.randrange(-1000, 1000))
            doc["i"] = str(rng.randrange(100))
            doc["d"] = str(rng.uniform(-5, 5))
            doc["f"] = str(float(np.float32(rng.uniform(0, 10))))
            doc["flag"] = rng.choice(["true", "false"])
            doc["when"] = str(1_700_000_000_000 + 1000 * i)
        n = rng.randrange(4)
        if n:
            doc["mtag"] = [f"m{rng.randrange(6)}" for _ in range(n)]
            doc["mnum"] = [str(rng.randrange(50)) for _ in range(n)]
            doc["mdbl"] = [str(rng.uniform(0, 1)) for _ in range(n)]
        out.append(doc)
    return out


WAVES = [(0, 400), (400, 700), (700, 900)]


def _waves():
    rng = random.Random(23)
    return [_docs(range(lo, hi), rng) for lo, hi in WAVES]


@pytest.fixture(scope="module")
def ref_segments():
    """The reference's 3 segments, with deletes in the first two."""
    from nrtsearch_tpu.core.writer import IndexWriter as RefWriter

    writer = RefWriter({n: ref_create_field_def(n, s) for n, s in FIELDS.items()})
    for k, wave in enumerate(_waves()):
        writer.add_documents([dict(d) for d in wave])
        writer.refresh()
        if k == 1:
            writer.delete_by_id([str(j) for j in range(0, 700, 9)])
    segs = writer.refresh()
    assert len(segs) == 3 and segs[0].del_count > 0
    return segs


@pytest.fixture(scope="module")
def port_segments():
    writer = IndexWriter({n: create_field_def(n, s) for n, s in FIELDS.items()}, "cpu")
    for wave in _waves():
        writer.add_documents([dict(d) for d in wave])
        writer.refresh()
    return writer.segments


def _device_dtype(values) -> str:
    return str(values.dtype).replace("torch.", "")


def assert_columns_equal(port_dv, ref_dv, ctx):
    assert port_dv.kind.value == ref_dv.kind.value, ctx
    np.testing.assert_array_equal(port_dv.host_values, np.asarray(ref_dv.host_values), ctx)
    assert port_dv.host_values.dtype == np.asarray(ref_dv.host_values).dtype, ctx
    np.testing.assert_array_equal(port_dv.host_present, np.asarray(ref_dv.host_present), ctx)
    assert port_dv.ord_terms == ref_dv.ord_terms, ctx
    assert port_dv.ord_index == ref_dv.ord_index, ctx
    for name in ("mv_offsets", "mv_values"):
        p, r = getattr(port_dv, name), getattr(ref_dv, name)
        assert (p is None) == (r is None), (ctx, name)
        if p is not None:
            np.testing.assert_array_equal(p, r, (ctx, name))
            assert p.dtype == r.dtype, (ctx, name)
    # the device column: f32 where f32 holds every value, f64 otherwise
    assert _device_dtype(port_dv.values) == str(ref_dv.values.dtype), ctx
    np.testing.assert_array_equal(port_dv.values.numpy(), np.asarray(ref_dv.values), ctx)
    np.testing.assert_array_equal(port_dv.present.numpy(), np.asarray(ref_dv.present), ctx)


@pytest.mark.parametrize("field", DV_FIELDS)
def test_builder_columns_match_reference(ref_segments, port_segments, field):
    """Unaffected by the reference's deletes: a delete replaces the live
    mask only."""
    for k, (rs, ps) in enumerate(zip(ref_segments, port_segments)):
        assert field in ps.doc_values, (field, k)
        assert_columns_equal(ps.doc_values[field], rs.doc_values[field], f"{field}[{k}]")


def test_device_precision_follows_the_values(port_segments):
    seg = port_segments[0]
    f64 = {n for n, dv in seg.doc_values.items() if dv.values.dtype == torch.float64}
    assert f64 == {"big", "d", "when", "mdbl"}


def test_searchable_atom_is_indexed(ref_segments, port_segments):
    for rs, ps in zip(ref_segments, port_segments):
        assert ps.fields["kw"].terms.keys() == rs.fields["kw"].terms.keys()
        for term in rs.fields["kw"].terms:
            assert ps.fields["kw"].doc_freq(term) == rs.fields["kw"].doc_freq(term)


def _assert_segments_equal(port_seg, ref_seg):
    ctx = port_seg.seg_id
    assert port_seg.seg_id == ref_seg.seg_id
    assert (port_seg.num_docs, port_seg.capacity, port_seg.del_count, port_seg.del_gen) == (
        ref_seg.num_docs, ref_seg.capacity, ref_seg.del_count, ref_seg.del_gen), ctx
    np.testing.assert_array_equal(port_seg.live.numpy(), np.asarray(ref_seg.live))
    np.testing.assert_array_equal(port_seg.host_live, np.asarray(ref_seg.host_live))
    assert port_seg.stored == ref_seg.stored, ctx
    assert port_seg.fields.keys() == ref_seg.fields.keys(), ctx
    for name, rt in ref_seg.fields.items():
        pt = port_seg.fields[name]
        assert pt.terms == rt.terms, (ctx, name)
        for arr in ("doc_ids", "freqs", "doc_lens"):
            np.testing.assert_array_equal(getattr(pt, arr).numpy(), np.asarray(getattr(rt, arr)))
        np.testing.assert_array_equal(pt.offsets, rt.offsets)
        np.testing.assert_array_equal(pt.lengths, rt.lengths)
        assert (pt.sum_doc_lens, pt.doc_count, pt.postings_len) == (
            rt.sum_doc_lens, rt.doc_count, rt.postings_len), (ctx, name)
    assert port_seg.doc_values.keys() == ref_seg.doc_values.keys(), ctx
    for name in ref_seg.doc_values:
        assert_columns_equal(port_seg.doc_values[name], ref_seg.doc_values[name], f"{ctx}/{name}")


def test_reference_commit_opens_in_port(ref_segments, tmp_path):
    from nrtsearch_tpu.core.directory import commit_segments as ref_commit

    ref_commit(ref_segments, tmp_path, gen=3, version=7, primary_gen=2)
    manifest, segs = port_dir.open_commit(tmp_path, "cpu")
    assert (manifest.gen, manifest.version, manifest.primary_gen) == (3, 7, 2)
    assert manifest.segments == [(s.seg_id, s.del_gen) for s in ref_segments]
    assert [s.del_gen for s in ref_segments] == [1, 1, 0]
    for ps, rs in zip(segs, ref_segments):
        _assert_segments_equal(ps, rs)
        assert ps.device == torch.device("cpu")


def test_port_commit_opens_in_reference(port_segments, tmp_path):
    from nrtsearch_tpu.core.directory import open_commit as ref_open

    port_dir.commit_segments(port_segments, tmp_path, gen=1, version=4)
    manifest, segs = ref_open(tmp_path)
    assert manifest.gen == 1 and len(segs) == len(port_segments)
    for ps, rs in zip(port_segments, segs):
        _assert_segments_equal(ps, rs)
        assert all(rs.fields[n].positions is None for n in rs.fields)
    # and back: the port reads its own files unchanged
    _m, again = port_dir.open_commit(tmp_path, "cpu")
    for a, b in zip(again, port_segments):
        assert a.doc_values.keys() == b.doc_values.keys()
        for n in a.doc_values:
            np.testing.assert_array_equal(a.doc_values[n].host_values, b.doc_values[n].host_values)


def test_port_writes_no_positions(port_segments, tmp_path):
    import msgpack

    names = port_dir.save_segment(port_segments[0], tmp_path)
    seg_id = port_segments[0].seg_id
    assert names == port_dir.segment_file_names(seg_id, 0)
    meta = msgpack.unpackb((tmp_path / f"{seg_id}.meta.msgpack").read_bytes(), raw=False)
    assert all(not fm["has_positions"] for fm in meta["fields"].values())
    keys = np.load(tmp_path / f"{seg_id}.arrays.npz").files
    assert not any("position" in k for k in keys)
    # base files are immutable: a second save skips them
    before = port_dir.file_metadata(tmp_path, names[0])
    port_dir.save_segment(port_segments[0], tmp_path)
    assert port_dir.file_metadata(tmp_path, names[0]) == before


def test_latest_commit_picks_the_highest_generation(port_segments, tmp_path):
    assert port_dir.latest_commit(tmp_path / "missing") is None
    port_dir.commit_segments(port_segments[:1], tmp_path, gen=2, version=1)
    port_dir.commit_segments(port_segments, tmp_path, gen=5, version=2)
    manifest, segs = port_dir.open_commit(tmp_path, "cpu")
    assert manifest.gen == 5 and len(segs) == 3


def test_bf16_vectors_raise_naming_item_12(tmp_path):
    from nrtsearch_tpu.core.directory import commit_segments as ref_commit
    from nrtsearch_tpu.core.writer import IndexWriter as RefWriter

    spec = {"type": "VECTOR", "vectorDimensions": 4, "vectorIndexingOptions": "float16"}
    writer = RefWriter({"v": ref_create_field_def("v", spec)})
    writer.add_documents([{"v": [0.1, 0.2, 0.3, 0.4]}])
    ref_commit(writer.refresh(), tmp_path, gen=1, version=1)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        port_dir.open_commit(tmp_path, "cpu")


@pytest.mark.parametrize("spec,item", [
    ({"type": "LAT_LON", "storeDocValues": True}, 10),
    ({"type": "POLYGON", "storeDocValues": True}, 10),
    ({"type": "VECTOR", "vectorDimensions": 2}, 12),
    ({"type": "CONTEXT_SUGGEST"}, 10),
    ({"type": "TEXT", "search": True, "indexPrefixes": {"minChars": 2, "maxChars": 4}}, 10),
])
def test_unported_field_types_raise(spec, item):
    writer = IndexWriter({"x": create_field_def("x", spec)}, "cpu")
    value = [1.0, 2.0] if spec["type"] in ("LAT_LON", "VECTOR") else "abc"
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        writer.add_documents([{"x": value}])
