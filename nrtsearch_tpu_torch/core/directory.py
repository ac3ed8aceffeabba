"""Segment persistence: the on-disk index format (counterpart:
nrtsearch_tpu/core/directory.py, whose format this module reads and writes
unchanged, both ways).

A committed index directory contains:

- ``segments_<gen>.json``: the commit manifest (segment ids with their
  delete generations, version, primary generation);
- ``<seg_id>.arrays.npz``: all packed numeric arrays of one segment
  (postings, doc values, vectors);
- ``<seg_id>.meta.msgpack``: host dictionaries (term tables, ordinal
  dictionaries, stored rows);
- ``<seg_id>.live.<del_gen>.npy``: the live mask of one delete generation.

The port keeps no term positions: it writes ``has_positions`` false and no
``positions`` arrays, and ignores them on load. msgpack is imported inside
the functions that read or write the meta file, so no search path needs it.
Loading an index moves its arrays to the device the caller names; a
float16 (bf16) vector column raises ``NotImplementedError`` (ROADMAP item
12).
"""

from __future__ import annotations

import json
import os
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nrtsearch_tpu_torch.core.segment import (
    Segment, TextFieldIndex, VectorColumn, doc_value_column,
)
from nrtsearch_tpu_torch.device import resolve_device
from nrtsearch_tpu_torch.schema.fields import DocValueKind


def segment_file_names(seg_id: str, del_gen: int = 0) -> list[str]:
    """Immutable base files + the per-delete-generation live mask file."""
    return [
        f"{seg_id}.arrays.npz",
        f"{seg_id}.meta.msgpack",
        f"{seg_id}.live.{del_gen}.npy",
    ]


# (path, size, mtime_ns) -> (length, crc32). Segment files are immutable, so
# metadata computed once per file stays valid; the stat key invalidates the
# entry if a file is ever replaced in place.
_FILE_META_CACHE: dict[tuple, tuple[int, int]] = {}


def file_metadata(directory: str | Path, name: str) -> tuple[int, int]:
    """(length, crc32) of one index file."""
    path = Path(directory) / name
    st = path.stat()
    key = (str(path), st.st_size, st.st_mtime_ns)
    hit = _FILE_META_CACHE.get(key)
    if hit is not None:
        return hit
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    meta = (st.st_size, crc)
    _FILE_META_CACHE[key] = meta
    return meta


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_segment(seg: Segment, directory: str | Path) -> list[str]:
    """Write one segment's files; returns the file names written. Base
    files are immutable and skipped when already present; the live mask
    goes to a per-del-gen file."""
    import msgpack

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    live_path = directory / f"{seg.seg_id}.live.{seg.del_gen}.npy"
    if not live_path.exists():
        with open(live_path, "wb") as f:
            np.save(f, _host(seg.live))
    npz_path = directory / f"{seg.seg_id}.arrays.npz"
    if npz_path.exists():
        return segment_file_names(seg.seg_id, seg.del_gen)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {
        "seg_id": seg.seg_id,
        "num_docs": seg.num_docs,
        "capacity": seg.capacity,
        "stored": seg.stored,
        "suggest": {k: [[d, t, w, c] for d, t, w, c in v]
                    for k, v in seg.suggest.items()},
        "fields": {},
        "doc_values": {},
        "vectors": {},
    }
    for name, tfi in seg.fields.items():
        key = f"f.{name}"
        arrays[f"{key}.doc_ids"] = _host(tfi.doc_ids)
        arrays[f"{key}.freqs"] = _host(tfi.freqs)
        arrays[f"{key}.doc_lens"] = _host(tfi.doc_lens)
        arrays[f"{key}.offsets"] = tfi.offsets
        arrays[f"{key}.lengths"] = tfi.lengths
        inv = [None] * len(tfi.terms)
        for t, tid in tfi.terms.items():
            inv[tid] = t
        meta["fields"][name] = {
            "terms": inv,
            "sum_doc_lens": tfi.sum_doc_lens,
            "doc_count": tfi.doc_count,
            "postings_len": tfi.postings_len,
            "has_positions": False,
        }
    for name, dv in seg.doc_values.items():
        key = f"dv.{name}"
        arrays[f"{key}.values"] = dv.host_values
        arrays[f"{key}.present"] = dv.host_present
        if dv.mv_offsets is not None:
            arrays[f"{key}.mv_offsets"] = dv.mv_offsets
            arrays[f"{key}.mv_values"] = dv.mv_values
        meta["doc_values"][name] = {
            "kind": dv.kind.value,
            "ord_terms": dv.ord_terms,
            "multi": dv.mv_offsets is not None,
        }
    for name, vc in seg.vectors.items():
        key = f"v.{name}"
        arrays[f"{key}.values"] = _host(vc.values)
        arrays[f"{key}.present"] = _host(vc.present)
        arrays[f"{key}.norms"] = vc.host_norms
        meta["vectors"][name] = {"fmt": vc.fmt, "scale": vc.scale}

    with open(npz_path, "wb") as f:
        np.savez(f, **arrays)
    with open(directory / f"{seg.seg_id}.meta.msgpack", "wb") as f:
        f.write(msgpack.packb(meta, use_bin_type=True))
    return segment_file_names(seg.seg_id, seg.del_gen)


def load_segment(seg_id: str, directory: str | Path, device: str | torch.device,
                 del_gen: int = 0) -> Segment:
    """Read one segment's files onto ``device``."""
    import msgpack

    dev = resolve_device(device)
    directory = Path(directory)
    with open(directory / f"{seg_id}.meta.msgpack", "rb") as f:
        meta = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
    arrays = np.load(directory / f"{seg_id}.arrays.npz", allow_pickle=False)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=dev)

    fields = {}
    for name, fm in meta["fields"].items():
        key = f"f.{name}"
        fields[name] = TextFieldIndex(
            terms={t: i for i, t in enumerate(fm["terms"])},
            offsets=arrays[f"{key}.offsets"],
            lengths=arrays[f"{key}.lengths"],
            doc_ids=put(arrays[f"{key}.doc_ids"]),
            freqs=put(arrays[f"{key}.freqs"]),
            doc_lens=put(arrays[f"{key}.doc_lens"]),
            sum_doc_lens=fm["sum_doc_lens"],
            doc_count=fm["doc_count"],
            postings_len=fm["postings_len"],
        )
    doc_values = {}
    for name, dm in meta["doc_values"].items():
        key = f"dv.{name}"
        doc_values[name] = doc_value_column(
            DocValueKind(dm["kind"]), arrays[f"{key}.values"],
            arrays[f"{key}.present"], dev, dm.get("ord_terms"),
            arrays[f"{key}.mv_offsets"] if dm["multi"] else None,
            arrays[f"{key}.mv_values"] if dm["multi"] else None,
        )
    vectors = {}
    for name, vm in meta["vectors"].items():
        key = f"v.{name}"
        fmt = (vm or {}).get("fmt", "float32")
        if fmt == "float16":
            raise NotImplementedError(
                f"vector field {name!r}: bf16 vector columns are not ported yet "
                "(ROADMAP item 12)"
            )
        vectors[name] = VectorColumn(
            values=put(arrays[f"{key}.values"]),
            present=put(arrays[f"{key}.present"]),
            host_norms=arrays[f"{key}.norms"],
            fmt=fmt,
            scale=float((vm or {}).get("scale", 1.0)),
        )
    live_full = np.load(directory / f"{seg_id}.live.{del_gen}.npy")
    host_live = live_full[: meta["num_docs"]].copy()
    return Segment(
        seg_id=meta["seg_id"],
        num_docs=meta["num_docs"],
        capacity=meta["capacity"],
        fields=fields,
        stored=meta["stored"],
        live=put(live_full),
        host_live=host_live,
        del_count=int(meta["num_docs"] - host_live.sum()),
        doc_values=doc_values,
        del_gen=del_gen,
        vectors=vectors,
        suggest={k: [(d, t, w, c) for d, t, w, c in v]
                 for k, v in meta.get("suggest", {}).items()},
    )


class CommitManifest:
    """The durable commit point (``segments_<gen>``): ``segments`` is a list
    of [seg_id, del_gen] pairs, like Lucene's SegmentInfos."""

    def __init__(
        self, gen: int, version: int, segments: list[tuple[str, int]],
        primary_gen: int = 0,
    ):
        self.gen = gen
        self.version = version
        self.segments = [(s, int(d)) for s, d in segments]
        self.primary_gen = primary_gen

    @property
    def seg_ids(self) -> list[str]:
        return [s for s, _ in self.segments]

    def to_json(self) -> str:
        return json.dumps(
            {
                "gen": self.gen,
                "version": self.version,
                "segments": [[s, d] for s, d in self.segments],
                "primaryGen": self.primary_gen,
            }
        )

    @classmethod
    def from_json(cls, s: str | bytes) -> "CommitManifest":
        d = json.loads(s)
        return cls(d["gen"], d["version"], d["segments"], d.get("primaryGen", 0))

    def file_name(self) -> str:
        return f"segments_{self.gen}.json"


def commit_segments(
    segments: list[Segment], directory: str | Path, gen: int, version: int,
    primary_gen: int = 0,
) -> CommitManifest:
    """Write all segment files (skipping ones already on disk) + manifest."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for seg in segments:
        save_segment(seg, directory)
    manifest = CommitManifest(
        gen, version, [(s.seg_id, s.del_gen) for s in segments], primary_gen
    )
    tmp = directory / (manifest.file_name() + ".tmp")
    tmp.write_text(manifest.to_json())
    os.replace(tmp, directory / manifest.file_name())
    return manifest


def latest_commit(directory: str | Path) -> Optional[CommitManifest]:
    directory = Path(directory)
    if not directory.exists():
        return None
    best = None
    for p in directory.glob("segments_*.json"):
        try:
            gen = int(p.stem.split("_")[1])
        except (IndexError, ValueError):
            continue
        if best is None or gen > best[0]:
            best = (gen, p)
    if best is None:
        return None
    return CommitManifest.from_json(best[1].read_text())


def open_commit(directory: str | Path, device: str | torch.device
                ) -> tuple[Optional[CommitManifest], list[Segment]]:
    """The latest commit's manifest and its segments on ``device``."""
    manifest = latest_commit(directory)
    if manifest is None:
        return None, []
    return manifest, [
        load_segment(sid, directory, device, del_gen)
        for sid, del_gen in manifest.segments
    ]
