"""Copy of ``nrtsearch_tpu/server/index_runtime.py`` that carries the device:
``IndexRuntime(..., device)`` builds its writer, opens commits and loads
segments onto that device; a delete by query reads each segment's match
mask back from that device.

Per-index runtime: writer + searcher lifecycle + NRT roles.

Reference: server/index/ShardState.java — start modes (standalone :559,
primary :690, replica :915), commit (:354), searcher acquire/release
(:406,:418), reopen thread. Differences by design:

- a searcher snapshot is an immutable Python object over immutable device
  arrays, so acquire/release ref-counting is unnecessary (GC handles it);
  SearcherLifetimeManager becomes a version -> snapshot dict;
- the reopen thread is replaced by refresh-on-demand plus an optional
  background ticker (maxRefreshSec), since segment flush is cheap;
- primary durability: on refresh/commit, segment files + NrtPointState go to
  the RemoteBackend (NrtDataManager.java:445 upload pipeline equivalent);
- replica: installs point states either by polling the remote backend
  (isolated replica, RemoteCopyJobManager.java:141) or via pushed
  newNRTPoint RPCs + file copy from the primary.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from nrtsearch_tpu_torch.core.directory import (
    CommitManifest,
    commit_segments,
    load_segment,
    open_commit,
)
from nrtsearch_tpu_torch.core.searcher import Searcher
from nrtsearch_tpu_torch.core.writer import IndexWriter
from nrtsearch_tpu_torch.nrt.point_state import NrtPointState
from nrtsearch_tpu_torch.remote.backend import RemoteBackend
from nrtsearch_tpu_torch.state.index_state import IndexStateInfo


def _parse_index_sort(settings: dict, field_defs: dict) -> list:
    """IndexSettings.indexSort -> [(field, reverse, missing_last)], with the
    reference's validation (ImmutableIndexState.validateIndexSort: sortable
    doc-value field required)."""
    from nrtsearch_tpu_torch.schema.fields import FieldType

    spec = settings.get("indexSort") or {}
    out = []
    for st in spec.get("sortedFields", []):
        name = st.get("fieldName", "")
        fd = field_defs.get(name)
        if fd is None:
            raise ValueError(f"index sort field not registered: {name!r}")
        if not fd.store_doc_values or fd.type in (
            FieldType.LAT_LON, FieldType.POLYGON, FieldType.VECTOR,
        ):
            raise ValueError(f"field is not index-sortable: {name!r}")
        missing_last = str(st.get("missingLast", "")).lower() in ("true", "1")
        out.append((name, bool(st.get("reverse", False)), missing_last))
    return out


# live runtimes, for test-harness thread cleanup (leaked refresh/poll
# ticker threads across hundreds of in-process fixtures destabilize the
# process — each keeps firing refresh() on a stale runtime)
_LIVE_RUNTIMES: "weakref.WeakSet" = weakref.WeakSet()


class IndexRuntime:
    """One started index on this node."""

    def __init__(
        self,
        state_info: IndexStateInfo,
        index_dir: str | Path,
        mode: str = "STANDALONE",
        remote: Optional[RemoteBackend] = None,
        service_name: str = "",
        primary_gen: int = 0,
        on_nrt_point: Optional[Callable[[NrtPointState], None]] = None,
        *,
        device: str | torch.device,
    ):
        self.state_info = state_info
        self.index_dir = Path(index_dir)
        self.index_dir.mkdir(parents=True, exist_ok=True)
        self.mode = mode
        self.remote = remote
        self.service_name = service_name
        self.primary_gen = primary_gen
        self.primary_id = uuid.uuid4().hex[:16]
        self.on_nrt_point = on_nrt_point  # primary: notify replicas hook
        self._lock = threading.RLock()
        self.field_defs = state_info.field_defs()
        merge_factor = int(state_info.settings.get("mergeFactor", 10))
        self.writer = IndexWriter(self.field_defs, device, merge_factor=merge_factor)
        self.device = self.writer.device
        self.writer.index_sort = _parse_index_sort(
            state_info.settings, self.field_defs
        )
        self.apply_live_settings(state_info.live_settings)
        self._version = 0
        self._gen = 0
        self.searcher = Searcher([], self.field_defs, version=0)
        self._searchers_by_version: dict[int, Searcher] = {}
        self._searcher_publish_time: dict[int, float] = {}
        self.start_time = time.time()
        self._refresh_thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        self._warm_lock = threading.Lock()
        self._warm_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        _LIVE_RUNTIMES.add(self)

    # -- lifecycle --------------------------------------------------------------

    def apply_live_settings(self, live_settings: dict) -> None:
        """Push hot-updatable settings into the writer (reference:
        ImmutableIndexState live settings drive TieredMergePolicy's
        setSegmentsPerTier / setMaxMergedSegmentMB)."""
        spt = int(
            live_settings.get("segmentsPerTier", 0)
            or self.state_info.settings.get("mergeFactor", 10)
        )
        self.writer.segments_per_tier = max(spt, 2)
        mb = int(live_settings.get("maxMergedSegmentMB", 0) or 0)
        # doc-count proxy for segment bytes (~1k docs per MB of typical text)
        self.writer.max_merged_docs = mb * 1000 if mb > 0 else 0
        # virtualShards applies to the CURRENT searcher immediately (it is a
        # live setting); future publishes pick it up from state_info
        try:
            self.searcher.dist_shards = int(
                live_settings.get("virtualShards", 1) or 1
            )
        except Exception:
            pass

    def start(self, restore: bool = False) -> None:
        with self._lock:
            if restore and self.remote is not None:
                self._restore_from_remote()
            else:
                manifest, segments = open_commit(self.index_dir, self.device)
                if manifest is not None:
                    self.writer.install_segments(segments)
                    self._gen = manifest.gen
                    self._version = manifest.version
                    self._publish_searcher(segments)
            if self.mode == "REPLICA" and self.remote is not None:
                self._start_replica_poll()
            if self.mode in ("STANDALONE", "PRIMARY"):
                self._start_refresh_ticker()

    def stop(self) -> None:
        self._stopped.set()
        for t in (self._refresh_thread, self._poll_thread, self._warm_thread):
            if t is not None:
                t.join(timeout=5)

    # -- indexing ----------------------------------------------------------------

    def add_documents(self, docs: list[dict[str, Any]]) -> int:
        self._check_writable()
        return self.writer.add_documents(docs)

    def delete_by_id(self, ids: list[str]) -> int:
        self._check_writable()
        return self.writer.delete_by_id(ids)

    def update_doc_values(self, docs: list[dict[str, Any]]) -> int:
        self._check_writable()
        return self.writer.update_doc_values(docs)

    def delete_by_query(self, node) -> int:
        self._check_writable()
        self.refresh()  # deletes run against a current view, like the reference
        seg_matches: dict[str, np.ndarray] = {}
        searcher = self.searcher
        masks = searcher.match_masks(node)
        for seg, mask in zip(searcher.segments, masks):
            ids = np.nonzero(np.asarray(mask[: seg.num_docs].cpu()))[0]
            if len(ids):
                seg_matches[seg.seg_id] = ids
        return self.writer.delete_matches(seg_matches)

    def delete_all(self) -> int:
        self._check_writable()
        with self._lock:
            gen = self.writer.delete_all()
            self._version += 1
            self._publish_searcher([])
            if self.mode == "PRIMARY":
                self._publish_nrt_point()
            return gen

    def _check_writable(self) -> None:
        if self.mode == "REPLICA":
            raise PermissionError("replica indexes are read-only (NRT replication)")

    # -- refresh / commit ----------------------------------------------------------

    def refresh(self) -> float:
        """Flush + publish a new searcher; primary also publishes an NRT point."""
        t0 = time.time()
        with self._lock:
            if self.mode == "REPLICA":
                return 0.0
            dirty = (
                self.writer.buffered_docs > 0
                or bool(self.writer._pending_deletes)
                or bool(self.writer._buffer_deleted)
                or bool(self.writer._pending_dv_updates)
            )
            segments = self.writer.refresh()
            # skip-publish only when the PUBLISHED searcher already serves
            # exactly these segments. Comparing against the writer's
            # pre-refresh list instead silently dropped flushed-but-never-
            # published segments: an ingest whose last add exactly filled
            # the buffer flushes inside add_documents, leaving buffered==0
            # and an unchanged writer list at refresh time — the refresh
            # returned without publishing and searches served a stale (even
            # empty) searcher (caught by the 1M-doc e2e bench: numDocs=0).
            published = [s.seg_id for s in self.searcher.segments]
            if not dirty and [s.seg_id for s in segments] == published:
                return (time.time() - t0) * 1000
            self._version += 1
            self._publish_searcher(segments)
            if self.mode == "PRIMARY":
                self._publish_nrt_point()
        return (time.time() - t0) * 1000

    def commit(self) -> int:
        with self._lock:
            if self.mode == "REPLICA":
                return self._gen
            self.refresh()
            self._gen += 1
            commit_segments(
                self.writer.segments, self.index_dir, self._gen, self._version,
                self.primary_gen,
            )
            if self.mode == "PRIMARY":
                self._publish_nrt_point()
            return self._gen

    def _publish_searcher(self, segments) -> None:
        self.searcher = Searcher(segments, self.field_defs, version=self._version)
        # honor liveSettings.virtualShards (reference: luceneserver.proto:1458,
        # MyIndexSearcher.slicesForShards): >1 on a multi-device host serves
        # plain text queries over a (shard, data) mesh
        self.searcher.dist_shards = int(
            self.state_info.live_settings.get("virtualShards", 1) or 1
        )
        self._searchers_by_version[self._version] = self.searcher
        self._searcher_publish_time[self._version] = time.time()
        self._prune_searchers()
        # Superseded snapshots drop their device caches (packed postings,
        # dense-head rows) NOW rather than at age-out: under a sustained
        # ingest the 1 s refresh ticker publishes a searcher per second, and
        # each retained snapshot's packed view + dense rows is O(index) HBM
        # — 60 s of retention at 8.8M-doc scale is a guaranteed OOM. The
        # immediately previous version keeps its caches (in-flight searches
        # acquired it moments ago); older pinned versions rebuild lazily if
        # a version-pinned search actually lands on them.
        for v, s in self._searchers_by_version.items():
            if v < self._version - 1:
                s.release_device_caches()
        self._warm_packed_views(self.searcher)

    def _warm_packed_views(self, searcher: Searcher) -> None:
        """Eagerly pack per-field device views off the refresh path so the
        first query after an NRT point doesn't pay the pack + compile
        (round-1 weakness: lazy per-(segment, field) precompute spiked
        first-query latency after every refresh)."""
        fields = [
            name for name, fd in self.field_defs.items()
            if getattr(fd, "search", False) and getattr(fd, "is_text", False)
        ]
        if not fields or not searcher.segments:
            return

        def warm():
            # Serialize warms, latest-wins: a 1 s refresh ticker under
            # streaming ingest would otherwise stack one un-bounded dense
            # build (O(index) HBM each) per publish — concurrent stale
            # builds were the e2e ingest OOM (PERF_E2E_r05). At most one
            # stale build can be mid-flight at a time.
            with self._warm_lock:
                if self.searcher is not searcher or self._stopped.is_set():
                    return
                try:
                    searcher.warm(fields)
                except Exception:
                    pass
            # close the release/warm race: if this snapshot was superseded
            # while its warm was mid-build, the publish-time release ran
            # before the caches existed — drop them now
            if searcher.version < self._version - 1:
                searcher.release_device_caches()

        t = threading.Thread(target=warm, daemon=True)
        self._warm_thread = t
        t.start()

    def _prune_searchers(self) -> None:
        """Age-based pruning of pinned searcher versions (reference:
        SearcherLifetimeManager.PruneByAge driven by the maxSearcherAgeSec
        live setting, ShardState.SearcherPruningThread). The current searcher
        is never pruned; a hard cap bounds memory if the age is set large."""
        max_age = float(
            self.state_info.live_settings.get("maxSearcherAgeSec", 60.0) or 60.0
        )
        now = time.time()
        versions = sorted(self._searchers_by_version)
        for v in versions:
            if v == self._version:
                continue
            age = now - self._searcher_publish_time.get(v, now)
            if age > max_age or len(self._searchers_by_version) > 64:
                del self._searchers_by_version[v]
                self._searcher_publish_time.pop(v, None)

    def acquire(
        self, version: Optional[int] = None, wait_sec: float = 10.0
    ) -> Searcher:
        """Latest searcher, or the one pinned by ``version``.

        Reference semantics (SearchHandler.getSearcherAndTaxonomy,
        SearchHandler.java:765): a version ahead of the current searcher
        means the client saw a refresh this node hasn't replicated yet —
        WAIT for it (read-your-writes; the reference blocks on a refresh
        listener). A version behind the current one whose searcher has been
        pruned is expired — ERROR, never silently serve a different
        version. ``wait_sec`` bounds the wait (the reference waits forever;
        a bogus future version must not hang a search thread)."""
        if version is None:
            return self.searcher
        s = self._searchers_by_version.get(version)
        if s is not None:
            return s
        current = self.searcher
        if current.version == version:
            return current
        if version > current.version:
            deadline = time.time() + wait_sec
            while time.time() < deadline:
                if self.searcher.version >= version:
                    pinned = self._searchers_by_version.get(version)
                    if pinned is not None:
                        return pinned
                    return self.searcher
                time.sleep(0.01)
            raise RuntimeError(
                f"searcher: requested version={version} did not become "
                f"available within {wait_sec}s (currentVersion="
                f"{self.searcher.version})"
            )
        raise RuntimeError(
            f"searcher: This searcher has expired version={version} vs "
            f"currentVersion={current.version}"
        )

    # -- NRT primary ---------------------------------------------------------------

    def current_point(self) -> NrtPointState:
        """The current searchable point (persisting segment files first)."""
        from nrtsearch_tpu_torch.core.directory import file_metadata

        with self._lock:
            segments = self.writer.segments
            names: list[str] = []
            for seg in segments:
                names.extend(commit_file_names_for(
                    seg, self.index_dir, self.remote, self.service_name,
                    self.state_info.index_id,
                ))
            return NrtPointState(
                version=self._version,
                gen=self._gen,
                primary_gen=self.primary_gen,
                primary_id=self.primary_id,
                segments=[(s.seg_id, s.del_gen) for s in segments],
                file_meta={n: file_metadata(self.index_dir, n) for n in names},
            )

    def _publish_nrt_point(self) -> None:
        # persist segment files locally, upload new ones to the object store
        point = self.current_point()
        if self.remote is not None:
            self.remote.upload_versioned(
                self.service_name, NrtPointState.resource(self.state_info.index_id),
                point.to_json().encode(),
            )
        if self.on_nrt_point is not None:
            # notify replicas OFF the runtime lock: a replica's copy job calls
            # back into this primary (recvCopyState/recvRawFile), which must
            # not deadlock against the refresh holding _lock. The reference
            # similarly sends newNRTPoint from the refresh path but serves
            # copy RPCs on independent executors.
            threading.Thread(
                target=self.on_nrt_point, args=(point,), daemon=True
            ).start()

    # -- NRT replica ----------------------------------------------------------------

    def install_point(self, point: NrtPointState, file_fetcher=None) -> bool:
        """Download a point's files and swap the searcher (replica side).

        ``file_fetcher(files)`` fetches missing files into index_dir — either
        the object store (isolated replica) or a primary file-copy stream
        (server/replication.py, SimpleCopyJob equivalent).
        """
        with self._lock:
            # a new primary incarnation (higher primaryGen) restarts the
            # version clock; accept its points unconditionally (reference:
            # primaryGen monotonic generation + ephemeral primaryId detect a
            # new primary, SURVEY.md §5 failure detection)
            new_primary = point.primary_gen > self.primary_gen
            if not new_primary and point.version <= self._version and self._version > 0:
                return False
            if new_primary:
                self.primary_gen = point.primary_gen
            missing = [
                f for f in point.files
                if not self._file_matches_point(f, point)
            ]
            if missing:
                if file_fetcher is not None:
                    file_fetcher(missing)
                elif self.remote is not None:
                    self.remote.download_index_files(
                        self.service_name, self.state_info.index_id,
                        self.index_dir, missing,
                    )
                bad = [
                    f for f in missing if not self._file_matches_point(f, point)
                ]
                if bad:
                    raise IOError(
                        f"fetched files failed length/crc verification: {bad}"
                    )
            segments = [
                load_segment(sid, self.index_dir, self.device, del_gen)
                for sid, del_gen in point.segments
            ]
            self.writer.install_segments(segments)
            self._version = point.version
            self._gen = point.gen
            self._publish_searcher(segments)
            return True

    def _file_matches_point(self, name: str, point: NrtPointState) -> bool:
        """True if a local file exists AND matches the point's per-file
        length+crc metadata (the reference compares FileMetaData before
        reusing a local file, CopyState.fileMetadata). A mismatched file —
        e.g. a stale file under a reused name, or a truncated copy — is
        deleted so the fetcher re-copies it."""
        from nrtsearch_tpu_torch.core.directory import file_metadata

        path = self.index_dir / name
        if not path.exists():
            return False
        expected = point.file_meta.get(name)
        if expected is None:  # point predates file metadata; trust the name
            return True
        if file_metadata(self.index_dir, name) == tuple(expected):
            return True
        path.unlink(missing_ok=True)
        return False

    def sync_from_remote(self) -> bool:
        if self.remote is None:
            return False
        data = self.remote.download_current(
            self.service_name, NrtPointState.resource(self.state_info.index_id)
        )
        if data is None:
            return False
        return self.install_point(NrtPointState.from_json(data))

    def _restore_from_remote(self) -> None:
        synced = self.sync_from_remote()
        if not synced:
            manifest, segments = open_commit(self.index_dir, self.device)
            if manifest is not None:
                self.writer.install_segments(segments)
                self._gen = manifest.gen
                self._version = manifest.version
                self._publish_searcher(segments)

    def _start_replica_poll(self, interval: float = 1.0) -> None:
        def poll():
            while not self._stopped.is_set():
                try:
                    self.sync_from_remote()
                except Exception:
                    pass
                self._stopped.wait(interval)

        self._poll_thread = threading.Thread(target=poll, daemon=True)
        self._poll_thread.start()

    def _start_refresh_ticker(self) -> None:
        if float(self.state_info.live_settings.get("maxRefreshSec", 1.0)) <= 0:
            return

        def tick():
            while not self._stopped.is_set():
                # re-read per tick: maxRefreshSec is a LIVE setting
                # (reference: ControlledRealTimeReopenThread reconfigured on
                # liveSettings updates, ShardState.restartReopenThread) —
                # bulk loaders raise it mid-ingest to stop paying a flush +
                # merge + warm per second
                max_refresh = float(
                    self.state_info.live_settings.get("maxRefreshSec", 1.0)
                    or 1.0
                )
                self._stopped.wait(max(max_refresh, 0.05))
                if self._stopped.is_set():
                    break
                try:
                    if self.writer.buffered_docs > 0 or self.writer._pending_deletes:
                        self.refresh()
                except Exception:
                    pass

        self._refresh_thread = threading.Thread(target=tick, daemon=True)
        self._refresh_thread.start()

    # -- snapshots (reference: PersistentSnapshotDeletionPolicy via
    # CreateSnapshotHandler; ref-counted commit gens, ShardState.java:753-761) --

    def _snapshots_file(self) -> Path:
        return self.index_dir / "snapshots.json"

    def _load_snapshots(self) -> dict:
        p = self._snapshots_file()
        import json

        return json.loads(p.read_text()) if p.exists() else {}

    def create_snapshot(self) -> int:
        """Commit and pin the commit point; returns the pinned gen."""
        gen = self.commit()
        import json

        with self._lock:
            snaps = self._load_snapshots()
            snaps[str(gen)] = snaps.get(str(gen), 0) + 1
            self._snapshots_file().write_text(json.dumps(snaps))
        return gen

    def release_snapshot(self, gen: int) -> bool:
        import json

        with self._lock:
            snaps = self._load_snapshots()
            key = str(gen)
            if key not in snaps:
                return False
            snaps[key] -= 1
            if snaps[key] <= 0:
                del snaps[key]
            self._snapshots_file().write_text(json.dumps(snaps))
            self.gc_files()
            return True

    def snapshot_gens(self) -> list[int]:
        return sorted(int(g) for g in self._load_snapshots())

    def searcher_for_snapshot(self, gen: int) -> Searcher:
        """Open a point-in-time searcher over a pinned commit."""
        from nrtsearch_tpu_torch.core.directory import CommitManifest, load_segment

        manifest_path = self.index_dir / f"segments_{gen}.json"
        if not manifest_path.exists():
            raise KeyError(f"no snapshot commit gen {gen}")
        manifest = CommitManifest.from_json(manifest_path.read_text())
        segments = [
            load_segment(sid, self.index_dir, self.device, dg)
            for sid, dg in manifest.segments
        ]
        return Searcher(segments, self.field_defs, version=manifest.version)

    def gc_files(self) -> list[str]:
        """Delete index files not referenced by the latest commit, any pinned
        snapshot, or the live searcher (ReplicaDeleterManager analogue)."""
        from nrtsearch_tpu_torch.core.directory import (
            CommitManifest,
            latest_commit,
            segment_file_names,
        )

        with self._lock:
            keep: set[str] = set()
            keep_manifests: set[str] = set()
            latest = latest_commit(self.index_dir)
            pinned_gens = set(self.snapshot_gens())
            if latest is not None:
                pinned_gens.add(latest.gen)
            for gen in pinned_gens:
                p = self.index_dir / f"segments_{gen}.json"
                if not p.exists():
                    continue
                keep_manifests.add(p.name)
                m = CommitManifest.from_json(p.read_text())
                for sid, dg in m.segments:
                    keep.update(segment_file_names(sid, dg))
            for seg in self.writer.segments:
                keep.update(segment_file_names(seg.seg_id, seg.del_gen))
            removed = []
            for p in self.index_dir.iterdir():
                if p.name == "snapshots.json" or not p.is_file():
                    continue
                if p.name.startswith("segments_"):
                    drop = p.name not in keep_manifests
                else:
                    drop = p.name not in keep
                if drop:
                    removed.append(p.name)
                    p.unlink()
            return removed

    # -- stats ------------------------------------------------------------------------

    def stats(self) -> dict:
        s = self.searcher
        published = self._searcher_publish_time.get(s.version)
        return {
            "maxDoc": s.max_doc,
            "numDocs": s.num_docs,
            "numSegments": len(s.segments),
            "version": s.version,
            "gen": self._gen,
            "mode": self.mode,
            "bufferedDocs": self.writer.buffered_docs,
            # searcher age since publish (reference: SearchResponseCollector
            # nrt_searcher_age family) + merge scheduler activity
            "searcherAgeSec": (time.time() - published) if published else 0.0,
            **self.writer.merge_stats,
        }


def commit_file_names_for(seg, index_dir: Path, remote, service: str, index_id: str):
    """Persist one segment locally (if needed) and upload to the remote store."""
    from nrtsearch_tpu_torch.core.directory import save_segment

    names = save_segment(seg, index_dir)  # no-op for already-persisted files
    if remote is not None:
        missing = [
            n for n in names if not remote.index_file_exists(service, index_id, n)
        ]
        if missing:
            remote.upload_index_files(service, index_id, index_dir, missing)
    return names
