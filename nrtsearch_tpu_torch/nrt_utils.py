"""Copy of ``nrtsearch_tpu/nrt_utils.py``, kept whole, its imports pointed at
the port.

nrt_utils: object-store-side ops tooling.

Reference: tools/nrt_utils (picocli, NrtUtilsCommand.java:39-57 —
cleanupData, cleanupSnapshots, getRemoteState, getResourceVersion,
listResourceVersions, listSnapshots, putRemoteState, restore (including
restore into a DIFFERENT service/index), setResourceVersion, snapshot,
updateGlobalIndexState). These commands operate purely against the object
store with no server running, over EITHER store backend:

    --root /path/to/store                      local filesystem store
    --bucket B [--region R] [--endpoint URL]   S3 (SigV4, remote/s3.py)

The reference's legacy/incremental commands migrate a pre-1.0 Lucene backup
format; this engine has no legacy format, so they are omitted by design.

Usage: python -m nrtsearch_tpu_torch.nrt_utils [--root DIR | --bucket B] <cmd> ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from nrtsearch_tpu_torch.nrt.point_state import NrtPointState
from nrtsearch_tpu_torch.remote.backend import LocalFileBackend


def _load_point(remote, service: str, index_id: str) -> NrtPointState:
    data = remote.download_current(service, NrtPointState.resource(index_id))
    if data is None:
        raise SystemExit(f"no point state for {index_id}")
    return NrtPointState.from_json(data)


def _snap_res(index_id: str, snap_id: str) -> str:
    return f"{index_id}/snapshots/{snap_id}"


def cmd_snapshot(remote, args) -> None:
    """Pin the current point under snapshots/<id> (reference:
    backup/SnapshotCommand — a metadata-only S3-side snapshot; data files
    are immutable and shared). The blob carries a ``snapshotTsSec`` creation
    timestamp so cleanupSnapshots' age guard works for custom snapshot ids
    too (NrtPointState.from_json ignores the extra key)."""
    point = _load_point(remote, args.serviceName, args.indexId)
    now = int(time.time())
    ts = args.snapshotId or str(now)
    blob = json.loads(point.to_json())
    blob["snapshotTsSec"] = now
    remote.upload_versioned(
        args.serviceName, _snap_res(args.indexId, ts),
        json.dumps(blob).encode(),
    )
    print(json.dumps({"snapshotId": ts, "version": point.version,
                      "files": len(point.files)}))


def cmd_restore(remote, args) -> None:
    """Make a snapshot the current point — optionally into a DIFFERENT
    service/index (reference: backup/RestoreCommand --restoreServiceName /
    --restoreIndexId, RestoreCommand.java:60-75): the point state AND every
    referenced data file are copied into the destination tree."""
    data = remote.download_current(
        args.serviceName, _snap_res(args.indexId, args.snapshotId)
    )
    if data is None:
        raise SystemExit(f"no snapshot {args.snapshotId}")
    point = NrtPointState.from_json(data)
    missing = [
        f for f in point.files
        if not remote.index_file_exists(args.serviceName, args.indexId, f)
    ]
    if missing:
        raise SystemExit(f"snapshot incomplete; missing files: {missing}")
    dst_service = args.restoreServiceName or args.serviceName
    dst_index = args.restoreIndexId or args.indexId
    copied = 0
    if (dst_service, dst_index) != (args.serviceName, args.indexId):
        import shutil
        import tempfile

        with tempfile.TemporaryDirectory(prefix="nrt_restore_") as tmp:
            for name in point.files:
                remote.download_index_files(
                    args.serviceName, args.indexId, tmp, [name]
                )
                remote.upload_index_files(dst_service, dst_index, tmp, [name])
                copied += 1
    remote.upload_versioned(
        dst_service, NrtPointState.resource(dst_index), data
    )
    print(json.dumps({
        "restored": args.snapshotId, "version": point.version,
        "service": dst_service, "indexId": dst_index, "filesCopied": copied,
    }))


def cmd_list_snapshots(remote, args) -> None:
    """Reference: backup/ListSnapshotsCommand."""
    out = []
    for res in remote.list_resources(
        args.serviceName, f"{args.indexId}/snapshots/"
    ):
        data = remote.download_current(args.serviceName, res)
        if data:
            point = NrtPointState.from_json(data)
            out.append({
                "snapshotId": res.rsplit("/", 1)[-1],
                "version": point.version, "gen": point.gen,
                "files": len(point.files),
            })
    print(json.dumps(out, indent=1))


def cmd_cleanup_snapshots(remote, args) -> None:
    """Delete snapshots older than --minAgeSec, keeping the newest --keep
    (reference: backup/CleanupSnapshotsCommand). Age comes from the
    ``snapshotTsSec`` recorded in the snapshot blob; numeric-named snapshots
    written before that field existed fall back to parsing the id. Snapshots
    whose age is UNKNOWN are protected whenever --minAgeSec is set."""
    snaps = []
    for res in remote.list_resources(
        args.serviceName, f"{args.indexId}/snapshots/"
    ):
        sid = res.rsplit("/", 1)[-1]
        ts = 0
        data = remote.download_current(args.serviceName, res)
        if data:
            try:
                ts = int(json.loads(data).get("snapshotTsSec", 0))
            except (ValueError, AttributeError):
                ts = 0
        if not ts and sid.isdigit():
            ts = int(sid)
        snaps.append((ts, sid, res))
    snaps.sort(reverse=True)
    now = int(time.time())
    removed = []
    for rank, (ts, sid, res) in enumerate(snaps):
        if rank < max(args.keep, 0):
            continue
        if args.minAgeSec and (not ts or now - ts < args.minAgeSec):
            continue
        if not args.dryRun:
            # tombstone: point the resource at an empty marker (object
            # stores have no atomic delete-of-versioned-tree; the data
            # cleanup pass drops unreferenced files afterwards)
            remote.upload_versioned(args.serviceName, res, b"")
        removed.append(sid)
    print(json.dumps({"removed": removed, "dryRun": bool(args.dryRun)}))


def _referenced_files(remote, service: str, index_id: str) -> set:
    keep: set[str] = set()
    try:
        keep.update(_load_point(remote, service, index_id).files)
    except SystemExit:
        pass
    for res in remote.list_resources(service, f"{index_id}/snapshots/"):
        data = remote.download_current(service, res)
        if data:
            keep.update(NrtPointState.from_json(data).files)
    return keep


def cmd_cleanup(remote, args) -> None:
    """Delete data files not referenced by the current point or any live
    snapshot (reference: cleanup/CleanupDataCommand, which requires
    --deleteAfter/--gracePeriod for exactly this race): a live primary
    uploads a new point's data files BEFORE publishing its point state, so
    an unprotected sweep can delete files of an in-flight publish. Files
    whose store upload time is within --gracePeriodSec (default 2h) are
    kept; files with an UNKNOWN upload time are kept too unless
    --gracePeriodSec=0 explicitly disables the guard."""
    keep = _referenced_files(remote, args.serviceName, args.indexId)
    now = time.time()
    removed, in_grace = [], []
    for name in remote.list_index_files(args.serviceName, args.indexId):
        if name in keep:
            continue
        if args.gracePeriodSec > 0:
            mtime = remote.index_file_mtime(
                args.serviceName, args.indexId, name
            )
            if mtime is None or now - mtime < args.gracePeriodSec:
                in_grace.append(name)
                continue
        if not args.dryRun:
            remote.delete_index_files(args.serviceName, args.indexId, [name])
        removed.append(name)
    print(json.dumps({"removed": removed, "kept": len(keep),
                      "inGracePeriod": in_grace,
                      "dryRun": bool(args.dryRun)}))


def cmd_current_state(remote, args) -> None:
    point = _load_point(remote, args.serviceName, args.indexId)
    print(point.to_json())


def cmd_get_remote_state(remote, args) -> None:
    """Download any state resource's current blob (reference:
    state/GetRemoteStateCommand)."""
    data = remote.download_current(args.serviceName, args.resourceName)
    if data is None:
        raise SystemExit(f"no resource {args.resourceName}")
    sys.stdout.write(data.decode("utf-8", "replace"))


def cmd_put_remote_state(remote, args) -> None:
    """Upload a new version of a state resource from a file (reference:
    state/PutRemoteStateCommand)."""
    from pathlib import Path

    data = Path(args.stateFile).read_bytes()
    v = remote.upload_versioned(args.serviceName, args.resourceName, data)
    print(json.dumps({"resource": args.resourceName, "version": v}))


def cmd_get_resource_version(remote, args) -> None:
    """Reference: state/GetResourceVersionCommand."""
    v = remote.current_version(args.serviceName, args.resourceName)
    print(json.dumps({"resource": args.resourceName, "version": v}))


def cmd_set_resource_version(remote, args) -> None:
    """Re-point _current at an existing stored version (rollback — the
    reference's SetResourceVersionCommand)."""
    versions = remote.list_resource_versions(args.serviceName, args.resourceName)
    if args.version not in versions:
        raise SystemExit(
            f"version {args.version} not in stored versions {versions}"
        )
    cur = remote.current_version(args.serviceName, args.resourceName)
    # re-upload the requested blob as the newest version so the _current
    # pointer stays monotonic (readers cache monotonically)
    blob = _download_version(remote, args.serviceName, args.resourceName,
                             args.version)
    v = remote.upload_versioned(args.serviceName, args.resourceName, blob)
    print(json.dumps({"resource": args.resourceName, "restoredFrom":
                      args.version, "previousCurrent": cur, "version": v}))


def _download_version(remote, service, resource, version) -> bytes:
    """Fetch a specific stored version (both backends share the key layout)."""
    if hasattr(remote, "s3"):
        data = remote.s3.get_object(f"{service}/{resource}/_version/{version}")
        if data is None:
            raise SystemExit(f"missing version {version}")
        return data
    p = remote.root / service / resource / "_version" / str(version)
    if not p.exists():
        raise SystemExit(f"missing version {version}")
    return p.read_bytes()


def cmd_list_resource_versions(remote, args) -> None:
    """Reference: state/ListResourceVersions."""
    versions = remote.list_resource_versions(args.serviceName, args.resourceName)
    cur = remote.current_version(args.serviceName, args.resourceName)
    print(json.dumps({"resource": args.resourceName, "versions": versions,
                      "current": cur}))


def cmd_update_global_index_state(remote, args) -> None:
    """Update an index's id mapping in (or remove it from) the remote global
    state blob {"indices": {name: id}} (reference role:
    state/UpdateGlobalIndexStateCommand — this engine's remote global state
    carries the name->id registry; the started flag is node-local)."""
    data = remote.download_current(args.serviceName, "global_state")
    if data is None:
        raise SystemExit("no global state")
    state = json.loads(data)
    indices = state.setdefault("indices", {})
    if args.indexName not in indices and not args.setIndexId:
        raise SystemExit(f"index {args.indexName!r} not in global state "
                         f"({sorted(indices)})")
    if args.remove:
        indices.pop(args.indexName, None)
    elif args.setIndexId:
        indices[args.indexName] = args.setIndexId
    v = remote.upload_versioned(
        args.serviceName, "global_state", json.dumps(state).encode()
    )
    print(json.dumps({
        "indexName": args.indexName,
        "indexId": indices.get(args.indexName),
        "removed": bool(args.remove),
        "version": v,
    }))


def _make_backend(args):
    if args.bucket:
        from nrtsearch_tpu_torch.remote.s3 import S3Backend
        from nrtsearch_tpu_torch.remote.s3_client import S3Client

        client = S3Client(
            bucket=args.bucket, region=args.region,
            endpoint=args.endpoint or None,
        )
        return S3Backend(client)
    if not args.root:
        raise SystemExit("one of --root or --bucket is required")
    return LocalFileBackend(args.root)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nrt_utils")
    p.add_argument("--root", default="", help="local object store root")
    p.add_argument("--bucket", default="", help="S3 bucket (SigV4 backend)")
    p.add_argument("--region", default="us-east-1")
    p.add_argument("--endpoint", default="",
                   help="S3 endpoint override (e.g. http://localhost:9090)")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, *extra, index=True):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--serviceName", required=True)
        if index:
            sp.add_argument("--indexId", required=True)
        for flag, kw in extra:
            sp.add_argument(flag, **kw)

    add("snapshot", cmd_snapshot, ("--snapshotId", {"default": ""}))
    add("restore", cmd_restore,
        ("--snapshotId", {"required": True}),
        ("--restoreServiceName", {"default": ""}),
        ("--restoreIndexId", {"default": ""}))
    add("listSnapshots", cmd_list_snapshots)
    add("cleanupSnapshots", cmd_cleanup_snapshots,
        ("--minAgeSec", {"type": int, "default": 0}),
        ("--keep", {"type": int, "default": 1}),
        ("--dryRun", {"action": "store_true"}))
    add("currentState", cmd_current_state)
    add("cleanupData", cmd_cleanup,
        ("--dryRun", {"action": "store_true"}),
        ("--gracePeriodSec", {"type": int, "default": 7200}))
    # back-compat alias for the round-3 name
    add("cleanup", cmd_cleanup,
        ("--dryRun", {"action": "store_true"}),
        ("--gracePeriodSec", {"type": int, "default": 7200}))
    add("getRemoteState", cmd_get_remote_state,
        ("--resourceName", {"required": True}), index=False)
    add("putRemoteState", cmd_put_remote_state,
        ("--resourceName", {"required": True}),
        ("--stateFile", {"required": True}), index=False)
    add("getResourceVersion", cmd_get_resource_version,
        ("--resourceName", {"required": True}), index=False)
    add("setResourceVersion", cmd_set_resource_version,
        ("--resourceName", {"required": True}),
        ("--version", {"type": int, "required": True}), index=False)
    add("listResourceVersions", cmd_list_resource_versions,
        ("--resourceName", {"required": True}), index=False)
    add("updateGlobalIndexState", cmd_update_global_index_state,
        ("--indexName", {"required": True}),
        ("--setIndexId", {"default": ""}),
        ("--remove", {"action": "store_true"}), index=False)

    args = p.parse_args(argv)
    remote = _make_backend(args)
    try:
        args.fn(remote, args)
    except SystemExit:
        raise
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
