"""Copy of ``nrtsearch_tpu/cli.py``, kept whole, its imports pointed at the
port.

nrtsearch_client CLI: one subcommand per RPC.

Reference: tools/cli (picocli ``nrtsearch_client`` with ~30 subcommands —
SearchCommand, AddDocumentsCommand with CSV/JSON streaming, StartIndexV2Command,
...). CSV ingestion uses ';' as the multi-value separator, matching the
reference's CSV format (docker-compose-config/docs.csv).

Usage: python -m nrtsearch_tpu_torch.cli --host localhost --port 8000 <command> ...
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from typing import Iterable

from google.protobuf.json_format import MessageToJson, Parse

from nrtsearch_tpu_torch.client import NrtsearchClient
from nrtsearch_tpu_torch.gen import pb


def _print(msg) -> None:
    print(MessageToJson(msg, indent=1))


def cmd_create_index(client, args) -> None:
    _print(client.create_index(args.indexName))


def cmd_delete_index(client, args) -> None:
    _print(client.delete_index(args.indexName))


def cmd_register_fields(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.FieldDefRequest())
    if args.indexName:
        req.indexName = args.indexName
    _print(client.register_fields(req))


def cmd_settings(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.SettingsV2Request()) if args.fileName \
        else pb.SettingsV2Request(indexName=args.indexName)
    if args.indexName:
        req.indexName = args.indexName
    _print(client.settings_v2(req))


def cmd_live_settings(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.LiveSettingsV2Request()) if args.fileName \
        else pb.LiveSettingsV2Request(indexName=args.indexName)
    if args.indexName:
        req.indexName = args.indexName
    _print(client.live_settings_v2(req))


def cmd_start_index(client, args) -> None:
    if args.fileName:
        req = Parse(open(args.fileName).read(), pb.StartIndexRequest())
        if args.indexName:
            req.indexName = args.indexName
    else:
        req = pb.StartIndexRequest(
            indexName=args.indexName, mode=pb.Mode.Value(args.mode),
            primaryAddress=args.primaryAddress or "",
        )
    _print(client.start_index(req))


def cmd_stop_index(client, args) -> None:
    _print(client.stop_index(args.indexName))


def _csv_documents(index_name: str, path: str) -> Iterable[pb.AddDocumentRequest]:
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            req = pb.AddDocumentRequest(indexName=index_name)
            for key, value in row.items():
                if value is None or value == "":
                    continue
                for v in value.split(";"):
                    req.fields[key].value.append(v)
            yield req


def _json_documents(index_name: str, path: str) -> Iterable[pb.AddDocumentRequest]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            req = pb.AddDocumentRequest(indexName=index_name)
            for key, value in doc.items():
                values = value if isinstance(value, list) else [value]
                for v in values:
                    req.fields[key].value.append(
                        json.dumps(v) if isinstance(v, (dict, list)) else str(v)
                    )
            yield req


def cmd_add_documents(client, args) -> None:
    gen = _csv_documents if args.fileType == "csv" else _json_documents
    _print(client.add_documents(gen(args.indexName, args.fileName)))


def cmd_search(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.SearchRequest())
    if args.indexName:
        req.indexName = args.indexName
    _print(client.search(req))


def cmd_delete(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.AddDocumentRequest())
    _print(client.delete(req))


def cmd_delete_by_query(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.DeleteByQueryRequest())
    _print(client.delete_by_query(req))


def cmd_delete_all(client, args) -> None:
    _print(client.delete_all(args.indexName))


def cmd_refresh(client, args) -> None:
    _print(client.refresh(args.indexName))


def cmd_commit(client, args) -> None:
    _print(client.commit(args.indexName))


def cmd_stats(client, args) -> None:
    _print(client.stats(args.indexName))


def cmd_indices(client, args) -> None:
    _print(client.indices())


def cmd_status(client, args) -> None:
    _print(client.status())


def cmd_ready(client, args) -> None:
    _print(client.ready(args.indexNames or ""))


def cmd_force_merge(client, args) -> None:
    _print(client.force_merge(args.indexName, args.maxSegments))


def cmd_write_nrt_point(client, args) -> None:
    from nrtsearch_tpu_torch.server.replication import ReplicationClient

    rc = ReplicationClient(f"{args.host}:{args.replicationPort}")
    try:
        _print(rc.write_nrt_point(args.indexName))
    finally:
        rc.close()


def cmd_get_nodes(client, args) -> None:
    from nrtsearch_tpu_torch.server.replication import ReplicationClient

    rc = ReplicationClient(f"{args.host}:{args.replicationPort}")
    try:
        _print(rc.get_nodes_info(args.indexName))
    finally:
        rc.close()


def cmd_update_fields(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.FieldDefRequest())
    if args.indexName:
        req.indexName = args.indexName
    _print(client.update_fields(req))


def cmd_settings_v1(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.SettingsRequest()) if args.fileName \
        else pb.SettingsRequest(indexName=args.indexName)
    if args.indexName:
        req.indexName = args.indexName
    _print(client.settings(req))


def cmd_live_settings_v1(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.LiveSettingsRequest()) if args.fileName \
        else pb.LiveSettingsRequest(indexName=args.indexName)
    if args.indexName:
        req.indexName = args.indexName
    _print(client.live_settings(req))


def cmd_start_index_v2(client, args) -> None:
    _print(client.start_index_v2(args.indexName))


def cmd_reload_state(client, args) -> None:
    _print(client.reload_state())


def cmd_search_v2(client, args) -> None:
    req = Parse(open(args.fileName).read(), pb.SearchRequest())
    if args.indexName:
        req.indexName = args.indexName
    _print(client.search_v2(req))


def cmd_node_info(client, args) -> None:
    _print(client.node_info())


def cmd_global_state(client, args) -> None:
    _print(client.global_state())


def cmd_state(client, args) -> None:
    _print(client.state(args.indexName))


def cmd_index_state(client, args) -> None:
    _print(client.index_state(args.indexName))


def cmd_force_merge_deletes(client, args) -> None:
    _print(client.force_merge_deletes(args.indexName, do_wait=args.doWait))


def cmd_create_snapshot(client, args) -> None:
    _print(client.create_snapshot(args.indexName))


def cmd_release_snapshot(client, args) -> None:
    _print(client.release_snapshot(args.indexName, args.indexGen))


def cmd_get_all_snapshot_gens(client, args) -> None:
    _print(client.get_all_snapshot_gens(args.indexName))


def cmd_backup_warming_queries(client, args) -> None:
    _print(client.backup_warming_queries(args.indexName))


def cmd_custom(client, args) -> None:
    req = pb.CustomRequest(id=args.id, path=args.path)
    _print(client.custom(req))


def cmd_metrics(client, args) -> None:
    """Prometheus exposition text (reference: MetricsCommand.java)."""
    sys.stdout.write(client.metrics().data.decode())


def cmd_current_searcher_version(client, args) -> None:
    """Replica's current searching version (GetCurrentSearcherVersion.java);
    talks to the REPLICATION port."""
    import grpc as _grpc

    target = f"{args.host}:{args.replicationPort}"
    with _grpc.insecure_channel(target) as ch:
        call = ch.unary_unary(
            "/luceneserver.ReplicationServer/getCurrentSearcherVersion",
            request_serializer=pb.IndexName.SerializeToString,
            response_deserializer=pb.SearcherVersion.FromString,
        )
        _print(call(pb.IndexName(indexName=args.indexName)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nrtsearch_client")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=8000)
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, *flags):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        for flag, kw in flags:
            sp.add_argument(flag, **kw)
        return sp

    idx = ("--indexName", {"required": True})
    idx_opt = ("--indexName", {"default": ""})
    fname = ("--fileName", {"required": True})
    fname_opt = ("--fileName", {"default": ""})

    add("createIndex", cmd_create_index, idx)
    add("deleteIndex", cmd_delete_index, idx)
    add("registerFields", cmd_register_fields, fname, idx_opt)
    add("settings", cmd_settings, fname_opt, idx_opt)
    add("liveSettings", cmd_live_settings, fname_opt, idx_opt)
    add(
        "startIndex", cmd_start_index, idx_opt, fname_opt,
        ("--mode", {"default": "STANDALONE",
                    "choices": ["STANDALONE", "PRIMARY", "REPLICA"]}),
        ("--primaryAddress", {"default": ""}),
    )
    add("stopIndex", cmd_stop_index, idx)
    add(
        "addDocuments", cmd_add_documents, idx, fname,
        ("--fileType", {"default": "csv", "choices": ["csv", "json"]}),
    )
    add("search", cmd_search, fname, idx_opt)
    add("delete", cmd_delete, fname)
    add("deleteByQuery", cmd_delete_by_query, fname)
    add("deleteAllDocuments", cmd_delete_all, idx)
    add("refresh", cmd_refresh, idx)
    add("commit", cmd_commit, idx)
    add("stats", cmd_stats, idx)
    add("indices", cmd_indices)
    add("status", cmd_status)
    add("ready", cmd_ready, ("--indexNames", {"default": ""}))
    add("forceMerge", cmd_force_merge, idx, ("--maxSegments", {"type": int, "default": 1}))
    add("writeNRTPoint", cmd_write_nrt_point, idx,
        ("--replicationPort", {"type": int, "default": 8001}))
    add("getNodes", cmd_get_nodes, idx,
        ("--replicationPort", {"type": int, "default": 8001}))
    add("updateFields", cmd_update_fields, fname, idx_opt)
    add("settingsV1", cmd_settings_v1, fname_opt, idx_opt)
    add("liveSettingsV1", cmd_live_settings_v1, fname_opt, idx_opt)
    add("startIndexV2", cmd_start_index_v2, idx)
    add("reloadState", cmd_reload_state)
    add("searchV2", cmd_search_v2, fname, idx_opt)
    add("nodeInfo", cmd_node_info)
    add("globalState", cmd_global_state)
    add("state", cmd_state, idx)
    add("indexState", cmd_index_state, idx)
    add("forceMergeDeletes", cmd_force_merge_deletes, idx,
        ("--doWait", {"action": "store_true"}))
    add("createSnapshot", cmd_create_snapshot, idx)
    add("releaseSnapshot", cmd_release_snapshot, idx,
        ("--indexGen", {"type": int, "required": True}))
    add("getAllSnapshotIndexGen", cmd_get_all_snapshot_gens, idx)
    add("backupWarmingQueries", cmd_backup_warming_queries, idx)
    add("custom", cmd_custom, ("--id", {"required": True}),
        ("--path", {"default": ""}))
    add("metrics", cmd_metrics)
    add("currentSearcherVersion", cmd_current_searcher_version, idx,
        ("--replicationPort", {"type": int, "default": 8001}))
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with NrtsearchClient(f"{args.host}:{args.port}") as client:
        try:
            args.fn(client, args)
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
