"""gRPC front-end: exposes the Handlers over the LuceneServer service
(counterpart: nrtsearch_tpu/server/grpc_server.py).

Reference: server/grpc/NrtsearchServer.java:160 (server bootstrap) and the
LuceneServerImpl per-RPC delegates (:490-731). Implemented with grpc generic
method handlers; method routing, error -> status mapping, and the streaming
ingest live here.

The port's node keeps its index tensors on one device: ``NrtsearchServer(...,
device="cuda")`` by default, ``--device cpu`` on the command line only when
the caller asks (tests do). Asking for CUDA without a card fails at startup
(``device.resolve_device``); the server never moves to the CPU on its own.
The reference's XLA compile cache and its JAX platform pin have no
counterpart: the port's kernels build once per process (``kernels``).

A ``NotImplementedError`` from the engine answers ``UNIMPLEMENTED``, never
``INTERNAL``.
"""

from __future__ import annotations

import logging
import time
from concurrent import futures
from typing import Callable, Optional

import grpc
import torch
from google.protobuf import any_pb2

from nrtsearch_tpu_torch.config import NrtsearchConfig
from nrtsearch_tpu_torch.device import resolve_device
from nrtsearch_tpu_torch.gen import pb
from nrtsearch_tpu_torch.server.handlers import Handlers
from nrtsearch_tpu_torch.state.backend import LocalStateBackend
from nrtsearch_tpu_torch.state.global_state import GlobalState

log = logging.getLogger("nrtsearch_tpu_torch.server")

_STATUS_MAP = {
    KeyError: grpc.StatusCode.NOT_FOUND,
    FileExistsError: grpc.StatusCode.ALREADY_EXISTS,
    FileNotFoundError: grpc.StatusCode.NOT_FOUND,
    ValueError: grpc.StatusCode.INVALID_ARGUMENT,
    PermissionError: grpc.StatusCode.FAILED_PRECONDITION,
    RuntimeError: grpc.StatusCode.FAILED_PRECONDITION,
    NotImplementedError: grpc.StatusCode.UNIMPLEMENTED,
}

def _status_of(e: Exception) -> tuple[grpc.StatusCode, str]:
    """The status and details a failed RPC answers with."""
    code = _STATUS_MAP.get(type(e))
    if code is not None:
        return code, f"{type(e).__name__}: {e}"
    return grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"


def _check_deadline(context) -> None:
    """DeadlineUtils.checkDeadline equivalent (DeadlineUtils.java:48)."""
    remaining = context.time_remaining()
    if remaining is not None and remaining <= 0:
        context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "deadline exceeded")


def _wrap(fn: Callable, metrics=None):
    """One RPC: call ``fn`` with the request (or the request stream) and map
    a failure to its status (Handler.java:83)."""

    def call(request, context):
        t0 = time.perf_counter()
        try:
            _check_deadline(context)
            resp = fn(request)
            if metrics is not None:
                metrics.observe_rpc(fn.__name__, time.perf_counter() - t0)
            return resp
        except Exception as e:
            code, detail = _status_of(e)
            if metrics is not None:
                metrics.observe_rpc(fn.__name__, time.perf_counter() - t0, code.name)
            if code == grpc.StatusCode.INTERNAL:
                log.exception("rpc %s failed", fn.__name__)
            else:
                log.warning("rpc %s failed: %s", fn.__name__, detail)
            context.abort(code, detail)

    return call


# RPC name -> (request type, response type, kind)
_LUCENE_RPCS = {
    "createIndex": (pb.CreateIndexRequest, pb.CreateIndexResponse, "unary"),
    "deleteIndex": (pb.DeleteIndexRequest, pb.DeleteIndexResponse, "unary"),
    "liveSettings": (pb.LiveSettingsRequest, pb.LiveSettingsResponse, "unary"),
    "liveSettingsV2": (pb.LiveSettingsV2Request, pb.LiveSettingsV2Response, "unary"),
    "settings": (pb.SettingsRequest, pb.SettingsResponse, "unary"),
    "settingsV2": (pb.SettingsV2Request, pb.SettingsV2Response, "unary"),
    "registerFields": (pb.FieldDefRequest, pb.FieldDefResponse, "unary"),
    "updateFields": (pb.FieldDefRequest, pb.FieldDefResponse, "unary"),
    "startIndex": (pb.StartIndexRequest, pb.StartIndexResponse, "unary"),
    "startIndexV2": (pb.StartIndexV2Request, pb.StartIndexResponse, "unary"),
    "stopIndex": (pb.StopIndexRequest, pb.DummyResponse, "unary"),
    "reloadState": (pb.ReloadStateRequest, pb.ReloadStateResponse, "unary"),
    "searchV2": (pb.SearchRequest, any_pb2.Any, "unary"),
    "nodeInfo": (pb.NodeInfoRequest, pb.NodeInfoResponse, "unary"),
    "globalState": (pb.GlobalStateRequest, pb.GlobalStateResponse, "unary"),
    "state": (pb.StateRequest, pb.StateResponse, "unary"),
    "indexState": (pb.IndexStateRequest, pb.IndexStateResponse, "unary"),
    "forceMergeDeletes": (
        pb.ForceMergeDeletesRequest, pb.ForceMergeDeletesResponse, "unary",
    ),
    "addDocuments": (pb.AddDocumentRequest, pb.AddDocumentResponse, "stream_unary"),
    "refresh": (pb.RefreshRequest, pb.RefreshResponse, "unary"),
    "commit": (pb.CommitRequest, pb.CommitResponse, "unary"),
    "delete": (pb.AddDocumentRequest, pb.AddDocumentResponse, "unary"),
    "deleteByQuery": (pb.DeleteByQueryRequest, pb.AddDocumentResponse, "unary"),
    "deleteAll": (pb.DeleteAllDocumentsRequest, pb.DeleteAllDocumentsResponse, "unary"),
    "search": (pb.SearchRequest, pb.SearchResponse, "unary"),
    "stats": (pb.StatsRequest, pb.StatsResponse, "unary"),
    "indices": (pb.IndicesRequest, pb.IndicesResponse, "unary"),
    "status": (pb.HealthCheckRequest, pb.HealthCheckResponse, "unary"),
    "ready": (pb.ReadyCheckRequest, pb.HealthCheckResponse, "unary"),
    "forceMerge": (pb.ForceMergeRequest, pb.ForceMergeResponse, "unary"),
    "metrics": (pb.Empty, pb.HttpBody, "unary"),
    "custom": (pb.CustomRequest, pb.CustomResponse, "unary"),
    "createSnapshot": (pb.CreateSnapshotRequest, pb.CreateSnapshotResponse, "unary"),
    "releaseSnapshot": (pb.ReleaseSnapshotRequest, pb.ReleaseSnapshotResponse, "unary"),
    "getAllSnapshotIndexGen": (
        pb.GetAllSnapshotGenRequest, pb.GetAllSnapshotGenResponse, "unary",
    ),
    "backupWarmingQueries": (
        pb.BackupWarmingQueriesRequest, pb.BackupWarmingQueriesResponse, "unary",
    ),
}


def _named(fn: Callable, name: str) -> Callable:
    fn.__name__ = name
    return fn


def make_lucene_service(handlers: Handlers, metrics=None) -> grpc.GenericRpcHandler:
    """The LuceneServer service over ``handlers``."""
    fns = {name: getattr(handlers, name, None) for name in _LUCENE_RPCS}
    # `delete` takes a single AddDocumentRequest in the reference
    fns["delete"] = _named(lambda req: handlers.delete([req]), "delete")
    method_handlers = {}
    for name, (req_t, resp_t, kind) in _LUCENE_RPCS.items():
        fn = fns[name]
        if fn is None:
            continue
        make = (grpc.unary_unary_rpc_method_handler if kind == "unary"
                else grpc.stream_unary_rpc_method_handler)
        method_handlers[name] = make(
            _wrap(fn, metrics),
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    return grpc.method_handlers_generic_handler(
        "luceneserver.LuceneServer", method_handlers
    )


class NrtsearchServer:
    """Server bootstrap (NrtsearchServer.java:160 equivalent) whose indexes
    live on ``device``."""

    def __init__(self, config: Optional[NrtsearchConfig] = None,
                 global_state: Optional[GlobalState] = None,
                 device: str | torch.device = "cuda"):
        self.config = config or NrtsearchConfig()
        self.device = resolve_device(device)
        if global_state is None:
            remote = self._make_remote_backend(self.config)
            if remote is not None and str(
                self.config.raw.get("stateConfig", {}).get("backendType", "LOCAL")
            ).upper() == "REMOTE":
                from nrtsearch_tpu_torch.state.backend import RemoteStateBackend

                backend = RemoteStateBackend(remote, self.config.service_name)
            else:
                backend = LocalStateBackend(self.config.state_dir)
            global_state = GlobalState(self.config, backend, remote=remote,
                                       device=self.device)
        self.global_state = global_state
        from nrtsearch_tpu_torch.server.monitoring import Metrics
        from nrtsearch_tpu_torch.server.plugins import PluginRegistry, load_plugins

        self.metrics = Metrics(global_state)
        self.plugins = PluginRegistry()
        load_plugins(self.config.plugins, self.plugins,
                     remote=getattr(global_state, "remote", None),
                     service=self.config.service_name)
        for ingestor in self.plugins.ingestors:
            ingestor.initialize(global_state)
        self.handlers = Handlers(global_state, self.metrics, self.plugins)
        self.server: Optional[grpc.Server] = None
        self.port: Optional[int] = None
        self.replication_server: Optional[grpc.Server] = None
        self.replication_port: Optional[int] = None
        from nrtsearch_tpu_torch.server.replication import ReplicationService

        self.replication_service = ReplicationService(global_state)
        global_state.on_nrt_point = self.replication_service.notify_replicas
        global_state.connect_replica = self._connect_replica

    @staticmethod
    def _make_remote_backend(config: NrtsearchConfig):
        """Build the object-store backend from config: bucketName selects the
        real S3 client (remote/s3.py, SigV4 over http.client — boto3 is not
        available here); a ``remoteRoot`` path selects the filesystem double.
        Returns None when no remote storage is configured (pure-local node)."""
        if config.bucket_name:
            from nrtsearch_tpu_torch.remote.s3 import S3Backend

            return S3Backend.from_config(config)
        remote_root = config.raw.get("remoteRoot", "")
        if remote_root:
            from nrtsearch_tpu_torch.remote.backend import LocalFileBackend

            return LocalFileBackend(remote_root)
        return None

    def _connect_replica(self, index_name, rt, primary_address) -> None:
        self.replication_service.connect_to_primary(
            index_name, rt, primary_address,
            self.config.host_name, self.replication_port or 0,
        )

    def start(self, port: Optional[int] = None) -> int:
        self.server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=self.config.thread_pools.grpc_threads
            ),
            options=[
                ("grpc.max_send_message_length", 1024 * 1024 * 1024),
                ("grpc.max_receive_message_length", 1024 * 1024 * 1024),
            ],
        )
        self.server.add_generic_rpc_handlers(
            [make_lucene_service(self.handlers, self.metrics)]
        )
        bind_port = port if port is not None else self.config.port
        self.port = self.server.add_insecure_port(f"[::]:{bind_port}")

        # replication server starts before the main server, like the reference
        # (NrtsearchServer.start:171-196)
        from nrtsearch_tpu_torch.server.replication import make_replication_service

        compression = {
            "gzip": grpc.Compression.Gzip,
            "deflate": grpc.Compression.Deflate,
        }.get(str(self.config.get("compressionType", "")).lower())
        self.replication_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4),
            options=[("grpc.max_send_message_length", 1024 * 1024 * 1024)],
            compression=compression,
        )
        self.replication_server.add_generic_rpc_handlers(
            [make_replication_service(self.replication_service)]
        )
        self.replication_port = self.replication_server.add_insecure_port(
            f"[::]:{self.config.replication_port if port is None else 0}"
        )
        self.replication_server.start()

        self.global_state.warm_boot()
        for ingestor in self.plugins.ingestors:
            ingestor.start()
        self.server.start()
        dev = self.device
        log.info(
            "LuceneServer on %s, ReplicationServer on %s, indexes on %s",
            self.port, self.replication_port,
            f"{dev} ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else dev,
        )
        return self.port

    def stop(self, grace: float = 2.0) -> None:
        for ingestor in self.plugins.ingestors:
            try:
                ingestor.stop()
            except Exception:
                log.exception("ingestor stop failed")
        if self.server is not None:
            self.server.stop(grace)
        if self.replication_server is not None:
            self.replication_server.stop(grace)
        if self.handlers.batcher is not None:
            self.handlers.batcher.stop()
        self.global_state.close()

    def wait(self) -> None:
        if self.server is not None:
            self.server.wait_for_termination()


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="nrtsearch_tpu_torch server")
    parser.add_argument("config", nargs="?", help="YAML config file")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="where the index tensors live: cuda (default; fails without a card) "
             "or cpu",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = NrtsearchConfig.load(args.config)
    server = NrtsearchServer(config, device=args.device)
    server.start(args.port)
    server.wait()


if __name__ == "__main__":
    main()
