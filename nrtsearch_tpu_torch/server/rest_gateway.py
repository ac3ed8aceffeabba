"""Copy of ``nrtsearch_tpu/server/rest_gateway.py``, kept whole, its imports
pointed at the port.

REST gateway: HTTP/JSON -> gRPC proxy.

Reference: grpc-gateway generated Go reverse proxy + http_wrapper.go (~60 LoC)
exposing the gRPC API as REST with proto-JSON bodies. Same idea here as a
thin threaded HTTP server: POST /v1/<rpc> with a proto-JSON body (or GET for
parameterless RPCs) forwards to the local gRPC server.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from google.protobuf.json_format import MessageToJson, Parse, ParseError

from nrtsearch_tpu_torch.client import NrtsearchClient
from nrtsearch_tpu_torch.gen import pb

log = logging.getLogger("nrtsearch_tpu.rest")

# path -> (request type, client method, http methods)
_ROUTES = {
    "createIndex": (pb.CreateIndexRequest, "create_index_raw", ("POST",)),
    "registerFields": (pb.FieldDefRequest, "register_fields", ("POST",)),
    "startIndex": (pb.StartIndexRequest, "start_index", ("POST",)),
    "stopIndex": (pb.StopIndexRequest, "stop_index_raw", ("POST",)),
    "addDocuments": (pb.AddDocumentRequest, None, ("POST",)),  # special: list body
    "refresh": (pb.RefreshRequest, "refresh_raw", ("POST",)),
    "commit": (pb.CommitRequest, "commit_raw", ("POST",)),
    "search": (pb.SearchRequest, "search", ("POST",)),
    "deleteByQuery": (pb.DeleteByQueryRequest, "delete_by_query", ("POST",)),
    "delete": (pb.AddDocumentRequest, "delete", ("POST",)),
    "deleteAll": (pb.DeleteAllDocumentsRequest, "delete_all_raw", ("POST",)),
    "liveSettingsV2": (pb.LiveSettingsV2Request, "live_settings_v2", ("POST",)),
    "settingsV2": (pb.SettingsV2Request, "settings_v2", ("POST",)),
    "forceMerge": (pb.ForceMergeRequest, "force_merge_raw", ("POST",)),
    "stats": (pb.StatsRequest, "stats_raw", ("POST", "GET")),
    "indices": (pb.IndicesRequest, "indices", ("GET", "POST")),
    "status": (pb.HealthCheckRequest, "status", ("GET", "POST")),
    "metrics": (pb.Empty, "metrics", ("GET", "POST")),
    # round-2 surface (reference: grpc-gateway routes for the same RPCs)
    "updateFields": (pb.FieldDefRequest, "update_fields", ("POST",)),
    "settings": (pb.SettingsRequest, "settings", ("POST",)),
    "liveSettings": (pb.LiveSettingsRequest, "live_settings", ("POST",)),
    "startIndexV2": (pb.StartIndexV2Request, "start_index_v2_raw", ("POST",)),
    "reloadState": (pb.ReloadStateRequest, "reload_state_raw", ("POST",)),
    "searchV2": (pb.SearchRequest, "search_v2", ("POST",)),
    "nodeInfo": (pb.NodeInfoRequest, "node_info_raw", ("GET", "POST")),
    "globalState": (pb.GlobalStateRequest, "global_state_raw", ("GET", "POST")),
    "state": (pb.StateRequest, "state_raw", ("POST", "GET")),
    "indexState": (pb.IndexStateRequest, "index_state_raw", ("POST", "GET")),
    "forceMergeDeletes": (
        pb.ForceMergeDeletesRequest, "force_merge_deletes_raw", ("POST",),
    ),
}


class _RawAdapters:
    """Adapters from raw pb requests to the typed client methods."""

    def __init__(self, client: NrtsearchClient):
        self.c = client

    def create_index_raw(self, req):
        return self.c.create_index(req.indexName)

    def stop_index_raw(self, req):
        return self.c.stop_index(req.indexName)

    def refresh_raw(self, req):
        return self.c.refresh(req.indexName)

    def force_merge_raw(self, req):
        return self.c.force_merge(req.indexName, max(req.maxNumSegments, 1))

    def commit_raw(self, req):
        return self.c.commit(req.indexName)

    def delete_all_raw(self, req):
        return self.c.delete_all(req.indexName)

    def stats_raw(self, req):
        return self.c.stats(req.indexName)

    def status(self, req):
        return self.c.status()

    def indices(self, req):
        return self.c.indices()

    def metrics(self, req):
        return self.c.metrics()

    def start_index_v2_raw(self, req):
        return self.c.start_index_v2(req.indexName)

    def reload_state_raw(self, req):
        return self.c.reload_state()

    def node_info_raw(self, req):
        return self.c.node_info()

    def global_state_raw(self, req):
        return self.c.global_state()

    def state_raw(self, req):
        return self.c.state(req.indexName)

    def index_state_raw(self, req):
        return self.c.index_state(req.index_name)

    def force_merge_deletes_raw(self, req):
        return self.c.force_merge_deletes(req.indexName, req.doWait)

    def __getattr__(self, name):
        return getattr(self.c, name)


class RestGateway:
    def __init__(self, grpc_target: str, port: int = 0):
        self.client = NrtsearchClient(grpc_target)
        self.adapters = _RawAdapters(self.client)
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def _respond(self, code: int, body: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _handle(self, method: str) -> None:
                path = self.path.strip("/").split("/")
                if len(path) != 2 or path[0] != "v1" or path[1] not in _ROUTES:
                    self._respond(404, json.dumps({"error": "unknown route"}))
                    return
                req_t, client_method, methods = _ROUTES[path[1]]
                if method not in methods:
                    self._respond(405, json.dumps({"error": "method not allowed"}))
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length).decode() if length else "{}"
                try:
                    if path[1] == "addDocuments":
                        docs = json.loads(body)
                        if isinstance(docs, dict):
                            docs = [docs]
                        reqs = [Parse(json.dumps(d), pb.AddDocumentRequest())
                                for d in docs]
                        resp = gateway.client.add_documents(reqs)
                    else:
                        req = Parse(body, req_t())
                        resp = getattr(gateway.adapters, client_method)(req)
                    self._respond(200, MessageToJson(resp, indent=1))
                except ParseError as e:
                    self._respond(400, json.dumps({"error": str(e)}))
                except Exception as e:
                    code = getattr(e, "code", lambda: None)()
                    http = {"NOT_FOUND": 404, "ALREADY_EXISTS": 409,
                            "INVALID_ARGUMENT": 400,
                            "FAILED_PRECONDITION": 412}.get(
                        code.name if code else "", 500
                    )
                    self._respond(http, json.dumps({"error": str(e)}))

            def do_POST(self):
                self._handle("POST")

            def do_GET(self):
                self._handle("GET")

        self.server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()
        log.info("REST gateway on %s", self.port)
        return self.port

    def stop(self) -> None:
        self.server.shutdown()
        self.client.close()


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="nrtsearch_tpu REST gateway")
    p.add_argument("--grpc", default="localhost:8000")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    gw = RestGateway(args.grpc, args.port)
    gw.start()
    try:
        gw._thread.join()
    except KeyboardInterrupt:
        gw.stop()


if __name__ == "__main__":
    main()
