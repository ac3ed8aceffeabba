"""Copy of ``nrtsearch_tpu/server/handlers.py``, kept whole, its imports
pointed at the port, but for one line: a request-level virtual field reads
a segment's scores from the match arrays with ``.cpu()`` first (the port's
arrays are tensors on the index's device, which ``np.asarray`` refuses on
CUDA).

Request handlers: one method per RPC over protobuf messages.

Reference: server/handler/ (47 Handler subclasses; template at
Handler.java:83). Handlers validate, call into state/engine, and map errors
to gRPC status (done by the transport layer, server/grpc_server.py).
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
from google.protobuf.json_format import MessageToDict

from nrtsearch_tpu_torch.core.searcher import SortSpec
from nrtsearch_tpu_torch.query import plan as qp
from nrtsearch_tpu_torch.schema.fields import DocValueKind
from nrtsearch_tpu_torch.gen import pb
from nrtsearch_tpu_torch.query.plan import parse_query, validate_fields
from nrtsearch_tpu_torch.search import collectors as coll
from nrtsearch_tpu_torch.search.fetch import fill_hit_fields_pb
from nrtsearch_tpu_torch.state.global_state import GlobalState


class Handlers:
    def __init__(self, global_state: GlobalState, metrics=None, plugins=None):
        self.gs = global_state
        self.metrics_provider = metrics
        self.plugins = plugins
        self._warmers: dict[str, object] = {}
        self.batcher = None
        cfg = getattr(global_state, "config", None)
        if cfg is not None and getattr(cfg, "micro_batch_enabled", False):
            from nrtsearch_tpu_torch.server.batcher import SearchBatcher

            self.batcher = SearchBatcher(
                max_batch=getattr(cfg, "micro_batch_max", 64),
                window_ms=getattr(cfg, "micro_batch_window_ms", 1.0),
                metrics=metrics,
            )

    def _warmer(self, index_name: str):
        from nrtsearch_tpu_torch.server.warming import Warmer

        if index_name not in self._warmers:
            self._warmers[index_name] = Warmer(
                index_name, self.gs.config.max_warming_queries
            )
        return self._warmers[index_name]

    # -- admin -----------------------------------------------------------------

    def createIndex(self, req: pb.CreateIndexRequest) -> pb.CreateIndexResponse:
        info = self.gs.create_index(req.indexName, req.existsWithId)
        return pb.CreateIndexResponse(
            response=f"Created Index name: {req.indexName}, id: {info.index_id}"
        )

    def deleteIndex(self, req: pb.DeleteIndexRequest) -> pb.DeleteIndexResponse:
        self.gs.delete_index(req.indexName)
        return pb.DeleteIndexResponse(ok="ok")

    def registerFields(self, req: pb.FieldDefRequest) -> pb.FieldDefResponse:
        fields = {}
        for f in req.field:
            spec = MessageToDict(f, preserving_proto_field_name=False)
            spec.pop("name", None)
            fields[f.name] = spec
        info = self.gs.register_fields(req.indexName, fields)
        return pb.FieldDefResponse(response=info.to_json())

    def liveSettingsV2(self, req: pb.LiveSettingsV2Request) -> pb.LiveSettingsV2Response:
        info = self.gs.get_state(req.indexName)
        if req.HasField("liveSettings"):
            updates = MessageToDict(req.liveSettings)
            info = info.with_live_settings(updates)
            if not req.local:
                self.gs.update_state(req.indexName, info)
            rt = self.gs.runtimes.get(req.indexName)
            if rt is not None:
                # the runtime holds a state snapshot: swap it so readers of
                # live settings (search defaults, refresh ticker, searcher
                # pruning) see the update immediately
                rt.state_info = info
                rt.apply_live_settings(info.live_settings)
        resp = pb.LiveSettingsV2Response()
        _dict_to_pb(info.live_settings, resp.liveSettings)
        return resp

    def settingsV2(self, req: pb.SettingsV2Request) -> pb.SettingsV2Response:
        info = self.gs.get_state(req.indexName)
        if req.HasField("settings"):
            if req.indexName in self.gs.runtimes:
                raise RuntimeError("settings can only be changed on a stopped index")
            info = info.with_settings(MessageToDict(req.settings))
            self.gs.update_state(req.indexName, info)
        resp = pb.SettingsV2Response()
        _dict_to_pb(info.settings, resp.settings)
        return resp

    def liveSettings(self, req: pb.LiveSettingsRequest) -> pb.LiveSettingsResponse:
        """V1 flat live-settings surface (reference: LiveSettingsHandler).
        Zero-valued fields mean 'leave unchanged', per the reference's
        proto3-semantics handling."""
        import json as _json

        updates = {}
        for f, _v in req.ListFields():
            if f.name != "indexName":
                updates[f.name] = getattr(req, f.name)
        info = self.gs.get_state(req.indexName)
        if updates:
            info = info.with_live_settings(updates)
            self.gs.update_state(req.indexName, info)
            rt = self.gs.runtimes.get(req.indexName)
            if rt is not None:
                rt.state_info = info
                rt.apply_live_settings(info.live_settings)
        return pb.LiveSettingsResponse(response=_json.dumps(info.live_settings))

    def settings(self, req: pb.SettingsRequest) -> pb.SettingsResponse:
        """V1 settings surface (reference: SettingsHandler)."""
        import json as _json

        updates = MessageToDict(req)
        updates.pop("indexName", None)
        info = self.gs.get_state(req.indexName)
        if updates:
            if req.indexName in self.gs.runtimes:
                raise RuntimeError("settings can only be changed on a stopped index")
            info = info.with_settings(updates)
            self.gs.update_state(req.indexName, info)
        return pb.SettingsResponse(response=_json.dumps(info.settings))

    def updateFields(self, req: pb.FieldDefRequest) -> pb.FieldDefResponse:
        """Schema evolution: add new fields to an existing index
        (reference: UpdateFieldsHandler, luceneserver.proto:67)."""
        fields = {}
        for f in req.field:
            spec = MessageToDict(f, preserving_proto_field_name=False)
            spec.pop("name", None)
            fields[f.name] = spec
        info = self.gs.update_fields(req.indexName, fields)
        return pb.FieldDefResponse(response=info.to_json())

    def startIndex(self, req: pb.StartIndexRequest) -> pb.StartIndexResponse:
        mode = pb.Mode.Name(req.mode)
        t0 = time.time()
        primary_address = req.primaryAddress
        if primary_address and req.port:
            primary_address = f"{primary_address}:{req.port}"
        elif not primary_address and req.primaryDiscoveryFile:
            primary_address = f"file:{req.primaryDiscoveryFile}"
        rt = self.gs.start_index(
            req.indexName,
            mode=mode,
            restore=req.HasField("restore"),
            primary_gen=req.primaryGen,
            primary_address=primary_address,
        )
        s = rt.searcher
        return pb.StartIndexResponse(
            maxDoc=s.max_doc,
            numDocs=s.num_docs,
            segments=str(len(s.segments)),
            startTimeMS=(time.time() - t0) * 1000,
        )

    def startIndexV2(self, req: pb.StartIndexV2Request) -> pb.StartIndexResponse:
        """Start using the server config's IndexStartConfig (reference:
        StartIndexV2Handler + IndexStartConfig — the modern start surface:
        the node's role lives in its YAML, not the request)."""
        cfg = getattr(self.gs, "config", None)
        isc = (cfg.raw.get("indexStartConfig", {}) if cfg is not None else {})
        v1 = pb.StartIndexRequest(
            indexName=req.indexName,
            mode=pb.Mode.Value(str(isc.get("mode", "STANDALONE")).upper()),
            primaryAddress=str(isc.get("primaryAddress", "")),
            port=int(isc.get("port", 0)),
            primaryGen=int(isc.get("primaryGen", 0)),
            primaryDiscoveryFile=str(isc.get("primaryDiscoveryFile", "")),
        )
        if isc.get("restore"):
            v1.restore.serviceName = str(isc.get("serviceName", ""))
            v1.restore.resourceName = req.indexName
        return self.startIndex(v1)

    def reloadState(self, req: pb.ReloadStateRequest) -> pb.ReloadStateResponse:
        self.gs.reload()
        return pb.ReloadStateResponse()

    def nodeInfo(self, req: pb.NodeInfoRequest) -> pb.NodeInfoResponse:
        from nrtsearch_tpu_torch.version import __version__

        cfg = self.gs.config
        return pb.NodeInfoResponse(
            node_name=cfg.node_name,
            service_name=cfg.service_name,
            host_name=cfg.host_name,
            version=__version__,
            ephemeral_id=self.gs.ephemeral_id,
        )

    def globalState(self, req: pb.GlobalStateRequest) -> pb.GlobalStateResponse:
        resp = pb.GlobalStateResponse()
        resp.global_state.gen = max(
            (info.gen for info in self.gs.states.values()), default=0
        )
        for name, index_id in self.gs.index_ids.items():
            igs = resp.global_state.indices[name]
            igs.id = index_id
            igs.started = name in self.gs.runtimes
        return resp

    def state(self, req: pb.StateRequest) -> pb.StateResponse:
        info = self.gs.get_state(req.indexName)
        return pb.StateResponse(response=info.to_json())

    def indexState(self, req: pb.IndexStateRequest) -> pb.IndexStateResponse:
        from google.protobuf.json_format import ParseDict

        info = self.gs.get_state(req.index_name)
        resp = pb.IndexStateResponse()
        m = resp.index_state
        m.indexName = info.index_name
        m.gen = info.gen
        m.committed = bool(info.gen)
        ParseDict(info.settings, m.settings, ignore_unknown_fields=True)
        ParseDict(info.live_settings, m.liveSettings, ignore_unknown_fields=True)
        for fname, spec in info.fields.items():
            fmsg = m.fields[fname]
            ParseDict(dict(spec, name=fname), fmsg, ignore_unknown_fields=True)
        return resp

    def forceMergeDeletes(
        self, req: pb.ForceMergeDeletesRequest
    ) -> pb.ForceMergeDeletesResponse:
        """Rewrite segments containing deletes (reference:
        ForceMergeDeletesHandler — Lucene forceMergeDeletes)."""
        rt = self.gs.get_runtime(req.indexName)

        def do_merge():
            from nrtsearch_tpu_torch.core.merge import merge_segments

            with rt._lock:
                rt.writer.refresh()
                dirty = [s for s in rt.writer.segments if s.del_count > 0]
                if dirty:
                    clean = [s for s in rt.writer.segments if s.del_count == 0]
                    merged, _ = merge_segments(
                        dirty, rt.field_defs, rt.writer.index_sort
                    )
                    rt.writer.install_segments(clean + [merged])
                    rt._version += 1
                    rt._publish_searcher(rt.writer.segments)

        if req.doWait:
            do_merge()
            status = pb.ForceMergeDeletesResponse.Status.FORCE_MERGE_DELETES_COMPLETED
        else:
            import threading as _threading

            _threading.Thread(target=do_merge, daemon=True).start()
            status = pb.ForceMergeDeletesResponse.Status.FORCE_MERGE_DELETES_SUBMITTED
        return pb.ForceMergeDeletesResponse(status=status)

    def stopIndex(self, req: pb.StopIndexRequest) -> pb.DummyResponse:
        self.gs.stop_index(req.indexName)
        return pb.DummyResponse(ok="ok")

    def indices(self, req: pb.IndicesRequest) -> pb.IndicesResponse:
        resp = pb.IndicesResponse()
        for name in self.gs.index_ids:
            entry = resp.indicesResponse.add()
            entry.indexName = name
            if name in self.gs.runtimes:
                entry.statsResponse.CopyFrom(self.stats(pb.StatsRequest(indexName=name)))
        return resp

    def stats(self, req: pb.StatsRequest) -> pb.StatsResponse:
        rt = self.gs.get_runtime(req.indexName)
        st = rt.stats()
        resp = pb.StatsResponse(
            maxDoc=st["maxDoc"],
            numDocs=st["numDocs"],
            state=st["mode"],
        )
        resp.currentSearcher.version = st["version"]
        resp.currentSearcher.numDocs = st["numDocs"]
        resp.currentSearcher.numSegments = st["numSegments"]
        return resp

    def status(self, req: pb.HealthCheckRequest) -> pb.HealthCheckResponse:
        return pb.HealthCheckResponse(health=pb.TransferStatusCode.Done)

    def ready(self, req: pb.ReadyCheckRequest) -> pb.HealthCheckResponse:
        names = [n for n in req.indexNames.split(",") if n] or list(self.gs.runtimes)
        ok = all(n in self.gs.runtimes for n in names)
        return pb.HealthCheckResponse(
            health=pb.TransferStatusCode.Done if ok else pb.TransferStatusCode.Failed
        )

    # -- indexing ----------------------------------------------------------------

    def addDocuments(
        self, requests: Iterable[pb.AddDocumentRequest]
    ) -> pb.AddDocumentResponse:
        """Client-streamed ingest (AddDocumentHandler.java:67)."""
        index_name: Optional[str] = None
        rt = None
        buffer: list[dict] = []
        gen = 0
        max_buffer = 100
        for req in requests:
            if index_name is None:
                index_name = req.indexName
                rt = self.gs.get_runtime(index_name)
                max_buffer = int(
                    rt.state_info.live_settings.get("addDocumentsMaxBufferLen", 100)
                )
            doc = {}
            for fname, mv in req.fields.items():
                doc[fname] = list(mv.value)
            if req.requestType == pb.IndexingRequestType.UPDATE_DOC_VALUES:
                gen = rt.update_doc_values([doc])
                continue
            buffer.append(doc)
            if len(buffer) >= max_buffer:
                gen = rt.add_documents(buffer)
                buffer = []
        if rt is None:
            raise ValueError("no documents in stream")
        if buffer:
            gen = rt.add_documents(buffer)
        return pb.AddDocumentResponse(genId=str(gen), primaryId=rt.primary_id)

    def delete(self, requests: Iterable[pb.AddDocumentRequest]) -> pb.AddDocumentResponse:
        """Delete-by-id-field (DeleteDocumentsHandler)."""
        rt = None
        gen = 0
        for req in requests:
            if rt is None:
                rt = self.gs.get_runtime(req.indexName)
                if rt.writer.id_field is None:
                    raise ValueError("index has no _ID field; use deleteByQuery")
            ids = list(req.fields[rt.writer.id_field].value)
            gen = rt.delete_by_id(ids)
        if rt is None:
            raise ValueError("no delete requests in stream")
        return pb.AddDocumentResponse(genId=str(gen), primaryId=rt.primary_id)

    def deleteByQuery(self, req: pb.DeleteByQueryRequest) -> pb.AddDocumentResponse:
        rt = self.gs.get_runtime(req.indexName)
        gen = 0
        for q in req.query:
            node = parse_query(MessageToDict(q))
            gen = rt.delete_by_query(node)
        return pb.AddDocumentResponse(genId=str(gen), primaryId=rt.primary_id)

    def deleteAll(self, req: pb.DeleteAllDocumentsRequest) -> pb.DeleteAllDocumentsResponse:
        rt = self.gs.get_runtime(req.indexName)
        gen = rt.delete_all()
        return pb.DeleteAllDocumentsResponse(genId=str(gen))

    def refresh(self, req: pb.RefreshRequest) -> pb.RefreshResponse:
        rt = self.gs.get_runtime(req.indexName)
        return pb.RefreshResponse(refreshTimeMS=rt.refresh())

    def commit(self, req: pb.CommitRequest) -> pb.CommitResponse:
        rt = self.gs.get_runtime(req.indexName)
        gen = rt.commit()
        info = rt.state_info
        if not info.committed:
            self.gs.update_state(req.indexName, info._bump(committed=True))
            rt.state_info = self.gs.get_state(req.indexName)
        return pb.CommitResponse(gen=gen, primaryId=rt.primary_id)

    def forceMerge(self, req: pb.ForceMergeRequest) -> pb.ForceMergeResponse:
        rt = self.gs.get_runtime(req.indexName)
        with rt._lock:
            rt.writer.refresh()
            if len(rt.writer.segments) > max(req.maxNumSegments, 1):
                from nrtsearch_tpu_torch.core.merge import merge_segments

                merged, _ = merge_segments(
                    rt.writer.segments, rt.field_defs, rt.writer.index_sort
                )
                rt.writer.install_segments([merged])
            rt._version += 1
            rt._publish_searcher(rt.writer.segments)
        return pb.ForceMergeResponse(
            status=pb.ForceMergeResponse.Status.FORCE_MERGE_COMPLETED
        )

    # -- snapshots / warming / metrics / custom -------------------------------------

    def createSnapshot(self, req: pb.CreateSnapshotRequest) -> pb.CreateSnapshotResponse:
        rt = self.gs.get_runtime(req.indexName)
        gen = rt.create_snapshot()
        resp = pb.CreateSnapshotResponse()
        resp.snapshotId.indexGen = gen
        resp.snapshotId.stateGen = rt.state_info.gen
        return resp

    def releaseSnapshot(self, req: pb.ReleaseSnapshotRequest) -> pb.ReleaseSnapshotResponse:
        rt = self.gs.get_runtime(req.indexName)
        ok = rt.release_snapshot(req.snapshotId.indexGen)
        return pb.ReleaseSnapshotResponse(success=ok)

    def getAllSnapshotIndexGen(
        self, req: pb.GetAllSnapshotGenRequest
    ) -> pb.GetAllSnapshotGenResponse:
        rt = self.gs.get_runtime(req.indexName)
        return pb.GetAllSnapshotGenResponse(indexGens=rt.snapshot_gens())

    def backupWarmingQueries(
        self, req: pb.BackupWarmingQueriesRequest
    ) -> pb.BackupWarmingQueriesResponse:
        rt = self.gs.get_runtime(req.index)
        if self.gs.remote is None:
            raise RuntimeError("no remote backend configured for warming backup")
        n = self._warmer(req.index).backup(
            self.gs.remote, self.gs.config.service_name, rt.state_info.index_id
        )
        return pb.BackupWarmingQueriesResponse(numQueriesBackedUp=n)

    def metrics(self, req) -> "pb.HttpBody":
        if self.metrics_provider is None:
            return pb.HttpBody(content_type="text/plain", data=b"")
        return pb.HttpBody(
            content_type="text/plain; version=0.0.4",
            data=self.metrics_provider.scrape().encode(),
        )

    def custom(self, req: pb.CustomRequest) -> pb.CustomResponse:
        if self.plugins is None or req.id not in self.plugins.custom_request_handlers:
            raise KeyError(f"no custom request handler registered for {req.id!r}")
        result = self.plugins.custom_request_handlers[req.id](
            req.path, dict(req.params)
        )
        resp = pb.CustomResponse()
        for k, v in (result or {}).items():
            resp.response[k] = str(v)
        return resp

    # -- search -------------------------------------------------------------------

    def searchV2(self, req: pb.SearchRequest):
        """Same lifecycle as search; response packed as protobuf Any
        (reference: SearchV2Handler, luceneserver.proto:173)."""
        from google.protobuf import any_pb2

        out = any_pb2.Any()
        out.Pack(self.search(req))
        return out

    def search(self, req: pb.SearchRequest) -> pb.SearchResponse:
        t_start = time.time()
        rt = self.gs.get_runtime(req.indexName)
        which_searcher = req.WhichOneof("Searcher")
        if req.snapshotGen:
            searcher = rt.searcher_for_snapshot(req.snapshotGen)
        elif which_searcher == "snapshot":
            # reference snapshot ids are "indexGen:taxonomyGen:stateGen"
            searcher = rt.searcher_for_snapshot(int(req.snapshot.split(":")[0]))
        elif which_searcher == "indexGen":
            raise ValueError(
                "SearchRequest.indexGen pinning is not supported; use "
                "version or snapshot"
            )
        else:
            searcher = rt.acquire(req.version or None)
        field_defs = rt.field_defs
        self._warmer(req.indexName).add_search_request(req)
        if self.metrics_provider is not None:
            self.metrics_provider.search_hits.labels(req.indexName).inc()

        has_query = req.HasField("query")
        qdict = MessageToDict(req.query) if has_query else {}
        node = parse_query(qdict)
        if not has_query and req.queryText and req.queryText != "*:*":
            from nrtsearch_tpu_torch.query.text_parser import parse_query_text

            default_fields = [
                n for n, fd in field_defs.items() if fd.search and fd.is_text
            ]
            node = parse_query_text(req.queryText, default_fields or ["*"])
            has_query = True
        node = self._resolve_cross_index(node)

        # unknown field names anywhere in the tree fail loudly up front
        # (reference: QueryNodeMapper getFieldDef throws); request-level
        # virtual/runtime fields are legal references too
        known = dict(field_defs)
        for vf in list(req.virtualFields) + list(req.runtimeFields):
            known.setdefault(vf.name, None)
        validate_fields(node, known)

        sort = self._parse_sort(req, field_defs)

        # reference semantics (SearchHandler.getHitsFromOffset:696): topHits is
        # the end of the collected window; the page is [startHit, topHits)
        top_hits = req.topHits or 10
        fetch_n = max(top_hits, req.startHit)

        # deep pagination via searchAfter: extend the collected window past
        # the cursor (reference: LastHitInfo searchAfter state)
        search_after = req.searchAfter if req.HasField("searchAfter") else None
        if search_after is not None:
            fetch_n += search_after.lastHitIndex + 1
        if req.HasField("loggingHits"):
            # the logger may ask for more hits than the returned page
            # (reference: LoggingHits.hitsToLog, search.proto:940)
            fetch_n = max(fetch_n, req.loggingHits.hitsToLog)

        need_arrays = bool(req.facets) or bool(req.collectors) or bool(req.knn)

        kernel_reduced: list = [None]

        def _recall(fetch_n):
            if req.HasField("multiRetriever") and req.multiRetriever.retrievers:
                # multi-retriever hybrid mode: retrievers recall
                # independently, then blend (reference:
                # executeMultiRetriever, SearchHandler:528)
                td = self._multi_retriever(searcher, req, fetch_n)
                arrays = self._hits_as_arrays(searcher, td) if need_arrays else None
                return td, arrays
            if req.knn and not has_query:
                # knn-only request: results come from the vector queries alone
                td = self._knn_only(searcher, req.knn, fetch_n)
                arrays = [] if need_arrays else None
                if req.facets or req.collectors:
                    # facets still need match arrays: matches = knn result docs
                    arrays = self._hits_as_arrays(searcher, td)
                return td, arrays
            ls = rt.state_info.live_settings
            timeout_sec = req.timeoutSec or float(ls.get("defaultSearchTimeoutSec", 0))
            terminate_after = req.terminateAfter or int(ls.get("defaultTerminateAfter", 0))
            # honored as the doc-space chunk granularity of the timeout path
            # (reference: SearchCutoffWrapper checks every N collects,
            # search.proto:481 / defaultSearchTimeoutCheckEvery)
            check_every = req.timeoutCheckEvery or int(
                ls.get("defaultSearchTimeoutCheckEvery", 0)
            )
            td = arrays = None
            if (
                need_arrays and not req.knn
                and not timeout_sec and not terminate_after
                and not req.rescorers
            ):
                # in-kernel flat reductions: plain terms facets + flat
                # collectors accumulate over the fused kernel's own match
                # stream in the SAME dispatch as recall — no dense [D]
                # match mask is ever materialized (VERDICT r2 #3; reference
                # role: one-pass collection, DrillSidewaysImpl)
                plan = self._kernel_reduce_plan(req, field_defs, node)
                if plan is not None:
                    spec = searcher.compile_batchable(node, sort)
                    if spec is not None:
                        td, red = searcher.fast_search_reduce(
                            spec, fetch_n, plan[0]
                        )
                        kernel_reduced[0] = (plan[1], red)
                        return td, None
            if (
                self.batcher is not None
                and not need_arrays and not req.knn
                and not timeout_sec and not terminate_after
            ):
                # micro-batching: concurrent eligible queries coalesce into
                # one fused device dispatch (server/batcher.py). Sorted and
                # filtered boolean shapes batch too — the fused kernel takes
                # per-query filter masks / sort keys (packed_view.QuerySpec).
                spec = searcher.compile_batchable(node, sort)
                if spec is not None:
                    td = self.batcher.search(searcher, spec, fetch_n)
            if td is None:
                result = searcher.search(
                    node, fetch_n, sort=sort, return_arrays=need_arrays,
                    timeout_sec=timeout_sec, terminate_after=terminate_after,
                    timeout_check_every=check_every,
                    arrays_score_free=(
                        need_arrays and not req.knn
                        and not _needs_array_scores(req)
                    ),
                )
                td, arrays = result if need_arrays else (result, None)
            if req.knn:
                td = self._merge_knn(searcher, td, arrays, req.knn, fetch_n)
            return td, arrays

        td, arrays = _recall(fetch_n)
        recall_ms = (time.time() - t_start) * 1000

        # rescorers run sequentially over the top window (SearchHandler:270-281)
        t_rescore = time.time()
        for rescorer in req.rescorers:
            self._apply_rescorer(searcher, td, rescorer)
        rescore_ms = (time.time() - t_rescore) * 1000

        if search_after is not None:
            kept = self._after_cursor(td.hits, search_after, sort)
            # stock clients don't send the lastHitIndex extension, so the
            # cursor's rank is unknown: when the filtered page comes up short
            # and deeper candidates exist, widen the window and re-collect
            # (reference collects past the cursor inside Lucene's
            # searchAfter collector, so it never under-fills)
            while (
                len(kept) < top_hits
                and len(td.hits) >= fetch_n
                and td.total_hits > fetch_n
            ):
                fetch_n = min(max(fetch_n * 4, 64), int(td.total_hits))
                td, arrays = _recall(fetch_n)
                for rescorer in req.rescorers:
                    self._apply_rescorer(searcher, td, rescorer)
                kept = self._after_cursor(td.hits, search_after, sort)
            td.hits = kept

        resp = pb.SearchResponse()
        resp.totalHits.value = td.total_hits
        resp.totalHits.relation = pb.TotalHits.Relation.Value(
            getattr(td, "relation", "EQUAL_TO")
        )
        resp.hitTimeout = getattr(td, "hit_timeout", False)
        resp.terminatedEarly = getattr(td, "terminated_early", False)

        hits = td.hits[req.startHit : top_hits]
        t_fetch = time.time()
        retrieve = list(req.retrieveFields)
        virtual_values = self._virtual_values(searcher, req, arrays)
        highlight_plan = self._highlight_plan(req, node, field_defs)
        inner_cache: dict = {}  # per-request inner-query eval cache
        pb_hits = []
        for h in hits:
            pb_hit = resp.hits.add()
            pb_hits.append(pb_hit)
            pb_hit.luceneDocId = h.global_ord
            if sort is None:
                pb_hit.score = h.score
            elif sort.is_multi:
                vals = h.sort_key if isinstance(h.sort_key, tuple) else (
                    (h.sort_key or 0.0),
                )
                for comp, v in zip(sort.components, vals):
                    sf_val = pb_hit.sortedFields[comp.field].fieldValue.add()
                    sf_val.doubleValue = float(v)
            else:
                sf_val = pb_hit.sortedFields[sort.field].fieldValue.add()
                sf_val.doubleValue = h.sort_key or 0.0

        def fill_one(pair):
            pb_hit, h = pair
            if retrieve:
                fill_hit_fields_pb(
                    pb_hit, searcher, h, retrieve, field_defs, pb, virtual_values
                )
            if req.explain:
                pb_hit.explain = (
                    f"score={h.score:.6f} query={node!r} doc={h.global_ord}"
                )
            for hfield, (terms, settings) in highlight_plan.items():
                self._highlight_hit(pb_hit, searcher, h, hfield, terms, settings)

        pairs = list(zip(pb_hits, hits))
        has_fill_work = bool(retrieve or req.explain or highlight_plan)
        if has_fill_work and len(pairs) > 8 and not req.inner_hits:
            # parallel fetch by doc CHUNK (reference: FillDocsTask on the
            # FETCH pool, liveSettings.parallelFetchChunkSize, default 50)
            # — one executor task per chunk, not per hit: per-hit futures
            # cost ~36 us each in pure submission overhead, which at
            # topHits=100 dominated the whole host path for cheap queries
            from nrtsearch_tpu_torch.server.concurrent import ExecutorFactory

            ls = rt.state_info.live_settings
            csize = max(int(ls.get("parallelFetchChunkSize", 50) or 50), 1)
            chunks = [
                pairs[i : i + csize] for i in range(0, len(pairs), csize)
            ]

            def fill_chunk(chunk):
                for pair in chunk:
                    fill_one(pair)

            list(ExecutorFactory.get().pool("FETCH").map(fill_chunk, chunks))
        elif has_fill_work:
            for pair in pairs:
                fill_one(pair)
        # inner hits mutate a shared eval cache: keep them on the caller thread
        for pb_hit, h in pairs:
            for ih_name, ih in req.inner_hits.items():
                self._inner_hits(
                    pb_hit, searcher, h, ih_name, ih, field_defs, inner_cache
                )
        fetch_ms = (time.time() - t_fetch) * 1000

        if kernel_reduced[0] is not None:
            self._fill_kernel_reduced(req, resp, *kernel_reduced[0])
        elif need_arrays:
            score_parts = [s for s, _ in arrays]
            matches = coll.SegmentMatches(
                searcher, [m for _, m in arrays],
                None if any(s is None for s in score_parts) else score_parts,
            )
            self._run_facets(req, resp, matches, searcher, td.hits, field_defs)
            self._run_collectors(req.collectors, resp.collectorResults, matches)

        # searchAfter state
        resp.searchState.timestamp = int(t_start * 1000)
        resp.searchState.searcherVersion = searcher.version
        if hits:
            resp.searchState.lastDocId = hits[-1].global_ord
            resp.searchState.lastScore = hits[-1].score
            resp.searchState.lastHitInfo.lastHitIndex = (
                req.startHit + len(hits) - 1
            )
            if sort is not None and hits[-1].sort_key is not None:
                vals = hits[-1].sort_key
                if not isinstance(vals, tuple):
                    vals = (vals,)
                for v in vals:
                    resp.searchState.lastFieldValues.append(repr(float(v)))

        resp.diagnostics.firstPassSearchTimeMs = recall_ms
        resp.diagnostics.getFieldsTimeMs = fetch_ms
        resp.diagnostics.rescoreTimeMs = rescore_ms
        resp.diagnostics.parsedQuery = repr(node)
        if self.metrics_provider is not None:
            # per-stage timing families (reference: nrt_search_timing)
            obs = self.metrics_provider.observe_search_stage
            obs(req.indexName, "recall", recall_ms / 1e3)
            obs(req.indexName, "rescore", rescore_ms / 1e3)
            obs(req.indexName, "fetch", fetch_ms / 1e3)
            obs(req.indexName, "total", time.time() - t_start)

        if req.profile:
            # ProfileResult (reference: SearchStatsWrapper, search.proto:1403)
            resp.profileResult.parsedQuery = repr(node)
            stats = resp.profileResult.searchStats
            stats.totalCollectTimeMs = recall_ms
            cs = stats.collectorStats.add()
            cs.totalCollectTimeMs = recall_ms
            cs.totalCollectedCount = len(td.hits)
            for seg in searcher.segments:
                ss = cs.segmentStats.add()
                ss.maxDoc = seg.num_docs
                ss.numDocs = seg.live_doc_count
                ss.collectTimeMs = recall_ms / max(len(searcher.segments), 1)

        # hits loggers (reference: HitsLoggerFetchTask, server/logging/)
        if req.HasField("loggingHits"):
            lh = req.loggingHits
            logger = (self.plugins.hits_loggers.get(lh.name)
                      if self.plugins is not None else None)
            if logger is None:
                raise ValueError(f"unknown hits logger: {lh.name!r}")
            params = MessageToDict(lh.params) if lh.HasField("params") else {}
            n_log = lh.hitsToLog or top_hits
            logger(req.indexName, req, td.hits[:n_log], **(
                {"params": params} if params else {}
            ))
        elif self.plugins is not None and self.plugins.hits_loggers:
            for logger in self.plugins.hits_loggers.values():
                try:
                    logger(req.indexName, req, td.hits[: top_hits])
                except Exception:
                    pass
        return resp

    # -- search sub-features -------------------------------------------------------

    def _multi_retriever(self, searcher, req, fetch_n: int):
        """Hybrid recall: named retrievers run independently, then blend.

        Reference: MultiRetrieverRequest (search.proto:863-953) —
        Retriever{textRetriever|knnRetriever, boost, rescorer} + Blender
        oneof {weightedRrf, weightedScoreOrder, scorelessRawMerge, plugin};
        executed by SearchHandler.executeMultiRetriever (:528)."""
        from nrtsearch_tpu_torch.core.searcher import TopDocs
        from nrtsearch_tpu_torch.search import retrievers as rtr

        mreq = req.multiRetriever
        specs = []
        order = []
        for r in mreq.retrievers:
            name = r.name
            order.append(name)
            weight = r.boost if r.HasField("boost") else 1.0
            which = r.WhichOneof("retrieverType")
            if which == "knnRetriever":
                knn = r.knnRetriever.knnQuery
                specs.append(
                    rtr.RetrieverSpec(
                        name=name,
                        knn_field=knn.field,
                        knn_vector=np.asarray(list(knn.query_vector), np.float32),
                        knn_k=knn.k or 10,
                        knn_filter=parse_query(MessageToDict(knn.filter))
                        if knn.HasField("filter") else None,
                        window_size=knn.num_candidates or knn.k or 100,
                        weight=weight,
                    )
                )
            else:
                tr = r.textRetriever
                specs.append(
                    rtr.RetrieverSpec(
                        name=name,
                        query=parse_query(MessageToDict(tr.query)),
                        window_size=tr.topHits or 100,
                        weight=weight,
                    )
                )
        results = rtr.run_retrievers(searcher, specs)
        weights = {s.name: s.weight for s in specs}
        blender = mreq.blender
        which_b = blender.WhichOneof("blenderType") if mreq.HasField("blender") else None
        if which_b == "weightedScoreOrder":
            stype = pb.WeightedScoreOrderBlender.ScoreMode.Name(
                blender.weightedScoreOrder.scoreMode
            )
            merged = rtr.blend_weighted_score(results, weights, stype)
        elif which_b == "scorelessRawMerge":
            merged = rtr.blend_raw(results, order)
        elif which_b == "plugin":
            merged = rtr.blend_plugin(
                self.plugins, blender.plugin.name, results, weights,
                MessageToDict(blender.plugin.params)
                if blender.plugin.HasField("params") else {},
            )
        else:
            rank_c = (
                blender.weightedRrf.rankConstant
                if which_b == "weightedRrf" else 0
            )
            merged = rtr.blend_rrf(results, weights, rank_c or 60)
        return TopDocs(merged[:fetch_n], len(merged))

    @staticmethod
    def _parse_sort(req, field_defs):
        """All sortedFields -> SortSpec (reference: SortParser.java:39
        consumes the full repeated SortType list). Unsupported sort fields
        fail LOUDLY instead of being silently dropped."""
        if not (req.HasField("querySort") and req.querySort.fields.sortedFields):
            return None
        from nrtsearch_tpu_torch.core.searcher import SortComponent

        comps = []
        for sf in req.querySort.fields.sortedFields:
            name = sf.fieldName
            if name not in ("docid", "score"):
                fd = field_defs.get(name)
                if fd is None:
                    raise ValueError(f"unknown sort field: {name!r}")
                sortable = (
                    fd.type.value in ("VIRTUAL", "RUNTIME")
                    or fd.store_doc_values
                )
                if not sortable:
                    raise ValueError(
                        f"field {name!r} is not sortable (no doc values)"
                    )
            missing_last = str(sf.missingLast).lower() in ("true", "1")
            comps.append(
                SortComponent(name, reverse=sf.reverse,
                              missing_last=missing_last)
            )
        return SortSpec(
            comps[0].field, comps[0].reverse, comps[0].missing_last,
            rest=tuple(comps[1:]),
        )

    def _apply_rescorer(self, searcher, td, rescorer) -> None:
        """One rescorer pass over td.hits in place (reference:
        QueryRescore/ScriptRescore, search.proto Rescorer oneof)."""
        window = rescorer.windowSize or len(td.hits)
        which = rescorer.WhichOneof("Rescorers")
        if which == "queryRescorer":
            from nrtsearch_tpu_torch.search.rescore import query_rescore

            qr = rescorer.queryRescorer
            rescore_node = self._resolve_cross_index(
                parse_query(MessageToDict(qr.rescoreQuery))
            )
            td.hits = query_rescore(
                searcher, td.hits, window, rescore_node,
                qr.queryWeight or 1.0, qr.rescoreQueryWeight or 1.0,
            )
        elif which == "scriptRescorer":
            from nrtsearch_tpu_torch.search.rescore import script_rescore

            td.hits = script_rescore(
                searcher, td.hits, window, rescorer.scriptRescorer.script.source
            )

    def _after_cursor(self, hits, search_after, sort):
        """Drop hits at or before the searchAfter cursor (reference:
        LastHitInfo; the cursor is the last hit's (sort keys, doc id) and
        pagination resumes strictly after it)."""
        from nrtsearch_tpu_torch.core.searcher import sort_compare_key

        out = []
        if sort is not None and search_after.lastFieldValues:
            last_key = sort_compare_key(
                sort, [float(v) for v in search_after.lastFieldValues]
            )
        else:
            last_key = None
        for h in hits:
            if sort is None:
                key_ok = h.score < search_after.lastScore or (
                    h.score == search_after.lastScore
                    and h.global_ord > search_after.lastDocId
                )
            elif last_key is not None:
                vals = h.sort_key if isinstance(h.sort_key, tuple) else (
                    (h.sort_key or 0.0),
                )
                hk = sort_compare_key(sort, [float(v) for v in vals])
                key_ok = (hk, h.global_ord) > (
                    last_key[: len(hk)], search_after.lastDocId
                )
            else:
                key_ok = h.global_ord > search_after.lastDocId
            if key_ok:
                out.append(h)
        return out

    def _virtual_values(self, searcher, req, arrays):
        """Request-level virtual fields -> global-ord-indexed value arrays."""
        if not req.virtualFields:
            return None
        from nrtsearch_tpu_torch.query.eval import _ScriptDocValues
        from nrtsearch_tpu_torch.script.expr import compile_expression

        out = {}
        for vf in req.virtualFields:
            fn = compile_expression(vf.script.source, vf.script.lang)
            vals = []
            for idx, seg in enumerate(searcher.segments):
                if arrays:
                    score_arr = arrays[idx][0]
                    score_arr = np.asarray(score_arr if score_arr is None else score_arr.cpu())
                else:
                    score_arr = np.zeros(seg.capacity, np.float32)
                v = np.asarray(fn(_ScriptDocValues(seg), score_arr))
                if v.ndim == 0:
                    v = np.full(seg.capacity, float(v), np.float32)
                vals.append(v[: seg.num_docs])
            out[vf.name] = np.concatenate(vals) if vals else np.zeros(0)
        return out

    def _highlight_plan(self, req, node, field_defs):
        if not req.HasField("highlight") or not req.highlight.fields:
            return {}
        from nrtsearch_tpu_torch.search.highlight import (
            HighlightSettings,
            build_highlight_query,
        )

        def settings_for(fname):
            s = req.highlight.field_settings.get(fname) or req.highlight.settings
            hs = HighlightSettings()
            if s.pre_tags:
                hs.pre_tag = s.pre_tags[0]
            if s.post_tags:
                hs.post_tag = s.post_tags[0]
            if s.HasField("fragment_size"):
                hs.fragment_size = s.fragment_size.value
            if s.HasField("max_number_of_fragments"):
                hs.max_fragments = s.max_number_of_fragments.value
            if s.HasField("score_ordered"):
                hs.score_ordered = s.score_ordered.value
            return s, hs

        plan = {}
        for fname in req.highlight.fields:
            s, hs = settings_for(fname)
            # per-field highlightQuery override (reference:
            # HighlightSettings.highlightQuery)
            hl_node = node
            if s.HasField("highlight_query"):
                hl_node = parse_query(MessageToDict(s.highlight_query))
            plan[fname] = (build_highlight_query(hl_node, fname), hs)
        return plan

    def _highlight_hit(self, pb_hit, searcher, hit, field, terms, settings):
        from nrtsearch_tpu_torch.search.highlight import highlight_text

        seg = searcher.segments[hit.segment_idx]
        text = seg.stored[hit.local_id].get(field)
        if not text:
            return
        if isinstance(text, list):
            text = " ".join(str(t) for t in text)
        frags = highlight_text(str(text), terms, settings)
        if frags:
            pb_hit.highlights[field].fragments.extend(frags)

    # -- kNN integration (reference: KnnUtils SHOULD-merge into main query) -----

    def _exec_knn(self, searcher, knn_req, fetch_n: int):
        filter_node = (
            parse_query(MessageToDict(knn_req.filter))
            if knn_req.HasField("filter")
            else None
        )
        return searcher.knn_search(
            knn_req.field,
            np.asarray(list(knn_req.query_vector), np.float32),
            max(knn_req.k or 10, fetch_n),
            filter_node=filter_node,
            boost=knn_req.boost or 1.0,
        )

    def _knn_only(self, searcher, knn_reqs, fetch_n: int):
        from nrtsearch_tpu_torch.core.searcher import Hit, TopDocs

        scores: dict[int, float] = {}
        hit_by_ord: dict[int, Hit] = {}
        for knn_req in knn_reqs:
            td = self._exec_knn(searcher, knn_req, fetch_n)
            for h in td.hits:
                scores[h.global_ord] = scores.get(h.global_ord, 0.0) + h.score
                hit_by_ord[h.global_ord] = h
        merged = [
            Hit(hit_by_ord[o].segment_idx, hit_by_ord[o].local_id, o, s)
            for o, s in scores.items()
        ]
        merged.sort(key=lambda h: (-h.score, h.global_ord))
        return TopDocs(merged[:fetch_n], len(merged))

    def _merge_knn(self, searcher, td, arrays, knn_reqs, fetch_n: int):
        """Union the query's top window with knn top-k docs, summing scores
        (boolean SHOULD semantics: each knn clause matches exactly its top-k)."""
        from nrtsearch_tpu_torch.core.searcher import Hit, TopDocs

        scores: dict[int, float] = {h.global_ord: h.score for h in td.hits}
        hit_by_ord: dict[int, Hit] = {h.global_ord: h for h in td.hits}
        total = td.total_hits
        for knn_req in knn_reqs:
            ktd = self._exec_knn(searcher, knn_req, fetch_n)
            for h in ktd.hits:
                if h.global_ord in scores:
                    scores[h.global_ord] += h.score
                else:
                    # doc matched knn but not the query top window: its query
                    # score comes from the per-segment arrays (0 if no match)
                    qs = 0.0
                    if arrays:
                        s_arr, m_arr = arrays[h.segment_idx]
                        if bool(m_arr[h.local_id].item()):
                            qs = float(s_arr[h.local_id].item())
                        else:
                            total += 1
                    scores[h.global_ord] = qs + h.score
                    hit_by_ord[h.global_ord] = h
        merged = [
            Hit(hit_by_ord[o].segment_idx, hit_by_ord[o].local_id, o, s)
            for o, s in scores.items()
        ]
        merged.sort(key=lambda h: (-h.score, h.global_ord))
        return TopDocs(merged[:fetch_n], total)

    def _hits_as_arrays(self, searcher, td):
        arrays = []
        for idx, seg in enumerate(searcher.segments):
            m = np.zeros(seg.capacity, bool)
            s = np.zeros(seg.capacity, np.float32)
            for h in td.hits:
                if h.segment_idx == idx:
                    m[h.local_id] = True
                    s[h.local_id] = h.score
            arrays.append((s, m))
        return arrays

    def _inner_hits(self, pb_hit, searcher, hit, ih_name, ih, field_defs,
                    inner_cache) -> None:
        """Per-parent child sub-search (reference: InnerHitFetchTask,
        server/innerhit/; proto search.proto:965-982)."""
        from nrtsearch_tpu_torch.core.segment import SegmentBuilder
        from nrtsearch_tpu_torch.query import eval as qeval

        seg = searcher.segments[hit.segment_idx]
        parents = seg.parent_positions()
        dv = seg.doc_values.get(SegmentBuilder.NESTED_PATH_FIELD)
        result = pb_hit.innerHits[ih_name or ih.query_nested_path]
        if parents is None or dv is None:
            return
        path_ord = (dv.ord_index or {}).get(ih.query_nested_path)
        if path_ord is None:
            return
        idx = int(np.searchsorted(parents, hit.local_id))
        if idx >= len(parents) or parents[idx] != hit.local_id:
            return
        start = int(parents[idx - 1]) + 1 if idx > 0 else 0
        end = hit.local_id
        if end <= start:
            result.totalHits.value = 0
            return

        # evaluate the inner query once per (segment, query) pair
        cache_key = (hit.segment_idx, ih.SerializeToString())
        if cache_key not in inner_cache:
            inner_node = (
                parse_query(MessageToDict(ih.inner_query))
                if ih.HasField("inner_query")
                else parse_query({})
            )
            ctx = qeval.EvalContext(seg, field_defs, searcher.stats)
            scores, match = qeval.eval_node(inner_node, ctx)
            inner_cache[cache_key] = (np.asarray(scores.cpu()), np.asarray(match.cpu()))
        scores, match = inner_cache[cache_key]

        on_path = dv.host_values[start:end] == path_ord
        ok = match[start:end] & on_path & seg.host_live[start:end]
        child_ids = np.nonzero(ok)[0] + start
        child_scores = scores[child_ids]
        order = np.argsort(-child_scores, kind="stable")
        top = int(ih.top_hits or 3)
        sel = order[int(ih.start_hit) : int(ih.start_hit) + top]
        result.totalHits.value = len(child_ids)
        from nrtsearch_tpu_torch.core.searcher import Hit as CoreHit

        base = int(searcher.bases[hit.segment_idx])
        for o in sel:
            child_local = int(child_ids[o])
            child_hit = CoreHit(
                hit.segment_idx, child_local, base + child_local,
                float(child_scores[o]),
            )
            child_pb = result.hits.add()
            child_pb.luceneDocId = child_hit.global_ord
            child_pb.score = child_hit.score
            if ih.retrieve_fields:
                fill_hit_fields_pb(
                    child_pb, searcher, child_hit, list(ih.retrieve_fields),
                    field_defs, pb,
                )

    def _run_facets(
        self, req, resp, matches, searcher=None, ranked_hits=None, field_defs=None
    ) -> None:
        # drill-sideways (reference: DrillSidewaysImpl): when the query ANDs
        # in FILTER clauses on a facet's own dimension, that dimension's
        # counts are computed with its own filter EXCLUDED
        sideways = self._drill_sideways_matches(req, matches)
        # fused pre-pass: plain terms facets over the shared match set reduce
        # in one device call (one round trip per dim otherwise); sideways/
        # sampled/range/hierarchy dims keep their own paths
        fused_facets: dict[str, dict] = {}
        plain_dims = [
            f.dim for f in req.facets
            if not f.sampleTopDocs and not f.numericRange and not f.paths
            and f.dim not in sideways
        ]
        if len(plain_dims) > 1:
            res = coll.fused_flat_reductions(
                matches, [{"kind": "ordinal", "field": d} for d in plain_dims]
            )
            fused_facets = {
                d: r for d, r in zip(plain_dims, res) if r is not None
            }
        for facet in req.facets:
            if facet.sampleTopDocs > 0 and ranked_hits is not None:
                self._sampled_facet(facet, resp, searcher, ranked_hits, field_defs)
                continue
            facet_matches = sideways.get(facet.dim, matches)
            fr = resp.facetResult.add()
            fr.name = facet.name or facet.dim
            fr.dim = facet.dim
            if facet.numericRange:
                ranges = [MessageToDict(r) for r in facet.numericRange]
                for label, count in coll.numeric_range_counts(
                    facet_matches, facet.dim, ranges
                ):
                    lv = fr.labelValues.add()
                    lv.label = label
                    lv.value = count
                fr.childCount = len(fr.labelValues)
                continue
            if facet.paths:
                counts, under = coll.hierarchy_counts(
                    facet_matches, facet.dim, list(facet.paths)
                )
                fr.path.extend(facet.paths)
                fr.value = under
                fr.childCount = len(counts)
                top_n = facet.topN or 10
                for label, count in sorted(
                    counts.items(), key=lambda kv: (-kv[1], kv[0])
                )[:top_n]:
                    lv = fr.labelValues.add()
                    lv.label = label
                    lv.value = count
                continue
            counts = (
                fused_facets[facet.dim]
                if facet.dim in fused_facets
                else coll.terms_counts(facet_matches, facet.dim)
            )
            fr.childCount = len(counts)
            fr.value = sum(counts.values())
            if facet.labels:
                # explicit labels: counts for EXACTLY the requested labels,
                # in request order, 0 when absent (reference:
                # getFacetCountsForLabels vs getTopChildren)
                for label in facet.labels:
                    lv = fr.labelValues.add()
                    lv.label = label
                    lv.value = counts.get(label, 0)
                continue
            top_n = facet.topN or 10
            for label, count in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[
                :top_n
            ]:
                lv = fr.labelValues.add()
                lv.label = label
                lv.value = count

    def _sampled_facet(self, facet, resp, searcher, ranked_hits, field_defs) -> None:
        """Facet counts over a sample of the top ranked docs (reference:
        facet/FacetTopDocs.java facetTopDocsSample — only facets with
        sampleTopDocs > 0; counts doc values of the first
        min(len(topDocs), sampleTopDocs) hits)."""
        from nrtsearch_tpu_torch.search.fetch import fetch_field_values

        fd = (field_defs or {}).get(facet.dim)
        if fd is None:
            raise ValueError(f"Sampling facet field must be indexable: {facet.dim}")
        if not fd.store_doc_values:
            raise ValueError(
                f"Sampling facet field must have doc values enabled: {facet.dim}"
            )
        counts: dict[str, int] = {}
        total_docs = 0
        for hit in ranked_hits[: facet.sampleTopDocs]:
            values = fetch_field_values(searcher, hit, facet.dim, field_defs)
            if not values:
                continue
            for v in values:
                key = str(v.item() if hasattr(v, "item") else v)
                if isinstance(v, float) and v.is_integer():
                    key = str(int(v))
                counts[key] = counts.get(key, 0) + 1
            total_docs += 1
        fr = resp.facetResult.add()
        fr.name = facet.name or facet.dim
        fr.dim = facet.dim
        fr.value = total_docs
        fr.childCount = len(counts)
        top_n = facet.topN or 10
        for label, count in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[
            :top_n
        ]:
            lv = fr.labelValues.add()
            lv.label = label
            lv.value = count

    def _resolve_cross_index(self, node):
        """Resolve CrossIndexQueryNodes by searching the secondary index and
        rewriting to ResolvedJoinNodes (reference: QueryNodeMapper
        getCrossIndexQuery -> JoinUtil.createJoinQuery, where the from-side
        search happens at query-build time). Walks the plan tree."""
        import dataclasses

        from nrtsearch_tpu_torch.query import plan as qp

        if isinstance(node, qp.CrossIndexQueryNode):
            rt2 = self.gs.get_runtime(node.index)
            if node.secondary_field not in rt2.field_defs:
                raise ValueError(
                    f"unknown secondary field: {node.secondary_field!r}"
                )
            inner = self._resolve_cross_index(node.query or qp.MatchAllNode())
            td = rt2.searcher.search(inner, top_hits=1_000_000)
            # aggregate secondary-side scores per join value
            agg: dict = {}
            from nrtsearch_tpu_torch.search.fetch import fetch_field_values

            for hit in td.hits:
                vals = fetch_field_values(
                    rt2.searcher, hit, node.secondary_field, rt2.field_defs
                )
                for v in vals or []:
                    v = v.item() if hasattr(v, "item") else v
                    agg.setdefault(v, []).append(hit.score)
            mode = node.score_mode
            items = list(agg.items())
            if node.max_terms > 0:
                items = items[: node.max_terms]
            values, value_scores = [], []
            for v, ss in items:
                values.append(v)
                if mode == "JOIN_SCORE_AVG":
                    value_scores.append(sum(ss) / len(ss))
                elif mode == "JOIN_SCORE_MAX":
                    value_scores.append(max(ss))
                elif mode == "JOIN_SCORE_MIN":
                    value_scores.append(min(ss))
                elif mode == "JOIN_SCORE_TOTAL":
                    value_scores.append(sum(ss))
                else:  # UNSET / NONE: constant score
                    value_scores.append(1.0)
            return qp.ResolvedJoinNode(
                boost=node.boost,
                field=node.primary_field,
                values=tuple(values),
                value_scores=tuple(value_scores),
                constant_score=mode in ("JOIN_SCORE_UNSET", "JOIN_SCORE_NONE"),
            )
        # recurse into children (frozen dataclasses)
        changed = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, qp.QueryNode):
                nv = self._resolve_cross_index(v)
                if nv is not v:
                    changed[f.name] = nv
            elif isinstance(v, tuple) and v and isinstance(
                v[0], (qp.QueryNode, qp.BooleanClause)
            ):
                nv = tuple(
                    dataclasses.replace(c, node=self._resolve_cross_index(c.node))
                    if isinstance(c, qp.BooleanClause)
                    else self._resolve_cross_index(c)
                    for c in v
                )
                if nv != v:
                    changed[f.name] = nv
        return dataclasses.replace(node, **changed) if changed else node

    def _drill_sideways_matches(self, req, matches) -> dict:
        """Per-facet-dimension match sets with that dim's own FILTER clauses
        removed from the query (DrillSidewaysImpl semantics). Only boolean
        top-level queries with field-bearing FILTER clauses participate."""
        from nrtsearch_tpu_torch.query import plan as qp

        if not req.HasField("query") or not req.facets:
            return {}
        node = parse_query(MessageToDict(req.query))
        if not isinstance(node, qp.BooleanQueryNode):
            return {}
        filter_fields = {
            getattr(c.node, "field", None)
            for c in node.clauses
            if c.occur == qp.Occur.FILTER
        }
        out = {}
        for facet in req.facets:
            dim = facet.dim
            if dim not in filter_fields:
                continue
            reduced = qp.BooleanQueryNode(
                boost=node.boost,
                clauses=tuple(
                    c for c in node.clauses
                    if not (
                        c.occur == qp.Occur.FILTER
                        and getattr(c.node, "field", None) == dim
                    )
                ),
                minimum_number_should_match=node.minimum_number_should_match,
            )
            masks = matches.searcher.match_masks(reduced)
            out[dim] = coll.SegmentMatches(
                matches.searcher, [np.asarray(m.cpu()) for m in masks]
            )
        return out

    def _kernel_reduce_plan(self, req, field_defs, node):
        """(reduce_plan, fill_route) when EVERY facet/collector of this
        request is a flat single-valued field reduction the fused kernel can
        accumulate in-dispatch, else None (the arrays path serves it).

        Shapes kept on the arrays path: sampled/range/hierarchy/script/label
        facets, drill-sideways dims (a FILTER clause on the facet's own dim
        needs per-dim re-matching), topHits/filter/plugin collectors,
        script sources, nested collectors, multi-valued columns."""
        facets = list(req.facets)
        collectors = dict(req.collectors)
        if not facets and not collectors:
            return None

        def _single_ordinal(fname):
            fd = field_defs.get(fname)
            return (
                fd is not None and fd.store_doc_values
                and not fd.multi_valued
                and fd.doc_value_kind == DocValueKind.ORDINAL
            )

        def _single_numeric(fname):
            fd = field_defs.get(fname)
            return (
                fd is not None and fd.store_doc_values
                and not fd.multi_valued
                and fd.doc_value_kind in (DocValueKind.LONG, DocValueKind.DOUBLE)
            )

        filter_dims = set()
        if isinstance(node, qp.BooleanQueryNode):
            filter_dims = {
                getattr(c.node, "field", None)
                for c in node.clauses if c.occur == qp.Occur.FILTER
            }
        plan, route = [], []
        for facet in facets:
            if (facet.sampleTopDocs or facet.numericRange or facet.paths
                    or facet.labels or facet.HasField("script")
                    or facet.dim in filter_dims
                    or not _single_ordinal(facet.dim)):
                return None
            plan.append({"kind": "ordinal", "field": facet.dim})
            route.append(("facet", facet))
        for name, spec in collectors.items():
            which = spec.WhichOneof("Collectors")
            if spec.nestedCollectors:
                return None
            if which == "terms" and not spec.terms.HasField("script") \
                    and _single_ordinal(spec.terms.field):
                plan.append({"kind": "ordinal", "field": spec.terms.field})
            elif which in ("sum", "min", "max") and not getattr(
                spec, which
            ).HasField("script") and _single_numeric(
                getattr(spec, which).field
            ):
                plan.append({"kind": which, "field": getattr(spec, which).field})
            elif which == "hitCount":
                plan.append({"kind": "count", "field": None})
            else:
                return None
            route.append(("collector", name, which, spec))
        return plan, route

    def _fill_kernel_reduced(self, req, resp, route, red) -> None:
        for entry, r in zip(route, red):
            if entry[0] == "facet":
                facet = entry[1]
                fr = resp.facetResult.add()
                fr.name = facet.name or facet.dim
                fr.dim = facet.dim
                top_n = facet.topN or 10
                fr.childCount = len(r)
                fr.value = sum(r.values())
                for label, count in sorted(
                    r.items(), key=lambda kv: (-kv[1], kv[0])
                )[:top_n]:
                    lv = fr.labelValues.add()
                    lv.label = label
                    lv.value = count
                continue
            _, name, which, spec = entry
            result = resp.collectorResults[name]
            if which == "terms":
                size = spec.terms.size or 10
                ordered = sorted(r.items(), key=lambda kv: (-kv[1], kv[0]))
                for key, count in ordered[:size]:
                    b = result.bucketResult.buckets.add()
                    b.key = key
                    b.count = count
                result.bucketResult.totalBuckets = len(r)
                result.bucketResult.totalOtherCounts = sum(
                    c for _, c in ordered[size:]
                )
            elif which == "hitCount":
                result.hitCountResult.value = int(r)
            else:
                result.doubleResult.value = float(r)

    def _validate_collector_fields(self, specs, field_defs) -> None:
        for name, spec in specs.items():
            which = spec.WhichOneof("Collectors")
            field = None
            if which == "terms" and not spec.terms.HasField("script"):
                field = spec.terms.field
            elif which in ("max", "min", "sum") and not getattr(
                spec, which
            ).HasField("script"):
                field = getattr(spec, which).field
            if field:
                fd = field_defs.get(field)
                if fd is None:
                    raise ValueError(
                        f"collector {name!r}: unknown field {field!r}"
                    )
                if not fd.store_doc_values:
                    raise ValueError(
                        f"collector {name!r}: field {field!r} has no doc "
                        "values (storeDocValues=true required)"
                    )
            if spec.nestedCollectors:
                self._validate_collector_fields(
                    dict(spec.nestedCollectors), field_defs
                )

    def _run_collectors(self, specs, results_map, matches) -> None:
        # validate field references up-front: an unknown or docvalue-less
        # field fails the request loudly instead of returning empty buckets
        # (reference: CollectorCreator resolves FieldDef or throws,
        # server/search/collectors/CollectorCreator.java)
        field_defs = matches.searcher.field_defs
        self._validate_collector_fields(specs, field_defs)
        # fused pre-pass: every flat field-sourced reduction in this request
        # (terms counts, sum/min/max, hitCount) executes in ONE device call
        # per segment instead of one round trip per collector
        fused: dict[str, object] = {}
        plan, plan_names = [], []
        for name, spec in specs.items():
            which = spec.WhichOneof("Collectors")
            if which == "terms" and spec.terms.field and not \
                    spec.terms.HasField("script") and not spec.nestedCollectors:
                plan.append({"kind": "ordinal", "field": spec.terms.field})
            elif which in ("max", "min", "sum") and not \
                    getattr(spec, which).HasField("script"):
                plan.append({
                    "kind": "stat", "field": getattr(spec, which).field,
                    "op": which,
                })
            elif which == "hitCount":
                plan.append({"kind": "count"})
            else:
                continue
            plan_names.append(name)
        if len(plan) > 1:
            for name, res in zip(
                plan_names, coll.fused_flat_reductions(matches, plan)
            ):
                if res is not None:
                    fused[name] = res
        for name, spec in specs.items():
            result = results_map[name]
            which = spec.WhichOneof("Collectors")
            if which == "terms":
                if name in fused:
                    counts = fused[name]
                    size = spec.terms.size or 10
                    ordered = sorted(
                        counts.items(), key=lambda kv: (-kv[1], kv[0])
                    )
                    for key, count in ordered[:size]:
                        b = result.bucketResult.buckets.add()
                        b.key = key
                        b.count = count
                    result.bucketResult.totalBuckets = len(counts)
                    result.bucketResult.totalOtherCounts = sum(
                        c for _, c in ordered[size:]
                    )
                    continue
                field = spec.terms.field or None
                script = (
                    spec.terms.script.source if spec.terms.HasField("script") else None
                )
                if script is not None:
                    counts = self._script_terms_counts(matches, script)
                else:
                    counts = coll.terms_counts(matches, field)
                size = spec.terms.size or 10
                ordered = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
                for key, count in ordered[:size]:
                    b = result.bucketResult.buckets.add()
                    b.key = key
                    b.count = count
                    if spec.nestedCollectors:
                        sub = self._bucket_matches(matches, spec.terms.field, key)
                        self._run_collectors(
                            spec.nestedCollectors, b.nestedCollectorResults, sub
                        )
                result.bucketResult.totalBuckets = len(counts)
                result.bucketResult.totalOtherCounts = sum(
                    c for _, c in ordered[size:]
                )
            elif which in ("max", "min", "sum"):
                if name in fused:
                    result.doubleResult.value = fused[name]
                    continue
                sub = getattr(spec, which)
                script = sub.script.source if sub.HasField("script") else None
                result.doubleResult.value = coll.numeric_stat(
                    matches, sub.field or "", which, script
                )
            elif which == "hitCount":
                if name in fused:
                    result.hitCountResult.value = fused[name]
                    continue
                result.hitCountResult.value = coll.hit_count(matches)
            elif which == "pluginCollector":
                pc = spec.pluginCollector
                fn = (self.plugins.collectors.get(pc.name)
                      if self.plugins is not None else None)
                if fn is None:
                    raise ValueError(f"unknown plugin collector: {pc.name!r}")
                params = (MessageToDict(pc.params)
                          if pc.HasField("params") else {})
                out = fn(matches, params)
                from google.protobuf import struct_pb2

                st = struct_pb2.Struct()
                st.update(out or {})
                result.anyResult.Pack(st)
            elif which == "topHitsCollector":
                self._top_hits_collector(spec.topHitsCollector, result, matches)
            elif which == "filter":
                fq = spec.filter.query if spec.filter.HasField("query") else spec.filter.setQuery
                fnode = parse_query(MessageToDict(fq))
                fmasks = matches.searcher.match_masks(fnode)
                sub = matches.and_mask(fmasks)
                result.filterResult.docCount = coll.hit_count(sub)
                if spec.nestedCollectors:
                    self._run_collectors(
                        spec.nestedCollectors,
                        result.filterResult.nestedCollectorResults, sub,
                    )
            else:
                raise NotImplementedError(f"collector type {which!r}")

    def _top_hits_collector(self, spec, result, matches) -> None:
        """TopHitsCollector: top docs within the match set by score or by
        the FULL multi-key querySort (reference TopHitsCollectorManager
        honors every SortFields entry; ties break docid-ascending)."""
        from nrtsearch_tpu_torch.core.searcher import Hit as CoreHit

        searcher = matches.searcher
        candidates: list[tuple[tuple, CoreHit]] = []
        top_n = (spec.topHits or 10)
        sort_fields: list[tuple[str, bool]] = []
        if spec.HasField("querySort") and spec.querySort.fields.sortedFields:
            sort_fields = [
                (sf.fieldName, bool(sf.reverse))
                for sf in spec.querySort.fields.sortedFields
            ]
        total = 0
        for idx, (seg, mask) in enumerate(zip(searcher.segments, matches.masks)):
            m = mask[: seg.num_docs]
            ids = np.nonzero(m)[0]
            total += len(ids)
            if len(ids) == 0:
                continue
            if sort_fields:
                # ascending-normalized key columns (reverse keys negate), so
                # one lexicographic ascending sort ranks all components
                keys = []
                for fname, rev in sort_fields:
                    dv = seg.doc_values.get(fname)
                    kcol = (
                        dv.host_values[ids].astype(np.float64)
                        if dv is not None
                        else np.zeros(len(ids))
                    )
                    keys.append(-kcol if rev else kcol)
                # np.lexsort: LAST key is primary; docid breaks ties
                order = np.lexsort((ids,) + tuple(reversed(keys)))[:top_n]
                sel_keys = [tuple(float(kc[o]) for kc in keys) for o in order]
                # reported hit score = first sort key's real value
                disp = [
                    -kt[0] if sort_fields[0][1] else kt[0] for kt in sel_keys
                ]
            else:
                scores = (
                    matches.scores[idx][: seg.num_docs][ids]
                    if matches.scores is not None
                    else np.zeros(len(ids))
                )
                order = np.argsort(-scores, kind="stable")[:top_n]
                sel_keys = [(-float(scores[o]),) for o in order]
                disp = [float(scores[o]) for o in order]
            base = int(searcher.bases[idx])
            for o, kt, dv_ in zip(order, sel_keys, disp):
                candidates.append(
                    (kt, CoreHit(idx, int(ids[o]), base + int(ids[o]), float(dv_)))
                )
        candidates.sort(key=lambda kh: (kh[0], kh[1].global_ord))
        hr = result.hitsResult
        hr.totalHits.value = total
        rt_fields = None
        for _, h in candidates[int(spec.startHit) : int(spec.startHit) + top_n]:
            pb_hit = hr.hits.add()
            pb_hit.luceneDocId = h.global_ord
            pb_hit.score = h.score
            if spec.retrieveFields:
                if rt_fields is None:
                    rt_fields = searcher.field_defs
                fill_hit_fields_pb(
                    pb_hit, searcher, h, list(spec.retrieveFields), rt_fields, pb
                )

    def _script_terms_counts(self, matches, script: str) -> dict[str, int]:
        from collections import defaultdict

        from nrtsearch_tpu_torch.query.eval import _ScriptDocValues
        from nrtsearch_tpu_torch.script.expr import compile_expression

        out = defaultdict(int)
        fn = compile_expression(script)
        for seg, mask in zip(matches.searcher.segments, matches.masks):
            vals = np.asarray(fn(_ScriptDocValues(seg), np.zeros(seg.capacity, np.float32)))
            m = mask[: seg.num_docs]
            uniq, counts = np.unique(vals[: seg.num_docs][m], return_counts=True)
            for v, c in zip(uniq, counts):
                out[coll._fmt_num(v)] += int(c)
        return dict(out)

    def _bucket_matches(self, matches, field: str, key: str):
        """Narrow matches to docs whose `field` == key (for nested collectors)."""
        new_masks = []
        for seg, mask in zip(matches.searcher.segments, matches.masks):
            dv = seg.doc_values.get(field)
            m = np.zeros_like(mask)
            if dv is not None:
                if dv.ord_terms is not None and dv.ord_index is not None:
                    o = dv.ord_index.get(key, -2)
                    if dv.mv_offsets is not None:
                        docs = np.repeat(
                            np.arange(seg.num_docs), np.diff(dv.mv_offsets)
                        )
                        hit_docs = np.unique(docs[dv.mv_values == o])
                        m[hit_docs] = True
                    else:
                        m[: seg.num_docs] = dv.host_values[: seg.num_docs] == o
                else:
                    m[: seg.num_docs] = dv.host_values[: seg.num_docs] == float(key)
            new_masks.append(mask & m)
        return coll.SegmentMatches(matches.searcher, new_masks, matches.scores)


def _dict_to_struct(d: dict, struct_msg) -> None:
    """Copy a plain dict into a google.protobuf.Struct field."""
    from google.protobuf.json_format import ParseDict

    try:
        ParseDict(d or {}, struct_msg)
    except Exception:
        pass  # non-JSON-able values: leave the struct empty


def _dict_to_pb(d: dict, msg) -> None:
    """Copy known keys from a proto-JSON-shaped dict into a pb message."""
    from google.protobuf.json_format import ParseDict

    for field in msg.DESCRIPTOR.fields:
        if field.name not in d or d[field.name] is None:
            continue
        value = d[field.name]
        if field.type == field.TYPE_MESSAGE:
            try:
                ParseDict(value, getattr(msg, field.name))
            except Exception:
                pass
            continue
        try:
            setattr(msg, field.name, type(getattr(msg, field.name))(value))
        except (TypeError, ValueError):
            pass


def _needs_array_scores(req) -> bool:
    """True when any facet/collector of this request reads per-doc SCORES
    from the match arrays (topHits sub-collections, script sources that can
    reference _score); mask-only consumers let recall skip the dense score
    materialization entirely (Searcher.search arrays_score_free)."""
    def walk(specs) -> bool:
        for spec in specs.values():
            which = spec.WhichOneof("Collectors")
            if which == "topHitsCollector":
                return True
            if which == "terms" and spec.terms.HasField("script"):
                return True
            if which in ("max", "min", "sum") and getattr(
                spec, which
            ).HasField("script"):
                return True
            if spec.nestedCollectors and walk(spec.nestedCollectors):
                return True
        return False

    if walk(req.collectors):
        return True
    for facet in req.facets:
        if facet.HasField("script"):
            return True
    return False
