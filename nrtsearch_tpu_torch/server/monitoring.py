"""Copy of ``nrtsearch_tpu/server/monitoring.py``, kept whole but for the
serving path's gauge and two histograms: the gauge takes its route from
``core/packed_view.fast_path`` on the device the node's indexes live on
(``GlobalState.device``) where the reference asks whether JAX runs on a
TPU, and the micro-batcher's group sizes and queue waits
(``server/batcher.py``) have histograms of their own.

Prometheus metrics.

Reference: server/monitoring/ (19 collectors, 2,031 LoC; registered at
NrtsearchServer.java:255-281) — per-RPC latency/counts via a server
interceptor, index metrics (docs/segments/searcher age), NRT metrics (point
lag, copy bytes), and the /metrics surface exposed through an RPC returning
the text exposition format (MetricsHandler equivalent).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class Metrics:
    """Per-server metrics registry (one per NrtsearchServer)."""

    def __init__(self, global_state=None):
        self.registry = CollectorRegistry()
        self.global_state = global_state
        self.rpc_latency = Histogram(
            "grpc_server_handled_latency_seconds",
            "gRPC handler latency",
            ["method"],
            registry=self.registry,
            buckets=_BUCKETS,
        )
        self.rpc_count = Counter(
            "grpc_server_handled_total",
            "gRPC calls handled",
            ["method", "code"],
            registry=self.registry,
        )
        self.indexing_docs = Counter(
            "nrt_indexing_docs_total",
            "documents indexed",
            ["index"],
            registry=self.registry,
        )
        self.search_hits = Counter(
            "nrt_search_total_hits",
            "total hits returned",
            ["index"],
            registry=self.registry,
        )
        self.nrt_point_version = Gauge(
            "nrt_current_point_version",
            "current searcher version",
            ["index"],
            registry=self.registry,
        )
        # which fast-path contract this deployment serves (ADVICE r4: the
        # TPU dense default quantizes head impacts through bf16 and returns
        # pruned totalHits as lower bounds; operators must be able to tell).
        # Gauge set to 1 on the active path label at scrape.
        self.fast_path = Gauge(
            "nrt_search_fast_path",
            "active batched-search fast path (1 = serving default)",
            ["path"],
            registry=self.registry,
        )
        self.copy_bytes = Counter(
            "nrt_replication_copied_bytes_total",
            "bytes copied by replication",
            ["index"],
            registry=self.registry,
        )
        # live index gauges (numDocs / segments / searcher age) collected at
        # scrape time via a custom collector
        self._index_gauges = Gauge(
            "nrt_index_num_docs", "live docs", ["index"], registry=self.registry
        )
        self._segment_gauges = Gauge(
            "nrt_index_num_segments", "segments", ["index"], registry=self.registry
        )
        self._buffered_gauges = Gauge(
            "nrt_index_buffered_docs", "buffered docs", ["index"],
            registry=self.registry,
        )
        # searcher age since publish (reference: SearchResponseCollector)
        self._searcher_age = Gauge(
            "nrt_searcher_age_seconds", "seconds since current searcher publish",
            ["index"], registry=self.registry,
        )
        # merge scheduler activity (reference: MergeSchedulerCollector)
        self._merges = Gauge(
            "nrt_index_merges", "merges completed", ["index"],
            registry=self.registry,
        )
        self._merged_docs = Gauge(
            "nrt_index_merged_docs", "docs rewritten by merges", ["index"],
            registry=self.registry,
        )
        self._merge_seconds = Gauge(
            "nrt_index_merge_seconds", "wall seconds spent merging", ["index"],
            registry=self.registry,
        )
        # per-stage search timing (reference: SearchHandler Diagnostics ->
        # nrt_search_timing families)
        self.search_stage_latency = Histogram(
            "nrt_search_stage_latency_seconds",
            "per-stage search latency",
            ["index", "stage"],
            registry=self.registry,
            buckets=_BUCKETS,
        )
        # the micro-batcher (server/batcher.py): queries per dispatched
        # group, and each query's wait from its enqueue to its group's
        # dispatch
        self.batcher_group_size = Histogram(
            "nrt_batcher_group_size",
            "queries per micro-batcher group",
            registry=self.registry,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
        )
        self.batcher_wait = Histogram(
            "nrt_batcher_wait_seconds",
            "per query, from the batcher's enqueue to its group's dispatch",
            registry=self.registry,
            buckets=_BUCKETS,
        )
        # thread-pool accounting (reference: ThreadPoolCollector)
        self._pool_submitted = Gauge(
            "nrt_pool_tasks_submitted", "tasks submitted", ["pool"],
            registry=self.registry,
        )
        self._pool_rejected = Gauge(
            "nrt_pool_tasks_rejected", "tasks rejected to caller-runs",
            ["pool"], registry=self.registry,
        )
        self._pool_queue = Gauge(
            "nrt_pool_queue_depth", "queued tasks", ["pool"],
            registry=self.registry,
        )
        # process stats (reference: ProcStatCollector)
        self._proc_rss = Gauge(
            "process_resident_memory_bytes", "resident set size",
            registry=self.registry,
        )
        self._proc_cpu = Gauge(
            "process_cpu_seconds_total", "user+system CPU seconds",
            registry=self.registry,
        )

    def observe_rpc(self, method: str, seconds: float, code: str = "OK") -> None:
        self.rpc_latency.labels(method).observe(seconds)
        self.rpc_count.labels(method, code).inc()

    def observe_search_stage(self, index: str, stage: str, seconds: float) -> None:
        self.search_stage_latency.labels(index, stage).observe(seconds)

    def scrape(self) -> str:
        from nrtsearch_tpu_torch.core.packed_view import fast_path

        on_cuda = getattr(getattr(self.global_state, "device", None), "type", "") == "cuda"
        active = fast_path(on_cuda)
        for p in ("dense", "merge", "bucket"):
            self.fast_path.labels(p).set(1.0 if p == active else 0.0)
        if self.global_state is not None:
            for name, rt in list(self.global_state.runtimes.items()):
                st = rt.stats()
                self._index_gauges.labels(name).set(st["numDocs"])
                self._segment_gauges.labels(name).set(st["numSegments"])
                self._buffered_gauges.labels(name).set(st["bufferedDocs"])
                self.nrt_point_version.labels(name).set(st["version"])
                self._searcher_age.labels(name).set(st.get("searcherAgeSec", 0.0))
                self._merges.labels(name).set(st.get("merges", 0))
                self._merged_docs.labels(name).set(st.get("merged_docs", 0))
                self._merge_seconds.labels(name).set(st.get("merge_seconds", 0.0))
        from nrtsearch_tpu_torch.server.concurrent import ExecutorFactory

        for pool, ps in ExecutorFactory.get().stats().items():
            self._pool_submitted.labels(pool).set(ps["submitted"])
            self._pool_rejected.labels(pool).set(ps["rejected"])
            self._pool_queue.labels(pool).set(ps["queue_depth"])
        try:
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF)
            # CURRENT resident memory (Prometheus convention for
            # process_resident_memory_bytes), not ru_maxrss's lifetime peak
            with open("/proc/self/statm") as f:
                rss_pages = int(f.read().split()[1])
            self._proc_rss.set(rss_pages * os.sysconf("SC_PAGESIZE"))
            self._proc_cpu.set(ru.ru_utime + ru.ru_stime)
        except Exception:
            pass
        return generate_latest(self.registry).decode()
