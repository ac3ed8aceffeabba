"""Copy of ``nrtsearch_tpu/state/global_state.py`` that carries the device:
``GlobalState(config, backend, remote=..., device=...)`` starts every index
runtime on that device, in each of the reference's modes (STANDALONE,
PRIMARY, REPLICA).

GlobalState: the cluster-level index registry.

Reference: server/state/GlobalState.java:44 / BackendGlobalState.java:63.
Holds index name -> (index id, IndexStateInfo, IndexRuntime); persists the
registry and per-index state through a StateBackend; auto-restarts indices
flagged started (warm boot, BackendGlobalState.updateStartedIndices
equivalent).
"""

from __future__ import annotations

import json
import threading
import uuid
from pathlib import Path
from typing import Optional

import torch

from nrtsearch_tpu_torch.config import NrtsearchConfig
from nrtsearch_tpu_torch.remote.backend import RemoteBackend
from nrtsearch_tpu_torch.server.index_runtime import IndexRuntime
from nrtsearch_tpu_torch.state.backend import StateBackend
from nrtsearch_tpu_torch.state.index_state import IndexStateInfo


class GlobalState:
    def __init__(
        self,
        config: NrtsearchConfig,
        state_backend: StateBackend,
        remote: Optional[RemoteBackend] = None,
        *,
        device: str | torch.device,
    ):
        from nrtsearch_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.config = config
        self.backend = state_backend
        self.remote = remote
        # node ephemeral id (reference: GlobalState.getEphemeralId — changes
        # on every process start; exposed via nodeInfo, detects restarts)
        self.ephemeral_id = uuid.uuid4().hex
        self._lock = threading.RLock()
        self.index_ids: dict[str, str] = {}      # name -> unique index id
        self.states: dict[str, IndexStateInfo] = {}
        self.runtimes: dict[str, IndexRuntime] = {}
        # set by NrtsearchServer when push replication is enabled:
        # on_nrt_point(index_name, point) — primary publish hook;
        # connect_replica(index_name, rt, primary_address) — replica bootstrap
        self.on_nrt_point = None
        self.connect_replica = None
        self._load()

    # -- persistence -------------------------------------------------------------

    def _load(self) -> None:
        raw = self.backend.load_global_state()
        if raw is None:
            return
        data = json.loads(raw)
        self.index_ids = dict(data.get("indices", {}))
        for name, index_id in self.index_ids.items():
            s = self.backend.load_index_state(index_id)
            if s is not None:
                self.states[name] = IndexStateInfo.from_json(s)

    def _store_global(self) -> None:
        self.backend.store_global_state(json.dumps({"indices": self.index_ids}))

    def _store_index(self, name: str) -> None:
        info = self.states[name]
        self.backend.store_index_state(info.index_id, info.to_json())

    # started roles are NODE-local (the same index is PRIMARY on one node and
    # REPLICA on others), so they live beside — not inside — the shared index
    # state (reference: the node's IndexStartConfig determines its role)
    def _started_file(self) -> Path:
        return Path(self.config.state_dir) / f"node_{self.config.node_name}_started.json"

    def _load_started(self) -> dict:
        p = self._started_file()
        return json.loads(p.read_text()) if p.exists() else {}

    def _store_started(self, name: str, mode: Optional[str]) -> None:
        started = self._load_started()
        if mode is None:
            started.pop(name, None)
        else:
            started[name] = mode
        p = self._started_file()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(started))

    def warm_boot(self) -> None:
        """Auto-start indices this node had started when it went down."""
        for name, mode in self._load_started().items():
            if name in self.states:
                try:
                    self.start_index(name, mode, restore=True)
                except Exception:
                    pass

    # -- index lifecycle ------------------------------------------------------------

    def create_index(self, name: str, exists_with_id: bool = False) -> IndexStateInfo:
        with self._lock:
            if name in self.index_ids:
                raise FileExistsError(f"index {name!r} already exists")
            # unique index name: <name>-<uuid> (BackendGlobalState.getUniqueIndexName:95)
            index_id = f"{name}-{uuid.uuid4().hex[:12]}"
            info = IndexStateInfo(index_name=name, index_id=index_id)
            self.index_ids[name] = index_id
            self.states[name] = info
            self._store_index(name)
            self._store_global()
            return info

    def delete_index(self, name: str) -> None:
        with self._lock:
            self._require(name)
            rt = self.runtimes.pop(name, None)
            if rt is not None:
                rt.stop()
            del self.index_ids[name]
            del self.states[name]
            self._store_global()

    def get_state(self, name: str) -> IndexStateInfo:
        self._require(name)
        return self.states[name]

    def update_state(self, name: str, info: IndexStateInfo) -> None:
        with self._lock:
            self.states[name] = info
            self._store_index(name)

    def register_fields(self, name: str, fields: dict[str, dict]) -> IndexStateInfo:
        with self._lock:
            info = self.get_state(name).with_fields(fields)
            self.update_state(name, info)
            rt = self.runtimes.get(name)
            if rt is not None and rt.writer.buffered_docs == 0 and not rt.writer.segments:
                # index started but empty: runtime can adopt the new schema
                rt.state_info = info
                rt.field_defs = info.field_defs()
                rt.writer.field_defs = rt.field_defs
                rt.writer.id_field = next(
                    (n for n, f in rt.field_defs.items() if f.type.value == "_ID"), None
                )
            return info

    def update_fields(self, name: str, fields: dict[str, dict]) -> IndexStateInfo:
        """Schema evolution: add NEW fields to a (possibly running) index
        (reference: UpdateFieldsHandler + FieldUpdateUtils — existing fields
        cannot be redefined). A running runtime adopts the new defs in place,
        so its writer and live searchers see them immediately; existing
        segments simply have no data for the new fields."""
        with self._lock:
            info = self.get_state(name).with_fields(fields)  # raises on dup
            self.update_state(name, info)
            rt = self.runtimes.get(name)
            if rt is not None:
                rt.state_info = info
                with rt.writer._lock:
                    for fname, fd in info.field_defs().items():
                        if fname not in rt.field_defs:
                            rt.field_defs[fname] = fd
                        # the active SegmentBuilder snapshots the dict (it
                        # injects the nested-path field), so push new defs
                        # into it as well
                        builder = rt.writer._builder
                        if builder is not None and fname not in builder.field_defs:
                            builder.field_defs[fname] = fd
            return info

    def reload(self) -> None:
        """Re-read global + per-index state from the state backend
        (reference: ReloadStateHandler — replicas pick up state the primary
        published). Running runtimes adopt updated live settings and any new
        fields in place."""
        with self._lock:
            self._load()
            for name, rt in self.runtimes.items():
                info = self.states.get(name)
                if info is None:
                    continue
                rt.state_info = info
                rt.apply_live_settings(info.live_settings)
                for fname, fd in info.field_defs().items():
                    if fname not in rt.field_defs:
                        rt.field_defs[fname] = fd

    def start_index(
        self,
        name: str,
        mode: str = "STANDALONE",
        restore: bool = False,
        primary_gen: int = 0,
        primary_address: str = "",
    ) -> IndexRuntime:
        with self._lock:
            self._require(name)
            if name in self.runtimes:
                raise RuntimeError(f"index {name!r} already started")
            info = self.states[name]
            index_dir = Path(self.config.index_dir) / info.index_id
            on_point = None
            if mode == "PRIMARY" and self.on_nrt_point is not None:
                hook = self.on_nrt_point

                def on_point(point, _name=name):
                    hook(_name, point)

            rt = IndexRuntime(
                state_info=info,
                index_dir=index_dir,
                mode=mode,
                remote=self.remote,
                service_name=self.config.service_name,
                primary_gen=primary_gen,
                on_nrt_point=on_point,
                device=self.device,
            )
            rt.start(restore=restore)
            self.runtimes[name] = rt
            self._store_started(name, mode)
            if mode == "REPLICA" and primary_address and self.connect_replica:
                self.connect_replica(name, rt, primary_address)
            return rt

    def stop_index(self, name: str) -> None:
        with self._lock:
            self._require(name)
            rt = self.runtimes.pop(name, None)
            if rt is not None:
                rt.stop()
            self._store_started(name, None)

    def get_runtime(self, name: str) -> IndexRuntime:
        self._require(name)
        rt = self.runtimes.get(name)
        if rt is None:
            raise RuntimeError(f"index {name!r} is not started")
        return rt

    def _require(self, name: str) -> None:
        if name not in self.index_ids:
            # a shared state backend may have gained the index after our boot
            # (e.g. primary created it while this replica was already up)
            with self._lock:
                self._load()
        if name not in self.index_ids:
            raise KeyError(f"index {name!r} does not exist")

    def close(self) -> None:
        for rt in self.runtimes.values():
            rt.stop()
