"""Copy of ``nrtsearch_tpu/remote/s3.py``, kept whole, its imports pointed at
the port.

S3-backed RemoteBackend: the production object store.

Reference: server/remote/s3/S3Backend.java:81 — versioned blobs with a
``_current`` pointer (:94), immutable index data files, multipart transfer
for large files (:113), throttled downloads (GlobalThrottledInputStream).
Same key layout as LocalFileBackend so both pass one contract suite
(tests/test_remote_contract.py):

    <service>/<resource>/_version/<n>        versioned blob data
    <service>/<resource>/_current            pointer file: latest version n
    <service>/<index_id>/data/<file>         immutable index files
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional

from nrtsearch_tpu_torch.remote.backend import RemoteBackend
from nrtsearch_tpu_torch.remote.s3_client import S3Client


class S3Backend(RemoteBackend):
    def __init__(self, client: S3Client):
        self.s3 = client
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, config) -> "S3Backend":
        raw = getattr(config, "raw", {}) or {}
        s3cfg = raw.get("s3", {})
        return cls(S3Client(
            bucket=config.bucket_name,
            region=str(s3cfg.get("region", "us-east-1")),
            access_key=s3cfg.get("accessKey"),
            secret_key=s3cfg.get("secretKey"),
            endpoint=s3cfg.get("endpoint"),
            max_download_mb_per_sec=float(s3cfg.get("maxDownloadMBPerSec", 0.0)),
        ))

    # -- versioned blobs ------------------------------------------------------

    def upload_versioned(self, service: str, resource: str, data: bytes) -> int:
        with self._lock:
            cur = self.current_version(service, resource)
            version = 0 if cur is None else cur + 1
            self.s3.put_object(f"{service}/{resource}/_version/{version}", data)
            # pointer write is last: a reader never sees a version without data
            self.s3.put_object(
                f"{service}/{resource}/_current", str(version).encode()
            )
            return version

    def download_current(self, service: str, resource: str) -> Optional[bytes]:
        v = self.current_version(service, resource)
        if v is None:
            return None
        return self.s3.get_object(f"{service}/{resource}/_version/{v}")

    def current_version(self, service: str, resource: str) -> Optional[int]:
        data = self.s3.get_object(f"{service}/{resource}/_current")
        if data is None:
            return None
        return int(data.decode().strip())

    # -- index data files --------------------------------------------------------

    def _data_key(self, service: str, index_id: str, name: str) -> str:
        return f"{service}/{index_id}/data/{name}"

    def upload_index_files(
        self, service: str, index_id: str, src_dir: str | Path, file_names: list[str]
    ) -> None:
        for name in file_names:
            self.s3.put_file(
                self._data_key(service, index_id, name), Path(src_dir) / name
            )

    def download_index_files(
        self, service: str, index_id: str, dst_dir: str | Path, file_names: list[str]
    ) -> None:
        Path(dst_dir).mkdir(parents=True, exist_ok=True)
        for name in file_names:
            ok = self.s3.get_to_file(
                self._data_key(service, index_id, name), Path(dst_dir) / name
            )
            if not ok:
                raise FileNotFoundError(
                    f"s3://{self.s3.bucket}/{self._data_key(service, index_id, name)}"
                )

    def index_file_exists(self, service: str, index_id: str, file_name: str) -> bool:
        return self.s3.head_object(self._data_key(service, index_id, file_name))

    def index_file_mtime(self, service: str, index_id: str, file_name: str):
        return self.s3.head_object_mtime(
            self._data_key(service, index_id, file_name)
        )

    def delete_index_files(
        self, service: str, index_id: str, file_names: list[str]
    ) -> None:
        for name in file_names:
            self.s3.delete_object(self._data_key(service, index_id, name))

    # -- listing (ops tooling) -------------------------------------------------

    def list_resources(self, service: str, prefix: str = "") -> list[str]:
        keys = self.s3.list_objects(f"{service}/{prefix}")
        out = set()
        base = len(service) + 1
        for k in keys:
            if k.endswith("/_current"):
                out.add(k[base : -len("/_current")])
        return sorted(out)

    def list_index_files(self, service: str, index_id: str) -> list[str]:
        pre = f"{service}/{index_id}/data/"
        return sorted(k[len(pre):] for k in self.s3.list_objects(pre))

    def list_resource_versions(self, service: str, resource: str) -> list[int]:
        pre = f"{service}/{resource}/_version/"
        out = []
        for k in self.s3.list_objects(pre):
            tail = k[len(pre):]
            if tail.isdigit():
                out.append(int(tail))
        return sorted(out)
