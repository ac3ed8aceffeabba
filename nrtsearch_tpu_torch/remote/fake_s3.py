"""Copy of ``nrtsearch_tpu/remote/fake_s3.py``, kept whole, its imports pointed
at the port.

In-process fake S3 HTTP server for tests (the S3Mock analogue).

The reference tests all remote/backup/restore paths against findify S3Mock
with a file backend (AmazonS3Provider.java:92). This is the same idea in
~150 lines of stdlib: a ThreadingHTTPServer implementing the S3 REST subset
the client uses — object GET/PUT/HEAD/DELETE, ListObjectsV2, and multipart
upload. Signatures are accepted without validation, like S3Mock.
"""

from __future__ import annotations

import threading
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape


class _Store:
    def __init__(self):
        self.objects: dict[str, bytes] = {}          # bucket/key -> data
        self.uploads: dict[str, dict[int, bytes]] = {}  # uploadId -> parts
        self.upload_keys: dict[str, str] = {}
        self.lock = threading.Lock()


def _make_handler(store: _Store):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _split(self):
            u = urllib.parse.urlparse(self.path)
            parts = u.path.lstrip("/").split("/", 1)
            bucket = parts[0]
            key = parts[1] if len(parts) > 1 else ""
            query = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
            return bucket, key, query

        def _reply(self, status: int, body: bytes = b"",
                   content_type: str = "application/xml"):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def do_PUT(self):
            bucket, key, q = self._split()
            data = self._body()
            with store.lock:
                if "uploadId" in q:
                    parts = store.uploads.get(q["uploadId"])
                    if parts is None:
                        return self._reply(404, b"<Error>NoSuchUpload</Error>")
                    parts[int(q["partNumber"])] = data
                else:
                    store.objects[f"{bucket}/{key}"] = data
            self._reply(200)

        def do_POST(self):
            bucket, key, q = self._split()
            body = self._body()  # must drain
            with store.lock:
                if "uploads" in q:
                    upload_id = uuid.uuid4().hex
                    store.uploads[upload_id] = {}
                    store.upload_keys[upload_id] = f"{bucket}/{key}"
                    xml = (
                        f"<InitiateMultipartUploadResult>"
                        f"<Bucket>{escape(bucket)}</Bucket>"
                        f"<Key>{escape(key)}</Key>"
                        f"<UploadId>{upload_id}</UploadId>"
                        f"</InitiateMultipartUploadResult>"
                    )
                    return self._reply(200, xml.encode())
                if "uploadId" in q:
                    uid = q["uploadId"]
                    parts = store.uploads.pop(uid, None)
                    full_key = store.upload_keys.pop(uid, None)
                    if parts is None or full_key is None:
                        return self._reply(404, b"<Error>NoSuchUpload</Error>")
                    store.objects[full_key] = b"".join(
                        parts[n] for n in sorted(parts)
                    )
                    return self._reply(
                        200, b"<CompleteMultipartUploadResult/>"
                    )
            self._reply(400, b"<Error>BadRequest</Error>")

        def do_GET(self):
            bucket, key, q = self._split()
            with store.lock:
                if not key and "list-type" in q:
                    prefix = q.get("prefix", "")
                    keys = sorted(
                        k[len(bucket) + 1:]
                        for k in store.objects
                        if k.startswith(f"{bucket}/{prefix}")
                    )
                    items = "".join(
                        f"<Contents><Key>{escape(k)}</Key></Contents>" for k in keys
                    )
                    xml = (
                        f"<ListBucketResult><IsTruncated>false</IsTruncated>"
                        f"{items}</ListBucketResult>"
                    )
                    return self._reply(200, xml.encode())
                data = store.objects.get(f"{bucket}/{key}")
            if data is None:
                return self._reply(404, b"<Error>NoSuchKey</Error>")
            self._reply(200, data, content_type="application/octet-stream")

        def do_HEAD(self):
            bucket, key, _ = self._split()
            with store.lock:
                exists = f"{bucket}/{key}" in store.objects
            self._reply(200 if exists else 404)

        def do_DELETE(self):
            bucket, key, q = self._split()
            with store.lock:
                if "uploadId" in q:
                    store.uploads.pop(q["uploadId"], None)
                    store.upload_keys.pop(q["uploadId"], None)
                else:
                    store.objects.pop(f"{bucket}/{key}", None)
            self._reply(204)

    return Handler


class FakeS3Server:
    """Run with: server = FakeS3Server(); server.start() -> endpoint url."""

    def __init__(self):
        self.store = _Store()
        self._httpd = None
        self._thread = None
        self.port = None

    def start(self) -> str:
        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), _make_handler(self.store)
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
