"""Copy of ``nrtsearch_tpu/remote/s3_client.py``, kept whole, its imports
pointed at the port.

Minimal S3 REST client: pure stdlib, AWS Signature V4.

The reference uses the AWS SDK v2 + CRT transfer manager
(S3Backend.java:81,113). boto3 is not available in this environment, so this
is a from-scratch implementation of the S3 wire protocol over http.client:

- SigV4 request signing (AWS4-HMAC-SHA256, path-style addressing)
- GET/PUT/HEAD/DELETE object, ListObjectsV2
- multipart upload for large files (the transfer-manager analogue)
- token-bucket download throttling (GlobalThrottledInputStream analogue)

Works against real S3-compatible endpoints and the in-process fake
(remote/fake_s3.py) used by the contract tests, which mirrors the
reference's S3Mock-based AmazonS3Provider.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import os
import time
import urllib.parse
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Optional

MULTIPART_THRESHOLD = 64 * 1024 * 1024
PART_SIZE = 32 * 1024 * 1024
_CHUNK = 1 << 20


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3Error(IOError):
    def __init__(self, status: int, body: bytes = b""):
        super().__init__(f"S3 error {status}: {body[:300]!r}")
        self.status = status


class S3Client:
    def __init__(
        self,
        bucket: str,
        region: str = "us-east-1",
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        endpoint: Optional[str] = None,   # e.g. "http://localhost:9999"
        session_token: Optional[str] = None,
        max_download_mb_per_sec: float = 0.0,
    ):
        self.bucket = bucket
        self.region = region
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "anon")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "anon")
        self.session_token = session_token or os.environ.get("AWS_SESSION_TOKEN")
        if endpoint is None:
            endpoint = f"https://s3.{region}.amazonaws.com"
        u = urllib.parse.urlparse(endpoint)
        self.secure = u.scheme == "https"
        self.host = u.hostname
        self.port = u.port or (443 if self.secure else 80)
        self.max_download_rate = max_download_mb_per_sec * 1024 * 1024

    # -- signing ----------------------------------------------------------------

    def _sign(self, method: str, path: str, query: dict, headers: dict,
              payload_hash: str) -> dict:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host_hdr = self.host if self.port in (80, 443) else f"{self.host}:{self.port}"
        headers = dict(headers)
        headers["host"] = host_hdr
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        canonical_qs = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(str(v), safe='')}"
            for k, v in sorted(query.items())
        )
        signed = sorted(headers)
        canonical_headers = "".join(f"{k}:{headers[k].strip()}\n" for k in signed)
        canonical = "\n".join([
            method,
            urllib.parse.quote(path),
            canonical_qs,
            canonical_headers,
            ";".join(signed),
            payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope, _sha256(canonical.encode()),
        ])
        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={signature}"
        )
        return headers

    # -- low-level request ---------------------------------------------------------

    def _request(self, method: str, key: str = "", query: Optional[dict] = None,
                 body: bytes = b"", stream: bool = False):
        query = query or {}
        path = f"/{self.bucket}" + (f"/{key}" if key else "")
        payload_hash = _sha256(body)
        headers = self._sign(method, path, query, {}, payload_hash)
        if body:
            headers["content-length"] = str(len(body))
        conn_cls = http.client.HTTPSConnection if self.secure else http.client.HTTPConnection
        conn = conn_cls(self.host, self.port, timeout=120)
        qs = urllib.parse.urlencode(query)
        try:
            conn.request(method, path + (f"?{qs}" if qs else ""), body=body,
                         headers=headers)
            resp = conn.getresponse()
            if stream:
                return conn, resp
            data = resp.read()
            conn.close()
            return resp.status, data
        except Exception:
            conn.close()
            raise

    # -- object API -------------------------------------------------------------------

    def put_object(self, key: str, data: bytes) -> None:
        status, body = self._request("PUT", key, body=data)
        if status >= 300:
            raise S3Error(status, body)

    def put_file(self, key: str, path: str | Path) -> None:
        """Upload a file; large files go through multipart (transfer-manager
        analogue, S3Backend.java:113)."""
        size = Path(path).stat().st_size
        if size < MULTIPART_THRESHOLD:
            self.put_object(key, Path(path).read_bytes())
            return
        upload_id = self._initiate_multipart(key)
        etags = []
        try:
            with open(path, "rb") as f:
                part = 1
                while True:
                    chunk = f.read(PART_SIZE)
                    if not chunk:
                        break
                    status, body = self._request(
                        "PUT", key,
                        query={"partNumber": part, "uploadId": upload_id},
                        body=chunk,
                    )
                    if status >= 300:
                        raise S3Error(status, body)
                    etags.append((part, _sha256(chunk)))
                    part += 1
            self._complete_multipart(key, upload_id, etags)
        except Exception:
            self._request("DELETE", key, query={"uploadId": upload_id})
            raise

    def _initiate_multipart(self, key: str) -> str:
        status, body = self._request("POST", key, query={"uploads": ""})
        if status >= 300:
            raise S3Error(status, body)
        root = ET.fromstring(body)
        for el in root.iter():
            if el.tag.endswith("UploadId"):
                return el.text
        raise S3Error(status, body)

    def _complete_multipart(self, key: str, upload_id: str, etags) -> None:
        parts_xml = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
            for n, e in etags
        )
        body = f"<CompleteMultipartUpload>{parts_xml}</CompleteMultipartUpload>".encode()
        status, resp = self._request(
            "POST", key, query={"uploadId": upload_id}, body=body
        )
        if status >= 300:
            raise S3Error(status, resp)

    def get_object(self, key: str) -> Optional[bytes]:
        status, data = self._request("GET", key)
        if status == 404:
            return None
        if status >= 300:
            raise S3Error(status, data)
        return data

    def get_to_file(self, key: str, path: str | Path) -> bool:
        """Streamed download with optional token-bucket throttling."""
        conn, resp = self._request("GET", key, stream=True)
        try:
            if resp.status == 404:
                return False
            if resp.status >= 300:
                raise S3Error(resp.status, resp.read())
            start = time.monotonic()
            got = 0
            tmp = Path(str(path) + ".s3tmp")
            with open(tmp, "wb") as f:
                while True:
                    chunk = resp.read(_CHUNK)
                    if not chunk:
                        break
                    f.write(chunk)
                    got += len(chunk)
                    if self.max_download_rate > 0:
                        ahead = got / self.max_download_rate - (
                            time.monotonic() - start
                        )
                        if ahead > 0:
                            time.sleep(ahead)
            tmp.replace(path)
            return True
        finally:
            conn.close()

    def head_object(self, key: str) -> bool:
        status, _ = self._request("HEAD", key)
        return status < 300

    def head_object_mtime(self, key: str):
        """Last-Modified of an object as epoch seconds, or None."""
        conn, resp = self._request("HEAD", key, stream=True)
        try:
            resp.read()
            if resp.status >= 300:
                return None
            lm = resp.getheader("Last-Modified")
            if not lm:
                return None
            from email.utils import parsedate_to_datetime

            return parsedate_to_datetime(lm).timestamp()
        except Exception:
            return None
        finally:
            conn.close()

    def delete_object(self, key: str) -> None:
        self._request("DELETE", key)

    def list_objects(self, prefix: str) -> list[str]:
        keys = []
        token = None
        while True:
            q = {"list-type": "2", "prefix": prefix}
            if token:
                q["continuation-token"] = token
            status, body = self._request("GET", "", query=q)
            if status >= 300:
                raise S3Error(status, body)
            root = ET.fromstring(body)
            token = None
            for el in root.iter():
                if el.tag.endswith("Key"):
                    keys.append(el.text)
                elif el.tag.endswith("NextContinuationToken"):
                    token = el.text
            if not token:
                return keys
