"""Object-store-shaped byte transport: the remote artifact tier (the
port of ``spfft_tpu/net/blobstore.py``, with its byte and HTTP wire
format unchanged).

``PlanArtifactStore`` keeps two local tiers (the registry's in-memory
LRU, the on-disk artifacts); this module is the tier below disk — an
abstract ``get/put/list`` byte surface an autoscaled worker boots warm
from. Two backends behind :class:`BlobStore`:

* :class:`FileBlobStore` — a shared directory (NFS-mount-shaped);
  atomic writes, missing key -> ``None``.
* :class:`HttpBlobStore` — a minimal HTTP object store (GET/PUT, 404
  = miss) over ``http.client``; :func:`serve_blobstore` /
  ``python -m spfft_tpu_torch.net.blobstore --serve ROOT`` runs the
  matching local server over a :class:`FileBlobStore` root.

The store consumes these VERBATIM bytes through the same
``parse_artifact`` digest/version checks as a disk read. Failures raise
the typed :class:`~spfft_tpu_torch.errors.BlobStoreError` (the artifact
store treats it as a remote miss); ``blob.get``/``blob.put`` are the
package's fault sites. Every operation lands in
``spfft_blob_ops_total{op,outcome}``.

One blob store can hold both packages' artifacts: this package's store
keeps its blobs under the ``torch/`` namespace
(:data:`~spfft_tpu_torch.serve.store.REMOTE_PREFIX`), the JAX package's
under ``art/`` and ``req/``, and :func:`gc_blobstore` sweeps one
namespace only.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import urllib.parse
from typing import List, Optional

from .. import faults as _faults
from .. import obs as _obs
from ..errors import BlobStoreError, InvalidParameterError
from ..faults import InjectedFault

#: Default per-operation HTTP timeout (seconds). Deliberately short:
#: the remote tier is an optimisation — a wedged object store must
#: degrade to a miss quickly, not stall a plan load.
HTTP_TIMEOUT_S = 10.0


def _count(op: str, outcome: str) -> None:
    _obs.GLOBAL_COUNTERS.inc("spfft_blob_ops_total", op=op,
                             outcome=outcome)


class BlobStore:
    """The abstract byte surface: ``get(key) -> bytes | None`` (None =
    miss), ``put(key, data)``, ``list() -> [key]``, plus the GC half —
    ``stat(key) -> {"size", "mtime"} | None`` and
    ``delete(key) -> bool`` (False = already gone). Keys are relative
    slash-separated paths (this package's store uses the
    ``torch/art/<key>`` and ``torch/req/<rkey>`` namespaces)."""

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def list(self) -> List[str]:
        raise NotImplementedError

    def stat(self, key: str) -> Optional[dict]:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError


def _validate_key(key: str) -> str:
    if not key or key.startswith(("/", ".")) or ".." in key \
            or "\\" in key:
        raise InvalidParameterError(f"bad blob key {key!r}")
    return key


class FileBlobStore(BlobStore):
    """A directory as an object store — the shared-volume backend (and
    what the HTTP server fronts)."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *(_validate_key(key).split("/")))

    def get(self, key: str) -> Optional[bytes]:
        path = self._path(key)
        try:
            _faults.check_site("blob.get")
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            _count("get", "miss")
            return None
        except (OSError, InjectedFault) as exc:
            _count("get", "error")
            raise BlobStoreError(
                f"blob get {key!r} failed: {exc}") from exc
        _count("get", "hit")
        return data

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            _faults.check_site("blob.put")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except (OSError, InjectedFault) as exc:
            _count("put", "error")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise BlobStoreError(
                f"blob put {key!r} failed: {exc}") from exc
        _count("put", "ok")

    def list(self) -> List[str]:
        out = []
        for dirpath, _, names in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for name in names:
                if ".tmp-" in name:
                    continue
                key = name if rel == "." else f"{rel}/{name}"
                out.append(key.replace(os.sep, "/"))
        return sorted(out)

    def stat(self, key: str) -> Optional[dict]:
        try:
            st = os.stat(self._path(key))
        except FileNotFoundError:
            return None
        except OSError as exc:
            raise BlobStoreError(
                f"blob stat {key!r} failed: {exc}") from exc
        return {"size": st.st_size, "mtime": st.st_mtime}

    def delete(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            return False
        except OSError as exc:
            raise BlobStoreError(
                f"blob delete {key!r} failed: {exc}") from exc
        return True


class HttpBlobStore(BlobStore):
    """A minimal HTTP object store client: ``GET /<key>`` (404 = miss),
    ``PUT /<key>``, ``GET /?list=1`` -> JSON key array. One connection
    per operation — robust against a restarted server, and the remote
    tier is far off any hot path."""

    def __init__(self, url: str, timeout: float = HTTP_TIMEOUT_S):
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme != "http" or not parsed.netloc:
            raise InvalidParameterError(
                f"HttpBlobStore needs an http:// URL, got {url!r}")
        self.url = url
        self._host = parsed.hostname
        self._port = parsed.port or 80
        self._base = parsed.path.rstrip("/")
        self._timeout = float(timeout)

    def _request(self, method: str, key: str,
                 body: Optional[bytes] = None, query: str = ""):
        path = f"{self._base}/{urllib.parse.quote(key)}" if key \
            else f"{self._base}/?list=1"
        if key and query:
            path = f"{path}?{query}"
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=self._timeout)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def get(self, key: str) -> Optional[bytes]:
        _validate_key(key)
        try:
            _faults.check_site("blob.get")
            status, data = self._request("GET", key)
        except (OSError, InjectedFault) as exc:
            _count("get", "error")
            raise BlobStoreError(
                f"blob get {key!r} failed: {exc}") from exc
        if status == 404:
            _count("get", "miss")
            return None
        if status != 200:
            _count("get", "error")
            raise BlobStoreError(
                f"blob get {key!r} answered HTTP {status}")
        _count("get", "hit")
        return data

    def put(self, key: str, data: bytes) -> None:
        _validate_key(key)
        try:
            _faults.check_site("blob.put")
            status, _ = self._request("PUT", key, body=data)
        except (OSError, InjectedFault) as exc:
            _count("put", "error")
            raise BlobStoreError(
                f"blob put {key!r} failed: {exc}") from exc
        if status not in (200, 201, 204):
            _count("put", "error")
            raise BlobStoreError(
                f"blob put {key!r} answered HTTP {status}")
        _count("put", "ok")

    def list(self) -> List[str]:
        try:
            status, data = self._request("GET", "")
        except OSError as exc:
            raise BlobStoreError(f"blob list failed: {exc}") from exc
        if status != 200:
            raise BlobStoreError(f"blob list answered HTTP {status}")
        try:
            keys = json.loads(data)
        except ValueError as exc:
            raise BlobStoreError(
                f"blob list is not JSON: {exc}") from exc
        return [str(k) for k in keys]

    def stat(self, key: str) -> Optional[dict]:
        _validate_key(key)
        try:
            status, data = self._request("GET", key, query="stat=1")
        except OSError as exc:
            raise BlobStoreError(
                f"blob stat {key!r} failed: {exc}") from exc
        if status == 404:
            return None
        if status != 200:
            raise BlobStoreError(
                f"blob stat {key!r} answered HTTP {status}")
        try:
            row = json.loads(data)
            return {"size": int(row["size"]),
                    "mtime": float(row["mtime"])}
        except (ValueError, KeyError, TypeError) as exc:
            raise BlobStoreError(
                f"blob stat {key!r} is malformed: {exc}") from exc

    def delete(self, key: str) -> bool:
        _validate_key(key)
        try:
            status, _ = self._request("DELETE", key)
        except OSError as exc:
            raise BlobStoreError(
                f"blob delete {key!r} failed: {exc}") from exc
        if status == 404:
            return False
        if status not in (200, 204):
            raise BlobStoreError(
                f"blob delete {key!r} answered HTTP {status}")
        return True


def open_blobstore(spec: Optional[str]) -> Optional[BlobStore]:
    """Resolve a blob-store spec: empty/None -> no remote tier,
    ``http://...`` -> :class:`HttpBlobStore`, anything else -> a
    :class:`FileBlobStore` directory."""
    if not spec:
        return None
    if spec.startswith("http://"):
        return HttpBlobStore(spec)
    return FileBlobStore(spec)


def gc_blobstore(store: BlobStore, max_bytes: int,
                 prefix: str = "torch/req/") -> dict:
    """Bound the remote tier's ``prefix`` namespace (default: this
    package's ``torch/req/`` request journal, which grows per served
    signature and has no local-tier GC; the JAX package's ``req/`` is
    never swept by it) to ``max_bytes`` by an oldest-mtime-first sweep
    — the same eviction order as the disk tier's ``store gc``.
    ``max_bytes <= 0`` means unbounded: nothing is swept (counted
    ``skipped``). Per-key failures are typed and NON-FATAL: a
    concurrently-deleted or unreachable key counts
    ``spfft_blob_gc_total{outcome="error"}`` and the sweep continues —
    GC is an optimisation, never an availability risk. Returns
    ``{"removed": [keys], "bytes_in_use": n, "errors": n}``."""
    if max_bytes is None or int(max_bytes) <= 0:
        _obs.GLOBAL_COUNTERS.inc("spfft_blob_gc_total",
                                 outcome="skipped")
        return {"removed": [], "bytes_in_use": None, "errors": 0}
    rows = []
    errors = 0
    for key in store.list():
        if not key.startswith(prefix):
            continue
        try:
            st = store.stat(key)
        except BlobStoreError:
            errors += 1
            _obs.GLOBAL_COUNTERS.inc("spfft_blob_gc_total",
                                     outcome="error")
            continue
        if st is not None:
            rows.append((float(st["mtime"]), key, int(st["size"])))
    rows.sort()  # oldest first
    in_use = sum(size for _, _, size in rows)
    removed: List[str] = []
    for mtime, key, size in rows:
        if in_use <= int(max_bytes):
            break
        try:
            if store.delete(key):
                removed.append(key)
                _obs.GLOBAL_COUNTERS.inc("spfft_blob_gc_total",
                                         outcome="removed")
            in_use -= size
        except BlobStoreError:
            errors += 1
            _obs.GLOBAL_COUNTERS.inc("spfft_blob_gc_total",
                                     outcome="error")
    return {"removed": removed, "bytes_in_use": in_use,
            "errors": errors}


# -- the matching local HTTP server ------------------------------------------
def serve_blobstore(root: str, bind: str = "127.0.0.1",
                    port: int = 0):
    """Run an HTTP object store over ``root`` on a daemon thread:
    ``(server, thread)``; the bound port is ``server.server_port``."""
    import http.server

    store = FileBlobStore(root)

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: tests/smokes drive this
            pass

        def _key(self) -> str:
            return urllib.parse.unquote(
                urllib.parse.urlsplit(self.path).path.lstrip("/"))

        def do_GET(self):
            parsed = urllib.parse.urlsplit(self.path)
            if not parsed.path.strip("/"):
                body = json.dumps(store.list()).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if ("stat", "1") in urllib.parse.parse_qsl(parsed.query):
                try:
                    row = store.stat(self._key())
                except (BlobStoreError, InvalidParameterError):
                    self.send_response(500)
                    self.end_headers()
                    return
                if row is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps(row).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            try:
                data = store.get(self._key())
            except (BlobStoreError, InvalidParameterError):
                self.send_response(500)
                self.end_headers()
                return
            if data is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_DELETE(self):
            try:
                removed = store.delete(self._key())
            except (BlobStoreError, InvalidParameterError):
                self.send_response(500)
                self.end_headers()
                return
            self.send_response(204 if removed else 404)
            self.end_headers()

        def do_PUT(self):
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                store.put(self._key(), data)
            except (BlobStoreError, InvalidParameterError):
                self.send_response(500)
                self.end_headers()
                return
            self.send_response(204)
            self.end_headers()

    server = http.server.ThreadingHTTPServer((bind, port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              daemon=True, name="spfft-blob-server")
    thread.start()
    return server, thread


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.net.blobstore",
        description="Serve a directory as the remote artifact tier "
                    "over HTTP.")
    ap.add_argument("--serve", metavar="ROOT", required=True,
                    help="FileBlobStore root directory to serve")
    ap.add_argument("--bind", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    server, thread = serve_blobstore(args.serve, args.bind, args.port)
    print(json.dumps({"blobstore": args.serve,
                      "port": server.server_port}), flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
