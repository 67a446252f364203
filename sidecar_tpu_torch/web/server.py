"""The threading HTTP server that mounts the Sidecar API, the UI's static
files and the ``/watch`` stream of versioned snapshot and delta
documents — the port of ``sidecar_tpu/web/server.py`` (reference:
sidecarhttp/http.go:56-84; the stream's protocol: docs/query.md).

``ui_dir`` and ``static_dir`` are arguments: the server only reads
them."""

from __future__ import annotations

import logging
import mimetypes
import pathlib
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from sidecar_tpu_torch.telemetry.span import span as _span
from sidecar_tpu_torch.web.api import SidecarApi

log = logging.getLogger(__name__)


def make_handler(api: SidecarApi, ui_dir: Optional[str],
                 static_dir: Optional[str]):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            log.debug("http: " + fmt, *args)

        # -- plumbing ------------------------------------------------------

        def _send(self, status: int, content_type: str, body: bytes,
                  extra: Optional[dict] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _serve_file(self, root: str, rel: str) -> None:
            base = pathlib.Path(root).resolve()
            target = (base / rel.lstrip("/")).resolve()
            if not target.is_relative_to(base):
                self._send(403, "text/plain", b"Forbidden")
                return
            if target.is_dir():
                target = target / "index.html"
            if not target.is_file():
                self._send(404, "text/plain", b"Not Found")
                return
            ctype = mimetypes.guess_type(str(target))[0] or \
                "application/octet-stream"
            self._send(200, ctype, target.read_bytes())

        def _watch(self, by_service: bool,
                   since: Optional[int] = None) -> None:
            """Versioned delta stream over the query hub
            (docs/query.md): a snapshot document establishes the
            client's version cursor, then one delta document per
            contiguous burst of changes; a client that passes
            ``?since=V`` at the current version skips the snapshot.  A
            subscriber that falls behind gets a fresh snapshot document
            (the hub's coalesce-to-snapshot rule) — version sequences
            are gap-free by construction."""
            sub = api.state.query_hub().subscribe(
                f"watch-{id(self)}-{threading.get_ident()}", prime=False)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def push(payload: bytes) -> None:
                    # The delivery hop of the live propagation path
                    # (docs/telemetry.md): write one /watch document to
                    # this subscriber.  ``payload`` is the hub's shared
                    # per-version buffer — the same object every other
                    # watcher of this version writes — so this hop does
                    # zero serialization; the memoryview keeps the
                    # chunked framing from copying the body.
                    with _span("watch.deliver"):
                        self.wfile.write(b"%x\r\n" % len(payload))
                        self.wfile.write(memoryview(payload))
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()

                current = api.state.query_hub().current()
                if since is None or since != current.version:
                    push(api.watch_snapshot_bytes(by_service, current))
                cursor = current.version
                while True:
                    ev = sub.get(timeout=30.0)
                    if ev is None:
                        if sub.closed:
                            break  # the hub let the subscriber go
                        continue  # keep the connection; no change yet
                    events = [ev] + sub.drain()  # coalesce the burst
                    # A resync marker supersedes the deltas BEFORE it —
                    # but deltas published after the collapse can land
                    # behind it in the same batch (get() clears the
                    # marker, then the writer publishes into the freed
                    # deque before drain()); dropping those would be a
                    # permanent gap, so push the snapshot first and the
                    # newer deltas after it.
                    snaps = [e for e in events if e.kind == "snapshot"]
                    if snaps:
                        latest = snaps[-1].snapshot
                        if latest.version > cursor:
                            push(api.watch_snapshot_bytes(by_service,
                                                          latest))
                            cursor = latest.version
                    deltas = [e for e in events
                              if e.kind == "delta" and
                              e.version > cursor]
                    if deltas:
                        push(api.watch_delta_bytes(deltas))
                        cursor = deltas[-1].version
            except OSError:
                pass  # client went away
            finally:
                sub.close()

        # -- methods -------------------------------------------------------

        def do_GET(self) -> None:  # noqa: N802 — http.server API
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path
            query = urllib.parse.parse_qs(parsed.query)

            if path == "/":
                self.send_response(301)
                self.send_header("Location", "/ui/")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            if path.startswith("/ui") and ui_dir:
                self._serve_file(ui_dir, path[len("/ui"):])
                return
            if path.startswith("/static") and static_dir:
                self._serve_file(static_dir, path[len("/static"):])
                return

            result = api.dispatch("GET", path, query,
                                  client=self.client_address[0])
            if isinstance(result, tuple) and result and result[0] == "watch":
                self._watch(result[1], result[2])
                return
            status, ctype, body, extra = result
            self._send(status, ctype, body, extra)

        def do_POST(self) -> None:  # noqa: N802
            parsed = urllib.parse.urlparse(self.path)
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                self.rfile.read(length)
            status, ctype, body, extra = api.dispatch(
                "POST", parsed.path, client=self.client_address[0])
            self._send(status, ctype, body, extra)

        def do_OPTIONS(self) -> None:  # noqa: N802
            status, ctype, body, extra = api.dispatch("OPTIONS", self.path)
            self._send(status, ctype, body, extra)

    return Handler


def serve_http(api: SidecarApi, bind: str = "0.0.0.0", port: int = 7777,
               ui_dir: Optional[str] = None,
               static_dir: Optional[str] = None,
               background: bool = True) -> ThreadingHTTPServer:
    """Start the API server (http.go:56-84; default port 7777)."""
    server = ThreadingHTTPServer(
        (bind, port), make_handler(api, ui_dir, static_dir))
    if background:
        threading.Thread(target=server.serve_forever, name="http-server",
                         daemon=True).start()
    else:
        server.serve_forever()
    return server
