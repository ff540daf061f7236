"""Stdlib HTTP plumbing of the port's embedded servers (a copy of
``incubator_mxnet_tpu/http_util.py``, so that the wire format is the
reference's byte for byte).

The telemetry exporter (``telemetry_http.py``) and the model server
(``serving/server.py``) are stdlib-only ``http.server`` stacks on daemon
threads; this module is the plumbing they share:

* :class:`BaseJSONHandler` — a ``BaseHTTPRequestHandler`` with the
  common response helpers (``_send``/``send_json``/``read_json``),
  silent request logging (training stdout stays clean), a
  swallow-all error guard so a handler bug degrades to a 500, never a
  crash-looping accept thread, and per-request id handling: every
  response — 200s, 4xx/5xx error branches, even the guard's own
  500 — carries an ``X-Request-Id`` header echoing the client's
  ``x-request-id`` (sanitized) or a freshly generated id, so a client
  can always correlate a response with server-side FAULT events, spans,
  and flight-recorder dumps (docs/observability.md).
* :func:`start_http_server` / :func:`stop_http_server` — daemon-thread
  lifecycle.  Port 0 binds an ephemeral port; the bound port is
  ``server.server_address[1]``.
"""
from __future__ import annotations

import json
import re
import sys
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Type

__all__ = ["BaseJSONHandler", "HTTPServerBase", "start_http_server",
           "stop_http_server", "parse_trace_id"]


class HTTPServerBase(ThreadingHTTPServer):
    """Default server class: daemon handler threads and a listen
    backlog deep enough for a thundering herd of concurrent clients
    (socketserver's default of 5 resets connections under load)."""
    daemon_threads = True
    request_queue_size = 128

    def handle_error(self, request, client_address):
        # A client dropping its half of a keep-alive connection (or an
        # SSE consumer walking away) is business as usual for a server
        # fronted by a router/balancer — not worth a stderr traceback.
        # Anything else keeps socketserver's loud default.
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError, TimeoutError)):
            return
        super().handle_error(request, client_address)


# what survives of a client-supplied x-request-id: word chars, dot,
# dash — anything else is stripped so ids are safe to grep, log, and
# embed in filenames
_REQUEST_ID_JUNK = re.compile(r"[^A-Za-z0-9._\-]")

# the router's traceparent-style header: <trace root>-<hop span id>.
# The trace root is the request id (which may itself contain dashes),
# the hop id is the 8-hex sid of the router span that made this
# upstream call — so the split is on the LAST dash.
_TRACE_ID_RE = re.compile(r"^([A-Za-z0-9._\-]{1,64})-([0-9a-f]{1,16})$")
_TRACE_ID_MAX = 96


def parse_trace_id(raw) -> Optional[tuple]:
    """Parse an ``X-Trace-Id`` header value into ``(trace_id,
    parent_span_id)``.  Anything malformed, oversized, or
    junk-charactered returns ``None`` — propagation is best-effort and a
    hostile/buggy header must never fail the request it rides on."""
    if not raw or not isinstance(raw, str):
        return None
    raw = raw.strip()
    if len(raw) > _TRACE_ID_MAX:
        return None
    m = _TRACE_ID_RE.match(raw)
    return (m.group(1), m.group(2)) if m else None


class BaseJSONHandler(BaseHTTPRequestHandler):
    """Response/request helpers shared by every embedded HTTP server."""

    server_version = "mxtpu-http/1.0"
    # chunked streaming (start_stream) requires HTTP/1.1 framing; every
    # non-streamed response carries Content-Length, so keep-alive is safe
    protocol_version = "HTTP/1.1"

    def request_id(self) -> str:
        """This request's id: the client's ``x-request-id`` header
        (sanitized, capped at 64 chars) or a generated 16-hex-char id.
        Stable for the duration of one request; ``_send`` echoes it on
        the response and resets it for the next keep-alive request."""
        rid = getattr(self, "_mxtpu_request_id", None)
        if rid is None:
            raw = (self.headers.get("x-request-id") or "").strip() \
                if getattr(self, "headers", None) else ""
            rid = _REQUEST_ID_JUNK.sub("", raw)[:64] or uuid.uuid4().hex[:16]
            self._mxtpu_request_id = rid
        return rid

    def trace_parent(self) -> Optional[tuple]:
        """The upstream trace context from this request's ``X-Trace-Id``
        header: ``(trace_id, parent_span_id)``, or ``None`` when absent
        or malformed (see :func:`parse_trace_id`)."""
        if getattr(self, "headers", None) is None:
            return None
        return parse_trace_id(self.headers.get("x-trace-id"))

    def _send(self, code: int, body: str, ctype: str,
              headers: Optional[dict] = None) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Request-Id", self.request_id())
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)
        self._mxtpu_request_id = None   # keep-alive: next request, new id

    def send_text(self, code: int, body: str,
                  ctype: str = "text/plain; charset=utf-8",
                  headers: Optional[dict] = None) -> None:
        self._send(code, body, ctype, headers)

    def send_json(self, code: int, obj,
                  headers: Optional[dict] = None) -> None:
        self._send(code, json.dumps(obj, default=str) + "\n",
                   "application/json", headers)

    def read_body(self) -> bytes:
        """The raw request body (``b""`` when absent).  The router
        reads the body once and forwards the same bytes on every
        failover attempt, so retried requests are byte-identical."""
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length > 0 else b""

    def read_json(self):
        """Parse the request body as JSON (``ValueError`` on garbage;
        an absent/empty body parses as ``{}``)."""
        raw = self.read_body()
        if not raw:
            return {}
        try:
            return json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"request body is not valid JSON: {e}")

    # -- streaming (SSE over chunked transfer) --------------------------
    def start_stream(self, code: int = 200,
                     ctype: str = "text/event-stream",
                     headers: Optional[dict] = None) -> None:
        """Open a chunked streaming response (no ``Content-Length``).
        The ``X-Request-Id`` header rides the stream headers like any
        other response, so streamed requests stay correlatable with
        server-side spans/FAULT events.  Follow with
        :meth:`send_event` calls and finish with :meth:`end_stream`."""
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Request-Id", self.request_id())
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    def send_event(self, obj, event: Optional[str] = None) -> None:
        """One SSE event carrying a JSON payload.  Raises
        ``BrokenPipeError``/``ConnectionError`` when the client has gone
        away — callers treat that as a cancel signal."""
        prefix = f"event: {event}\n" if event else ""
        self._write_chunk(
            (prefix + "data: " + json.dumps(obj, default=str)
             + "\n\n").encode("utf-8"))

    def relay_chunk(self, data: bytes) -> None:
        """Forward already-framed payload bytes (upstream SSE lines) onto
        an open stream without re-encoding: the router's passthrough.
        Same disconnect contract as :meth:`send_event`."""
        if data:
            self._write_chunk(data)

    def end_stream(self) -> None:
        """Terminate the chunked response (zero-length chunk)."""
        try:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        finally:
            self._mxtpu_request_id = None

    def guard(self, fn) -> None:
        """Run a route handler; an exporter/server bug must not
        500-loop or kill the accept thread."""
        try:
            fn()
        except Exception as e:
            try:
                self.send_text(500, f"server error: {e!r}\n")
            except Exception:
                pass

    def log_message(self, fmt, *args):
        pass                            # stay silent on training stdout


def start_http_server(handler_cls: Type[BaseHTTPRequestHandler],
                      port: int, host: str = "0.0.0.0",
                      name: str = "mxtpu-http",
                      server_cls: Type[ThreadingHTTPServer]
                      = HTTPServerBase) -> ThreadingHTTPServer:
    """Bind ``host:port`` and serve ``handler_cls`` from a daemon thread.
    Raises ``OSError`` when the port cannot be bound.  The serving
    thread is attached to the server object so :func:`stop_http_server`
    can join it."""
    srv = server_cls((host, int(port)), handler_cls)
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, name=name, daemon=True)
    th.start()
    srv._mxtpu_thread = th
    return srv


def stop_http_server(srv: Optional[ThreadingHTTPServer],
                     timeout: float = 5.0) -> None:
    """Shut a server started by :func:`start_http_server` down and
    release its port (no-op on ``None``)."""
    if srv is None:
        return
    th = getattr(srv, "_mxtpu_thread", None)
    srv.shutdown()
    srv.server_close()
    if th is not None:
        th.join(timeout=timeout)
