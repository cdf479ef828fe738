"""HTTP proxy: ingress for Serve applications (counterpart of
``ray_tpu/serve/proxy.py``).

Upstream analog: python/ray/serve/_private/proxy.py (ProxyActor:1129,
HTTPProxy:752). The reference's proxy runs on aiohttp, which the card's
host is not promised; this one is the standard library's
``ThreadingHTTPServer`` in a daemon thread, one thread per connection,
with the reference's behaviour:

 * ``/-/healthz`` answers ``success``; ``/-/routes`` the route table as
   ``{prefix: app}``;
 * every other path goes to the longest matching route prefix's ingress
   deployment (``RouteTableCache``), which receives a ``Request`` whose
   ``path`` is the sub-path below the prefix; no match is a 404;
 * a replica error is a 500 whose body is ``Type: message``;
 * a dict result whose ``error.code`` is an int in 400-599 (the OpenAI
   front end's rejections) takes that status, with ``Retry-After`` from
   ``llm.admission.retry_after_header``; any other dict or list is JSON,
   ``str`` is text and ``bytes`` the raw body, so a streamed completion's
   whole SSE transcript is the body, as the reference sends it.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qsl, urlsplit

from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.serve.proxy")


@dataclass
class Request:
    """What an HTTP ingress callable receives (stand-in for upstream's
    starlette.Request; carries the same essentials)."""

    method: str
    path: str  # path below the route prefix
    query: dict
    headers: dict
    body: bytes = b""
    route_prefix: str = "/"

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    @property
    def text(self) -> str:
        return self.body.decode()


class _Server(ThreadingHTTPServer):
    daemon_threads = True  # a connection's thread never holds the process open
    allow_reuse_address = True
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of concurrent clients, which then wait out TCP's 1 s retransmit
    request_queue_size = 1024


class HTTPProxy:
    """``ThreadingHTTPServer`` serving in a daemon thread."""

    # a request's wait for its replica (the reference's 300 s)
    REQUEST_TIMEOUT_S = 300.0

    def __init__(self, host: str, port: int, controller_handle):
        from ray_tpu_torch.serve.routes import RouteTableCache

        self._host = host
        self._controller = controller_handle
        self._handles: dict[str, Any] = {}  # app_name -> DeploymentHandle
        self._handles_lock = threading.Lock()
        self._route_cache = RouteTableCache(controller_handle)
        proxy = self

        class _Handler(BaseHTTPRequestHandler):
            def _serve(self):
                proxy._handle(self)

            do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = do_HEAD = do_OPTIONS = _serve

            def log_message(self, fmt, *args):  # no access log, as the reference
                pass

        try:
            self._server = _Server((host, port), _Handler)
        except OSError as e:
            raise RuntimeError(f"HTTP proxy failed to bind {host}:{port}: {e}") from e
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="serve-http-proxy", daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._port

    def _match(self, path: str):
        """Longest-prefix route match (shared cache: serve/routes.py)."""
        return self._route_cache.match(path)

    def _get_handle(self, app: str, ingress: str):
        with self._handles_lock:
            h = self._handles.get(app)
            if h is None or h.deployment_name != ingress:
                from ray_tpu_torch.serve.handle import DeploymentHandle

                h = DeploymentHandle(ingress, app)
                self._handles[app] = h
            return h

    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        url = urlsplit(h.path)
        path = url.path
        if path == "/-/healthz":
            return self._send(h, 200, b"success", "text/plain; charset=utf-8")
        if path == "/-/routes":
            routes = self._route_cache.get()
            return self._send_json(h, 200, {p: a for p, (a, _) in routes.items()})
        match = self._match(path)
        if match is None:
            return self._send(h, 404, f"no route for {path}".encode(),
                              "text/plain; charset=utf-8")
        norm, prefix, app, ingress = match
        sub_path = path[len(norm):] if norm != "/" else path
        n = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(n) if n > 0 else b""
        query: dict = {}
        for k, v in parse_qsl(url.query, keep_blank_values=True):
            query.setdefault(k, v)  # the first of repeated keys, as a multidict's []
        req = Request(
            method=h.command,
            path=sub_path or "/",
            query=query,
            headers=dict(h.headers.items()),
            body=body,
            route_prefix=prefix,
        )
        handle = self._get_handle(app, ingress)
        try:
            result = handle.remote(req).result(timeout_s=self.REQUEST_TIMEOUT_S)
        except Exception as e:  # surface replica errors as 500s
            logger.exception("request to %s failed", path)
            return self._send(h, 500, f"{type(e).__name__}: {e}".encode(),
                              "text/plain; charset=utf-8")
        self._respond(h, result)

    def _respond(self, h: BaseHTTPRequestHandler, result) -> None:
        if isinstance(result, bytes):
            return self._send(h, 200, result, "application/octet-stream")
        if isinstance(result, str):
            return self._send(h, 200, result.encode(), "text/plain; charset=utf-8")
        if isinstance(result, dict):
            # OpenAI-style error payloads carry their HTTP status in
            # error.code; admission rejections also carry a retry_after
            # hint the client reads from the Retry-After header (429
            # overload / 503 draining)
            err = result.get("error")
            if isinstance(err, dict) and isinstance(err.get("code"), int) \
                    and 400 <= err["code"] < 600:
                from ray_tpu_torch.llm.admission import retry_after_header

                ra = retry_after_header(result)
                headers = {"Retry-After": ra} if ra is not None else {}
                return self._send_json(h, err["code"], result, headers)
        self._send_json(h, 200, result)

    def _send_json(self, h, status: int, obj, headers=None) -> None:
        self._send(h, status, json.dumps(obj).encode(), "application/json; charset=utf-8",
                   headers)

    @staticmethod
    def _send(h: BaseHTTPRequestHandler, status: int, body: bytes, ctype: str,
              headers=None) -> None:
        h.send_response(status)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            h.send_header(k, v)
        h.end_headers()
        if h.command != "HEAD":
            h.wfile.write(body)

    def shutdown(self) -> None:
        self._server.shutdown()  # returns once serve_forever has left its loop
        self._server.server_close()
        self._thread.join(timeout=5)
