"""Minimal dashboard: HTTP state + metrics endpoints (counterpart of
``ray_tpu/dashboard/__init__.py``).

Reference analog: python/ray/dashboard/ (head.py:62 DashboardHead + the
modules/ API routes + metrics pipeline). Single-host collapse: one HTTP
server exposing

  /api/tasks /api/actors /api/objects /api/nodes /api/placement_groups
  /api/summary /api/cluster_status   — JSON state (util/state.py)
  /metrics                           — Prometheus text (util/metrics.py)
  /timeline                          — Chrome trace JSON (task events)
  /api/trace[?trace_id=&limit=]      — task timeline merged with request
                                       spans, bounded (obs recorder)
  /api/requests                      — flight-recorder trace listing
  /healthz                           — liveness

and, given ``gcs_address``, the cluster view: /api/cluster/{nodes,actors,
placement_groups,demand,timeline}, /api/metrics/cluster, /api/slo,
/api/perf and /metrics/cluster. The routes and JSON shapes are the
reference's; the reference serves them on aiohttp, which the card's host
does not have, so this one is the standard library's
``ThreadingHTTPServer`` in a daemon thread (one thread per connection, as
the Serve proxy's). ``port=0`` binds an ephemeral port, read back as
``Dashboard.port``. The dashboard process imports no torch.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qsl, urlsplit

from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.dashboard")

_dashboard: Optional["Dashboard"] = None


class _Server(ThreadingHTTPServer):
    daemon_threads = True  # a connection's thread never holds the process open
    allow_reuse_address = True


def _jsonable(x):
    if isinstance(x, bytes):
        return x.hex()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


class Dashboard:
    """`gcs_address` switches on the CLUSTER view: /api/cluster/* routes
    aggregate the GCS tables plus per-node stats pulled live from every
    node daemon's RPC server — each daemon IS the per-node dashboard agent
    (reference: dashboard/agent.py processes colocated with each raylet;
    the daemon's rpc_stats/rpc_timeline endpoints fill that role)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8265,
                 gcs_address: Optional[str] = None):
        from ray_tpu_torch.cluster.rpc import ClientPool

        self.host = host
        self.gcs_address = gcs_address
        # one cached connection per address (reference: rpc client pools);
        # per-request connect/teardown churn would spawn and abandon a
        # reader thread per node per poll
        self._pool = ClientPool(timeout=5.0)
        routes = self._routes()
        dash = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                dash._handle(self, routes)

            do_HEAD = do_GET

            def log_message(self, fmt, *args):  # no access log, as the reference
                pass

        try:
            self._server = _Server((host, port), _Handler)
        except OSError as e:
            self._pool.close_all()
            raise RuntimeError(f"dashboard failed to bind {host}:{port}: {e}") from e
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="ray_tpu_torch-dashboard", daemon=True,
        )
        self._thread.start()

    # -- routes ---------------------------------------------------------------

    def _routes(self) -> dict[str, Callable[[dict], object]]:
        """path -> fn(query): a str answers as text, anything else as JSON."""
        from ray_tpu_torch.util import metrics as metrics_mod
        from ray_tpu_torch.util import state

        def cluster_status(_q):
            import ray_tpu_torch

            return {"cluster_resources": ray_tpu_torch.cluster_resources(),
                    "available_resources": ray_tpu_torch.available_resources()}

        routes = {
            "/healthz": lambda _q: "success",
            "/api/tasks": lambda q: [vars(r) for r in state.list_tasks(q.get("state"))],
            "/api/actors": lambda _q: state.list_actors(),
            "/api/objects": lambda _q: state.list_objects(),
            "/api/nodes": lambda _q: state.list_nodes(),
            "/api/placement_groups": lambda _q: state.list_placement_groups(),
            "/api/summary": lambda _q: state.summarize_tasks(),
            "/api/cluster_status": cluster_status,
            "/metrics": lambda _q: metrics_mod.prometheus_text(),
            "/timeline": lambda _q: state.timeline(),
            "/api/trace": self._api_trace,
            "/api/requests": lambda _q: self._api_requests(),
        }
        if self.gcs_address:
            routes.update({
                "/api/cluster/nodes": lambda _q: self._cluster_nodes(),
                "/api/cluster/actors": lambda _q: self._cluster_actors(),
                "/api/cluster/placement_groups":
                    lambda _q: _jsonable(self._gcs_call("list_pgs")),
                "/api/cluster/demand": lambda _q: self._gcs_call("cluster_demand"),
                "/api/cluster/timeline": lambda _q: self._cluster_timeline(),
                # cluster-level aggregate: counter sums + rates, gauge
                # rollups, merged histograms w/ percentiles, staleness
                "/api/metrics/cluster": lambda _q: self._gcs_call("telemetry_cluster"),
                # per-model-tag SLO grades from the MERGED histograms
                "/api/slo": lambda _q: self._gcs_call("telemetry_slo"),
                # sampled step-profiling rollup (empty until a sampler reports)
                "/api/perf": lambda _q: self._gcs_call("telemetry_perf"),
                # merged Prometheus exposition: the fleet's /metrics
                "/metrics/cluster": lambda _q: self._gcs_call("telemetry_prometheus"),
            })
        return routes

    def _handle(self, h: BaseHTTPRequestHandler, routes: dict) -> None:
        url = urlsplit(h.path)
        route = routes.get(url.path)
        if route is None:
            return self._send(h, 404, b"404: Not Found", "text/plain; charset=utf-8")
        query: dict = {}
        for k, v in parse_qsl(url.query, keep_blank_values=True):
            query.setdefault(k, v)  # the first of repeated keys, as a multidict's get
        try:
            out = route(query)
            if isinstance(out, str):
                body, ctype = out.encode(), "text/plain; charset=utf-8"
            else:
                body, ctype = json.dumps(out).encode(), "application/json; charset=utf-8"
        except Exception:  # noqa: BLE001 — one failed route is a 500, not a dead server
            logger.exception("dashboard route %s failed", url.path)
            return self._send(h, 500, b"500 Internal Server Error", "text/plain; charset=utf-8")
        self._send(h, 200, body, ctype)

    @staticmethod
    def _send(h: BaseHTTPRequestHandler, status: int, body: bytes, ctype: str) -> None:
        h.send_response(status)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        if h.command != "HEAD":
            h.wfile.write(body)

    # -- local view -----------------------------------------------------------

    @staticmethod
    def _api_trace(query: dict) -> dict:
        """Request spans (the obs flight recorder) merged with the task
        timeline as one Chrome trace; ?trace_id= narrows both halves to one
        request. BOUNDED (?limit=, default 50k events) with an explicit
        truncated flag."""
        from ray_tpu_torch.obs import get_recorder
        from ray_tpu_torch.util import state

        trace_id = query.get("trace_id")
        try:
            limit = int(query.get("limit", 50_000))
        except ValueError:
            limit = 50_000
        # profiler strips would reach both sinks; the bounded recorder copy
        # is authoritative here, so task-buffer profile rows are dropped
        events = [e for e in state.timeline() if e.get("cat") != "profile"]
        if trace_id:
            events = [e for e in events if e.get("args", {}).get("trace_id") == trace_id]
        rec = get_recorder().chrome_trace_bounded(trace_id=trace_id, max_events=limit)
        events += rec["events"]
        total = len(events) + (rec["total_spans"] - len(rec["events"]))
        truncated = rec["truncated"]
        if len(events) > limit:
            events.sort(key=lambda e: e.get("ts", 0.0))
            events = events[:limit]
            truncated = True
        return {"events": events, "truncated": truncated, "total_events": total}

    @staticmethod
    def _api_requests() -> list:
        from ray_tpu_torch.obs import get_recorder

        return get_recorder().traces()

    # -- cluster view: GCS tables + live per-daemon agent stats ---------------

    def _gcs_call(self, method, payload=None):
        host, port = self.gcs_address.rsplit(":", 1)
        return self._pool.get((host, int(port))).call(method, payload)

    def _node_call(self, n, method, payload=None):
        """One agent RPC; evict the cached connection on failure so a
        recovered daemon re-dials clean."""
        addr = tuple(n["addr"])
        try:
            return self._pool.get(addr).call(method, payload)
        except Exception:
            self._pool.invalidate(addr)
            raise

    @staticmethod
    def _fan_out(nodes, fn) -> list:
        from concurrent.futures import ThreadPoolExecutor

        alive = [n for n in nodes if n.get("alive")]
        if not alive:
            return []
        # fan out: one wedged daemon must not serialize the sweep
        with ThreadPoolExecutor(max_workers=min(16, len(alive))) as ex:
            return list(ex.map(fn, alive))

    def _cluster_nodes(self) -> list:
        def agent_stats(n):
            try:  # the daemon doubles as the per-node agent
                n["stats"] = self._node_call(n, "stats")
            except Exception as e:  # noqa: BLE001
                n["stats_error"] = repr(e)[:120]
            return n

        nodes = self._gcs_call("list_nodes")
        self._fan_out(nodes, agent_stats)
        return nodes

    def _cluster_actors(self) -> list:
        rows = self._gcs_call("list_actors")
        for r in rows:
            r.pop("creation_spec", None)  # pickled blob, not JSON
        return _jsonable(rows)

    def _cluster_timeline(self) -> list:
        """Chrome-trace events of worker-side execution spans across all
        node daemons (the cross-process half of `ray timeline`; driver-side
        lease/exec spans live in the driver's client)."""
        import time as _time

        # bounded window: shipping each daemon's whole span buffer per poll
        # grows linearly with cluster size
        since = _time.time() - 600.0

        def pull(n):
            try:
                return n["node_id"], self._node_call(n, "timeline", {"since": since})
            except Exception:  # noqa: BLE001
                return n["node_id"], []

        events = []
        for node_id, spans in self._fan_out(self._gcs_call("list_nodes"), pull):
            for s in spans:
                events.append({
                    "name": s.get("desc", "task"),
                    "ph": "X",
                    "ts": float(s.get("start", 0.0)) * 1e6,
                    "dur": max(0.0, float(s.get("end", 0.0)) - float(s.get("start", 0.0))) * 1e6,
                    "pid": node_id,
                    "tid": s.get("worker_id", "worker"),
                    "cat": "exec" if s.get("ok", True) else "error",
                    **({"args": {"trace_id": s["trace_id"], "span_id": s.get("span_id")}}
                       if s.get("trace_id") else {}),
                })
        return events

    def shutdown(self) -> None:
        self._server.shutdown()  # returns once serve_forever has left its loop
        self._server.server_close()
        self._thread.join(timeout=5)
        self._pool.close_all()


def start_dashboard(host: str = "127.0.0.1", port: int = 8265,
                    gcs_address: Optional[str] = None) -> Dashboard:
    global _dashboard
    if _dashboard is None:
        _dashboard = Dashboard(host, port, gcs_address=gcs_address)
    return _dashboard


def shutdown_dashboard() -> None:
    global _dashboard
    if _dashboard is not None:
        _dashboard.shutdown()
        _dashboard = None
