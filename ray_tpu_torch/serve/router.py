"""Request router: picks a replica per request (counterpart of
``ray_tpu/serve/router.py``).

Upstream analog: python/ray/serve/_private/router.py:321 +
replica_scheduler/pow_2_scheduler.py, power-of-two-choices over replica
queue lengths. This router keeps its own in-flight count per replica
(incremented on dispatch, decremented on completion) instead of cached
queue-length RPCs: every router lives in the process, so local counts are
exact for one router and a cheap approximation across several.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional


class BackpressureError(Exception):
    """max_queued_requests exceeded at the router (reference:
    serve._private.router queue-length backpressure)."""


class Router:
    def __init__(
        self,
        deployment_name: str,
        app_name: str,
        controller_handle,
    ):
        self._deployment = deployment_name
        self._app = app_name
        self._controller = controller_handle
        self._max_queued = -1  # refreshed with the replica set
        self._lock = threading.Lock()
        self._replicas: list = []  # list[(replica_id, ActorHandle, max_ongoing)]
        self._version = -1
        self._inflight: dict[str, int] = {}
        self._last_refresh = 0.0
        # failover suspects: replica_id -> expiry. A reported-dead replica
        # is avoided for SUSPECT_TTL_S even after a refresh re-adopts the
        # controller's (not yet updated) set — without routing forever
        # around a replica that only suffered an injected/transient crash
        self._suspect: dict[str, float] = {}

    SUSPECT_TTL_S = 2.0

    # -- replica-set maintenance ---------------------------------------------

    def _refresh(self, block: bool = False) -> None:
        """Pull the running replica set from the controller if stale.
        (The reference pushes via long-poll; a pull with a version check
        is equivalent single-host and far simpler.)"""
        import ray_tpu_torch

        now = time.time()
        if not block:
            # the staleness fast path: two reads under _lock, held for
            # nothing else (no RPC, no wait), so concurrent dispatches
            # pass it one after another in well under a microsecond each
            with self._lock:
                if self._replicas and now - self._last_refresh < 0.25:
                    return
        try:
            info = ray_tpu_torch.get(
                self._controller.get_running_replicas.remote(self._app, self._deployment)
            )
        except Exception:
            # degraded-mode contract (control-plane blackout): the
            # controller/GCS being unreachable may only cost routing
            # FRESHNESS — keep serving the cached replica set and retry
            # the refresh on a later dispatch. Only an empty cache (no
            # replicas ever seen) propagates the failure.
            with self._lock:
                if self._replicas:
                    self._last_refresh = now
                    return
            raise
        with self._lock:
            self._last_refresh = now
            self._max_queued = info.get("max_queued_requests", -1)
            if info["version"] != self._version:
                self._version = info["version"]
                self._replicas = info["replicas"]
                live = {rid for rid, _, _ in self._replicas}
                self._inflight = {
                    rid: n for rid, n in self._inflight.items() if rid in live
                }

    def _wait_for_replicas(self, timeout: float = 30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            self._refresh(block=True)
            with self._lock:
                if self._replicas:
                    return
            time.sleep(0.05)
        raise TimeoutError(
            f"no running replicas for deployment "
            f"{self._app}/{self._deployment} after {timeout}s"
        )

    def report_failure(self, rid: str) -> None:
        """Failover eviction: a dispatch to this replica hit a system
        failure (actor died / crashed mid-request). Drop it from the local
        routing set immediately — the controller's health sweep replaces
        it, but until that lands no new request should race onto the
        corpse — and force a controller refresh on the next dispatch."""
        with self._lock:
            self._replicas = [r for r in self._replicas if r[0] != rid]
            # the inflight count is NOT popped: a replica that survives a
            # transient crash comes back with its real outstanding load
            # (zeroing it would make p2c prefer the busiest replica);
            # a genuinely dead replica's counter is pruned by the refresh
            # once the controller drops it
            # TTL'd suspicion: the refresh below may re-adopt the
            # controller's set (its health sweep runs on seconds) with
            # the corpse still in it — _pick avoids suspects while an
            # alternative exists, and expiry lets a replica that only
            # suffered an injected/transient crash come back
            self._suspect[rid] = time.time() + self.SUSPECT_TTL_S
            # force the next refresh to re-adopt the controller's set even
            # at an unchanged version: a crash that didn't kill the actor
            # (injected fault, transient) leaves the controller's view
            # intact, and the evicted replica must be able to come back
            self._last_refresh = 0.0
            self._version = -1

    # -- scheduling -----------------------------------------------------------

    def _pick(self, exclude: Optional[set] = None):
        """Power-of-two-choices on local in-flight counts. ``exclude``
        (failover retries) removes replicas this request already died on,
        falling back to them only when nothing else exists."""
        now = time.time()
        with self._lock:
            for rid in [r for r, t in self._suspect.items() if t <= now]:
                del self._suspect[rid]
            suspects = set(self._suspect)
            replicas = list(self._replicas)
            # p2c reads its two counts from this snapshot: a heuristic, so a
            # count that moves before the pick skews one pick, never the
            # accounting (increments and decrements stay under _lock)
            inflight = dict(self._inflight)

        def _avoiding(pool):
            # preference ladder: avoid suspects AND this request's failed
            # replicas; if that empties the pool, drop only the (possibly
            # stale) suspicion — a replica THIS request died on is a hard
            # fact and must stay excluded while any alternative exists
            hard = set(exclude or ())
            best = [r for r in pool if r[0] not in suspects and r[0] not in hard]
            if best:
                return best
            unfailed = [r for r in pool if r[0] not in hard]
            return unfailed or pool

        replicas = _avoiding(replicas)
        if not replicas:
            self._wait_for_replicas()
            with self._lock:
                replicas = list(self._replicas)
                inflight = dict(self._inflight)
            replicas = _avoiding(replicas)
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        na = inflight.get(a[0], 0)
        nb = inflight.get(b[0], 0)
        return a if na <= nb else b

    def dispatch(self, method_name: Optional[str], args, kwargs, streaming: bool,
                 exclude: Optional[set] = None):
        """Route one request by power-of-two-choices; returns (replica_id,
        ObjectRef-or-generator).

        The dispatch wall-clock (refresh + pick + submit: the router's own
        contribution to request latency) lands in the
        serve_router_dispatch_seconds histogram; the trace context, when
        the caller carries one, rides the actor-task envelope the
        `.remote()` below captures, so the replica executes inside the
        request's trace."""
        t0 = time.perf_counter()
        self._refresh()
        with self._lock:
            # one consistent snapshot: inflight sum and replica count move
            # together under _lock, so backpressure prices a real state
            over_queued = self._max_queued >= 0 and sum(
                self._inflight.values()
            ) >= self._max_queued + len(self._replicas)
        if over_queued:
            raise BackpressureError(
                f"deployment {self._app}/{self._deployment}: "
                f"max_queued_requests={self._max_queued} exceeded"
            )
        rid, handle, _max_ongoing = self._pick(exclude)
        with self._lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + 1
        try:
            if streaming:
                ref = handle.handle_request_streaming.options(
                    num_returns="streaming"
                ).remote(method_name, args, kwargs)
            else:
                ref = handle.handle_request.remote(method_name, args, kwargs)
        except Exception:
            with self._lock:
                self._inflight[rid] = max(0, self._inflight.get(rid, 1) - 1)
            raise
        finally:
            from ray_tpu_torch.obs import slo

            slo.record_dispatch(
                self._app, self._deployment, time.perf_counter() - t0
            )
        return rid, ref

    def complete(self, rid: str) -> None:
        with self._lock:
            self._inflight[rid] = max(0, self._inflight.get(rid, 1) - 1)
