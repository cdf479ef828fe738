"""ChaosRunner: executes a schedule's orchestrated faults on a timeline
(counterpart of ``ray_tpu/chaos/runner.py``).

In-process faults fire inline at hook sites; process-level faults
(``PREEMPT_NODE``, ``KILL_GCS``, ``KILL_GCS_PRIMARY``,
``PARTITION_GCS_PAIR``, and ``KILL_WORKER`` / ``KILL_REPLICA`` specs given
an ``at_s`` offset) need an executor with a handle on the blast radius.
The runner walks ``schedule.orchestrated()`` sorted by ``at_s`` on a
daemon thread, picking targets from the spec's seeded RNG when the spec
names none:

 * ``PREEMPT_NODE``       -> ``LocalCluster.kill_node`` (SIGKILL of the
   daemon and its workers; the GCS learns by heartbeat timeout);
 * ``KILL_WORKER``        -> the node daemon's ``chaos_kill_worker`` RPC
   (the newest leased worker dies mid-task);
 * ``KILL_GCS``           -> ``LocalCluster.kill_gcs``, and its restart
   ``restart_after_s`` later (a ``gcs.outage`` span covers the blackout);
 * ``KILL_GCS_PRIMARY``   -> ``LocalCluster.kill_gcs_primary``: no restart,
   the standby promotes when its lease expires (a ``gcs.failover`` span);
 * ``PARTITION_GCS_PAIR`` -> the standby's ``ha_partition`` hook and this
   process's ``harness.BLOCKED_PEERS`` for ``window_s``: the standby
   promotes while the primary lives, and the fencing term retires it;
 * ``KILL_REPLICA``       -> the Serve controller's ``kill_replica``.

Every executed fault is appended to the schedule's ``log`` and recorded
in the flight recorder as a ``chaos.<kind>`` span, so a post-mortem reads
one merged sequence.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch.chaos.schedule import (
    KILL_GCS,
    KILL_GCS_PRIMARY,
    KILL_REPLICA,
    KILL_WORKER,
    PARTITION_GCS_PAIR,
    PREEMPT_NODE,
    Fault,
    FaultSchedule,
)
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.chaos.runner")


class ChaosRunner:
    def __init__(
        self,
        schedule: FaultSchedule,
        *,
        cluster=None,           # ray_tpu_torch.cluster.LocalCluster (node faults)
        controller_handle=None,  # serve controller (replica faults)
    ):
        self.schedule = schedule
        self.cluster = cluster
        self.controller = controller_handle
        self.executed: list[Fault] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._restart_threads: list[threading.Thread] = []

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ChaosRunner":
        self._thread = threading.Thread(
            target=self._run, name="chaos-runner", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for t in self._restart_threads:
            t.join(timeout=5)

    def join(self, timeout: float = 60.0) -> None:
        """Wait for the timeline (and any scheduled restart or heal) to end,
        each thread at most ``timeout`` seconds."""
        if self._thread is not None:
            self._thread.join(timeout)
        for t in self._restart_threads:
            t.join(timeout)

    # -- execution ------------------------------------------------------------

    def _run(self) -> None:
        t0 = time.monotonic()
        for idx, spec in self.schedule.orchestrated():
            wait = spec.at_s - (time.monotonic() - t0)
            if wait > 0 and self._stop.wait(wait):
                return
            if self._stop.is_set():
                return
            try:
                self._execute(idx, spec)
            except Exception:  # noqa: BLE001 — one failed kill must not end the run
                logger.exception("orchestrated fault %s failed", spec.kind)

    def _execute(self, idx, spec) -> None:
        attrs: dict = {}
        if spec.kind == PREEMPT_NODE:
            attrs = self._preempt_node(idx, spec)
        elif spec.kind == KILL_WORKER:
            attrs = self._kill_worker(idx, spec)
        elif spec.kind == KILL_REPLICA:
            attrs = self._kill_replica(idx, spec)
        elif spec.kind == KILL_GCS:
            attrs = self._kill_gcs(idx, spec)
        elif spec.kind == KILL_GCS_PRIMARY:
            attrs = self._kill_gcs_primary(idx, spec)
        elif spec.kind == PARTITION_GCS_PAIR:
            attrs = self._partition_gcs_pair(idx, spec)
        else:
            return
        with self.schedule._lock:
            fault = Fault(
                seq=self.schedule._seq, kind=spec.kind, site="runner",
                spec_index=idx, attrs=attrs, t=time.time(),
            )
            self.schedule._seq += 1
            self.schedule.log.append(fault)
        self.executed.append(fault)
        # mirror into the obs flight recorder like in-process hook fires,
        # so orchestrated kills land in Chrome-trace exports too
        from ray_tpu_torch.chaos import harness as _harness

        _harness._record_obs_event("runner", spec.kind, attrs)
        logger.warning("chaos: executed %s %s", spec.kind, attrs)

    def _preempt_node(self, idx, spec) -> dict:
        if self.cluster is None:
            raise RuntimeError("PREEMPT_NODE needs a cluster")
        node_id = spec.target or self.schedule.pick(
            idx, list(self.cluster.nodes.keys())
        )
        self.cluster.kill_node(node_id)
        return {"node_id": node_id}

    def _kill_worker(self, idx, spec) -> dict:
        if self.cluster is None:
            raise RuntimeError("KILL_WORKER (orchestrated) needs a cluster")
        node_id = spec.target or self.schedule.pick(
            idx, list(self.cluster.nodes.keys())
        )
        node = self.cluster.nodes[node_id]
        client = self.cluster.client()
        r = client.pool.get(tuple(node.addr)).call(
            "chaos_kill_worker", {}, timeout=10
        )
        return {"node_id": node_id, **(r or {})}

    def _kill_gcs(self, idx, spec) -> dict:
        """SIGKILL the control plane; optionally schedule its restart
        ``restart_after_s`` later — the blackout window the data plane
        must serve through. The restart runs on its own thread so a long
        window never delays other orchestrated faults; the ``gcs.outage``
        obs span covers kill -> restart so Chrome-trace exports show the
        blackout instead of an unexplained metrics gap."""
        if self.cluster is None:
            raise RuntimeError("KILL_GCS needs a cluster")
        t_kill = time.time()
        self.cluster.kill_gcs()
        attrs = {"restart_after_s": spec.restart_after_s}
        if spec.restart_after_s > 0:
            def _restart():
                if self._stop.wait(spec.restart_after_s):
                    return
                try:
                    self.cluster.restart_gcs()
                except Exception:  # noqa: BLE001 — surface, don't die
                    logger.exception("chaos: scheduled GCS restart failed")
                    return
                try:
                    from ray_tpu_torch.obs import recorder as _recorder

                    _recorder.get_recorder().record(
                        "gcs.outage", t_kill, time.time(),
                        attrs={"restart_after_s": str(spec.restart_after_s)},
                        status="error",
                    )
                except Exception:  # noqa: BLE001
                    pass
                logger.warning("chaos: restarted GCS after blackout")

            t = threading.Thread(
                target=_restart, name="chaos-gcs-restart", daemon=True
            )
            t.start()
            self._restart_threads.append(t)
        return attrs

    def _kill_gcs_primary(self, idx, spec) -> dict:
        """SIGKILL the primary GCS with NO restart (KILL_GCS_PRIMARY):
        the warm standby's lease expires and it promotes in place — the
        failover path, as opposed to _kill_gcs's blackout-then-restart.
        The promotion itself is asynchronous (lease-driven inside the
        standby); callers observe it through ha_status / the
        gcs_failovers_total counter."""
        if self.cluster is None:
            raise RuntimeError("KILL_GCS_PRIMARY needs a cluster")
        standby = getattr(self.cluster, "standby_addr", None)
        if standby is None:
            raise RuntimeError(
                "KILL_GCS_PRIMARY needs a standby GCS "
                "(LocalCluster(standby=True))"
            )
        t_kill = time.time()
        self.cluster.kill_gcs_primary()
        try:
            from ray_tpu_torch.obs import recorder as _recorder

            _recorder.get_recorder().record(
                "gcs.failover", t_kill, time.time(),
                attrs={"standby": f"{standby[0]}:{standby[1]}"},
                status="error",
            )
        except Exception:  # noqa: BLE001
            pass
        return {"standby": tuple(standby), "restart": False}

    def _partition_gcs_pair(self, idx, spec) -> dict:
        """Open a split-brain window (PARTITION_GCS_PAIR): the standby
        stops seeing the primary for ``window_s`` (server-side
        ha_partition hook), so its lease expires and it promotes WHILE
        the primary is still alive. This process blocks its own view of
        the old primary for the same window (harness.BLOCKED_PEERS), so
        multi-endpoint clients here discover the promoted standby and
        its bumped term — after heal, the first fenced call the old
        primary sees retires it. Exactly one term wins."""
        if self.cluster is None:
            raise RuntimeError("PARTITION_GCS_PAIR needs a cluster")
        standby = getattr(self.cluster, "standby_addr", None)
        if standby is None:
            raise RuntimeError(
                "PARTITION_GCS_PAIR needs a standby GCS "
                "(LocalCluster(standby=True))"
            )
        from ray_tpu_torch.chaos import harness as _harness
        from ray_tpu_torch.cluster.rpc import RpcClient

        window = spec.window_s
        primary = tuple(self.cluster.gcs_addr)
        c = RpcClient(*standby, timeout=10.0).connect(retries=3)
        try:
            c.call("ha_partition", {"window_s": window}, timeout=10.0)
        finally:
            c.close()
        _harness.BLOCKED_PEERS.add(primary)

        def _heal():
            # heal even when stopped early: a blocked peer must never
            # outlive the chaos run
            self._stop.wait(window)
            _harness.BLOCKED_PEERS.discard(primary)
            logger.warning("chaos: GCS pair partition healed")

        t = threading.Thread(
            target=_heal, name="chaos-partition-heal", daemon=True
        )
        t.start()
        self._restart_threads.append(t)
        return {
            "window_s": window,
            "primary": primary,
            "standby": tuple(standby),
        }

    def _kill_replica(self, idx, spec) -> dict:
        if self.controller is None:
            raise RuntimeError("KILL_REPLICA (orchestrated) needs a controller")
        import ray_tpu_torch

        app, _, dep = (spec.target or "").partition("/")
        if not app:
            # no target: pick the victim app from the spec's seeded RNG
            # (same contract as _preempt_node), not a silent no-op
            st = ray_tpu_torch.get(self.controller.status.remote(), timeout=60)
            apps = sorted(st.get("applications", {}))
            if not apps:
                raise RuntimeError("KILL_REPLICA: no serve applications")
            app = self.schedule.pick(idx, apps)
        rid = ray_tpu_torch.get(
            self.controller.kill_replica.remote(app, dep or None), timeout=60
        )
        if rid is None:
            # nothing died — surfacing this matters more than the kill:
            # a chaos run that silently skips its fault tests nothing
            raise RuntimeError(
                f"KILL_REPLICA: no running replica in app {app!r}"
            )
        return {"replica_id": rid, "app": app, "deployment": dep}
