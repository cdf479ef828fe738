"""Serve controller: the singleton control-plane actor (counterpart of
``ray_tpu/serve/controller.py``).

Upstream analog: python/ray/serve/_private/controller.py:84
(ServeController) + deployment_state.py + application_state.py +
autoscaling_state.py, collapsed into one reconciliation loop: desired
state (configs set by deploy) vs actual state (live replica actors),
converged every tick: replica start/stop, health checks, user_config
pushes and queue-depth autoscaling.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.serve.config import (
    ApplicationStatus,
    DeploymentConfig,
    DeploymentStatus,
    ReplicaConfig,
    ReplicaState,
)
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.serve.controller")

CONTROLLER_NAME = "SERVE_CONTROLLER"


def replica_gauges() -> dict:
    """Role-tagged replica gauges: the pool view the telemetry plane
    rolls up by DeploymentConfig.role (prefill/decode pools under
    disaggregated serving) for status readers and the autoscaler."""
    from ray_tpu_torch.obs.telemetry import cluster_gauge

    return {
        "running": cluster_gauge(
            "serve_replicas_running",
            description="serve replicas in RUNNING state per deployment "
            "(role-tagged for pool rollups)",
            tag_keys=("app", "deployment", "role"),
        ),
        "target": cluster_gauge(
            "serve_replicas_target",
            description="serve replica target per deployment "
            "(role-tagged for pool rollups)",
            tag_keys=("app", "deployment", "role"),
        ),
    }


def _differ(a, b) -> bool:
    """Constructor arguments changed? The same objects never did; an
    argument whose ``==`` is not a truth value (a tensor compares
    elementwise) counts as changed."""
    if a is b:
        return False
    try:
        return bool(a != b)
    except (RuntimeError, TypeError, ValueError):
        return True


@dataclass
class _ReplicaInfo:
    replica_id: str
    handle: Any  # ActorHandle of Replica
    state: str = ReplicaState.STARTING
    consecutive_health_failures: int = 0
    last_ongoing: float = 0.0


@dataclass
class _DeploymentState:
    name: str
    app_name: str
    deployment_config: DeploymentConfig
    replica_config: ReplicaConfig
    version: int = 0  # bumped when the running replica set changes
    code_version: int = 0  # bumped when replica_config changes (full restart)
    target_replicas: int = 1
    replicas: list = field(default_factory=list)  # list[_ReplicaInfo]
    status: str = DeploymentStatus.UPDATING
    # consecutive replica deaths with no replica ever reaching RUNNING at
    # this code_version → deploy failure, not a transient fault
    consecutive_start_failures: int = 0
    ever_running: bool = False
    last_error: str = ""
    _counter: int = 0
    # sliding window of (t, total_ongoing) for autoscaling
    metrics_window: list = field(default_factory=list)
    last_scale_up: float = 0.0
    last_scale_down: float = 0.0


@dataclass
class _AppState:
    name: str
    route_prefix: Optional[str]
    ingress: str  # ingress deployment name
    deployments: dict = field(default_factory=dict)  # name -> _DeploymentState
    status: str = ApplicationStatus.DEPLOYING


class ServeController:
    """Run as a detached named actor; reconcile loop in a daemon thread."""

    def __init__(self, reconcile_interval_s: float = 0.1):
        self._lock = threading.RLock()
        self._apps: dict[str, _AppState] = {}
        self._interval = reconcile_interval_s
        self._shutdown = threading.Event()
        self._drains: list = []  # replica drain threads, joined by shutdown()
        self._thread = threading.Thread(
            target=self._reconcile_loop, name="serve-reconcile", daemon=True
        )
        self._thread.start()

    # -- deploy / delete ------------------------------------------------------

    def deploy_application(
        self,
        name: str,
        route_prefix: Optional[str],
        ingress: str,
        deployments: list,
    ) -> None:
        """deployments: list of (dep_name, DeploymentConfig, ReplicaConfig)."""
        with self._lock:
            app = self._apps.get(name)
            if app is None:
                app = _AppState(name=name, route_prefix=route_prefix, ingress=ingress)
                self._apps[name] = app
            app.route_prefix = route_prefix
            app.ingress = ingress
            app.status = ApplicationStatus.DEPLOYING
            new_names = set()
            for dep_name, dcfg, rcfg in deployments:
                new_names.add(dep_name)
                ds = app.deployments.get(dep_name)
                if ds is None:
                    ds = _DeploymentState(
                        name=dep_name,
                        app_name=name,
                        deployment_config=dcfg,
                        replica_config=rcfg,
                    )
                    ds.target_replicas = dcfg.target_initial_replicas()
                    app.deployments[dep_name] = ds
                else:
                    self._apply_update(ds, dcfg, rcfg)
            # deployments removed from the app spec are torn down
            for stale in set(app.deployments) - new_names:
                for r in app.deployments[stale].replicas:
                    self._stop_replica(app.deployments[stale], r)
                self._retract_replica_gauges(app.deployments[stale])
                del app.deployments[stale]

    def _apply_update(
        self, ds: _DeploymentState, dcfg: DeploymentConfig, rcfg: ReplicaConfig
    ) -> None:
        """In-place update semantics (reference deployment_state's
        lightweight-update path): user_config-only changes push
        reconfigure(); replica_config changes roll all replicas."""
        old = ds.deployment_config
        code_changed = (
            rcfg.callable_factory is not ds.replica_config.callable_factory
            or _differ(rcfg.init_args, ds.replica_config.init_args)
            or _differ(rcfg.init_kwargs, ds.replica_config.init_kwargs)
        )
        user_config_changed = dcfg.user_config != old.user_config
        ds.deployment_config = dcfg
        ds.replica_config = rcfg
        if dcfg.autoscaling_config is None:
            ds.target_replicas = dcfg.num_replicas
        else:
            ac = dcfg.autoscaling_config
            ds.target_replicas = max(
                ac.min_replicas, min(ac.max_replicas, max(ds.target_replicas, 1))
            )
        if code_changed:
            ds.code_version += 1
            ds.status = DeploymentStatus.UPDATING
            ds.consecutive_start_failures = 0
            ds.ever_running = False
            ds.last_error = ""
            for r in list(ds.replicas):
                self._stop_replica(ds, r)
        elif user_config_changed and dcfg.user_config is not None:
            for r in ds.replicas:
                try:
                    r.handle.reconfigure.remote(dcfg.user_config)
                except Exception:
                    logger.exception("reconfigure push failed")

    def delete_application(self, name: str) -> None:
        with self._lock:
            app = self._apps.get(name)
            if app is None:
                return
            app.status = ApplicationStatus.DELETING
            for ds in app.deployments.values():
                ds.target_replicas = 0
                for r in list(ds.replicas):
                    self._stop_replica(ds, r)
                self._retract_replica_gauges(ds)
            del self._apps[name]

    def shutdown(self) -> None:
        """Delete every application and wait (bounded by the deployments'
        graceful_shutdown_timeout_s) for their replicas to drain and run
        their shutdown hooks, so a caller of serve.shutdown() finds the
        replicas' resources (an engine's device memory) released."""
        with self._lock:
            grace = max([ds.deployment_config.graceful_shutdown_timeout_s
                         for app in self._apps.values() for ds in app.deployments.values()],
                        default=0.0)
            for name in list(self._apps):
                self.delete_application(name)
            drains, self._drains = self._drains, []
        deadline = time.time() + grace + 2.0
        for t in drains:
            t.join(timeout=max(0.0, deadline - time.time()))
        self._shutdown.set()

    # -- queries (router / proxy / status surface) ---------------------------

    def get_running_replicas(self, app_name: str, dep_name: str) -> dict:
        with self._lock:
            ds = self._get_ds(app_name, dep_name)
            if ds is None:
                return {"version": -1, "replicas": [], "max_queued_requests": -1}
            reps = [
                (
                    r.replica_id,
                    r.handle,
                    ds.deployment_config.max_ongoing_requests,
                )
                for r in ds.replicas
                if r.state == ReplicaState.RUNNING
            ]
            return {
                "version": ds.version,
                "replicas": reps,
                # shipped with every refresh so routers track config updates
                "max_queued_requests": ds.deployment_config.max_queued_requests,
                # pool role ("prefill"/"decode" under disaggregated
                # serving): pool-aware clients tell deployments apart
                # without a second control-plane call
                "role": ds.deployment_config.role,
            }

    def get_ingress(self, app_name: str):
        with self._lock:
            app = self._apps.get(app_name)
            return app.ingress if app else None

    def get_app_route(self, app_name: str) -> Optional[str]:
        with self._lock:
            app = self._apps.get(app_name)
            return app.route_prefix if app else None

    def list_routes(self) -> dict:
        """route_prefix -> (app_name, ingress_deployment)."""
        with self._lock:
            return {
                app.route_prefix: (app.name, app.ingress)
                for app in self._apps.values()
                if app.route_prefix is not None
            }

    def status(self) -> dict:
        with self._lock:
            out = {"applications": {}}
            for app in self._apps.values():
                deps = {}
                for ds in app.deployments.values():
                    deps[ds.name] = {
                        "status": ds.status,
                        "message": ds.last_error,
                        "replica_states": {
                            s: sum(1 for r in ds.replicas if r.state == s)
                            for s in (ReplicaState.STARTING, ReplicaState.RUNNING)
                        },
                        "target_replicas": ds.target_replicas,
                    }
                    if ds.deployment_config.role:
                        deps[ds.name]["role"] = ds.deployment_config.role
                out["applications"][app.name] = {
                    "status": app.status,
                    "route_prefix": app.route_prefix,
                    "deployments": deps,
                }
            return out

    def _get_ds(self, app_name: str, dep_name: str) -> Optional[_DeploymentState]:
        app = self._apps.get(app_name)
        if app is None:
            return None
        return app.deployments.get(dep_name)

    # -- reconciliation -------------------------------------------------------

    def _reconcile_loop(self) -> None:
        last_health = 0.0
        while not self._shutdown.is_set():
            try:
                now = time.time()
                with self._lock:
                    for app in list(self._apps.values()):
                        for ds in app.deployments.values():
                            self._reconcile_deployment(ds, now)
                            self._export_replica_gauges(ds)
                        self._update_app_status(app)
                if now - last_health > 1.0:
                    last_health = now
                    self._poll_replicas()
            except Exception:
                logger.exception("reconcile tick failed")
            self._shutdown.wait(self._interval)

    def _reconcile_deployment(self, ds: _DeploymentState, now: float) -> None:
        self._autoscale(ds, now)
        running = [r for r in ds.replicas if r.state == ReplicaState.RUNNING]
        starting = [r for r in ds.replicas if r.state == ReplicaState.STARTING]
        n_live = len(running) + len(starting)
        if ds.consecutive_start_failures >= 3 and not ds.ever_running:
            # every replica of this code version died before serving: a
            # broken deployment, not a transient fault — stop crash-looping
            ds.status = DeploymentStatus.UNHEALTHY
            return
        for _ in range(ds.target_replicas - n_live):
            self._start_replica(ds)
        if n_live > ds.target_replicas:
            # scale down: prefer stopping STARTING, then least-loaded RUNNING
            excess = n_live - ds.target_replicas
            victims = (starting + sorted(running, key=lambda r: r.last_ongoing))[:excess]
            for r in victims:
                self._stop_replica(ds, r)
        # STARTING → RUNNING promotion happens in _poll_replicas (health ping)
        if ds.target_replicas > 0 and running and not starting:
            ds.status = DeploymentStatus.HEALTHY
        elif starting:
            ds.status = DeploymentStatus.UPDATING

    def _export_replica_gauges(self, ds: _DeploymentState) -> None:
        """Publish running/target replica counts into the process metrics
        registry (telemetry-plane pool rollups key off the role tag)."""
        try:
            g = replica_gauges()
            tags = {
                "app": ds.app_name,
                "deployment": ds.name,
                "role": ds.deployment_config.role,
            }
            running = sum(
                1 for r in ds.replicas if r.state == ReplicaState.RUNNING
            )
            g["running"].set(running, tags=tags)
            g["target"].set(ds.target_replicas, tags=tags)
        except Exception:  # noqa: BLE001 — observability must not break serve
            pass

    def _retract_replica_gauges(self, ds: _DeploymentState) -> None:
        """Remove a deleted deployment's gauge series — a gauge that is
        merely no longer updated keeps its last value in the registry and
        every telemetry snapshot would keep shipping phantom replicas."""
        try:
            g = replica_gauges()
            tags = {
                "app": ds.app_name,
                "deployment": ds.name,
                "role": ds.deployment_config.role,
            }
            g["running"].remove_series(tags=tags)
            g["target"].remove_series(tags=tags)
        except Exception:  # noqa: BLE001 — observability must not break serve
            pass

    def _update_app_status(self, app: _AppState) -> None:
        statuses = {ds.status for ds in app.deployments.values()}
        if statuses <= {DeploymentStatus.HEALTHY}:
            app.status = ApplicationStatus.RUNNING
        elif DeploymentStatus.UNHEALTHY in statuses:
            never_served = any(
                ds.status == DeploymentStatus.UNHEALTHY and not ds.ever_running
                for ds in app.deployments.values()
            )
            app.status = (
                ApplicationStatus.DEPLOY_FAILED
                if never_served and app.status == ApplicationStatus.DEPLOYING
                else ApplicationStatus.UNHEALTHY
            )

    def _start_replica(self, ds: _DeploymentState) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import Replica

        ds._counter += 1
        rid = f"{ds.app_name}#{ds.name}#{ds.code_version}.{ds._counter}"
        rcfg = ds.replica_config
        try:
            handle = (
                ray_tpu_torch.remote(Replica)
                .options(
                    num_cpus=rcfg.num_cpus,
                    num_gpus=rcfg.num_gpus,
                    resources=dict(rcfg.resources),
                    # high cap: the replica gates data-plane concurrency
                    # itself so control-plane calls never queue behind it
                    max_concurrency=10_000,
                    name=f"SERVE_REPLICA::{rid}",
                )
                .remote(
                    ds.name,
                    ds.app_name,
                    rcfg.callable_factory,
                    rcfg.init_args,
                    rcfg.init_kwargs,
                    rcfg.is_function,
                    ds.deployment_config.user_config,
                    ds.deployment_config.max_ongoing_requests,
                )
            )
        except Exception:
            logger.exception("replica start failed for %s", rid)
            ds.status = DeploymentStatus.UNHEALTHY
            return
        ds.replicas.append(_ReplicaInfo(replica_id=rid, handle=handle))

    def _stop_replica(self, ds: _DeploymentState, r: _ReplicaInfo) -> None:
        import ray_tpu_torch

        r.state = ReplicaState.STOPPING
        ds.replicas.remove(r)
        ds.version += 1

        timeout = ds.deployment_config.graceful_shutdown_timeout_s

        def _drain():
            try:
                ray_tpu_torch.get(r.handle.prepare_shutdown.remote(timeout), timeout=timeout + 1)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(r.handle)
            except Exception:
                pass

        t = threading.Thread(target=_drain, name=f"serve-drain-{r.replica_id}", daemon=True)
        t.start()
        # the caller holds _lock (every stop runs inside a locked update)
        self._drains = [d for d in self._drains if d.is_alive()] + [t]

    def kill_replica(self, app_name: str, dep_name: Optional[str] = None,
                     replica_id: Optional[str] = None) -> Optional[str]:
        """Fault injection (chaos KILL_REPLICA, run by ``ChaosRunner``):
        crash one replica without any bookkeeping, as a preempted replica
        looks. The health sweep finds the corpse (``ActorDiedError`` on its
        ping), evicts it and starts a replacement; routers fail over
        meanwhile. Returns the killed replica's id, or None when nothing
        ran (an unknown deployment name kills nothing)."""
        import ray_tpu_torch

        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return None
            if dep_name:
                if dep_name not in app.deployments:
                    return None
                deps = [app.deployments[dep_name]]
            else:
                deps = list(app.deployments.values())
            victim = None
            for ds in deps:
                pool = [r for r in ds.replicas if r.state == ReplicaState.RUNNING] \
                    or list(ds.replicas)
                for r in pool:
                    if replica_id in (None, r.replica_id):
                        victim = r
                        break
                if victim is not None:
                    break
        if victim is None:
            return None
        logger.warning("chaos: killing replica %s", victim.replica_id)
        try:
            ray_tpu_torch.kill(victim.handle)
        except Exception:  # noqa: BLE001 — reported as nothing killed
            logger.exception("chaos replica kill failed")
            return None
        return victim.replica_id

    def _poll_replicas(self) -> None:
        """Health-check + metrics sweep (outside the lock for the RPCs).
        Fan out all pings first, then collect — one wedged replica must not
        stall checks for every other deployment."""
        import ray_tpu_torch

        with self._lock:
            targets = [
                (ds, r)
                for app in self._apps.values()
                for ds in app.deployments.values()
                for r in list(ds.replicas)
            ]
        pings = []
        for ds, r in targets:
            try:
                pings.append(r.handle.ping.remote())
            except Exception:
                pings.append(None)
        for (ds, r), ref in zip(targets, pings):
            try:
                if ref is None:
                    raise RuntimeError("ping dispatch failed")
                metrics = ray_tpu_torch.get(
                    ref,
                    timeout=ds.deployment_config.health_check_timeout_s,
                )
                with self._lock:
                    r.consecutive_health_failures = 0
                    r.last_ongoing = metrics["num_ongoing_requests"]
                    if r.state == ReplicaState.STARTING:
                        r.state = ReplicaState.RUNNING
                        ds.version += 1
                        ds.ever_running = True
                        ds.consecutive_start_failures = 0
            except Exception as e:
                from ray_tpu_torch.core.errors import ActorDiedError

                with self._lock:
                    r.consecutive_health_failures += 1
                    # a dead actor (e.g. constructor raised) needs no 3-strike
                    # grace — replace (or give up) immediately
                    dead = isinstance(e, ActorDiedError)
                    if dead or r.consecutive_health_failures >= 3:
                        logger.warning(
                            "replica %s %s; replacing",
                            r.replica_id,
                            "died" if dead else "failed health checks",
                        )
                        if r in ds.replicas:
                            ds.replicas.remove(r)
                            ds.version += 1
                        if r.state == ReplicaState.STARTING and not ds.ever_running:
                            ds.consecutive_start_failures += 1
                            ds.last_error = f"{type(e).__name__}: {e}"
                        try:
                            ray_tpu_torch.kill(r.handle)
                        except Exception:
                            pass
        # fold fresh ongoing counts into autoscaling windows
        with self._lock:
            now = time.time()
            for app in self._apps.values():
                for ds in app.deployments.values():
                    total = sum(r.last_ongoing for r in ds.replicas)
                    ds.metrics_window.append((now, total))

    def _autoscale(self, ds: _DeploymentState, now: float) -> None:
        ac = ds.deployment_config.autoscaling_config
        if ac is None:
            ds.target_replicas = ds.deployment_config.num_replicas
            return
        ds.metrics_window = [
            (t, v) for t, v in ds.metrics_window if now - t <= ac.look_back_period_s
        ]
        if not ds.metrics_window:
            return
        avg_total = sum(v for _, v in ds.metrics_window) / len(ds.metrics_window)
        current = max(1, len(ds.replicas))
        desired = ac.desired_replicas(avg_total, current)
        if desired > ds.target_replicas and now - ds.last_scale_up >= ac.upscale_delay_s:
            ds.target_replicas = desired
            ds.last_scale_up = now
            ds.status = DeploymentStatus.UPSCALING
        elif (
            desired < ds.target_replicas
            and now - ds.last_scale_down >= ac.downscale_delay_s
        ):
            ds.target_replicas = desired
            ds.last_scale_down = now
            ds.status = DeploymentStatus.DOWNSCALING
