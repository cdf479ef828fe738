"""Actuators: how autoscale decisions become replica changes (counterpart
of ``ray_tpu/autoscale/actuators.py``).

Three implementations of one small surface:

* ``ServePoolActuator`` — drives the serve controller's pool-level
  target (``ServeController.set_pool_target``); scale-down rides the
  reconcile loop's graceful drain (prepare_shutdown before kill).
* ``FleetPoolActuator`` — a ``FleetManager``'s per-model replica pools
  (``FleetManager.set_pool_target`` / ``pool_state``).
* ``EnginePoolActuator`` — in-process replica pools for benches and
  chaos tests: replicas are any objects with ``drain()``/``close()``,
  scale-down drains the victim and RE-TARGETS its unfinished work onto
  the survivors (zero lost requests, even when chaos kills the victim
  mid-drain), and 0 -> N goes through a caller-supplied cold-start
  factory (fabric weight streaming via ``autoscale.coldstart``).

All keep the invariants the policy assumes: decreases never hard-kill
serving replicas, and a cold start is just a scale-up whose factory
streams weights.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscale.policy import (
    ACTION_COLD_START,
    ACTION_SCALE_DOWN,
    ACTION_SCALE_TO_ZERO,
    Decision,
)
from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.autoscale.actuators")


class PoolActuator:
    """Minimal actuator surface the controller drives."""

    def apply(self, decision: Decision) -> None:
        raise NotImplementedError

    def pool_state(self) -> Dict[str, dict]:
        """{pool: {"replicas_running": int, "replicas_target": int}}"""
        raise NotImplementedError


class ServePoolActuator(PoolActuator):
    """Drive serve-controller pools by role tag. Accepts either a local
    ``ServeController`` instance or its actor handle (the singleton
    actor: methods called via ``.remote`` + ``ray_tpu_torch.get``)."""

    def __init__(self, controller: Any, call_timeout_s: float = 10.0):
        self._controller = controller
        self._timeout = call_timeout_s

    def _call(self, method: str, *args):
        fn = getattr(self._controller, method)
        if hasattr(fn, "remote"):
            import ray_tpu_torch

            return ray_tpu_torch.get(fn.remote(*args), timeout=self._timeout)
        return fn(*args)

    def apply(self, decision: Decision) -> None:
        if not decision.is_scale_action or decision.target is None:
            return
        out = self._call("set_pool_target", decision.pool, decision.target)
        logger.info(
            "serve pool %s -> %d (%s): %s",
            decision.pool, decision.target, decision.action,
            out.get("deployments"),
        )

    def pool_state(self) -> Dict[str, dict]:
        return self._call("pool_state", None)


class FleetPoolActuator(PoolActuator):
    """Drive a FleetManager's per-model replica pools: pools are
    base model ids, targets converge via ``FleetManager.set_pool_target``
    (spawned replicas stream the fleet's current weight version from the
    weight plane; scale-down retires only replicas that drain idle — the
    same never-hard-kill invariant as the other actuators)."""

    def __init__(self, manager: Any, drain_timeout_s: float = 5.0):
        self._manager = manager
        self._drain_timeout_s = drain_timeout_s

    def apply(self, decision: Decision) -> None:
        if not decision.is_scale_action or decision.target is None:
            return
        target = max(1, int(decision.target))  # a fleet model never parks at 0
        got = self._manager.set_pool_target(
            decision.pool, target, drain_timeout_s=self._drain_timeout_s
        )
        logger.info(
            "fleet pool %s -> %d (%s): now %d replica(s)",
            decision.pool, target, decision.action, got,
        )

    def pool_state(self) -> Dict[str, dict]:
        return self._manager.pool_state()


class EnginePoolActuator(PoolActuator):
    """In-process pools of replica workers.

    ``spawn(pool)`` builds a warm replica; ``cold_start(pool)`` (used
    only for the 0 -> N transition when provided) builds one with
    fabric-streamed weights. Replicas may expose ``drain(timeout_s) ->
    list`` (unfinished work to re-target) and ``close()``; both are
    optional. Thread-safe: the controller loop and bench load threads
    may look at pool state concurrently."""

    def __init__(
        self,
        spawn: Callable[[str], Any],
        cold_start: Optional[Callable[[str], Any]] = None,
        requeue: Optional[Callable[[str, list], None]] = None,
        drain_timeout_s: float = 10.0,
    ):
        self._spawn = spawn
        self._cold_start = cold_start
        self._requeue = requeue
        self._drain_timeout_s = drain_timeout_s
        self._lock = threading.Lock()
        self._pools: Dict[str, List[Any]] = {}
        self._targets: Dict[str, int] = {}
        self.num_drained = 0
        self.num_drain_killed = 0
        self.num_retargeted = 0

    def replicas(self, pool: str) -> List[Any]:
        with self._lock:
            return list(self._pools.get(pool, ()))

    def pool_state(self) -> Dict[str, dict]:
        with self._lock:
            return {
                p: {
                    "replicas_running": len(reps),
                    "replicas_target": self._targets.get(p, len(reps)),
                }
                for p, reps in self._pools.items()
            }

    def apply(self, decision: Decision) -> None:
        if not decision.is_scale_action or decision.target is None:
            return
        pool, want = decision.pool, max(0, decision.target)
        with self._lock:
            have = len(self._pools.get(pool, ()))
            self._targets[pool] = want
        if want > have:
            use_cold = (
                decision.action == ACTION_COLD_START
                and self._cold_start is not None
            )
            for _ in range(want - have):
                rep = (self._cold_start if use_cold else self._spawn)(pool)
                with self._lock:
                    self._pools.setdefault(pool, []).append(rep)
        elif want < have and decision.action in (
            ACTION_SCALE_DOWN, ACTION_SCALE_TO_ZERO,
        ):
            for _ in range(have - want):
                self._retire_one(pool)

    def _retire_one(self, pool: str) -> None:
        with self._lock:
            reps = self._pools.get(pool, [])
            if not reps:
                return
            victim = reps.pop()
        # chaos site: a replica can die mid-drain (in-process KILL_REPLICA
        # analog of a node preemption hitting the drain victim) — its
        # unfinished work must still be re-targeted, never lost
        killed = _chaos.ACTIVE is not None and any(
            f.kind == _chaos.KILL_REPLICA
            for f in _chaos.fire(
                "autoscale.drain", kinds=(_chaos.KILL_REPLICA,), pool=pool
            )
        )
        leftovers: list = []
        if killed:
            self.num_drain_killed += 1
            pending = getattr(victim, "pending", None)
            if pending is not None:
                leftovers = list(pending())
        else:
            drain = getattr(victim, "drain", None)
            if drain is not None:
                leftovers = list(drain(self._drain_timeout_s) or ())
            self.num_drained += 1
        close = getattr(victim, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 — victim may already be dead
                pass
        if leftovers:
            self.num_retargeted += len(leftovers)
            if self._requeue is not None:
                self._requeue(pool, leftovers)
            else:
                with self._lock:
                    survivors = self._pools.get(pool, ())
                    target = survivors[0] if survivors else None
                if target is not None:
                    for item in leftovers:
                        target.submit(item)
                else:
                    logger.warning(
                        "pool %s drained to zero with %d unfinished items "
                        "and no requeue hook", pool, len(leftovers),
                    )

    def close(self) -> None:
        with self._lock:
            pools, self._pools = self._pools, {}
        for reps in pools.values():
            for rep in reps:
                close = getattr(rep, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001
                        pass
