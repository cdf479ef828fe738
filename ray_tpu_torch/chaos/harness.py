"""Chaos harness: the process-wide install point and the hook the runtime
calls (counterpart of ``ray_tpu/chaos/harness.py``).

Hook sites are guarded by ``if harness.ACTIVE is not None``: one
module-attribute load and an identity test when chaos is off. With a
schedule installed, ``fire(site, **attrs)`` asks it which faults hit this
call, and the call site interprets the kinds it implements (preempt ->
``EnginePreempted``, delay -> sleep, drop -> transfer error, corrupt ->
byte flip).

Fired faults land in the schedule's ``log`` and in this package's flight
recorder as zero-duration ``chaos.<kind>`` spans under the ambient trace,
so a request's trace shows which fault fired inside it.

Across processes: ``install(schedule, propagate_env=True)`` exports the
schedule as JSON in ``RAY_TPU_TORCH_CHAOS`` (the reference's variable is
``RAY_TPU_CHAOS``; the two packages' schedules never cross), and node
daemons and cluster workers call ``install_from_env()`` at start, so they
inherit the driver's schedule (each process holds its own decision
counters: determinism is over per-process call order). ``BLOCKED_PEERS``
is the set of endpoints the chaos runner's ``PARTITION_GCS_PAIR`` makes
unreachable from this process.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ray_tpu_torch.chaos.schedule import (  # noqa: F401 — the kinds the hook sites read
    CORRUPT_DEVICE_TRANSFER,
    CORRUPT_FRAME,
    CORRUPT_KV_TRANSFER,
    DELAY_RPC,
    DROP_DEVICE_TRANSFER,
    DROP_KV_TRANSFER,
    DROP_RPC,
    KILL_REPLICA,
    KILL_WORKER,
    PARTIAL_PARTITION,
    PREEMPT_ENGINE,
    STALL_GCS,
    STALL_HEARTBEAT,
    Fault,
    FaultSchedule,
    FaultSpec,
)

ENV_VAR = "RAY_TPU_TORCH_CHAOS"

# the fast-path guard: hook sites read this attribute and skip everything
# when it is None. An installed schedule is process-wide.
ACTIVE: Optional[FaultSchedule] = None

# PARTITION_GCS_PAIR: endpoints unreachable from this process (the chaos
# runner blocks the driver's view of the primary while the standby holds
# its own partition window). Clients of several GCS endpoints read it on
# every dial and call, behind a truthiness test.
BLOCKED_PEERS: set[tuple[str, int]] = set()


class FaultInjected(Exception):
    """Base of injected failures (so recovery paths and tests can tell
    chaos from organic faults)."""


class ReplicaCrashed(FaultInjected):
    """A serve replica crashed mid-request (KILL_REPLICA at the
    ``serve.replica`` site): the handle's failover treats it as the
    replica's death and re-dispatches to another replica."""


class EnginePreempted(FaultInjected):
    """The LLM engine was preempted mid-step (PREEMPT_ENGINE): its state
    is intact, so the serving runner recovers with
    ``recover(rebuild_kv=False)``."""


def install(schedule: FaultSchedule, *, propagate_env: bool = False) -> FaultSchedule:
    """Activate a schedule in this process. ``propagate_env`` exports it,
    so processes spawned from here (node daemons, cluster workers) adopt it
    through ``install_from_env``."""
    global ACTIVE
    ACTIVE = schedule
    if propagate_env:
        os.environ[ENV_VAR] = schedule.to_wire()
    return schedule


def uninstall() -> None:
    global ACTIVE
    ACTIVE = None
    BLOCKED_PEERS.clear()
    os.environ.pop(ENV_VAR, None)


def install_from_env() -> Optional[FaultSchedule]:
    """A daemon's or worker's start: adopt the schedule the driver exported,
    if any. A malformed value is ignored (it must not stop the process)."""
    global ACTIVE
    if ACTIVE is not None:
        return ACTIVE
    wire = os.environ.get(ENV_VAR)
    if not wire:
        return None
    try:
        ACTIVE = FaultSchedule.from_wire(wire)
    except Exception:  # noqa: BLE001 — a bad value must not kill the daemon
        return None
    return ACTIVE


def active() -> Optional[FaultSchedule]:
    return ACTIVE


def fire(site: str, kinds=None, **attrs) -> list[FaultSpec]:
    """Ask the active schedule which faults hit this call, mirroring each
    into the flight recorder. ``kinds``: the fault kinds this hook site
    implements (specs of other kinds are not eligible here, so they cannot
    burn their budget at a site that would ignore them). Returns [] when
    chaos is off."""
    sched = ACTIVE
    if sched is None:
        return []
    hits = sched.fire(site, kinds=kinds, **attrs)
    for spec in hits:
        _record_obs_event(site, spec.kind, attrs)
    return hits


def _record_obs_event(site: str, kind: str, attrs: dict) -> None:
    """Zero-duration ``chaos.<kind>`` span under the ambient trace (or a
    fresh root): the post-mortem trail. Never breaks the faulted path."""
    try:
        from ray_tpu_torch.obs import recorder as _recorder

        now = time.time()
        _recorder.get_recorder().record(
            f"chaos.{kind}", now, now,
            attrs={"site": site, **{k: str(v) for k, v in attrs.items()}},
            status="error",
        )
    except Exception:  # noqa: BLE001
        pass


def corrupt_frame(body: bytes) -> bytes:
    """Deterministic byte corruption for CORRUPT_FRAME: flip a span in the
    middle of the frame (its length stays, so the peer reads a whole frame
    and fails in deserialization)."""
    if not body:
        return body
    mid = len(body) // 2
    span = max(1, min(8, len(body) - mid))
    return body[:mid] + bytes(b ^ 0xFF for b in body[mid:mid + span]) + body[mid + span:]


def fault_log() -> list[Fault]:
    sched = ACTIVE
    return list(sched.log) if sched is not None else []
