"""Deterministic fault injection (counterpart of ``ray_tpu/chaos``).

Usage::

    from ray_tpu_torch import chaos

    sched = chaos.FaultSchedule(seed=7, faults=[
        chaos.FaultSpec(chaos.PREEMPT_ENGINE, site="llm.engine.step",
                        start_after=5, max_fires=1),
        chaos.FaultSpec(chaos.CORRUPT_KV_TRANSFER, site="disagg.kv_transfer",
                        max_fires=1),
    ])
    chaos.install(sched)
    try:
        ...                          # run the workload; faults fire
        print(sched.decisions())     # the deterministic post-mortem
    finally:
        chaos.uninstall()

Hook sites: ``llm.engine.step`` (``llm/engine.py``),
``disagg.kv_transfer`` (``llm/disagg/connector.py``), ``llm.kvtier.spill``
and ``llm.kvfetch`` (``llm/kvtier/tiers.py``), ``serve.replica``
(``serve/replica.py``: KILL_REPLICA raises ``ReplicaCrashed``),
``rpc.call`` / ``rpc.frame`` / ``gcs.call`` (``cluster/rpc.py``),
``node.heartbeat`` (``cluster/node_daemon.py``) and ``cluster.push``
(``cluster/client.py``), each behind an ``ACTIVE is None`` fast path.
``install(sched, propagate_env=True)`` hands the schedule to the cluster's
daemons and workers (``install_from_env``). Orchestrated faults
(``PREEMPT_NODE``, ``KILL_WORKER``, ``KILL_GCS``, ``KILL_GCS_PRIMARY``,
``PARTITION_GCS_PAIR``, ``KILL_REPLICA`` with an ``at_s``) run through
``chaos.runner.ChaosRunner``.
"""

from ray_tpu_torch.chaos import harness
from ray_tpu_torch.chaos.harness import (
    ENV_VAR,
    EnginePreempted,
    FaultInjected,
    ReplicaCrashed,
    active,
    corrupt_frame,
    fault_log,
    fire,
    install,
    install_from_env,
    uninstall,
)
from ray_tpu_torch.chaos.schedule import (
    CORRUPT_FRAME,
    CORRUPT_KV_TRANSFER,
    DELAY_RPC,
    DROP_CHANNEL,
    DROP_COLLECTIVE,
    DROP_KV_TRANSFER,
    DROP_RPC,
    KILL_GCS,
    KILL_GCS_PRIMARY,
    KILL_RANK,
    KILL_REPLICA,
    KILL_WORKER,
    KINDS,
    PARTIAL_PARTITION,
    PARTITION_GCS_PAIR,
    PREEMPT_ENGINE,
    PREEMPT_NODE,
    STALL_CHANNEL,
    STALL_COLLECTIVE,
    STALL_GCS,
    STALL_HEARTBEAT,
    Fault,
    FaultSchedule,
    FaultSpec,
)


def __getattr__(name):
    if name == "ACTIVE":  # convenience mirror of harness.ACTIVE
        return harness.ACTIVE
    if name == "ChaosRunner":
        from ray_tpu_torch.chaos.runner import ChaosRunner

        return ChaosRunner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CORRUPT_FRAME", "CORRUPT_KV_TRANSFER", "DELAY_RPC", "DROP_CHANNEL",
    "DROP_COLLECTIVE", "DROP_KV_TRANSFER", "DROP_RPC", "KILL_GCS",
    "KILL_GCS_PRIMARY", "KILL_RANK", "KILL_REPLICA", "KILL_WORKER", "KINDS",
    "PARTIAL_PARTITION", "PARTITION_GCS_PAIR", "PREEMPT_ENGINE", "PREEMPT_NODE",
    "STALL_CHANNEL", "STALL_COLLECTIVE", "STALL_GCS", "STALL_HEARTBEAT",
    "Fault", "FaultSchedule", "FaultSpec", "FaultInjected", "EnginePreempted", "ReplicaCrashed",
    "ChaosRunner", "ENV_VAR", "active", "corrupt_frame",
    "fault_log", "fire", "harness", "install", "install_from_env", "uninstall",
]
