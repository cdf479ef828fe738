"""State API: inspect live tasks, actors, objects, placement groups (a copy
of ``ray_tpu/util/state.py``).

Reference analog: python/ray/util/state/ (`ray list tasks/actors/...`,
summarize, get_log) backed by GCS + agents. Single-host: read straight
from the in-process runtime's Gcs, ObjectStore and TaskEventBuffer
(``core/events.py``). The cluster's tables are the dashboard's
``/api/cluster/*`` routes (``ray_tpu_torch.dashboard``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.core import runtime as rt


@dataclass
class TaskRow:
    task_id: str
    name: str
    state: str
    kind: str
    actor_id: Optional[str]
    ts: float
    error: Optional[str]
    trace_id: Optional[str] = None  # ray_tpu_torch.obs request trace, if any


def list_tasks(state: Optional[str] = None, limit: int = 1000) -> list[TaskRow]:
    runtime = rt.get_runtime()
    return [
        TaskRow(
            task_id=e.task_id, name=e.name, state=e.state, kind=e.kind,
            actor_id=e.actor_id, ts=e.ts, error=e.error, trace_id=e.trace_id,
        )
        for e in runtime.task_events.tasks(state=state, limit=limit)
    ]


def list_actors(limit: int = 1000) -> list[dict]:
    runtime = rt.get_runtime()
    return [
        {
            "actor_id": str(actor.actor_id),
            "class_name": actor.cls.__name__,
            "state": actor.state,
            "name": getattr(actor, "registered_name", None),
            "num_restarts": getattr(actor, "num_restarts", 0),
        }
        for actor in runtime.gcs.list_actors()[:limit]
    ]


def list_objects(limit: int = 1000) -> list[dict]:
    store = rt.get_runtime().object_store
    with store._lock:
        return [
            {
                "object_id": str(oid),
                "ready": e.ready.is_set(),
                "ref_count": e.ref_count,
                "nbytes": e.nbytes,
                "error": type(e.error).__name__ if e.error else None,
            }
            for oid, e in list(store._entries.items())[:limit]
        ]


def list_placement_groups(limit: int = 1000) -> list[dict]:
    runtime = rt.get_runtime()
    return [
        {
            "placement_group_id": str(pg.id),
            "name": pg.name,
            "strategy": getattr(pg, "strategy", ""),
            "state": getattr(pg, "_state", "UNKNOWN"),
        }
        for pg in runtime.gcs.list_placement_groups()[:limit]
    ]


def list_nodes() -> list[dict]:
    runtime = rt.get_runtime()
    return [
        {
            "node_id": str(info.node_id),
            "resources_total": dict(info.resources.total),
            "resources_available": dict(info.resources.available),
            "alive": True,
        }
        for info in runtime.gcs.alive_nodes()
    ]


def summarize_tasks() -> dict:
    counts: dict[str, int] = {}
    for row in list_tasks(limit=100_000):
        counts[row.state] = counts.get(row.state, 0) + 1
    return counts


def timeline(filename: Optional[str] = None) -> list[dict]:
    """Chrome trace of recorded task spans (reference: ray.timeline())."""
    trace = rt.get_runtime().task_events.chrome_trace()
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
