"""Task event buffer: lifecycle records for observability (counterpart of
``ray_tpu/core/events.py``).

Upstream analog: src/ray/core_worker/task_event_buffer.h (batched task
state transitions) feeding GcsTaskManager
(src/ray/gcs/gcs_server/gcs_task_manager.h), which powers `ray list
tasks`, `ray timeline`, and the dashboard task table. Single-host: a
bounded ring buffer on the runtime, read through ``chrome_trace`` (the
timeline) and ``tasks`` (the live table).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional


class TaskState:
    SUBMITTED = "SUBMITTED"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"


@dataclass
class TaskEvent:
    task_id: str
    name: str
    state: str
    ts: float
    kind: str = "task"          # task | actor_task
    actor_id: Optional[str] = None
    error: Optional[str] = None
    worker: str = ""            # thread name / worker pid
    # request tracing (ray_tpu_torch.obs): set when the task ran under a
    # TraceContext, so timeline() nests cluster work under the request
    trace_id: Optional[str] = None
    span_id: Optional[str] = None


class TaskEventBuffer:
    """Bounded ring of task lifecycle events + live task table."""

    def __init__(self, max_events: int = 10_000):
        self._events: deque[TaskEvent] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        # task_id -> latest state + name (live table; FINISHED/FAILED kept
        # until overwritten by ring pressure)
        self._latest: dict[str, TaskEvent] = {}
        self._max_latest = max_events

    def record(
        self,
        task_id,
        name: str,
        state: str,
        *,
        kind: str = "task",
        actor_id=None,
        error: Optional[str] = None,
        worker: str = "",
        ts: Optional[float] = None,
        trace_id: Optional[str] = None,
        span_id: Optional[str] = None,
    ) -> None:
        if trace_id is None:
            # auto-capture the ambient trace context: execution paths
            # attach the submitter's context around the task body, so
            # every record() call site tags events without plumbing
            from ray_tpu_torch.obs import context as _trace_context

            ctx = _trace_context.current()
            if ctx is not None:
                trace_id, span_id = ctx.trace_id, ctx.span_id
        # explicit ts: reconstructed spans (profiler segment attribution)
        # land at their measured offsets instead of the record() call time
        ev = TaskEvent(
            task_id=str(task_id),
            name=name,
            state=state,
            ts=time.time() if ts is None else ts,
            kind=kind,
            actor_id=str(actor_id) if actor_id is not None else None,
            error=error,
            worker=worker or threading.current_thread().name,
            trace_id=trace_id,
            span_id=span_id,
        )
        with self._lock:
            self._events.append(ev)
            if len(self._latest) >= self._max_latest and ev.task_id not in self._latest:
                # bound memory strictly: evict a terminal entry if any
                # exists, else the oldest entry outright
                victim = None
                oldest = None
                for k, v in self._latest.items():
                    if v.state in (TaskState.FINISHED, TaskState.FAILED):
                        victim = k
                        break
                    if oldest is None or v.ts < self._latest[oldest].ts:
                        oldest = k
                del self._latest[victim if victim is not None else oldest]
            self._latest[ev.task_id] = ev

    def events(self, limit: int = 1000) -> list[TaskEvent]:
        with self._lock:
            evs = list(self._events)
        return evs[-limit:]

    def tasks(self, state: Optional[str] = None, limit: int = 1000) -> list[TaskEvent]:
        with self._lock:
            rows = list(self._latest.values())
        if state:
            rows = [r for r in rows if r.state == state]
        rows.sort(key=lambda r: r.ts, reverse=True)
        return rows[:limit]

    def chrome_trace(self, limit: int = 10_000) -> list[dict]:
        """Chrome trace-event JSON (reference: `ray timeline`)."""
        with self._lock:
            evs = list(self._events)[-limit:]
        spans: dict[str, dict] = {}
        out = []
        for ev in evs:
            if ev.state == TaskState.RUNNING:
                spans[ev.task_id] = {"start": ev.ts, "ev": ev}
            elif ev.state in (TaskState.FINISHED, TaskState.FAILED):
                span = spans.pop(ev.task_id, None)
                if span is None:
                    continue
                tid_ = ev.trace_id or span["ev"].trace_id
                sid = ev.span_id or span["ev"].span_id
                out.append(
                    {
                        "name": ev.name,
                        "cat": ev.kind,
                        "ph": "X",
                        "ts": span["start"] * 1e6,
                        "dur": (ev.ts - span["start"]) * 1e6,
                        "pid": 0,
                        "tid": span["ev"].worker,
                        "args": {
                            "task_id": ev.task_id,
                            "state": ev.state,
                            **({"error": ev.error} if ev.error else {}),
                            **({"trace_id": tid_, "span_id": sid} if tid_ else {}),
                        },
                    }
                )
        return out
