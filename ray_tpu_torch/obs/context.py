"""Request-scoped trace context (counterpart of ``ray_tpu/obs/context.py``).

A ``TraceContext`` is (trace_id, span_id): the trace_id names one
end-to-end request, the span_id the current operation within it. It
travels by contextvar within a thread or asyncio task (``use`` /
``attach``), explicitly across threads (the serving front end hands it
to the engine loop with each request), and as a dict in the runtime's
task specs, attached around each execution (``to_dict`` / ``use_from``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Optional


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclasses.dataclass(frozen=True)
class TraceContext:
    trace_id: str          # 32 lowercase hex chars (16 bytes)
    span_id: str           # 16 lowercase hex chars (8 bytes)
    sampled: bool = True

    def child(self) -> "TraceContext":
        """Same trace, fresh span id: the context a sub-operation runs
        under (its spans record this span as parent)."""
        return TraceContext(self.trace_id, _rand_hex(8), self.sampled)

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["TraceContext"]:
        """The context a ``to_dict`` carried (a KV handoff's ``trace``);
        None for an empty one."""
        if not d or not d.get("trace_id"):
            return None
        return cls(
            trace_id=str(d["trace_id"]),
            span_id=str(d.get("span_id") or _rand_hex(8)),
            sampled=bool(d.get("sampled", True)),
        )


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "ray_tpu_torch_trace_context", default=None
)


def current() -> Optional[TraceContext]:
    return _CURRENT.get()


def new_context() -> TraceContext:
    """Fresh root: new trace_id + span_id."""
    return TraceContext(_rand_hex(16), _rand_hex(8))


def attach(ctx: Optional[TraceContext]):
    """Set the ambient context; returns a token for ``detach``."""
    return _CURRENT.set(ctx)


def detach(token) -> None:
    _CURRENT.reset(token)


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]):
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        try:
            _CURRENT.reset(token)
        except ValueError:
            # unwound in a different Context (an abandoned async generator
            # finalized by the event loop in a fresh task): that context
            # dies anyway, nothing to restore
            pass


@contextlib.contextmanager
def use_from(trace_dict: Optional[dict]):
    """Attach a context carried as a dict (a TaskSpec's ``trace``) around an
    execution body: the runtime's task and actor executions wrap with it.
    The context is attached as it is, not as a fresh child: the envelope's
    span_id names a span the submitter records (``serve.request``, an
    ``obs.span`` block), so spans recorded inside the body parent to a span
    that exists in the recorder. No-ops when the envelope carries no
    (valid) trace, and never raises: tracing must never break task
    execution. Yields the attached context or None."""
    try:
        ctx = TraceContext.from_dict(trace_dict)
    except Exception:  # noqa: BLE001
        ctx = None
    if ctx is None:
        yield None
        return
    with use(ctx):
        yield ctx
