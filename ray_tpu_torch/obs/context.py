"""Request-scoped trace context (counterpart of ``ray_tpu/obs/context.py``).

A ``TraceContext`` is (trace_id, span_id): the trace_id names one
end-to-end request, the span_id the current operation within it. It
travels by contextvar within a thread or asyncio task (``use`` /
``attach``) and explicitly across threads (the serving front end hands it
to the engine loop with each request).
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
