"""Flight recorder: a bounded in-process span store of the last N traces
(counterpart of ``ray_tpu/obs/recorder.py``).

Capacity is bounded two ways: ``max_traces`` whole requests (drop-oldest,
so a long-running server holds the most recent window) and
``max_spans_per_trace`` (a runaway generation cannot grow one trace
without bound); drops are counted, never silent.

Reads: ``get(trace_id)`` the raw spans, ``traces()`` the listing,
``summary(trace_id)`` end-to-end time and span coverage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Optional

from ray_tpu_torch.obs import context as trace_context


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start: float               # time.time() seconds
    end: float
    attrs: dict = dataclasses.field(default_factory=dict)
    status: str = "ok"         # ok | error

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_s": round(self.duration_s, 6),
            "attrs": dict(self.attrs),
            "status": self.status,
        }


class SpanRecorder:
    """Thread-safe ring of the last ``max_traces`` traces."""

    def __init__(self, max_traces: int = 256, max_spans_per_trace: int = 512):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, list[Span]]" = OrderedDict()
        self._meta: dict[str, dict] = {}
        self._by_request: dict[str, str] = {}  # request_id -> trace_id
        self.num_dropped_traces = 0
        self.num_dropped_spans = 0

    # -- writes ---------------------------------------------------------------

    def add(self, span: Span) -> None:
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                while len(self._traces) >= self.max_traces:
                    old_tid, _ = self._traces.popitem(last=False)
                    meta = self._meta.pop(old_tid, None)
                    for rid in (meta or {}).get("request_ids", ()):
                        self._by_request.pop(rid, None)
                    self.num_dropped_traces += 1
                spans = self._traces[span.trace_id] = []
                self._meta[span.trace_id] = {
                    "trace_id": span.trace_id,
                    "root": span.name,
                    "_root_dur": span.duration_s,
                    "start": span.start,
                    "end": span.end,
                    "num_spans": 0,
                    "request_ids": [],
                }
            meta = self._meta[span.trace_id]
            if len(spans) >= self.max_spans_per_trace:
                # drop-oldest within the trace too: the request-level root
                # spans are recorded last, at finish
                del spans[0]
                self.num_dropped_spans += 1
            spans.append(span)
            meta["num_spans"] = len(spans)
            meta["start"] = min(meta["start"], span.start)
            meta["end"] = max(meta["end"], span.end)
            # the listing labels a trace by its widest span
            if span.parent_id is None or span.duration_s >= meta["_root_dur"]:
                meta["root"] = span.name
                meta["_root_dur"] = span.duration_s
            rid = span.attrs.get("request_id")
            if rid is not None and rid not in meta["request_ids"]:
                meta["request_ids"].append(rid)
                self._by_request[str(rid)] = span.trace_id

    def record(self, name: str, start: float, end: float,
               ctx: Optional[trace_context.TraceContext] = None, *,
               attrs: Optional[dict] = None, status: str = "ok") -> Span:
        """Record one completed span under ``ctx`` (a child of
        ctx.span_id); without a ctx, under the ambient context or as the
        root of a new trace."""
        if ctx is None:
            ctx = trace_context.current() or trace_context.new_context()
        span = Span(
            trace_id=ctx.trace_id,
            span_id=trace_context._rand_hex(8),
            parent_id=ctx.span_id,
            name=name,
            start=start,
            end=end,
            attrs=dict(attrs or {}),
            status=status,
        )
        self.add(span)
        return span

    # -- reads ----------------------------------------------------------------

    def get(self, trace_id: str) -> list[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def find_by_request(self, request_id: str) -> Optional[str]:
        with self._lock:
            return self._by_request.get(str(request_id))

    def traces(self, limit: int = 100) -> list[dict]:
        """Flight-recorder listing, newest first."""
        with self._lock:
            metas = [
                {k: v for k, v in m.items() if not k.startswith("_")}
                for m in self._meta.values()
            ]
        metas.sort(key=lambda m: m["start"], reverse=True)
        for m in metas[:limit]:
            m["duration_s"] = round(max(0.0, m["end"] - m["start"]), 6)
        return metas[:limit]

    def summary(self, trace_id: str) -> Optional[dict]:
        """Root span + coverage: the % of the root's wall-clock covered by
        the union of the other spans."""
        spans = self.get(trace_id)
        if not spans:
            return None
        ids = {s.span_id for s in spans}
        roots = [s for s in spans if s.parent_id is None or s.parent_id not in ids]
        root = max(roots or spans, key=lambda s: s.duration_s)
        children = [s for s in spans if s is not root]
        coverage = 0.0
        if root.duration_s > 0 and children:
            intervals = sorted(
                (max(s.start, root.start), min(s.end, root.end)) for s in children
            )
            covered, cur_a, cur_b = 0.0, None, None
            for a, b in intervals:
                if b <= a:
                    continue
                if cur_b is None or a > cur_b:
                    if cur_b is not None:
                        covered += cur_b - cur_a
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            if cur_b is not None:
                covered += cur_b - cur_a
            coverage = 100.0 * covered / root.duration_s
        return {
            "trace_id": trace_id,
            "root": root.name,
            "start": root.start,
            "e2e_s": round(root.duration_s, 6),
            "num_spans": len(spans),
            "coverage_pct": round(coverage, 2),
            "attrs": dict(root.attrs),
        }


_RECORDER = SpanRecorder()


def get_recorder() -> SpanRecorder:
    return _RECORDER


@contextlib.contextmanager
def span(name: str, attrs: Optional[dict] = None,
         recorder: Optional[SpanRecorder] = None):
    """Record a span around a block, propagating the contextvar: the block
    runs under a child context, so nested spans chain. Yields the child
    TraceContext."""
    parent = trace_context.current()
    ctx = parent.child() if parent is not None else trace_context.new_context()
    token = trace_context.attach(ctx)
    t0 = time.time()
    status = "ok"
    try:
        yield ctx
    except BaseException:
        status = "error"
        raise
    finally:
        try:
            trace_context.detach(token)
        except ValueError:
            # unwound in a different Context (an async generator finalized
            # by the loop in a fresh task); still record the span below
            pass
        rec = recorder if recorder is not None else _RECORDER
        rec.add(Span(
            trace_id=ctx.trace_id,
            span_id=ctx.span_id,
            parent_id=parent.span_id if parent is not None else None,
            name=name,
            start=t0,
            end=time.time(),
            attrs=dict(attrs or {}),
            status=status,
        ))
