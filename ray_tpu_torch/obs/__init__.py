"""Request tracing and the flight recorder (counterpart of ``ray_tpu/obs``).

 * context — ``TraceContext`` (trace_id, span_id), carried by contextvar
   within a thread or asyncio task;
 * recorder — ``SpanRecorder``, a bounded flight recorder of the last N
   requests' spans (``span(...)`` records and propagates in one call).

The serving front end records its ``api.*`` spans here and answers
``/v1/requests`` and ``/v1/requests/{id}/trace`` from it. The engine's
lifecycle spans, the SLO histograms and the telemetry plane are not ported
yet (ROADMAP.md, Queue 1, B4c).
"""

from ray_tpu_torch.obs.context import TraceContext, attach, current, detach, new_context, use
from ray_tpu_torch.obs.recorder import Span, SpanRecorder, get_recorder, span

__all__ = [
    "Span",
    "SpanRecorder",
    "TraceContext",
    "attach",
    "current",
    "detach",
    "get_recorder",
    "new_context",
    "span",
    "use",
]
