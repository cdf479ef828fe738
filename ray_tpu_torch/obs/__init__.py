"""Request tracing and the flight recorder (counterpart of ``ray_tpu/obs``).

 * context — ``TraceContext`` (trace_id, span_id), carried by contextvar
   within a thread or asyncio task;
 * recorder — ``SpanRecorder``, a bounded flight recorder of the last N
   requests' spans (``span(...)`` records and propagates in one call);
 * slo — the serving SLO histograms (TTFT, TPOT, queue wait, e2e, KV
   transfer) on ``util/metrics``;
 * telemetry — the aggregation kinds metrics declare for a cluster plane.

The serving front end records its ``api.*`` spans here, the engine its
lifecycle spans (``engine.queue_wait``, ``engine.prefill``,
``engine.decode_chunk`` / ``engine.mixed_round`` / ``engine.spec_round``,
``engine.preempt``, ``engine.recover``, the ``llm.request`` root) and the
disaggregated orchestrator ``llm.kv_transfer``; ``/v1/requests`` and
``/v1/requests/{id}/trace`` answer from it. ``telemetry``'s
``TelemetryReporter`` pushes a process's series to the GCS, whose
``TelemetryStore`` aggregates them for the cluster.
"""

from ray_tpu_torch.obs.context import (
    TraceContext,
    attach,
    current,
    detach,
    new_context,
    use,
    use_from,
)
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
    "use_from",
]
