"""Acceptance-rate accounting and its metrics (counterpart of
``ray_tpu/llm/spec/stats.py``; the profiled verify-chunk histogram and
timeline span, ``record_spec_chunk``, come with ``EngineConfig(profile=)``,
slice E)."""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.obs.telemetry import AGG_MAX, declare_aggregation
from ray_tpu_torch.util.metrics import Counter, Gauge


@dataclasses.dataclass
class SpecStats:
    """Host-side running totals for one engine."""

    steps: int = 0       # verification passes dispatched
    rows: int = 0        # sequence-rows verified (sum of batch sizes)
    drafted: int = 0     # draft tokens proposed
    accepted: int = 0    # draft tokens accepted
    emitted: int = 0     # tokens actually kept (accepted + bonus, post-stop)

    @property
    def acceptance_rate(self) -> float:
        """Accepted / drafted — drafter quality (1.0 = every guess right)."""
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def mean_accepted_len(self) -> float:
        """Tokens emitted per row per verify pass (incl. the bonus token)."""
        return self.emitted / self.rows if self.rows else 0.0

    def to_dict(self) -> dict:
        return {
            "steps": self.steps,
            "rows": self.rows,
            "drafted_tokens": self.drafted,
            "accepted_tokens": self.accepted,
            "emitted_tokens": self.emitted,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "mean_accepted_len": round(self.mean_accepted_len, 4),
        }


def _spec_metrics() -> dict:
    """The speculative-decoding series (built per call, as every metric of
    this package, so a cleared registry strands none). The acceptance
    gauges are per-engine running rates: max is their honest rollup."""
    declare_aggregation("llm_spec_acceptance_rate", AGG_MAX)
    declare_aggregation("llm_spec_mean_accepted_len", AGG_MAX)
    return {
        "drafted": Counter(
            "llm_spec_drafted_tokens_total",
            description="speculative decoding: draft tokens proposed",
        ),
        "accepted": Counter(
            "llm_spec_accepted_tokens_total",
            description="speculative decoding: draft tokens accepted",
        ),
        "emitted": Counter(
            "llm_spec_emitted_tokens_total",
            description="speculative decoding: tokens emitted by verify "
            "passes (accepted + bonus, after stop conditions)",
        ),
        "acceptance_rate": Gauge(
            "llm_spec_acceptance_rate",
            description="speculative decoding: running accepted/drafted",
        ),
        "mean_accepted_len": Gauge(
            "llm_spec_mean_accepted_len",
            description="speculative decoding: running emitted tokens per "
            "verified row (includes the bonus token)",
        ),
    }


def export_spec_stats(stats: SpecStats, drafted: int, accepted: int, emitted: int) -> None:
    """Publish one verify pass's deltas and the running rates; never raises
    into decode."""
    try:
        m = _spec_metrics()
        if drafted:
            m["drafted"].inc(drafted)
        if accepted:
            m["accepted"].inc(accepted)
        if emitted:
            m["emitted"].inc(emitted)
        m["acceptance_rate"].set(stats.acceptance_rate)
        m["mean_accepted_len"].set(stats.mean_accepted_len)
    except Exception:  # noqa: BLE001 — observability must not break decode
        pass
