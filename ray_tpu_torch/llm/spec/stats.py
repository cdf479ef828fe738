"""Acceptance-rate accounting (counterpart of ``ray_tpu/llm/spec/stats.py``;
its Prometheus export and timeline spans wait for the port's metrics
registry)."""

from __future__ import annotations

import dataclasses


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
