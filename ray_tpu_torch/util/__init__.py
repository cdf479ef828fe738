"""Host-side utilities (counterpart of ``ray_tpu/util``): metrics
(Counter/Gauge/Histogram + Prometheus), the state API (list_tasks/actors/
objects/nodes, timeline), ActorPool, Queue, ExponentialBackoff."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.backoff import ExponentialBackoff
from ray_tpu_torch.util.queue import Empty, Full, Queue

__all__ = ["ActorPool", "Empty", "ExponentialBackoff", "Full", "Queue"]
