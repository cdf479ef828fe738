"""Serve configuration types (counterpart of ``ray_tpu/serve/config.py``).

Upstream analogs: python/ray/serve/config.py (AutoscalingConfig,
HTTPOptions) and python/ray/serve/_private/config.py (DeploymentConfig,
ReplicaConfig). Plain dataclasses: they cross no wire (the control plane
is in process), so validation lives in __post_init__. A replica's
accelerator resource is ``num_gpus``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class AutoscalingConfig:
    """Queue-depth proportional autoscaling (reference:
    python/ray/serve/config.py AutoscalingConfig + autoscaling_policy.py
    _calculate_desired_num_replicas)."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    # Seconds between autoscaling decisions and smoothing of the signal.
    metrics_interval_s: float = 0.5
    look_back_period_s: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0
    upscaling_factor: float = 1.0
    downscaling_factor: float = 1.0
    initial_replicas: Optional[int] = None

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError("min_replicas must be >= 0")
        if self.max_replicas < max(1, self.min_replicas):
            raise ValueError("max_replicas must be >= max(1, min_replicas)")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")

    def desired_replicas(self, total_ongoing: float, current: int) -> int:
        """Proportional control law: replicas ~ total load / per-replica target."""
        if current == 0:
            return max(self.min_replicas, 1 if total_ongoing > 0 else 0)
        error_ratio = total_ongoing / (current * self.target_ongoing_requests)
        if error_ratio > 1:
            desired = current * (1 + (error_ratio - 1) * self.upscaling_factor)
        else:
            desired = current * (1 - (1 - error_ratio) * self.downscaling_factor)
        import math

        desired = math.ceil(desired - 1e-9)
        return max(self.min_replicas, min(self.max_replicas, desired))


@dataclass
class DeploymentConfig:
    """Per-deployment runtime knobs (reference:
    python/ray/serve/_private/config.py DeploymentConfig)."""

    num_replicas: int = 1
    max_ongoing_requests: int = 100
    max_queued_requests: int = -1  # -1 = unbounded
    user_config: Any = None
    # deployment role tag ("prefill" / "decode" for disaggregated LLM
    # serving, "" for ordinary deployments): carried through the
    # controller's replica listings and serve.status so operators and
    # pool-aware clients can tell the pools apart
    role: str = ""
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 10.0

    def target_initial_replicas(self) -> int:
        ac = self.autoscaling_config
        if ac is None:
            return self.num_replicas
        if ac.initial_replicas is not None:
            return ac.initial_replicas
        return max(ac.min_replicas, min(ac.max_replicas, 1))


@dataclass
class ReplicaConfig:
    """What to run in each replica: the user callable + actor resources
    (reference: _private/config.py ReplicaConfig)."""

    callable_factory: Callable[[], Any]  # builds the user class/fn instance
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: dict = field(default_factory=dict)
    is_function: bool = False


@dataclass
class HTTPOptions:
    """Proxy options (reference: python/ray/serve/config.py HTTPOptions)."""

    host: str = "127.0.0.1"
    port: int = 8000
    root_path: str = ""


class DeploymentStatus:
    UPDATING = "UPDATING"
    HEALTHY = "HEALTHY"
    UNHEALTHY = "UNHEALTHY"
    UPSCALING = "UPSCALING"
    DOWNSCALING = "DOWNSCALING"


class ReplicaState:
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    STOPPING = "STOPPING"
    DEAD = "DEAD"


class ApplicationStatus:
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    DEPLOY_FAILED = "DEPLOY_FAILED"
    DELETING = "DELETING"
    UNHEALTHY = "UNHEALTHY"
