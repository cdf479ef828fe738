"""ray_tpu_torch.autoscale — the SLO closed-loop pool autoscaler
(counterpart of ``ray_tpu/autoscale``).

The telemetry plane grades every model tag's TTFT/TPOT/queue-wait and
emits ``autoscaler_hints``; the GCS serves them in one
``autoscale_signals`` RPC; the Serve controller exposes role-tagged pools
with graceful drain (``set_pool_target`` / ``pool_state``); the weight
plane streams current weights to a brand-new replica. This package is the
controller in the middle:

* ``PoolPolicy`` / ``PoolAutoscaler`` — pure decision ladder + the loop
  driving it (prefill and decode scale independently; hysteresis +
  cooldowns; HOLD on a dark GCS; scale-down always via drain).
* ``ServePoolActuator`` / ``FleetPoolActuator`` / ``EnginePoolActuator`` —
  how a decision becomes replica changes.
* ``size_prefill_pool`` — replica count from the measured prefill-span
  distribution (Little's law at a target utilization).
* ``cold_start_engine`` — zero -> serving via fabric weight streaming,
  bitwise-identical to the publisher, no checkpoint path.
* ``demand`` — the bin-pack planning core the node autoscalers will share
  (ROADMAP.md Queue 1, item 13); its pending-demand feed is one input
  signal here.
"""

from ray_tpu_torch.autoscale.actuators import (
    EnginePoolActuator,
    FleetPoolActuator,
    PoolActuator,
    ServePoolActuator,
)
from ray_tpu_torch.autoscale.coldstart import (
    ColdStartReport,
    cold_start_engine,
    params_bitwise_equal,
)
from ray_tpu_torch.autoscale.config import (
    POOL_DECODE,
    POOL_PREFILL,
    AutoscaleConfig,
    PoolLimits,
)
from ray_tpu_torch.autoscale.controller import PoolAutoscaler, signals_from_payload
from ray_tpu_torch.autoscale.policy import (
    ACTION_COLD_START,
    ACTION_HOLD,
    ACTION_SCALE_DOWN,
    ACTION_SCALE_TO_ZERO,
    ACTION_SCALE_UP,
    Decision,
    PoolPolicy,
    PoolSignals,
    size_prefill_pool,
    span_mean_from_histogram,
)

__all__ = [
    "ACTION_COLD_START",
    "ACTION_HOLD",
    "ACTION_SCALE_DOWN",
    "ACTION_SCALE_TO_ZERO",
    "ACTION_SCALE_UP",
    "AutoscaleConfig",
    "ColdStartReport",
    "Decision",
    "EnginePoolActuator",
    "FleetPoolActuator",
    "POOL_DECODE",
    "POOL_PREFILL",
    "PoolActuator",
    "PoolAutoscaler",
    "PoolLimits",
    "PoolPolicy",
    "PoolSignals",
    "ServePoolActuator",
    "cold_start_engine",
    "params_bitwise_equal",
    "signals_from_payload",
    "size_prefill_pool",
    "span_mean_from_histogram",
]
