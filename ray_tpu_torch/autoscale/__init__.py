"""The pool autoscaler's cold start and its series (counterpart of the
parts of ``ray_tpu/autoscale`` that need no cluster runtime).

 * ``cold_start_engine``: zero -> serving via the weight plane's retained
   latest publish (``WeightPublisher.publish_latest``), bitwise identical
   to the publisher after the cast to the engine's dtype, with no
   checkpoint path; the wall time lands in
   ``autoscale_cold_start_seconds``.
 * ``metrics``: the ``ray_tpu_autoscale_`` series, names, tags and
   boundaries the reference's.

The controller, its policy, demand planning, actuators and config
(``autoscale/{policy,controller,actuators,demand,config}.py``) grade the
cluster's telemetry, which needs the cluster runtime (ROADMAP.md, Queue 1,
B8); so does ``FleetPoolActuator`` (drive ``FleetManager.set_pool_target``
directly).
"""

from ray_tpu_torch.autoscale.coldstart import (
    ColdStartReport,
    cold_start_engine,
    params_bitwise_equal,
)

__all__ = [
    "ColdStartReport",
    "cold_start_engine",
    "params_bitwise_equal",
]
