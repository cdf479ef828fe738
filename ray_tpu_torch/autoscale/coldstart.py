"""Fabric cold start: zero -> serving with streamed weights (counterpart of
``ray_tpu/autoscale/coldstart.py``).

A pool scaled to zero holds no checkpoint lease and no warm process;
waking it must not touch a checkpoint path. The recipe: build a fresh
engine (its init weights are throwaway), register a fabric endpoint on its
cache device, stream the publisher's retained latest tree to it
(``WeightPublisher.publish_latest``) and write it into the engine's
weights (``WeightSubscriber.apply_to_engine``). The report carries a
bitwise identity verdict, so "the first served tokens come from the
streamed weights" is checkable, and the wall time lands in
``autoscale_cold_start_seconds``.

The port's engine holds its weights in the compute dtype, so the verdict
compares the engine's bytes with the reference tree cast to the engine's
dtype (the identity in fp32).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ray_tpu_torch.train.weight_sync import WeightSubscriber, params_bitwise_equal

logger = logging.getLogger("ray_tpu_torch.autoscale.coldstart")


@dataclass
class ColdStartReport:
    pool: str
    endpoint_id: str
    seconds: float
    weight_version: Optional[int]
    bitwise_identical: bool


def cold_start_engine(
    engine_factory: Callable[[], Any],
    publisher: Any,
    endpoint_id: str,
    *,
    pool: str = "decode",
    reference_params: Any = None,
    timeout_s: float = 30.0,
) -> tuple:
    """Bring one replica from nothing to serving-with-current-weights.

    ``publisher`` is a live ``WeightPublisher`` that has published at least
    once (its retained tree is what streams). Returns ``(engine,
    ColdStartReport)``; the engine is ready to serve and
    ``engine.weight_version`` matches the fleet. When ``reference_params``
    is given, the report's ``bitwise_identical`` compares the engine's
    weights with it, cast to the engine's dtype, byte for byte."""
    t0 = time.monotonic()
    engine = engine_factory()
    target = publisher.register_rollout(endpoint_id, device=engine.kv_cache_device())
    sub = WeightSubscriber(publisher.transport, endpoint_id)
    version = publisher.publish_latest(target, timeout_s=timeout_s)
    applied = sub.apply_to_engine(engine, timeout_s=timeout_s)
    seconds = time.monotonic() - t0
    if applied is None:
        raise RuntimeError(
            f"cold start {endpoint_id!r}: published v{version} bundle never arrived at the "
            "new endpoint"
        )
    identical = (params_bitwise_equal(reference_params, engine.params)
                 if reference_params is not None else True)
    report = ColdStartReport(pool=pool, endpoint_id=endpoint_id, seconds=round(seconds, 6),
                             weight_version=applied, bitwise_identical=identical)
    try:
        from ray_tpu_torch.autoscale.metrics import cold_start_histogram

        cold_start_histogram().observe(seconds, tags={"pool": pool})
    except Exception:  # noqa: BLE001 — observability must not fail the start
        pass
    logger.info("cold start %s/%s: %.3fs to v%s (bitwise=%s)", pool, endpoint_id, seconds,
                applied, identical)
    return engine, report
