"""Shared demand-driven launch planning: the bin-pack core of the one
autoscaling brain (counterpart of ``ray_tpu/autoscale/demand.py``).

``fits`` and ``plan_launches`` are the first-fit-decreasing loop that the
node autoscalers (ROADMAP.md Queue 1, item 13) plan launches with; the
``PoolAutoscaler`` consumes the same pending-demand count (the GCS's
``autoscale_signals``) as one input signal, so demand planning has exactly
one implementation.

Pure functions over plain data: no provider, no clock, no logging.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple


def fits(req: dict, cap: dict) -> bool:
    """True when every requested resource is available in ``cap``."""
    return all(cap.get(k, 0.0) >= v for k, v in req.items())


def plan_launches(
    demand: List[dict],
    node_types: dict,
    count: Callable[[str], int],
    seed_capacity: Iterable[dict] = (),
) -> Tuple[List[str], List[dict]]:
    """First-fit-decreasing bin pack of unmet demand onto new nodes.

    ``node_types`` maps name -> config with ``.resources`` and
    ``.max_workers``; ``count(name)`` is how many of that type already
    exist (launched or launching); ``seed_capacity`` is leftover room on
    nodes already bought but not yet absorbed (the ClusterAutoscaler's
    in-flight launches), consumed before anything new is planned.

    Returns ``(planned_type_names, unplaced_requests)`` — the caller
    launches the former and logs the latter.
    """
    planned: list[dict] = [dict(cap) for cap in seed_capacity]
    planned_types: list[str] = []
    unplaced: list[dict] = []
    for req in sorted(demand, key=lambda d: -sum(d.values())):
        placed = False
        for cap in planned:
            if fits(req, cap):
                for k, v in req.items():
                    cap[k] = cap.get(k, 0.0) - v
                placed = True
                break
        if placed:
            continue
        for tname, tcfg in node_types.items():
            if (
                fits(req, tcfg.resources)
                and count(tname) + planned_types.count(tname) < tcfg.max_workers
            ):
                cap = dict(tcfg.resources)
                for k, v in req.items():
                    cap[k] = cap.get(k, 0.0) - v
                planned.append(cap)
                planned_types.append(tname)
                placed = True
                break
        if not placed:
            unplaced.append(req)
    return planned_types, unplaced
