"""Resource accounting: the currency of scheduling (counterpart of
``ray_tpu/core/resources.py``).

Upstream Ray's ResourceSet / NodeResources
(src/ray/common/scheduling/resource_set.h). The node advertises ``CPU``,
``memory`` and, on a machine with NVIDIA cards, ``GPU``; anything else is
a plain custom resource.
"""

from __future__ import annotations

import threading
from typing import Optional

EPS = 1e-9


class ResourceSet(dict):
    """{resource_name: float}. Missing key == 0."""

    def __init__(self, mapping: Optional[dict] = None, **kwargs):
        super().__init__()
        for k, v in {**(mapping or {}), **kwargs}.items():
            if v < 0:
                raise ValueError(f"negative resource {k}={v}")
            if v > 0:
                self[k] = float(v)

    def fits_in(self, other: "ResourceSet") -> bool:
        return all(other.get(k, 0.0) + EPS >= v for k, v in self.items())

    def add(self, other: "ResourceSet") -> "ResourceSet":
        out = ResourceSet(self)
        for k, v in other.items():
            out[k] = out.get(k, 0.0) + v
        return out

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        out = ResourceSet(self)
        for k, v in other.items():
            nv = out.get(k, 0.0) - v
            if nv < -EPS:
                raise ValueError(f"resource {k} would go negative ({nv})")
            if abs(nv) < EPS:
                out.pop(k, None)
            else:
                out[k] = nv
        return out


class NodeResources:
    """Thread-safe available/total tracking for one node."""

    def __init__(self, total: ResourceSet):
        self.total = ResourceSet(total)
        self._available = ResourceSet(total)
        self._lock = threading.Lock()

    def try_acquire(self, req: ResourceSet) -> bool:
        with self._lock:
            if not req.fits_in(self._available):
                return False
            self._available = self._available.subtract(req)
            return True

    def release(self, req: ResourceSet) -> None:
        with self._lock:
            self._available = self._available.add(req)

    def add_capacity(self, extra: ResourceSet) -> None:
        """Dynamically grow totals (used by placement-group bundle resources)."""
        with self._lock:
            self.total = self.total.add(extra)
            self._available = self._available.add(extra)

    def remove_capacity(self, extra: ResourceSet) -> None:
        with self._lock:
            self.total = self.total.subtract(extra)
            self._available = self._available.subtract(extra)

    @property
    def available(self) -> ResourceSet:
        with self._lock:
            return ResourceSet(self._available)

    def in_use(self) -> ResourceSet:
        with self._lock:
            out = ResourceSet()
            for k, v in self.total.items():
                used = v - self._available.get(k, 0.0)
                if used > EPS:
                    out[k] = used
            return out

    def utilization(self) -> float:
        with self._lock:
            if not self.total:
                return 0.0
            fracs = [
                1.0 - self._available.get(k, 0.0) / v
                for k, v in self.total.items()
                if v > 0
            ]
            return max(fracs) if fracs else 0.0
