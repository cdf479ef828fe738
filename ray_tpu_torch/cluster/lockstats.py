"""Lock hold/wait and per-RPC latency instrumentation for the control
plane (a copy of ``ray_tpu/cluster/lockstats.py``, over the port's
``obs/telemetry.py`` cluster histograms).

The GCS serializes every table behind ONE ``RLock`` domain
(gcs_service.py). Before that domain can be partitioned, the roadmap
needs distributions, not vibes: how long do callers WAIT for the lock,
how long does the holder KEEP it, and which RPC methods pay. This
module provides:

 * ``TimedRLock`` — a thin wrapper around ``threading.RLock`` that
   feeds wait-time (outermost acquire) and hold-time (outermost
   release) histograms, tagged by lock domain. When timing is disabled
   (the default) acquire/release cost one attribute load and an integer
   add on top of the raw RLock — no clock reads, no histogram locks.
   The wrapper implements the ``_release_save`` / ``_acquire_restore``
   / ``_is_owned`` protocol so ``threading.Condition(TimedRLock(...))``
   works unchanged (the GCS event pubsub builds exactly that).
 * per-RPC-method server latency histograms (``RpcServer._dispatch``
   observes them), pricing each control-plane method end to end —
   executor queueing included, response write excluded.

Enable with ``enable_lock_timing()``; production code pays the fast path
until someone asks.
"""

from __future__ import annotations

import threading
import time

# lock waits/holds and RPC dispatch on the control plane are sub-ms to
# tens-of-ms; default bucket ladder tops out too coarse for that
_LATENCY_BOUNDARIES_MS = [
    0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 1000.0,
]

# module-level switch read on every acquire: a list cell (not a bare
# bool) so the flag flip is visible through the closure without globals
_ENABLED = [False]


def enable_lock_timing(on: bool = True) -> None:
    """Turn hold/wait histogram feeds on (off = the near-zero fast
    path). Process-wide: every TimedRLock domain follows the switch."""
    _ENABLED[0] = bool(on)


def lock_timing_enabled() -> bool:
    return _ENABLED[0]


def lock_wait_histogram():
    """Time callers spend blocked on an outermost acquire, by domain —
    the contention signal: ~0 uncontended regardless of hold times."""
    from ray_tpu_torch.obs.telemetry import cluster_histogram

    return cluster_histogram(
        "controlplane_lock_wait_ms",
        description="wall time blocked acquiring a control-plane lock "
        "(outermost acquire only), by lock domain",
        boundaries=_LATENCY_BOUNDARIES_MS,
        tag_keys=("domain",),
    )


def lock_hold_histogram():
    """Time the holder keeps the lock (outermost acquire -> outermost
    release), by domain — long holds are what sharding would split."""
    from ray_tpu_torch.obs.telemetry import cluster_histogram

    return cluster_histogram(
        "controlplane_lock_hold_ms",
        description="wall time a control-plane lock is held (outermost "
        "acquire to outermost release), by lock domain",
        boundaries=_LATENCY_BOUNDARIES_MS,
        tag_keys=("domain",),
    )


def rpc_latency_histogram():
    """Server-side RPC latency by method: handler execution including
    executor queueing, excluding the response write."""
    from ray_tpu_torch.obs.telemetry import cluster_histogram

    return cluster_histogram(
        "controlplane_rpc_latency_ms",
        description="server-side control-plane RPC handler latency by "
        "method (executor queueing included, response write excluded)",
        boundaries=_LATENCY_BOUNDARIES_MS,
        tag_keys=("method",),
    )


def register_metrics() -> None:
    """Force the lazy metrics to register."""
    lock_wait_histogram()
    lock_hold_histogram()
    rpc_latency_histogram()


class TimedRLock:
    """``threading.RLock`` with optional hold/wait histograms.

    Reentrancy depth is tracked unconditionally (an integer add by the
    holder, already serialized by the lock itself) so timing can be
    flipped on mid-flight without corrupting the outermost-release
    bookkeeping. Clock reads and histogram observes happen only while
    ``enable_lock_timing`` is on, and only at the OUTERMOST
    acquire/release — reentrant hops stay free.
    """

    def __init__(self, domain: str):
        self._lk = threading.RLock()
        self._domain = domain
        self._depth = 0        # mutated only by the current holder
        self._t_hold0 = 0.0    # outermost-acquire timestamp (0 = untimed)

    # -- core lock protocol ---------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _ENABLED[0]:
            ok = self._lk.acquire(blocking, timeout)
            if ok:
                self._depth += 1
            return ok
        t0 = time.perf_counter()
        ok = self._lk.acquire(blocking, timeout)
        if not ok:
            return False
        self._depth += 1
        if self._depth == 1:
            now = time.perf_counter()
            lock_wait_histogram().observe(
                (now - t0) * 1e3, {"domain": self._domain}
            )
            self._t_hold0 = now
        return True

    def release(self) -> None:
        if self._depth == 1 and self._t_hold0:
            # timing may have been disabled mid-hold: the observe is
            # gated on the recorded start, not on the current switch
            lock_hold_histogram().observe(
                (time.perf_counter() - self._t_hold0) * 1e3,
                {"domain": self._domain},
            )
            self._t_hold0 = 0.0
        self._depth -= 1
        self._lk.release()

    def __enter__(self) -> "TimedRLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    # -- Condition protocol ---------------------------------------------------
    # threading.Condition(lock) delegates to these when present; wait()
    # fully releases a reentrant lock and restores its depth after.

    def _release_save(self):
        if self._t_hold0:
            lock_hold_histogram().observe(
                (time.perf_counter() - self._t_hold0) * 1e3,
                {"domain": self._domain},
            )
            self._t_hold0 = 0.0
        depth, self._depth = self._depth, 0
        return (self._lk._release_save(), depth)

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        timing = _ENABLED[0]
        t0 = time.perf_counter() if timing else 0.0
        self._lk._acquire_restore(state)
        self._depth = depth
        if timing:
            now = time.perf_counter()
            lock_wait_histogram().observe(
                (now - t0) * 1e3, {"domain": self._domain}
            )
            self._t_hold0 = now

    def _is_owned(self) -> bool:
        return self._lk._is_owned()
