"""Control-plane high availability: a warm-standby GCS with lease-based,
fenced failover (counterpart of ``ray_tpu/cluster/ha.py``).

The standby tails the primary's replication log (``gcs_service.py``:
every critical mutation as a ``(seq, term, op, data)`` entry over
``repl_since``, bootstrapped and resynced by ``repl_snapshot``) and
promotes itself when the primary's lease expires (``lease_timeout_s`` of
silence, 2 s by default): a primary's death costs a lease, not a blackout.

Split-brain safety is epoch fencing, not consensus: promotion bumps the
fencing term, every client RPC carries the highest term seen (``rpc.py``'s
envelope and a shared ``TermTracker``), and a deposed primary that
receives one such request fences itself: its late acks are discarded by
the client (``StaleTermError``) and its late snapshot persists are
refused. The promoted standby then runs the restart-restore discipline of
a GCS restarted from its snapshot (nodes as reconcile claims, actors
pending confirmation, the shared sweeper loop), so what the log missed
converges through reconciliation.

Not replicated, on purpose: telemetry, the object directory (and the KV
prefix index, part 3c): freshness surfaces the cluster repopulates within
one reporting or heartbeat interval of a failover. During the promotion
window clients see refused dials or ``NotPrimaryError`` and ride them out
with the multi-endpoint client's bounded failover.

Like the GCS, this process never imports torch.
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

from ray_tpu_torch.cluster.gcs_service import GcsService, register_metrics, start_sweeper
from ray_tpu_torch.cluster.rpc import (
    ClientPool,
    NotPrimaryError,
    RemoteError,
    RpcClient,
    RpcError,
    RpcServer,
)
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.cluster.ha")


class _StandbyFacade:
    """RPC handler fronting the standby's GcsService.

    Until promotion, only the replication/diagnostic plane is served;
    everything else answers ``NotPrimaryError`` so multi-endpoint
    clients fail over to the primary. After promotion the facade is a
    transparent pass-through to the (now-primary) service."""

    # methods an UNPROMOTED standby serves: the replication plane (a
    # chained standby could tail us), diagnostics, and the chaos
    # partition control hook
    _STANDBY_ALLOWED = frozenset({
        "rpc_ha_status", "rpc_repl_since", "rpc_repl_snapshot",
        "rpc_gcs_ft", "rpc_ha_partition", "rpc_telemetry_status",
        "rpc_telemetry_prometheus",
    })

    def __init__(self, server: "StandbyGcsServer"):
        self._server = server

    # explicit forwards so RpcServer._dispatch's getattr(handler, ...)
    # probes find them without tripping __getattr__'s rpc_-only guard
    def ha_term(self) -> int:
        return self._server.service.ha_term()

    def ha_fence(self, hterm: int, method: str):
        return self._server.service.ha_fence(hterm, method)

    def rpc_ha_status(self, payload, peer):
        out = self._server.service.rpc_ha_status(payload, peer)
        out.update(self._server.status_extra())
        return out

    def rpc_ha_partition(self, payload, peer):
        """Chaos control hook (PARTITION_GCS_PAIR): stop seeing the
        primary for window_s seconds, as if the pair link was cut."""
        self._server.force_partition(float((payload or {}).get("window_s", 0.0)))
        return {"ok": True}

    def _reject(self, payload, peer):
        term = self._server.service.ha_term()
        raise NotPrimaryError(
            f"standby GCS at term {term} is not serving "
            "(primary lease still valid)",
            term=term,
        )

    def __getattr__(self, name: str):
        if not name.startswith("rpc_"):
            raise AttributeError(name)
        fn = getattr(self._server.service, name)  # AttributeError propagates
        if self._server.promoted.is_set() or name in self._STANDBY_ALLOWED:
            return fn
        return self._reject


class StandbyGcsServer:
    """Warm-standby GCS process: GcsService(role="standby") + RpcServer
    + the tail/lease thread. Promotes in-place when the primary's lease
    expires; after promotion it IS the primary (same address the clients
    already hold as their second endpoint)."""

    def __init__(self, primary_addr: tuple, host: str = "127.0.0.1",
                 port: int = 0, lease_timeout_s: float = 2.0,
                 poll_wait_s: float = 1.0,
                 node_death_timeout_s: float = 5.0,
                 persist_path: Optional[str] = None):
        self.primary_addr = (primary_addr[0], int(primary_addr[1]))
        self.service = GcsService(
            node_death_timeout_s=node_death_timeout_s,
            persist_path=persist_path,
            role="standby",
        )
        self.facade = _StandbyFacade(self)
        self.rpc = RpcServer(self.facade, host=host, port=port)
        self.lease_timeout_s = float(lease_timeout_s)
        self.poll_wait_s = float(poll_wait_s)
        self.promoted = threading.Event()
        self.address: Optional[tuple] = None
        self._stop = threading.Event()
        self._tail: Optional[threading.Thread] = None
        self._sweeper: Optional[threading.Thread] = None
        self._pool = ClientPool(timeout=120.0)  # the promoted primary's sweeps
        self._promote_lock = threading.Lock()
        self._synced = False        # current tail position is snapshot-anchored
        self._synced_once = False   # ever installed a snapshot (promotion gate)
        self._cursor = 1
        self._last_primary_ok: Optional[float] = None
        self._partition_until = 0.0

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> tuple:
        self.address = self.rpc.start()
        # the lease clock starts NOW: a primary that never answers at all
        # still expires it, but promotion additionally requires one
        # successful snapshot sync (promoting empty tables helps nobody)
        self._last_primary_ok = time.monotonic()
        self._tail = threading.Thread(
            target=self._tail_loop, name="gcs-ha-tail", daemon=True
        )
        self._tail.start()
        return self.address

    def stop(self) -> None:
        self._stop.set()
        self.rpc.stop()
        for t in (self._tail, self._sweeper):
            if t is not None:
                t.join(timeout=5)
        self._pool.close_all()

    # -- chaos ---------------------------------------------------------------

    def force_partition(self, window_s: float) -> None:
        """PARTITION_GCS_PAIR server side: pretend the pair link is cut
        for window_s seconds — the tail loop stops polling the primary,
        so the lease expires and promotion happens WHILE the primary is
        still alive (the split-brain the fencing term must resolve)."""
        self._partition_until = time.monotonic() + float(window_s)
        logger.warning(
            "standby partitioned from primary for %.2fs (chaos)", window_s
        )

    def status_extra(self) -> dict:
        now = time.monotonic()
        return {
            "standby_synced": self._synced,
            "primary_addr": self.primary_addr,
            "primary_silence_s": (
                now - self._last_primary_ok
                if self._last_primary_ok is not None else None
            ),
            "lease_timeout_s": self.lease_timeout_s,
        }

    # -- tail + lease ---------------------------------------------------------

    def _tail_loop(self) -> None:
        client: Optional[RpcClient] = None
        # tight: a dead-but-not-RST primary (half-open socket) must be
        # detected within the lease bound, not after a generous RPC
        # timeout — the long-poll budget plus half a lease of grace
        call_timeout = self.poll_wait_s + max(0.5, self.lease_timeout_s / 2)
        while not self._stop.is_set() and not self.promoted.is_set():
            if time.monotonic() < self._partition_until:
                if client is not None:
                    client.close()
                    client = None
                self._check_lease()
                self._stop.wait(0.05)
                continue
            try:
                if client is None or not client.connected:
                    if client is not None:
                        client.close()
                    client = RpcClient(
                        *self.primary_addr, timeout=call_timeout
                    ).connect(retries=0)
                if not self._synced:
                    r = client.call("repl_snapshot", {}, timeout=10.0)
                    self.service.repl_install_snapshot(
                        r["doc"], int(r["cursor"]), int(r["term"])
                    )
                    self._cursor = int(r["cursor"])
                    self._synced = True
                    self._synced_once = True
                    self._mark_primary_ok(lag_s=0.0)
                    logger.info(
                        "standby synced snapshot at cursor %d (term %d)",
                        self._cursor, int(r["term"]),
                    )
                    continue
                r = client.call(
                    "repl_since",
                    {"cursor": self._cursor, "wait": self.poll_wait_s},
                    timeout=call_timeout,
                )
                # the primary answered: its lease renews even on a
                # resync verdict (it is alive, we just fell behind)
                if r.get("resync"):
                    self._synced = False
                    self._mark_primary_ok(lag_s=None)
                    logger.warning(
                        "standby fell off the replication window; "
                        "re-syncing from snapshot"
                    )
                    continue
                self.service.repl_apply(r.get("entries", ()))
                self._cursor = int(r["cursor"])
                behind = int(r.get("head", 0)) - (self._cursor - 1)
                self._mark_primary_ok(lag_s=0.0 if behind <= 0 else None)
            except (RpcError, RemoteError, OSError):
                # primary unreachable: drop the connection and keep the
                # lease clock running — expiry is what promotes us
                if client is not None:
                    client.close()
                    client = None
                self._stop.wait(0.05)
            self._check_lease()
        if client is not None:
            client.close()

    def _mark_primary_ok(self, lag_s: Optional[float]) -> None:
        self._last_primary_ok = time.monotonic()
        if lag_s is not None:
            register_metrics()[0].set(lag_s)

    def _check_lease(self) -> None:
        if self.promoted.is_set() or self._stop.is_set():
            return
        last = self._last_primary_ok
        if last is None or not self._synced_once:
            return
        if time.monotonic() - last > self.lease_timeout_s:
            self._promote()

    def _promote(self) -> None:
        with self._promote_lock:
            if self.promoted.is_set():
                return
            silence = (
                time.monotonic() - self._last_primary_ok
                if self._last_primary_ok is not None else -1.0
            )
            term = self.service.promote()
            # the new primary needs the serving sweeps (health, reconcile,
            # restart, pg_reserve, persist): exactly GcsServer's loop
            self._sweeper = start_sweeper(self.service, self._stop, pool=self._pool)
            # flip the facade LAST: the first admitted client call must
            # see the bumped term and the restore-discipline tables
            self.promoted.set()
            logger.warning(
                "standby at %s promoted to primary (term %d, primary "
                "silent %.2fs > lease %.2fs)",
                self.address, term, silence, self.lease_timeout_s,
            )


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--primary", required=True,
                   help="host:port of the primary GCS to tail")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--death-timeout", type=float, default=5.0)
    p.add_argument("--lease-timeout", type=float, default=2.0,
                   help="seconds of primary silence before promotion")
    p.add_argument("--poll-wait", type=float, default=1.0,
                   help="repl_since long-poll budget per tail round")
    p.add_argument("--persist", default=None,
                   help="snapshot path for the (post-promotion) primary")
    args = p.parse_args()
    h, pr = args.primary.rsplit(":", 1)
    server = StandbyGcsServer(
        (h, int(pr)), host=args.host, port=args.port,
        lease_timeout_s=args.lease_timeout,
        poll_wait_s=args.poll_wait,
        node_death_timeout_s=args.death_timeout,
        persist_path=args.persist,
    )
    host, port = server.start()
    # same banner tag as gcs_service.main: the parent's _read_banner
    # discovers the bound port identically for both roles
    print(f"GCS_ADDRESS {host}:{port}", flush=True)
    try:
        # bounded parks only (check_timeouts): the entry thread idles in
        # slices instead of a forever-wait
        while not server._stop.wait(60.0):
            pass
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
