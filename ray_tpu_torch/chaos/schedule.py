"""Deterministic fault schedules: what breaks, where, and when
(counterpart of ``ray_tpu/chaos/schedule.py``; the kinds, ``FaultSpec``,
``FaultSchedule`` and its seeded decisions are the reference's).

A schedule is seeded and typed: the same seed reproduces the same fault
sequence against the same call sequence, so a failing chaos run is a
replayable artifact, not a flake. Eligibility is counted per spec;
probabilistic specs draw from a per-spec ``random.Random`` derived from
the schedule seed.

Every kind of the reference is accepted, so a schedule written for the
reference loads here. The port's hook sites implement the in-process
kinds they meet: ``llm.engine.step`` (PREEMPT_ENGINE, KILL_WORKER,
DELAY_RPC), ``disagg.kv_transfer`` (DROP_KV_TRANSFER, CORRUPT_KV_TRANSFER,
DELAY_RPC), ``llm.kvtier.spill`` (DROP_KV_TRANSFER, CORRUPT_KV_TRANSFER),
``llm.kvfetch`` (DROP_KV_TRANSFER, CORRUPT_KV_TRANSFER, DELAY_RPC) and
``process_pool.task`` (KILL_WORKER: the worker process of a
``worker_mode="process"`` task is killed), and the cluster's ``rpc.call``,
``rpc.frame``, ``gcs.call``, ``node.heartbeat`` and ``cluster.push``.
The orchestrated kinds run through ``chaos.runner.ChaosRunner`` against a
``LocalCluster`` or a Serve controller; ``to_wire`` / ``from_wire`` carry a
schedule to a cluster's processes (``harness.install(propagate_env=True)``).
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
from fnmatch import fnmatchcase
from typing import Optional, Sequence

# -- typed fault kinds --------------------------------------------------------

KILL_WORKER = "kill_worker"          # kill the worker process running a task
KILL_REPLICA = "kill_replica"        # crash a serve replica mid-request
DROP_RPC = "drop_rpc"                # transport error instead of the send
DELAY_RPC = "delay_rpc"              # inject latency before the send
STALL_HEARTBEAT = "stall_heartbeat"  # node stops heartbeating (partition)
PREEMPT_NODE = "preempt_node"        # SIGKILL a whole node (daemon+workers)
CORRUPT_FRAME = "corrupt_frame"      # flip bytes in the wire frame
PREEMPT_ENGINE = "preempt_engine"    # LLM engine dies mid-step
# disaggregated-serving KV-transfer plane (llm/disagg/connector.py): a
# handoff that vanishes in flight vs one that arrives bit-flipped — the
# two failure modes a prefill->decode transfer plane must survive
# (receiver detects corruption by checksum; both end in a re-prefill)
DROP_KV_TRANSFER = "drop_kv_transfer"        # handoff lost before the send
CORRUPT_KV_TRANSFER = "corrupt_kv_transfer"  # KV pages bit-flipped in flight
# collective/DAG plane (collective/collective.py, collective/
# cluster_group.py, plus rpc.call for process-wide partitions): the gang
# failure modes a data-parallel trainer on a preemptible pod must
# survive. All four end the same way for the survivors — a bounded wait
# raising a typed CollectiveError instead of a forever-hung allreduce.
KILL_RANK = "kill_rank"                  # a gang rank dies mid-collective
STALL_COLLECTIVE = "stall_collective"    # a rank arrives late (delay_s)
DROP_COLLECTIVE = "drop_collective"      # a contribution lost in flight
PARTIAL_PARTITION = "partial_partition"  # heartbeats reach GCS, peers don't
# control plane (r13): the one process chaos had never touched. KILL_GCS
# SIGKILLs the GCS on the runner timeline (with a scheduled restart via
# restart_after_s — the blackout window); STALL_GCS is an outage WITHOUT
# a process death: every GCS-bound rpc.call in the seeded window fails
# with DROP_RPC-style transport loss while the process stays up.
KILL_GCS = "kill_gcs"                    # SIGKILL the control plane
STALL_GCS = "stall_gcs"                  # GCS-bound RPCs get transport loss
# control-plane HA (r23, cluster/ha.py): KILL_GCS_PRIMARY SIGKILLs the
# primary GCS with NO restart ever scheduled — survival now means the
# warm standby promotes within its lease bound and clients fail over,
# not that the dead process comes back. PARTITION_GCS_PAIR opens a
# split-brain window of window_s seconds: the standby stops seeing the
# primary (server-side partition clock) while the driver's clients are
# blocked from the primary (harness.BLOCKED_PEERS) — the standby
# promotes, both "primaries" are alive, and epoch fencing must leave
# exactly one term winner with every zombie write counted and rejected.
KILL_GCS_PRIMARY = "kill_gcs_primary"    # SIGKILL primary; standby promotes
PARTITION_GCS_PAIR = "partition_gcs_pair"  # split-brain window (window_s)
# compiled-DAG channel plane (dag/channels.py send/recv + the
# dag/compiled.py exec loops): a value lost in flight (receiver's
# bounded read raises ChannelTimeoutError) vs a late writer (delay_s) —
# the collective fault kinds' semantics on the channel substrate.
DROP_CHANNEL = "drop_channel"            # written value lost in flight
STALL_CHANNEL = "stall_channel"          # channel op delayed by delay_s
# device-direct transfer plane (ray_tpu/fabric/transport.py): the same
# two failure modes the KV-transfer kinds model, on the ICI/device
# substrate — a device transfer that never lands vs one whose pages
# arrive bit-flipped (caught by the device-side checksum at import).
# Distinct kinds so a schedule can fault ONLY the device edges and the
# orchestrator's RPC-fallback path is what gets exercised.
DROP_DEVICE_TRANSFER = "drop_device_transfer"        # device xfer lost
CORRUPT_DEVICE_TRANSFER = "corrupt_device_transfer"  # pages flipped on device

KINDS = frozenset({
    KILL_WORKER, KILL_REPLICA, DROP_RPC, DELAY_RPC, STALL_HEARTBEAT,
    PREEMPT_NODE, CORRUPT_FRAME, PREEMPT_ENGINE,
    DROP_KV_TRANSFER, CORRUPT_KV_TRANSFER,
    KILL_RANK, STALL_COLLECTIVE, DROP_COLLECTIVE, PARTIAL_PARTITION,
    KILL_GCS, STALL_GCS, DROP_CHANNEL, STALL_CHANNEL,
    DROP_DEVICE_TRANSFER, CORRUPT_DEVICE_TRANSFER,
    KILL_GCS_PRIMARY, PARTITION_GCS_PAIR,
})

# kinds the in-process hook ignores (a runner executes them instead)
ORCHESTRATED = frozenset({
    PREEMPT_NODE, KILL_GCS, KILL_GCS_PRIMARY, PARTITION_GCS_PAIR,
})
# kinds ChaosRunner knows how to execute on an at_s timeline
RUNNER_KINDS = frozenset({
    PREEMPT_NODE, KILL_WORKER, KILL_REPLICA, KILL_GCS,
    KILL_GCS_PRIMARY, PARTITION_GCS_PAIR,
})


@dataclasses.dataclass
class FaultSpec:
    """One rule in a schedule.

    ``site`` / ``match`` select eligible hook calls (fnmatch patterns;
    ``match`` patterns apply to the hook's keyword attrs). Of eligible
    calls, the first ``start_after`` are skipped, then every
    ``every_n``-th is considered, fires with probability ``p`` (drawn
    from the spec's seeded RNG), at most ``max_fires`` times."""

    kind: str
    site: str = "*"
    match: dict = dataclasses.field(default_factory=dict)
    p: float = 1.0
    start_after: int = 0
    every_n: int = 1
    max_fires: int = -1          # -1 = unbounded
    delay_s: float = 0.05        # DELAY_RPC sleep
    at_s: float = 0.0            # orchestrated: offset from runner start
    target: Optional[str] = None  # orchestrated: node_id / "app/deployment"
    # KILL_GCS only: restart the control plane this many seconds after
    # the kill (0 = no scheduled restart; the test restarts it itself).
    # The window [at_s, at_s + restart_after_s] IS the blackout.
    # (KILL_GCS_PRIMARY deliberately rejects it: HA survival must come
    # from standby promotion, never from the dead primary coming back.)
    restart_after_s: float = 0.0
    # PARTITION_GCS_PAIR only: how long the split-brain window stays
    # open before the partition heals.
    window_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {sorted(KINDS)}")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.every_n < 1:
            raise ValueError("every_n must be >= 1")
        if self.restart_after_s < 0.0:
            raise ValueError("restart_after_s must be >= 0")
        if self.restart_after_s > 0.0 and self.kind != KILL_GCS:
            raise ValueError(
                f"restart_after_s is only valid for {KILL_GCS!r}, "
                f"not {self.kind!r}"
            )
        if self.window_s < 0.0:
            raise ValueError("window_s must be >= 0")
        if self.window_s > 0.0 and self.kind != PARTITION_GCS_PAIR:
            raise ValueError(
                f"window_s is only valid for {PARTITION_GCS_PAIR!r}, "
                f"not {self.kind!r}"
            )
        if self.kind == PARTITION_GCS_PAIR and self.window_s <= 0.0:
            raise ValueError(
                f"{PARTITION_GCS_PAIR!r} requires window_s > 0 "
                "(the split-brain window must eventually heal)"
            )
        if self.at_s > 0.0 and self.kind not in RUNNER_KINDS:
            # at_s routes the spec to ChaosRunner, which only executes
            # RUNNER_KINDS — anything else would be a silent no-op that
            # fires nowhere (neither hooks nor runner)
            raise ValueError(
                f"at_s is only valid for {sorted(RUNNER_KINDS)}, "
                f"not {self.kind!r} (in-process kinds use "
                "start_after/every_n/p instead)"
            )


@dataclasses.dataclass
class Fault:
    """A fired fault — the post-mortem record (also mirrored into the
    ray_tpu_torch.obs flight recorder as a ``chaos.<kind>`` event span)."""

    seq: int
    kind: str
    site: str
    spec_index: int
    attrs: dict
    t: float


class FaultSchedule:
    """Seeded, thread-safe fault decider. Same seed + same eligible-call
    sequence => same fault sequence; zero shared global RNG state."""

    def __init__(self, seed: int, faults: Sequence[FaultSpec]):
        self.seed = int(seed)
        self.specs = list(faults)
        for f in self.specs:
            if not isinstance(f, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {type(f)}")
        # one RNG per spec: a spec added/removed between runs cannot
        # shift its siblings' decision streams
        self._rngs = [
            random.Random((self.seed << 16) ^ i) for i in range(len(self.specs))
        ]
        self._eligible = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)
        self.log: list[Fault] = []
        self._seq = 0
        self._lock = threading.Lock()

    # -- decision ------------------------------------------------------------

    def fire(self, site: str, kinds: Optional[Sequence[str]] = None,
             **attrs) -> list[FaultSpec]:
        """Decide which specs fire for this hook call; records them in
        ``log``. Deterministic in (seed, call order). ``kinds`` is the
        set of fault kinds THIS hook site implements: a spec whose kind
        the site would ignore is not eligible here — otherwise a
        wildcard-site spec could burn its max_fires budget (and log a
        fault into the post-mortem) at a site where nothing happens."""
        hits: list[FaultSpec] = []
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.kind in ORCHESTRATED or spec.at_s > 0.0:
                    # timeline-orchestrated specs belong to ChaosRunner;
                    # matching them at in-process hook sites too would
                    # fire the same fault twice through different planes
                    continue
                if kinds is not None and spec.kind not in kinds:
                    continue
                if not fnmatchcase(site, spec.site):
                    continue
                if not all(
                    fnmatchcase(str(attrs.get(k, "")), pat)
                    for k, pat in spec.match.items()
                ):
                    continue
                n = self._eligible[i]
                self._eligible[i] += 1
                if n < spec.start_after:
                    continue
                if (n - spec.start_after) % spec.every_n:
                    continue
                if spec.max_fires >= 0 and self._fired[i] >= spec.max_fires:
                    continue
                if spec.p < 1.0 and self._rngs[i].random() >= spec.p:
                    continue
                self._fired[i] += 1
                self.log.append(Fault(
                    seq=self._seq, kind=spec.kind, site=site, spec_index=i,
                    attrs=dict(attrs), t=time.time(),
                ))
                self._seq += 1
                hits.append(spec)
        return hits

    def pick(self, spec_index: int, choices: Sequence) -> object:
        """Deterministic choice for orchestrated faults (e.g. which node
        to preempt) from the spec's own RNG."""
        if not choices:
            raise ValueError("no choices to pick from")
        return self._rngs[spec_index].choice(sorted(choices, key=str))

    def orchestrated(self) -> list[tuple[int, FaultSpec]]:
        """(index, spec) pairs a ChaosRunner should execute, by at_s."""
        out = [
            (i, s) for i, s in enumerate(self.specs)
            if s.kind in ORCHESTRATED or s.at_s > 0.0
        ]
        out.sort(key=lambda t: t[1].at_s)
        return out

    def fired_kinds(self) -> list[str]:
        with self._lock:
            return [f.kind for f in self.log]

    def decisions(self) -> list[tuple[str, str, int]]:
        """Compact (kind, site, spec_index) sequence — the determinism
        contract surface: equal for equal seeds and call sequences."""
        with self._lock:
            return [(f.kind, f.site, f.spec_index) for f in self.log]

    # -- wire form (env propagation to subprocesses) --------------------------

    def to_wire(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [dataclasses.asdict(f) for f in self.specs],
        })

    @classmethod
    def from_wire(cls, wire: str) -> "FaultSchedule":
        doc = json.loads(wire)
        return cls(doc["seed"], [FaultSpec(**f) for f in doc["faults"]])
