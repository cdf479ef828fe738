"""The cluster-wide metrics plane (counterpart of ``ray_tpu/obs/telemetry.py``).

Every process's ``util/metrics`` registry (node daemons, engine hosts, the
Serve controller) ships snapshots to the GCS, which keeps a bounded
time-series ring per (reporter, metric, labels) and serves cluster-level
aggregation. The names, the wire form, the aggregation and the status
text are the reference's, so one seeded snapshot sequence fed to both
packages' ``TelemetryStore`` gives equal aggregates, SLO reports and
``format_status`` text.

Correctness contract:

 * counters and histograms travel as monotonic totals per process epoch:
   a dropped or delayed ``telemetry_push`` only costs freshness, the next
   snapshot carries the full totals, so aggregates never double count
   and never go backwards;
 * a process restart bumps ``epoch``: the store banks the dead epoch's
   final totals into ``base`` and the new epoch counts from zero;
 * re-ordered deliveries (a delayed push landing after a newer one) are
   dropped by ``seq``;
 * staleness per reporter is itself reported
   (``ray_tpu_telemetry_staleness_seconds``).

Aggregation kinds are declared per metric (``sum`` / ``max`` /
``merge``) and travel with the snapshot, so the GCS imports none of the
instrumented modules (and never torch). Histogram ``merge`` is bucket-wise
vector addition: percentiles of the merged vector equal percentiles over
the union of the per-replica observations to within one bucket width.

On top of the store: the SLO evaluator that grades each model tag
green/yellow/red from the merged TTFT/TPOT/queue-wait histograms (the
fleet's canary ladder grades a replica with it too), ``perf_health`` over
whatever ``ray_tpu_perf_*`` series arrive (the sampler that makes them is
ROADMAP.md Queue 1, item 11), and ``format_status``, the text of the
cluster's one-query status.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, _fq
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.obs.telemetry")

# -- aggregation kinds --------------------------------------------------------

AGG_SUM = "sum"      # cluster value = sum over reporters (capacity, totals)
AGG_MAX = "max"      # cluster value = max over reporters (worst-case view)
AGG_MERGE = "merge"  # histograms: bucket-wise vector addition
VALID_AGGREGATIONS = frozenset({AGG_SUM, AGG_MAX, AGG_MERGE})

# Name prefixes the telemetry plane aggregates: every gauge/counter under
# these MUST declare an aggregation kind (the metrics lint's rule).
AGGREGATED_PREFIXES = (
    "ray_tpu_node_",
    "ray_tpu_serve_",
    "ray_tpu_telemetry_",
    "ray_tpu_llm_",
    "ray_tpu_profiler_",
    "ray_tpu_train_",
    "ray_tpu_fabric_",
    # RL post-training actor/learner plane (rl/post_train) — the
    # version-skew/trajectory-lag series behind `== rl post-train ==`
    "ray_tpu_rl_post_",
    # SLO closed-loop pool autoscaler (autoscale) — decisions,
    # scale events, cold-start timings behind `== autoscaler ==`
    "ray_tpu_autoscale_",
    # multi-tenant model fleet (fleet) — adapter residency churn,
    # canary outcomes, per-tenant routing volume behind `== fleet ==`
    "ray_tpu_fleet_",
    # perfwatch sampled step profiling (obs.perfwatch) — segment
    # times, coverage, MFU, overlap, regression ratio behind `== perf ==`
    "ray_tpu_perf_",
)

_AGGREGATIONS: dict[str, str] = {}


def declare_aggregation(name: str, kind: str) -> None:
    """Declare how a metric aggregates across reporters. Names are
    fully-qualified the same way the registry qualifies them."""
    if kind not in VALID_AGGREGATIONS:
        raise ValueError(
            f"aggregation kind {kind!r} not in {sorted(VALID_AGGREGATIONS)}"
        )
    _AGGREGATIONS[_fq(name)] = kind


def aggregation_kind(name: str, metric_type: Optional[str] = None) -> Optional[str]:
    """Declared kind, else the per-type default: counters sum, histograms
    merge; gauges have NO default (sum-vs-max is a semantic choice the
    owner must make — that's the check_metrics lint)."""
    k = _AGGREGATIONS.get(_fq(name))
    if k is not None:
        return k
    if metric_type == "counter":
        return AGG_SUM
    if metric_type == "histogram":
        return AGG_MERGE
    return None


def cluster_counter(name: str, description: str = "",
                    tag_keys: Optional[tuple] = None,
                    agg: str = AGG_SUM) -> Counter:
    declare_aggregation(name, agg)
    return Counter(name, description=description, tag_keys=tag_keys)


def cluster_gauge(name: str, description: str = "",
                  tag_keys: Optional[tuple] = None,
                  agg: str = AGG_SUM) -> Gauge:
    declare_aggregation(name, agg)
    return Gauge(name, description=description, tag_keys=tag_keys)


def cluster_histogram(name: str, description: str = "",
                      boundaries: Optional[list] = None,
                      tag_keys: Optional[tuple] = None) -> Histogram:
    declare_aggregation(name, AGG_MERGE)
    return Histogram(name, description=description, boundaries=boundaries,
                     tag_keys=tag_keys)


# -- histogram math (pure, property-tested) -----------------------------------


def merge_bucket_vectors(vectors: list) -> list:
    """Bucket-wise sum of same-shape histogram vectors."""
    if not vectors:
        return []
    n = len(vectors[0])
    out = [0] * n
    for v in vectors:
        if len(v) != n:
            raise ValueError(
                f"cannot merge bucket vectors of length {len(v)} and {n} "
                "(boundary mismatch)"
            )
        for i, x in enumerate(v):
            out[i] += x
    return out


def bucket_percentile(boundaries: list, buckets: list, q: float) -> Optional[float]:
    """Nearest-rank percentile estimate from a bucket vector: the UPPER
    boundary of the bucket holding the rank-q observation (the +Inf
    bucket reports the last finite boundary — the best known lower
    bound). By construction the true union-of-observations nearest-rank
    percentile lies inside the same bucket, i.e. the estimate is exact to
    within one bucket width."""
    total = sum(buckets)
    if total <= 0:
        return None
    rank = max(1, math.ceil(q / 100.0 * total))
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= rank:
            return float(boundaries[i]) if i < len(boundaries) else float(boundaries[-1])
    return float(boundaries[-1])


def bucket_percentile_band(boundaries: list, buckets: list,
                           q: float) -> Optional[tuple]:
    """(lower, upper) bounds of the bucket holding the rank-q observation
    (upper = +inf for the overflow bucket) — the containment interval the
    merge-correctness property test asserts against."""
    total = sum(buckets)
    if total <= 0:
        return None
    rank = max(1, math.ceil(q / 100.0 * total))
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= rank:
            lo = float(boundaries[i - 1]) if i > 0 else float("-inf")
            hi = float(boundaries[i]) if i < len(boundaries) else float("inf")
            return (lo, hi)
    return (float(boundaries[-1]), float("inf"))


# -- SLO evaluation -----------------------------------------------------------

GRADE_GREEN = "green"
GRADE_YELLOW = "yellow"
GRADE_RED = "red"
GRADE_NO_DATA = "no_data"
_GRADE_ORDER = {GRADE_NO_DATA: 0, GRADE_GREEN: 1, GRADE_YELLOW: 2, GRADE_RED: 3}

# the three merged histograms the evaluator grades, by registry name
SLO_HISTOGRAMS = {
    "ttft": _fq("llm_ttft_seconds"),
    "tpot": _fq("llm_tpot_seconds"),
    "queue_wait": _fq("llm_queue_wait_seconds"),
}


@dataclasses.dataclass
class SLOThresholds:
    """Green thresholds at ``percentile``; yellow up to
    ``yellow_factor`` x threshold, red beyond. Defaults sized for a CPU
    smoke model — production configs come from the serving deployment."""

    ttft_p_s: float = 2.0
    tpot_p_s: float = 0.2
    queue_wait_p_s: float = 1.0
    percentile: float = 95.0
    yellow_factor: float = 2.0
    min_count: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SLOThresholds":
        if not d:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def grade_value(value: Optional[float], threshold: float,
                yellow_factor: float) -> str:
    if value is None:
        return GRADE_NO_DATA
    if value <= threshold:
        return GRADE_GREEN
    if value <= threshold * yellow_factor:
        return GRADE_YELLOW
    return GRADE_RED


def evaluate_slo(histograms: dict, thresholds: Optional[SLOThresholds] = None) -> dict:
    """Grade every model tag from MERGED SLO histograms.

    ``histograms``: {registry_name: {model_tag: {"boundaries", "buckets",
    "sum", "count"}}} — the shape ``TelemetryStore.cluster_metrics``
    produces. Output is the autoscaler's input: per-tag grades with the
    signal->pool mapping made explicit (TTFT prices the prefill pool,
    TPOT the decode pool, queue_wait admission/overall capacity)."""
    th = thresholds or SLOThresholds()
    limits = {
        "ttft": th.ttft_p_s,
        "tpot": th.tpot_p_s,
        "queue_wait": th.queue_wait_p_s,
    }
    tags: set = set()
    for name in SLO_HISTOGRAMS.values():
        tags.update((histograms.get(name) or {}).keys())
    out: dict = {"thresholds": th.to_dict(), "model_tags": {}}
    for tag in sorted(tags):
        entry: dict = {}
        worst = GRADE_NO_DATA
        for short, name in SLO_HISTOGRAMS.items():
            h = (histograms.get(name) or {}).get(tag)
            count = int(h["count"]) if h else 0
            p = None
            if h and count >= th.min_count:
                p = bucket_percentile(h["boundaries"], h["buckets"], th.percentile)
            g = grade_value(p, limits[short], th.yellow_factor)
            entry[short] = {
                "count": count,
                f"p{th.percentile:g}": p,
                "p50": bucket_percentile(h["boundaries"], h["buckets"], 50.0)
                if h else None,
                "threshold_s": limits[short],
                "grade": g,
            }
            if _GRADE_ORDER[g] > _GRADE_ORDER[worst]:
                worst = g
        entry["grade"] = worst
        # the closed-loop mapping ROADMAP item 4 consumes: which pool a
        # breached signal points at
        entry["autoscaler_hints"] = {
            "scale_prefill": entry["ttft"]["grade"] in (GRADE_YELLOW, GRADE_RED),
            "scale_decode": entry["tpot"]["grade"] in (GRADE_YELLOW, GRADE_RED),
            "shed_or_add_capacity":
                entry["queue_wait"]["grade"] in (GRADE_YELLOW, GRADE_RED),
        }
        out["model_tags"][tag] = entry
    return out


# -- reporter-side ------------------------------------------------------------


def pushes_counter() -> Counter:
    return cluster_counter(
        "telemetry_pushes_total",
        description="telemetry snapshots this process attempted to ship "
        "to the GCS, by result (ok / dropped / error)",
        tag_keys=("result",),
        agg=AGG_SUM,
    )


def staleness_gauge() -> Gauge:
    return cluster_gauge(
        "telemetry_staleness_seconds",
        description="seconds since each reporter's last accepted "
        "telemetry push (set GCS-side at aggregation time; a partitioned "
        "or crashed reporter shows up here, never as silent absence)",
        tag_keys=("reporter",),
        agg=AGG_MAX,
    )


def register_metrics() -> None:
    """The metrics lint's hook: force telemetry-plane metrics to
    register and their aggregation kinds to be declared."""
    pushes_counter()
    staleness_gauge()


def annotated_snapshot(
    series_filter: Optional[Callable[[str, dict], bool]] = None,
) -> dict:
    """util/metrics.snapshot_registry + per-metric aggregation kinds, so
    declarations travel with the data and the GCS never imports the
    instrumented modules."""
    snap = metrics_mod.snapshot_registry(series_filter)
    for entry in snap["metrics"]:
        agg = aggregation_kind(entry["name"], entry["type"])
        if agg is not None:
            entry["agg"] = agg
    return snap


class TelemetryReporter:
    """Ships this process's metrics registry to the GCS on an interval.

    ``collect`` callbacks run right before each snapshot (refresh
    utilization gauges from live state); failures in them — and in the
    push itself — never propagate: telemetry loss is staleness, by
    design. Chaos's DROP_RPC/DELAY_RPC specs match the push at the
    ``rpc.call`` site with ``method="telemetry_push"``."""

    def __init__(
        self,
        gcs_addr: Optional[tuple] = None,
        *,
        reporter_id: str,
        kind: str = "process",
        role: str = "",
        interval_s: float = 2.0,
        series_filter: Optional[Callable[[str, dict], bool]] = None,
        collect: Optional[list] = None,
        client: Any = None,
        timeout_s: float = 5.0,
    ):
        if client is None and gcs_addr is None:
            raise ValueError("need gcs_addr or an rpc client")
        self.reporter_id = reporter_id
        self.kind = kind
        self.role = role
        self.interval_s = float(interval_s)
        self._series_filter = series_filter
        self._collect = list(collect or ())
        self._timeout = timeout_s
        self._client = client
        self._gcs_addr = tuple(gcs_addr) if gcs_addr else None
        self._owns_client = client is None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_ok = 0
        self.num_dropped = 0

    def _get_client(self):
        if self._client is None:
            from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient

            self._client = ReconnectingRpcClient(
                *self._gcs_addr, timeout=self._timeout
            ).connect(retries=5)
        return self._client

    def add_collect(self, fn: Callable[[], None]) -> None:
        self._collect.append(fn)

    def snapshot(self) -> dict:
        for fn in self._collect:
            try:
                fn()
            except Exception:  # noqa: BLE001 — telemetry must not break serving
                logger.exception("telemetry collect callback failed")
        return annotated_snapshot(self._series_filter)

    def push_once(self) -> bool:
        """One snapshot->push round. False = this push was lost (the next
        one re-carries the full totals; nothing to retry)."""
        from ray_tpu_torch.cluster.rpc import RemoteError, RpcError

        snap = self.snapshot()
        try:
            self._get_client().call(
                "telemetry_push",
                {
                    "reporter_id": self.reporter_id,
                    "kind": self.kind,
                    "role": self.role,
                    "snapshot": snap,
                },
                timeout=self._timeout,
            )
        except (RpcError, RemoteError):
            self.num_dropped += 1
            try:
                pushes_counter().inc(tags={"result": "dropped"})
            except Exception:  # noqa: BLE001
                pass
            return False
        self.num_ok += 1
        try:
            pushes_counter().inc(tags={"result": "ok"})
        except Exception:  # noqa: BLE001
            pass
        return True

    def start(self) -> "TelemetryReporter":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name=f"telemetry-{self.reporter_id}", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.push_once()
            except Exception:  # noqa: BLE001 — the loop must never die
                logger.exception("telemetry push failed")

    def stop(self, final_push: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if final_push:
            try:
                self.push_once()
            except Exception:  # noqa: BLE001
                pass
        if self._owns_client and self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None


# -- GCS-side store -----------------------------------------------------------


class TelemetryStore:
    """Bounded time-series store + cluster aggregation (lives inside the
    GCS service; one instance per control plane).

    Per (reporter, metric, labels) series state: ``base`` (totals banked
    from dead process epochs), ``last`` (the live epoch's running total
    or gauge value), and a ring of (wall_ts, cumulative) points bounded
    by ``ring_len`` — enough history for rate computation (bytes/s) and
    a recent-window sparkline without unbounded growth."""

    def __init__(self, ring_len: int = 240, rate_window_s: float = 60.0,
                 expire_after_s: float = 900.0):
        self._lock = threading.RLock()
        self.ring_len = int(ring_len)
        self.rate_window_s = float(rate_window_s)
        # reporters silent this long are evicted with all their series:
        # partitioned nodes show up as STALE well before this (staleness
        # is the signal), but a decommissioned/renamed reporter must not
        # contribute its last gauge values to sum rollups forever
        self.expire_after_s = float(expire_after_s)
        self._reporters: dict[str, dict] = {}
        self._series: dict[tuple, dict] = {}
        self._meta: dict[str, dict] = {}
        self.num_ingested = 0
        self.num_ignored_stale = 0
        self.num_expired = 0

    # -- writes ---------------------------------------------------------------

    def ingest(self, reporter_id: str, snapshot: dict,
               meta: Optional[dict] = None) -> dict:
        now_m, now_w = time.monotonic(), time.time()
        with self._lock:
            out = self._ingest_one_locked(reporter_id, snapshot, meta,
                                          now_m, now_w)
            self._reap(now_m)
        return out

    def ingest_batch(self, items: list) -> list:
        """Coalesced ingest (control-plane batching): N snapshots —
        ``(reporter_id, snapshot, meta)`` tuples — under ONE lock
        acquisition and ONE reap sweep, for the GCS's batched heartbeat/
        telemetry frames. Per-item epoch/seq guards are identical to
        ``ingest``; results are returned in order."""
        now_m, now_w = time.monotonic(), time.time()
        out: list = []
        with self._lock:
            for reporter_id, snapshot, meta in items:
                out.append(
                    self._ingest_one_locked(reporter_id, snapshot, meta,
                                            now_m, now_w)
                )
            self._reap(now_m)
        return out

    def _ingest_one_locked(self, reporter_id: str, snapshot: dict,
                           meta: Optional[dict], now_m: float,
                           now_w: float) -> dict:
        """One snapshot's epoch/seq-guarded ingest; caller holds
        ``self._lock`` (and runs ``_reap`` once per lock acquisition)."""
        epoch = str(snapshot.get("epoch", ""))
        seq = int(snapshot.get("seq", 0))
        rep = self._reporters.get(reporter_id)
        if rep is not None:
            if rep["epoch"] == epoch and seq <= rep["seq"]:
                # a delayed/duplicated push landing after a newer one:
                # ignoring it is what "monotonic re-send, never
                # double-count" means on the receive side
                self.num_ignored_stale += 1
                return {"ok": True, "ignored": "stale_seq"}
            if epoch in rep["dead_epochs"]:
                # a delayed pre-restart push landing after the new
                # epoch already reported: accepting it would re-bank
                # the live epoch's totals under the dead epoch's —
                # a PERMANENT double count. Its tail delta is lost,
                # which is staleness at the restart boundary, not
                # corruption.
                self.num_ignored_stale += 1
                return {"ok": True, "ignored": "stale_epoch"}
        if rep is None:
            rep = self._reporters[reporter_id] = {
                "kind": "", "role": "", "pushes": 0,
                "dead_epochs": deque(maxlen=16),
            }
        if rep.get("epoch") not in (None, epoch):
            rep["dead_epochs"].append(rep["epoch"])
        rep["epoch"] = epoch
        rep["seq"] = seq
        rep["last_push_monotonic"] = now_m
        rep["last_push_wall"] = now_w
        rep["reporter_ts_wall"] = float(snapshot.get("ts_wall", now_w))
        rep["pushes"] += 1
        m = meta or {}
        if m.get("kind"):
            rep["kind"] = m["kind"]
        if m.get("role"):
            rep["role"] = m["role"]
        for entry in snapshot.get("metrics", ()):
            self._ingest_metric(reporter_id, epoch, now_w, entry)
        self.num_ingested += 1
        return {"ok": True}

    def _reap(self, now_m: float) -> None:
        """Evict reporters (and all their series) silent past
        ``expire_after_s`` — must hold the lock. Counter totals they
        contributed leave the aggregate with them: a reporter gone that
        long is decommissioned, and keeping its last gauges would count
        phantoms in every sum rollup while `_series` grows without bound
        under reporter churn."""
        dead = [
            rid for rid, rep in self._reporters.items()
            if now_m - rep["last_push_monotonic"] > self.expire_after_s
        ]
        for rid in dead:
            del self._reporters[rid]
            for key in [k for k in self._series if k[0] == rid]:
                del self._series[key]
            self.num_expired += 1
            try:
                staleness_gauge().remove_series(tags={"reporter": rid})
            except Exception:  # noqa: BLE001
                pass

    def _ingest_metric(self, reporter_id: str, epoch: str, now_w: float,
                       entry: dict) -> None:
        name = entry["name"]
        mtype = entry["type"]
        meta = self._meta.setdefault(name, {})
        meta["type"] = mtype
        if entry.get("description"):
            meta["description"] = entry["description"]
        meta["tag_keys"] = list(entry.get("tag_keys", ()))
        if "boundaries" in entry:
            meta["boundaries"] = list(entry["boundaries"])
        if entry.get("agg"):
            meta["agg"] = entry["agg"]
        for s in entry.get("series", ()):
            key = (reporter_id, name, tuple(s.get("tags", ())))
            st = self._series.get(key)
            if mtype == "histogram":
                buckets = [int(b) for b in s["buckets"]]
                zero = [0] * len(buckets)
                if st is None or len(st["last"]) != len(buckets):
                    # new series, or boundaries changed across a restart
                    # (vector shapes no longer merge): start clean
                    st = self._series[key] = {
                        "epoch": epoch, "base": list(zero), "last": list(zero),
                        "base_sum": 0.0, "last_sum": 0.0,
                        "base_count": 0, "last_count": 0,
                        "ring": deque(maxlen=self.ring_len),
                    }
                if st["epoch"] != epoch:
                    # restart: bank the dead epoch's final totals
                    st["base"] = [a + b for a, b in zip(st["base"], st["last"])]
                    st["base_sum"] += st["last_sum"]
                    st["base_count"] += st["last_count"]
                    st["epoch"] = epoch
                st["last"] = buckets
                st["last_sum"] = float(s.get("sum", 0.0))
                st["last_count"] = int(s.get("count", 0))
                st["ring"].append((now_w, st["base_count"] + st["last_count"]))
            elif mtype == "counter":
                val = float(s["value"])
                if st is None:
                    st = self._series[key] = {
                        "epoch": epoch, "base": 0.0, "last": 0.0,
                        "ring": deque(maxlen=self.ring_len),
                    }
                if st["epoch"] != epoch:
                    st["base"] += st["last"]
                    st["epoch"] = epoch
                    st["last"] = 0.0
                # max(): counters are monotonic within an epoch; a lower
                # value here could only be clock-free reordering the seq
                # guard already rejects — belt and braces
                st["last"] = max(st["last"], val)
                st["ring"].append((now_w, st["base"] + st["last"]))
            else:  # gauge: last write (per reporter) wins
                val = float(s["value"])
                if st is None:
                    st = self._series[key] = {
                        "epoch": epoch, "last": val,
                        "ring": deque(maxlen=self.ring_len),
                    }
                st["epoch"] = epoch
                st["last"] = val
                st["ring"].append((now_w, val))

    # -- reads ----------------------------------------------------------------

    @staticmethod
    def _tags_key(tag_keys: list, tags: tuple) -> str:
        """Stable string key for one tag combination. Values are escaped
        (``\\`` then ``,`` and ``=``) so a tag value containing the
        separators survives the round trip through `_parse_tags_key` —
        unescaped, `model=llama,8b` would re-parse as {model: llama} and
        be graded/grouped as the wrong tag."""
        if not tag_keys:
            return ""
        esc = (
            lambda v: str(v)
            .replace("\\", "\\\\")
            .replace(",", "\\,")
            .replace("=", "\\=")
        )
        return ",".join(f"{k}={esc(v)}" for k, v in zip(tag_keys, tags))

    @staticmethod
    def _parse_tags_key(skey: str) -> dict:
        """Inverse of `_tags_key` (tag KEYS are identifiers; only values
        carry escapes)."""
        if not skey:
            return {}
        out: dict = {}
        k: Optional[str] = None
        buf: list[str] = []
        it = iter(skey)
        for ch in it:
            if ch == "\\":
                buf.append(next(it, ""))
            elif ch == "=" and k is None:
                k = "".join(buf)
                buf = []
            elif ch == ",":
                if k is not None:
                    out[k] = "".join(buf)
                k, buf = None, []
            else:
                buf.append(ch)
        if k is not None:
            out[k] = "".join(buf)
        return out

    def _rate(self, ring: deque, now_w: float) -> float:
        """Per-second rate over the recent window from cumulative points."""
        if len(ring) < 2:
            return 0.0
        cutoff = now_w - self.rate_window_s
        pts = list(ring)
        first = pts[0]
        for p in pts:
            if p[0] >= cutoff:
                first = p
                break
        last = pts[-1]
        dt = last[0] - first[0]
        if dt <= 0:
            return 0.0
        return max(0.0, (last[1] - first[1]) / dt)

    def staleness(self) -> dict:
        """Seconds since each reporter's last accepted push (monotonic
        clock — wall-clock skew between hosts can't fake freshness).
        Also mirrored into this process's own registry so the merged
        exposition and /metrics carry it."""
        now_m = time.monotonic()
        with self._lock:
            self._reap(now_m)
            out = {
                rid: round(now_m - rep["last_push_monotonic"], 3)
                for rid, rep in self._reporters.items()
            }
        try:
            g = staleness_gauge()
            for rid, s in out.items():
                g.set(s, tags={"reporter": rid})
        except Exception:  # noqa: BLE001
            pass
        return out

    def cluster_metrics(self) -> dict:
        """The cluster-level aggregate: counter sums (+ windowed rates),
        gauge sum/max rollups, bucket-wise histogram merges with
        percentile estimates, per-reporter staleness."""
        now_w = time.time()
        staleness = self.staleness()
        with self._lock:
            reporters = {
                rid: {
                    "kind": rep.get("kind", ""),
                    "role": rep.get("role", ""),
                    "epoch": rep.get("epoch", ""),
                    "seq": rep.get("seq", 0),
                    "pushes": rep.get("pushes", 0),
                    "last_push_wall": rep.get("last_push_wall", 0.0),
                    "staleness_s": staleness.get(rid),
                }
                for rid, rep in self._reporters.items()
            }
            counters: dict = {}
            gauges: dict = {}
            hists: dict = {}
            for (rid, name, tags), st in self._series.items():
                meta = self._meta.get(name, {})
                mtype = meta.get("type", "gauge")
                skey = self._tags_key(meta.get("tag_keys", ()), tags)
                if mtype == "counter":
                    acc = counters.setdefault(name, {
                        "agg": meta.get("agg", AGG_SUM),
                        "description": meta.get("description", ""),
                        "total": 0.0, "series": {}, "rate_per_s": {},
                    })
                    cum = st["base"] + st["last"]
                    acc["total"] += cum
                    acc["series"][skey] = acc["series"].get(skey, 0.0) + cum
                    acc["rate_per_s"][skey] = round(
                        acc["rate_per_s"].get(skey, 0.0)
                        + self._rate(st["ring"], now_w), 6,
                    )
                elif mtype == "histogram":
                    acc = hists.setdefault(name, {
                        "agg": meta.get("agg", AGG_MERGE),
                        "description": meta.get("description", ""),
                        "boundaries": meta.get("boundaries", []),
                        "series": {},
                    })
                    merged = acc["series"].get(skey)
                    cum_buckets = [
                        a + b for a, b in zip(st["base"], st["last"])
                    ]
                    if merged is None:
                        merged = acc["series"][skey] = {
                            "buckets": list(cum_buckets),
                            "sum": 0.0, "count": 0,
                            "boundaries": acc["boundaries"],
                        }
                    else:
                        try:
                            merged["buckets"] = merge_bucket_vectors(
                                [merged["buckets"], cum_buckets]
                            )
                        except ValueError:
                            continue  # boundary drift: skip, don't corrupt
                    merged["sum"] += st["base_sum"] + st["last_sum"]
                    merged["count"] += st["base_count"] + st["last_count"]
                else:
                    kind = meta.get("agg") or AGG_SUM
                    acc = gauges.setdefault(name, {
                        "agg": kind,
                        "description": meta.get("description", ""),
                        "value": None, "series": {},
                    })
                    v = st["last"]
                    cur = acc["series"].get(skey)
                    if cur is None:
                        acc["series"][skey] = v
                    elif kind == AGG_MAX:
                        acc["series"][skey] = max(cur, v)
                    else:
                        acc["series"][skey] = cur + v
            for acc in gauges.values():
                vals = list(acc["series"].values())
                if vals:
                    acc["value"] = (
                        max(vals) if acc["agg"] == AGG_MAX else sum(vals)
                    )
            for acc in hists.values():
                for merged in acc["series"].values():
                    for q in (50.0, 90.0, 95.0, 99.0):
                        merged[f"p{q:g}"] = bucket_percentile(
                            merged["boundaries"], merged["buckets"], q
                        )
            return {
                "ts_wall": now_w,
                "reporters": reporters,
                "staleness": staleness,
                "counters": counters,
                "gauges": gauges,
                "histograms": hists,
                "ingested": self.num_ingested,
                "ignored_stale": self.num_ignored_stale,
            }

    def slo_histograms(self, agg: Optional[dict] = None) -> dict:
        """{registry_name: {model_tag: merged-series}} for the SLO
        evaluator, keyed off the histograms' ``model`` tag."""
        if agg is None:
            agg = self.cluster_metrics()
        out: dict = {}
        for short, name in SLO_HISTOGRAMS.items():
            acc = agg["histograms"].get(name)
            if not acc:
                continue
            per_tag: dict = {}
            for skey, merged in acc["series"].items():
                tag = self._parse_tags_key(skey).get("model", "")
                per_tag[tag] = merged
            out[name] = per_tag
        return out

    def slo_report(self, thresholds: Optional[SLOThresholds] = None,
                   agg: Optional[dict] = None) -> dict:
        if agg is None:
            agg = self.cluster_metrics()
        report = evaluate_slo(self.slo_histograms(agg), thresholds)
        report["staleness"] = agg["staleness"]
        return report

    def pool_rollups(self, agg: Optional[dict] = None) -> dict:
        """Role-keyed pool view from the serve controller's role-tagged
        replica gauges (DeploymentConfig.role)."""
        if agg is None:
            agg = self.cluster_metrics()
        pools: dict = {}
        for name, field in (
            (_fq("serve_replicas_running"), "replicas_running"),
            (_fq("serve_replicas_target"), "replicas_target"),
        ):
            acc = agg["gauges"].get(name)
            if not acc:
                continue
            for skey, v in acc["series"].items():
                tags = self._parse_tags_key(skey)
                role = tags.get("role", "") or "(none)"
                pool = pools.setdefault(role, {
                    "replicas_running": 0, "replicas_target": 0,
                    "deployments": [],
                })
                pool[field] = pool.get(field, 0) + int(v)
                dep = f"{tags.get('app', '')}/{tags.get('deployment', '')}"
                if dep != "/" and dep not in pool["deployments"]:
                    pool["deployments"].append(dep)
        return pools

    def utilization(self, agg: Optional[dict] = None) -> dict:
        """The fleet utilization summary `ray_tpu status` prints."""
        if agg is None:
            agg = self.cluster_metrics()

        def gauge_total(name):
            acc = agg["gauges"].get(_fq(name))
            return acc["value"] if acc else None

        def counter_rate(name):
            acc = agg["counters"].get(_fq(name))
            if not acc:
                return None
            return round(sum(acc["rate_per_s"].values()), 3)

        out = {
            "kv_pages_used": gauge_total("llm_kv_pages_used"),
            "kv_pages_total": gauge_total("llm_kv_pages_total"),
            "kv_hbm_bytes": gauge_total("llm_kv_hbm_bytes"),
            "queue_depth": gauge_total("llm_queue_depth"),
            "running_requests": gauge_total("llm_running_requests"),
            "kv_transfer_bytes_per_s": counter_rate("llm_kv_transfer_bytes_total"),
            "spec_acceptance_rate": gauge_total("llm_spec_acceptance_rate"),
        }
        used, total = out["kv_pages_used"], out["kv_pages_total"]
        out["kv_page_occupancy"] = (
            round(used / total, 4) if used is not None and total else None
        )
        return out

    def prometheus_text(self) -> str:
        """Merged cluster-level Prometheus exposition (the fleet analog of
        each process's /metrics): one series per (metric, labels), summed/
        maxed/merged across reporters, plus the staleness gauge."""
        from ray_tpu_torch.util.metrics import _escape_label_value

        agg = self.cluster_metrics()
        lines: list[str] = []

        def fmt_key(skey: str, extra: str = "") -> str:
            parts = [
                f'{k}="{_escape_label_value(v)}"'
                for k, v in self._parse_tags_key(skey).items()
            ]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        for name in sorted(agg["counters"]):
            acc = agg["counters"][name]
            lines.append(f"# HELP {name} {acc['description']}")
            lines.append(f"# TYPE {name} counter")
            for skey, v in sorted(acc["series"].items()):
                lines.append(f"{name}{fmt_key(skey)} {v}")
        for name in sorted(agg["gauges"]):
            acc = agg["gauges"][name]
            lines.append(f"# HELP {name} {acc['description']}")
            lines.append(f"# TYPE {name} gauge")
            for skey, v in sorted(acc["series"].items()):
                lines.append(f"{name}{fmt_key(skey)} {v}")
        for name in sorted(agg["histograms"]):
            acc = agg["histograms"][name]
            lines.append(f"# HELP {name} {acc['description']}")
            lines.append(f"# TYPE {name} histogram")
            for skey, merged in sorted(acc["series"].items()):
                cum = 0
                for b, n in zip(merged["boundaries"], merged["buckets"]):
                    cum += n
                    le = 'le="%s"' % b
                    lines.append(f"{name}_bucket{fmt_key(skey, le)} {cum}")
                if len(merged["buckets"]) > len(merged["boundaries"]):
                    cum += merged["buckets"][-1]
                le_inf = 'le="+Inf"'
                lines.append(f"{name}_bucket{fmt_key(skey, le_inf)} {cum}")
                lines.append(f"{name}_sum{fmt_key(skey)} {merged['sum']}")
                lines.append(f"{name}_count{fmt_key(skey)} {merged['count']}")
        stale = agg["staleness"]
        sname = _fq("telemetry_staleness_seconds")
        lines.append(
            f"# HELP {sname} seconds since each reporter's last accepted "
            "telemetry push"
        )
        lines.append(f"# TYPE {sname} gauge")
        for rid, s in sorted(stale.items()):
            lines.append(
                f'{sname}{{reporter="{_escape_label_value(rid)}"}} {s}'
            )
        return "\n".join(lines) + "\n"

    def trainer_health(self, agg: Optional[dict] = None) -> dict:
        """Elastic-trainer rollup for `ray_tpu status`: the
        fleet's current gang epoch (max over reporters — every recovery
        bumps it), completed recoveries and ranks lost (sums). All None
        when no trainer is reporting."""
        if agg is None:
            agg = self.cluster_metrics()

        def gauge(name):
            acc = agg["gauges"].get(_fq(name))
            return acc["value"] if acc else None

        def counter(name):
            acc = agg["counters"].get(_fq(name))
            return acc["total"] if acc else None

        return {
            "gang_epoch": gauge("train_gang_epoch"),
            "recoveries_total": counter("train_recoveries_total"),
            "ranks_lost_total": counter("train_ranks_lost_total"),
        }

    def fabric_health(self, agg: Optional[dict] = None) -> dict:
        """Transfer-fabric rollup for `ray_tpu status`: active
        edges per transport backend (summed over orchestrators),
        device→rpc fallbacks burned, and the KV-byte mix per backend
        (from the backend-labelled transfer counter). All None/empty
        when no fabric is reporting."""
        if agg is None:
            agg = self.cluster_metrics()
        edges: dict[str, int] = {}
        acc = agg["gauges"].get(_fq("fabric_edges_active"))
        if acc:
            for skey, v in acc["series"].items():
                backend = self._parse_tags_key(skey).get("backend", "")
                edges[backend] = edges.get(backend, 0) + int(v)
        fallbacks = None
        acc = agg["counters"].get(_fq("fabric_transfer_fallbacks_total"))
        if acc:
            fallbacks = int(acc["total"])
        bytes_by_backend: dict[str, float] = {}
        acc = agg["counters"].get(_fq("llm_kv_transfer_bytes_total"))
        if acc:
            for skey, v in acc["series"].items():
                backend = self._parse_tags_key(skey).get("backend", "")
                bytes_by_backend[backend] = (
                    bytes_by_backend.get(backend, 0.0) + float(v)
                )
        return {
            "edges_by_backend": edges,
            "fallbacks_total": fallbacks,
            "kv_bytes_by_backend": bytes_by_backend,
        }

    def kvtier_health(self, agg: Optional[dict] = None) -> dict:
        """Tiered-KV-cache rollup for `ray_tpu status`: resident
        spilled bytes per deep tier (gauge sum over engines), cumulative
        spilled bytes per destination tier, prefix-cache hit tokens per
        serving tier (the tier-labelled hit counter), resurrected
        tokens, and corrupt drops. All empty when no tiered cache is
        reporting."""
        if agg is None:
            agg = self.cluster_metrics()

        def by_tier(table: str, name: str) -> dict:
            out: dict[str, float] = {}
            acc = agg[table].get(_fq(name))
            if acc:
                for skey, v in acc["series"].items():
                    tier = self._parse_tags_key(skey).get("tier", "")
                    out[tier] = out.get(tier, 0.0) + float(v)
            return out

        corrupt = agg["counters"].get(_fq("llm_kvtier_corrupt_dropped_total"))
        # llm/kvfetch: prefetch phase totals, cross-engine fetch
        # bytes per backend, and the async-spill backlog gauge
        prefetch = {}
        for phase in ("started", "completed", "wasted"):
            acc = agg["counters"].get(
                _fq(f"llm_kvtier_prefetch_{phase}_total"))
            prefetch[phase] = int(acc["total"]) if acc else 0
        fetch_by_backend: dict[str, float] = {}
        acc = agg["counters"].get(_fq("llm_kvtier_fetch_bytes_total"))
        if acc:
            for skey, v in acc["series"].items():
                backend = self._parse_tags_key(skey).get("backend", "")
                fetch_by_backend[backend] = (
                    fetch_by_backend.get(backend, 0.0) + float(v)
                )
        spillq = agg["gauges"].get(_fq("llm_kvtier_spill_queue_depth"))
        return {
            "resident_bytes_by_tier": by_tier(
                "gauges", "llm_kvtier_resident_bytes"),
            "spilled_bytes_by_tier": by_tier(
                "counters", "llm_kvtier_spilled_bytes_total"),
            "hit_tokens_by_tier": by_tier(
                "counters", "llm_prefix_cache_hit_tokens_total"),
            "resurrected_tokens_by_tier": by_tier(
                "counters", "llm_kvtier_resurrected_tokens_total"),
            "corrupt_dropped_total": (
                int(corrupt["total"]) if corrupt else None
            ),
            "prefetch": prefetch,
            "fetch_bytes_by_backend": fetch_by_backend,
            "spill_queue_depth": (
                int(spillq["value"])
                if spillq and spillq.get("value") is not None else None
            ),
        }

    def rl_post_health(self, agg: Optional[dict] = None) -> dict:
        """RL post-training rollup for `ray_tpu status`: weight
        version per tier (MAX over reporters — learner = last published,
        rollout = applied by serving engines; the difference IS the
        actor/learner skew), trajectory lag (queued between the tiers),
        overflow/staleness drops, publishes, rollout preemptions ridden
        out, and the worst staleness ever trained on (the audit surface
        for the max_staleness contract). All None/empty when no
        post-training loop is reporting."""
        if agg is None:
            agg = self.cluster_metrics()
        versions: dict[str, float] = {}
        acc = agg["gauges"].get(_fq("ray_tpu_rl_post_weight_version"))
        if acc:
            for skey, v in acc["series"].items():
                tier = self._parse_tags_key(skey).get("tier", "")
                # learner: the newest successful publish (max). rollout:
                # the WORST engine (min over per-actor series) — the
                # skew line must surface a laggard serving stale
                # weights, not let a healthy peer mask it
                if tier == "rollout" and tier in versions:
                    versions[tier] = min(versions[tier], float(v))
                else:
                    versions[tier] = max(versions.get(tier, 0.0), float(v))

        def counter(name):
            c = agg["counters"].get(_fq(name))
            return int(c["total"]) if c else None

        def gauge(name):
            g = agg["gauges"].get(_fq(name))
            return g["value"] if g else None

        return {
            "version_by_tier": versions,
            "queue_depth": gauge("ray_tpu_rl_post_trajectory_queue_depth"),
            "queue_bytes": gauge("ray_tpu_rl_post_trajectory_queue_bytes"),
            "generated_total": counter(
                "ray_tpu_rl_post_trajectories_generated_total"),
            "trained_total": counter(
                "ray_tpu_rl_post_trajectories_trained_total"),
            "dropped_total": counter(
                "ray_tpu_rl_post_trajectories_dropped_total"),
            "stale_dropped_total": counter(
                "ray_tpu_rl_post_trajectories_stale_total"),
            "publishes_total": counter("ray_tpu_rl_post_publishes_total"),
            "rollout_preemptions_total": counter(
                "ray_tpu_rl_post_rollout_preemptions_total"),
            "max_trained_staleness": gauge(
                "ray_tpu_rl_post_max_trained_staleness"),
        }

    def prefill_span_summary(self, agg: Optional[dict] = None) -> dict:
        """The measured prefill-span distribution + arrival rate the
        autoscaler sizes the prefill pool from. Mean comes from the
        merged histogram sum/count; the arrival rate is the per-second
        rate of the same histogram's cumulative count rings (every
        request that produced a first token counts exactly once)."""
        if agg is None:
            agg = self.cluster_metrics()
        name = _fq("llm_prefill_span_seconds")
        now_w = time.time()
        rate = 0.0
        with self._lock:
            for (_rid, nm, _tags), st in self._series.items():
                if nm == name:
                    rate += self._rate(st["ring"], now_w)
        count, total = 0, 0.0
        p95 = None
        acc = agg["histograms"].get(name)
        if acc:
            for merged in acc["series"].values():
                count += int(merged.get("count", 0))
                total += float(merged.get("sum", 0.0))
                p = merged.get("p95")
                if p is not None:
                    p95 = max(p95, p) if p95 is not None else p
        return {
            "count": count,
            "mean_s": round(total / count, 6) if count else None,
            "p95_s": p95,
            "arrival_rate_per_s": round(rate, 6),
        }

    def autoscale_signals(
        self, thresholds: Optional[SLOThresholds] = None
    ) -> dict:
        """Everything the PoolAutoscaler consumes, from ONE aggregation
        pass: per-tag grades + autoscaler_hints, pool rollups, queue
        depth, the prefill-span distribution, per-reporter staleness.
        Pending lease demand is GCS-side state and is layered on by
        ``gcs_service.rpc_autoscale_signals``."""
        agg = self.cluster_metrics()
        return {
            "ts_wall": agg["ts_wall"],
            "staleness": agg["staleness"],
            "slo": self.slo_report(thresholds, agg),
            "pools": self.pool_rollups(agg),
            "utilization": self.utilization(agg),
            "prefill_span": self.prefill_span_summary(agg),
        }

    def autoscale_health(self, agg: Optional[dict] = None) -> dict:
        """Controller health for `ray_tpu status`: decision mix, scale
        events, cold-start timings, current pool targets, and whether
        the controller is holding on a dark GCS. All None/empty when no
        controller is reporting."""
        if agg is None:
            agg = self.cluster_metrics()

        def counter_total(name):
            c = agg["counters"].get(_fq(name))
            return int(c["total"]) if c else None

        by_action: dict = {}
        acc = agg["counters"].get(_fq("ray_tpu_autoscale_decisions_total"))
        if acc:
            for skey, v in acc["series"].items():
                action = self._parse_tags_key(skey).get("action", "")
                by_action[action] = by_action.get(action, 0) + int(v)
        targets: dict = {}
        g = agg["gauges"].get(_fq("ray_tpu_autoscale_pool_target"))
        if g:
            for skey, v in g["series"].items():
                pool = self._parse_tags_key(skey).get("pool", "")
                targets[pool] = targets.get(pool, 0) + int(v)
        cold = {"count": 0, "p50_s": None, "p95_s": None}
        h = agg["histograms"].get(_fq("ray_tpu_autoscale_cold_start_seconds"))
        if h:
            for merged in h["series"].values():
                cold["count"] += int(merged.get("count", 0))
                for q in ("p50", "p95"):
                    p = merged.get(q)
                    if p is not None:
                        key = f"{q}_s"
                        cold[key] = (
                            max(cold[key], p) if cold[key] is not None else p
                        )
        dark = agg["gauges"].get(_fq("ray_tpu_autoscale_gcs_dark"))
        return {
            "decisions_total": counter_total("ray_tpu_autoscale_decisions_total"),
            "decisions_by_action": by_action,
            "scale_ups_total": counter_total("ray_tpu_autoscale_scale_ups_total"),
            "scale_downs_total": counter_total(
                "ray_tpu_autoscale_scale_downs_total"),
            "holds_total": counter_total("ray_tpu_autoscale_holds_total"),
            "pool_targets": targets,
            "cold_starts": cold,
            "gcs_dark": dark["value"] if dark else None,
        }

    def fleet_health(self, agg: Optional[dict] = None) -> dict:
        """Multi-tenant fleet rollup for `ray_tpu status`: per-
        tenant request and shed counts (whether QoS isolation is pricing
        the right tenant), adapter slot churn (loads/evictions +
        residency per base model), canary rollout outcomes, and the
        preemption mix by reason (a paying tenant's priority preemptions
        show up here, not buried in engine pressure preemptions). All
        None/empty when no fleet is reporting."""
        if agg is None:
            agg = self.cluster_metrics()

        def counter_total(name):
            c = agg["counters"].get(_fq(name))
            return int(c["total"]) if c else None

        def by_tag(name, tag_name):
            acc = agg["counters"].get(_fq(name))
            out: dict = {}
            if acc:
                for skey, v in acc["series"].items():
                    key = self._parse_tags_key(skey).get(tag_name, "")
                    out[key] = out.get(key, 0) + int(v)
            return out

        resident: dict = {}
        g = agg["gauges"].get(_fq("ray_tpu_fleet_resident_adapters"))
        if g:
            for skey, v in g["series"].items():
                model = self._parse_tags_key(skey).get("model", "")
                resident[model] = resident.get(model, 0) + int(v)
        return {
            "tenant_requests": by_tag(
                "ray_tpu_fleet_tenant_requests_total", "tenant"),
            "rejections_by_tenant": {
                t: n for t, n in by_tag(
                    "ray_tpu_llm_admission_rejected_total", "tenant"
                ).items() if t
            },
            "adapter_loads_total": counter_total(
                "ray_tpu_fleet_adapter_loads_total"),
            "adapter_evictions_total": counter_total(
                "ray_tpu_fleet_adapter_evictions_total"),
            "resident_adapters_by_model": resident,
            "canary_by_outcome": by_tag(
                "ray_tpu_fleet_canary_rollouts_total", "outcome"),
            "preemptions_by_reason": by_tag(
                "ray_tpu_llm_preemptions_total", "reason"),
        }

    # regression-ratio grade ladder (latest/best sampled step time):
    # ≤ 1.25 green, ≤ 2.5 yellow, beyond red — mirrors the SLO grader's
    # threshold/yellow_factor shape
    PERF_REGRESSION_GREEN = 1.25
    PERF_REGRESSION_YELLOW_FACTOR = 2.0

    def perf_health(self, agg: Optional[dict] = None) -> dict:
        """Sampled-profiling rollup for `ray_tpu status`: per-step
        latest step time, coverage, MFU, all-reduce overlap, and the
        regression ratio vs the best-seen sample — graded GREEN/YELLOW/
        RED so a slowly-regressing step is a status-line fact, not a
        future bench surprise. Includes the sampler's own duty receipt.
        All None/empty when no sampler is reporting."""
        if agg is None:
            agg = self.cluster_metrics()

        def gauge_by_step(name):
            g = agg["gauges"].get(_fq(name))
            out: dict = {}
            if g:
                for skey, v in g["series"].items():
                    step = self._parse_tags_key(skey).get("step", "")
                    out[step] = max(out[step], v) if step in out else v
            return out

        step_ms = gauge_by_step("ray_tpu_perf_step_ms")
        coverage = gauge_by_step("ray_tpu_perf_coverage_pct")
        mfu = gauge_by_step("ray_tpu_perf_mfu_pct")
        overlap = gauge_by_step("ray_tpu_perf_overlap_ratio")
        ratio = gauge_by_step("ray_tpu_perf_step_regression_ratio")
        samples: dict = {}
        c = agg["counters"].get(_fq("ray_tpu_perf_samples_total"))
        if c:
            for skey, v in c["series"].items():
                step = self._parse_tags_key(skey).get("step", "")
                samples[step] = samples.get(step, 0) + int(v)
        # worst-segment pointer per step from the merged histograms:
        # where is the sampled time actually going?
        top_segment: dict = {}
        h = agg["histograms"].get(_fq("ray_tpu_perf_segment_ms"))
        if h:
            for skey, merged in h["series"].items():
                tags = self._parse_tags_key(skey)
                step, seg = tags.get("step", ""), tags.get("segment", "")
                p95 = merged.get("p95")
                if p95 is None:
                    continue
                cur = top_segment.get(step)
                if cur is None or p95 > cur[1]:
                    top_segment[step] = (seg, p95)
        duty = agg["gauges"].get(_fq("ray_tpu_perf_sampler_duty_pct"))
        steps: dict = {}
        for step in sorted(set(step_ms) | set(ratio)):
            steps[step] = {
                "step_ms": step_ms.get(step),
                "coverage_pct": coverage.get(step),
                "mfu_pct": mfu.get(step),
                "overlap_ratio": overlap.get(step),
                "regression_ratio": ratio.get(step),
                "samples": samples.get(step, 0),
                "top_segment": top_segment.get(step),
                "grade": grade_value(
                    ratio.get(step),
                    self.PERF_REGRESSION_GREEN,
                    self.PERF_REGRESSION_YELLOW_FACTOR,
                ),
            }
        return {
            "steps": steps,
            "sampler_duty_pct": duty["value"] if duty else None,
        }

    def status_payload(self, thresholds: Optional[SLOThresholds] = None) -> dict:
        """Everything `ray_tpu status` needs beyond the node table — the
        GCS assembles this so the CLI is ONE RPC. The full aggregation
        pass (every series, under the lock) runs ONCE and feeds all
        eight views."""
        agg = self.cluster_metrics()
        return {
            "reporters": agg["reporters"],
            "staleness": agg["staleness"],
            "pools": self.pool_rollups(agg),
            "utilization": self.utilization(agg),
            "slo": self.slo_report(thresholds, agg),
            "trainer": self.trainer_health(agg),
            "fabric": self.fabric_health(agg),
            "kvtier": self.kvtier_health(agg),
            "rl_post": self.rl_post_health(agg),
            "autoscale": self.autoscale_health(agg),
            "fleet": self.fleet_health(agg),
            "perf": self.perf_health(agg),
        }


# -- `ray_tpu status` rendering ----------------------------------------------


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TB"


def _fmt_s(v) -> str:
    return "-" if v is None else f"{float(v) * 1e3:.1f}ms"


def format_status(report: dict) -> str:
    """Human-readable cluster status (the `ray_tpu status` output): nodes,
    pools, utilization, SLO grades — all from one GCS query."""
    lines: list[str] = []
    nodes = report.get("nodes", [])
    reporters = report.get("reporters", {})
    staleness = report.get("staleness", {})
    alive = [n for n in nodes if n.get("alive")]
    vals = [v for v in staleness.values() if v is not None]
    stale_max = max(vals) if vals else None
    lines.append(
        f"== nodes ({len(alive)}/{len(nodes)} alive, "
        f"{len(reporters)} reporters, "
        f"staleness max {stale_max if stale_max is not None else '-'}s) =="
    )
    for n in nodes:
        avail = n.get("available", {})
        total = n.get("resources", {})
        res = " ".join(
            f"{k}={avail.get(k, 0):g}/{total.get(k, 0):g}" for k in sorted(total)
        )
        state = "alive" if n.get("alive") else "DEAD"
        if n.get("draining"):
            state += ",draining"
        st = staleness.get(n.get("node_id"))
        lines.append(
            f"  {n.get('node_id', '?'):<16} {state:<14} {res}"
            + (f"  staleness={st}s" if st is not None else "  [no telemetry]")
        )
    pools = report.get("pools", {})
    lines.append("== pools ==")
    if pools:
        for role in sorted(pools):
            p = pools[role]
            lines.append(
                f"  role={role:<10} replicas "
                f"{p.get('replicas_running', 0)}/{p.get('replicas_target', 0)}"
                f"  deployments: {', '.join(p.get('deployments', [])) or '-'}"
            )
    else:
        lines.append("  (no serve pools reporting)")
    ft = report.get("gcs_ft") or {}
    ha = report.get("gcs_ha") or {}
    if ft.get("gcs_restarts_total") or ha:
        # the blackout must SHOW here: a restarted control plane renders
        # as a counted restart + reconcile deltas, not phantom-zero rows;
        # an HA pair renders its role/term/replication posture the same
        # way (a promoted standby is a counted failover, not a mystery)
        lines.append("== control plane ==")
        if ha:
            lag = ha.get("replication_lag_s")
            lines.append(
                f"  role {ha.get('role', '?')}  term {ha.get('term', 0)}"
                f"  replication lag "
                f"{f'{lag:.3f}s' if lag is not None else '-'}"
                f"  failovers {ha.get('failovers_total', 0)}"
                + (f"  fenced writes {ha['fenced_writes_total']}"
                   if ha.get("fenced_writes_total") else "")
                + ("  [FENCED]" if ha.get("fenced") else "")
            )
        if ft.get("gcs_restarts_total"):
            lines.append(
                f"  gcs restarts {ft['gcs_restarts_total']}"
                f"  reconcile: {ft.get('reconcile_nodes_reregistered', 0)} nodes"
                f", actors +{ft.get('reconcile_actors_confirmed', 0)} confirmed"
                f" +{ft.get('reconcile_actors_resurrected', 0)} resurrected"
                f" -{ft.get('reconcile_actors_lost', 0)} lost"
                f", bundles {ft.get('reconcile_bundles_adopted', 0)} adopted"
                f"/{ft.get('reconcile_bundles_orphaned', 0)} released"
                + (f"  [{ft['actors_pending_confirm']} awaiting confirm]"
                   if ft.get("actors_pending_confirm") else "")
            )
    trainer = report.get("trainer") or {}
    if any(v is not None for v in trainer.values()):
        ge = trainer.get("gang_epoch")
        rec = trainer.get("recoveries_total")
        lost = trainer.get("ranks_lost_total")
        lines.append("== trainer ==")
        lines.append(
            f"  gang epoch {int(ge) if ge is not None else '-'}"
            f"  recoveries {int(rec) if rec is not None else 0}"
            f"  ranks lost {int(lost) if lost is not None else 0}"
        )
    fabric = report.get("fabric") or {}
    if fabric.get("edges_by_backend"):
        # the transfer fabric must SHOW here: which edges ride the chip
        # interconnect vs the wire, and how many device edges have been
        # burned down to their RPC fallback
        eb = fabric["edges_by_backend"]
        total_edges = sum(eb.values())
        mix = " ".join(f"{b}={n}" for b, n in sorted(eb.items()) if n)
        lines.append("== fabric ==")
        line = f"  edges {total_edges} ({mix})"
        fb = fabric.get("fallbacks_total")
        line += f"  fallbacks {int(fb) if fb is not None else 0}"
        lines.append(line)
        bb = fabric.get("kv_bytes_by_backend") or {}
        if bb:
            lines.append(
                "  kv bytes " + " ".join(
                    f"{b}={_fmt_bytes(n)}" for b, n in sorted(bb.items()) if n
                )
            )
    kvt = report.get("kvtier") or {}
    if (kvt.get("resident_bytes_by_tier") or kvt.get("spilled_bytes_by_tier")
            or kvt.get("hit_tokens_by_tier")):
        # the tier ladder must SHOW here: how much spilled prefix cache
        # each deep tier holds, which tier is actually serving hits, and
        # whether any spilled copy ever failed its seal
        lines.append("== kv tiers ==")
        res = kvt.get("resident_bytes_by_tier") or {}
        lines.append(
            "  resident "
            + (" ".join(f"{t}={_fmt_bytes(n)}" for t, n in sorted(res.items()))
               or "-")
            + "  spilled "
            + (" ".join(
                f"{t}={_fmt_bytes(n)}"
                for t, n in sorted((kvt.get("spilled_bytes_by_tier")
                                    or {}).items()) if n) or "-")
        )
        hits = kvt.get("hit_tokens_by_tier") or {}
        if hits:
            line = "  hit tokens " + " ".join(
                f"{t}={int(n)}" for t, n in sorted(hits.items()) if n
            )
            cd = kvt.get("corrupt_dropped_total")
            if cd:
                line += f"  corrupt dropped {int(cd)}"
            lines.append(line)
        pf = kvt.get("prefetch") or {}
        fb = kvt.get("fetch_bytes_by_backend") or {}
        sq = kvt.get("spill_queue_depth")
        if pf.get("started") or fb or sq:
            # the prefetch rungs must SHOW too: how far ahead of admission
            # prefetch runs, what crosses engines, what's still queued
            # for the async spill gather
            line = (
                f"  prefetch {int(pf.get('started', 0))} started"
                f" / {int(pf.get('completed', 0))} completed"
                f" / {int(pf.get('wasted', 0))} wasted"
            )
            if fb:
                line += "  fetched " + " ".join(
                    f"{b}={_fmt_bytes(n)}" for b, n in sorted(fb.items()) if n
                )
            if sq:
                line += f"  spill queue {int(sq)}"
            lines.append(line)
        idx = report.get("kvtier_index") or {}
        if idx.get("rows"):
            lines.append(
                f"  index {idx['rows']} rows / {idx['engines']} engines "
                f"({' '.join(f'{t}={n}' for t, n in sorted((idx.get('rows_by_tier') or {}).items()))})"
            )
    rp = report.get("rl_post") or {}
    if rp.get("version_by_tier") or rp.get("generated_total"):
        # actor/learner skew must SHOW here: which version each tier is
        # on, how many trajectories sit between them, and whether the
        # staleness contract dropped anything — from ONE RPC
        lines.append("== rl post-train ==")
        vb = rp.get("version_by_tier") or {}
        lv = vb.get("learner")
        rv = vb.get("rollout")
        skew = (
            int(lv - rv) if lv is not None and rv is not None else None
        )
        lines.append(
            "  weight version "
            + " ".join(f"{t}={int(v)}" for t, v in sorted(vb.items()))
            + (f"  skew {skew}" if skew is not None else "")
        )
        qd = rp.get("queue_depth")
        line = (
            f"  trajectories {int(rp.get('generated_total') or 0)} generated"
            f" / {int(rp.get('trained_total') or 0)} trained"
            f"  queue {int(qd) if qd is not None else '-'}"
        )
        if rp.get("queue_bytes"):
            line += f" ({_fmt_bytes(rp['queue_bytes'])})"
        dropped = rp.get("dropped_total") or 0
        stale = rp.get("stale_dropped_total") or 0
        if dropped or stale:
            line += f"  dropped {int(dropped)}  stale {int(stale)}"
        mts = rp.get("max_trained_staleness")
        if mts is not None:
            line += f"  max trained staleness {int(mts)}"
        lines.append(line)
        pub = rp.get("publishes_total")
        pre = rp.get("rollout_preemptions_total")
        if pub or pre:
            lines.append(
                f"  publishes {int(pub or 0)}"
                f"  rollout preemptions {int(pre or 0)}"
            )
    fl = report.get("fleet") or {}
    if fl.get("tenant_requests") or fl.get("adapter_loads_total"):
        # tenant isolation must SHOW here: who is actually being served,
        # who is being shed, who is being preempted for whom — plus the
        # adapter slot churn and canary rollout scoreboard
        lines.append("== fleet ==")
        tr = fl.get("tenant_requests") or {}
        rj = fl.get("rejections_by_tenant") or {}
        lines.append(
            "  tenants "
            + (" ".join(
                f"{t}={int(n)}"
                + (f"(-{int(rj[t])})" if rj.get(t) else "")
                for t, n in sorted(tr.items())
            ) or "-")
        )
        line = (
            f"  adapters loaded {int(fl.get('adapter_loads_total') or 0)}"
            f" / evicted {int(fl.get('adapter_evictions_total') or 0)}"
        )
        res = fl.get("resident_adapters_by_model") or {}
        if res:
            line += "  resident " + " ".join(
                f"{m}={int(n)}" for m, n in sorted(res.items())
            )
        lines.append(line)
        can = fl.get("canary_by_outcome") or {}
        pre = fl.get("preemptions_by_reason") or {}
        if can or pre:
            line = "  canary " + (
                " ".join(f"{o}={int(n)}" for o, n in sorted(can.items())
                         if n) or "-"
            )
            if pre:
                line += "  preemptions " + " ".join(
                    f"{r}={int(n)}" for r, n in sorted(pre.items()) if n
                )
            lines.append(line)
    asc = report.get("autoscale") or {}
    if asc.get("decisions_total"):
        lines.append("== autoscaler ==")
        by = asc.get("decisions_by_action") or {}
        lines.append(
            f"  decisions {int(asc['decisions_total'])}"
            f"  up {int(asc.get('scale_ups_total') or 0)}"
            f"  down {int(asc.get('scale_downs_total') or 0)}"
            f"  hold {int(asc.get('holds_total') or 0)}"
            + (
                "  (" + " ".join(
                    f"{a}={n}" for a, n in sorted(by.items()) if n
                ) + ")" if by else ""
            )
        )
        line = "  targets " + (
            " ".join(
                f"{p}={n}" for p, n in sorted(
                    (asc.get("pool_targets") or {}).items())
            ) or "-"
        )
        cold = asc.get("cold_starts") or {}
        if cold.get("count"):
            line += (
                f"  cold starts {int(cold['count'])}"
                f" (p50 {_fmt_s(cold.get('p50_s'))},"
                f" p95 {_fmt_s(cold.get('p95_s'))})"
            )
        dark = asc.get("gcs_dark")
        if dark:
            line += "  GCS DARK (holding)"
        lines.append(line)
    perf = report.get("perf") or {}
    if perf.get("steps"):
        # the sampled-profiling plane must SHOW here: per-step time,
        # regression grade vs best-seen, where the time goes, and the
        # sampler's own overhead receipt
        duty = perf.get("sampler_duty_pct")
        lines.append(
            "== perf (sampled) =="
            + (f"  duty {duty:.2f}%" if duty is not None else "")
        )
        for step in sorted(perf["steps"]):
            e = perf["steps"][step]
            sm = e.get("step_ms")
            cov = e.get("coverage_pct")
            mfu = e.get("mfu_pct")
            ov = e.get("overlap_ratio")
            rr = e.get("regression_ratio")
            top = e.get("top_segment")
            line = (
                f"  {step:<14} {e['grade'].upper():<7} "
                f"{sm:.2f}ms" if sm is not None
                else f"  {step:<14} {e['grade'].upper():<7} -"
            )
            if rr is not None:
                line += f" ({rr:.2f}x best)"
            if cov is not None:
                line += f"  coverage {cov:.1f}%"
            if mfu is not None:
                line += f"  mfu {mfu:.1f}%"
            if ov is not None:
                line += f"  overlap {ov:.2f}"
            if top:
                line += f"  top {top[0]}={top[1]:g}ms"
            line += f"  (n={e.get('samples', 0)})"
            lines.append(line)
    u = report.get("utilization", {})
    occ = u.get("kv_page_occupancy")
    lines.append("== utilization ==")
    lines.append(
        f"  kv pages {u.get('kv_pages_used', '-')}/{u.get('kv_pages_total', '-')}"
        + (f" ({occ * 100:.1f}%)" if occ is not None else "")
        + f"  hbm {_fmt_bytes(u.get('kv_hbm_bytes'))}"
        + f"  queue depth {u.get('queue_depth', '-')}"
        + f"  running {u.get('running_requests', '-')}"
    )
    rate = u.get("kv_transfer_bytes_per_s")
    accept = u.get("spec_acceptance_rate")
    lines.append(
        f"  kv transfer {_fmt_bytes(rate)}/s"
        + (f"  spec acceptance {accept:.2f}" if accept is not None else "")
    )
    slo = report.get("slo", {})
    th = slo.get("thresholds", {})
    pct = th.get("percentile", 95.0)
    lines.append(f"== SLO (p{pct:g} vs thresholds) ==")
    tags = slo.get("model_tags", {})
    if tags:
        for tag in sorted(tags):
            e = tags[tag]
            pk = f"p{pct:g}"
            lines.append(
                f"  {tag:<24} {e['grade'].upper():<7} "
                f"ttft {_fmt_s(e['ttft'].get(pk))} "
                f"tpot {_fmt_s(e['tpot'].get(pk))} "
                f"queue {_fmt_s(e['queue_wait'].get(pk))} "
                f"(n={e['ttft'].get('count', 0)})"
            )
    else:
        lines.append("  (no SLO histograms reporting)")
    return "\n".join(lines)
