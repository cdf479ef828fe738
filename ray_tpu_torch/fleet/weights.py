"""FleetWeightPlane: versioned weight distribution and the canary ladder
(counterpart of ``ray_tpu/fleet/weights.py``).

Generalizes the learner -> rollout publish plane (``train/weight_sync``)
from one params stream to the fleet's {base model x adapter} matrix:

 * **per-(model, adapter) version vectors**: every base model keeps its
   own ``WeightPublisher`` (monotonic versions, checksum-verified device
   bundles, ``publish_latest`` for late joiners); adapter payloads ride the
   same transport as ``{target.A, target.B}`` bundles to a per-replica
   adapter endpoint, so base and adapter updates share one verification
   and versioning discipline;
 * **canary-one-replica rollout**: ``begin_canary`` applies a new version
   to exactly ONE replica (replica tags are replica-scoped, so the SLO
   grading sees the canary alone); ``canary_grade`` grades only traffic
   observed SINCE the canary began (a delta against a histogram
   snapshot); ``promote`` ships the same tree to the rest of the pool,
   ``rollback`` re-publishes the retained previous weights as a NEW
   monotonic version (subscribers never apply backwards);
 * **bitwise identity gates**: promote checks that every replica's
   weights equal the canary's bit for bit, rollback that the canary's
   equal the retained previous weights, a checksum-green transfer that
   left divergent weights is a refused rollout;
 * **scoped invalidation**: a base swap drops every salt's prefix chains,
   an adapter swap exactly the swapped adapter's salt.

Where the port differs from the reference:

 * Weights are written into each engine's own tensors in place
   (``LLMEngine.write_params``), on the replica's loop thread between two
   steps (``runner.call``; the port's runner has no lock).
 * The gates compare the engine's bytes with the expected leaves cast to
   the engine's dtype (the engine holds the compute dtype; in fp32 the
   cast is the identity), and refuse two trees that share a storage: with
   in-place writes, an alias would make any equality trivially true.
 * The canary's previous base weights, when no publish is retained yet,
   are a snapshot taken before the apply (the engine's own tensors are
   overwritten by it). On the card it costs one more copy of the weights.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.fabric.transport import DeviceTransport, FabricTransferError
from ray_tpu_torch.fleet import metrics as fleet_metrics
from ray_tpu_torch.fleet.config import CanaryStateError, FleetError
from ray_tpu_torch.obs import slo as slo_metrics
from ray_tpu_torch.obs.telemetry import (
    GRADE_GREEN,
    GRADE_RED,
    SLO_HISTOGRAMS,
    SLOThresholds,
    evaluate_slo,
)
from ray_tpu_torch.train.weight_sync import (
    WeightPublisher,
    WeightSubscriber,
    WeightSyncError,
    params_bitwise_equal,
    snapshot,
    tree_leaves,
)

logger = logging.getLogger("ray_tpu_torch.fleet.weights")

_SLO_SOURCES = {
    "ttft": slo_metrics.ttft_histogram,
    "tpot": slo_metrics.tpot_histogram,
    "queue_wait": slo_metrics.queue_wait_histogram,
}


def _slo_snapshot() -> dict:
    """Process-local SLO histograms in ``evaluate_slo``'s input shape:
    {registry_name: {tag: {"boundaries","buckets","sum","count"}}}."""
    out: dict = {}
    for short, fq in SLO_HISTOGRAMS.items():
        h = _SLO_SOURCES[short]()
        per: dict = {}
        for key, (buckets, total, count) in h.hist_data().items():
            tag = key[0] if key else ""
            per[tag] = {
                "boundaries": list(h.boundaries),
                "buckets": list(buckets),
                "sum": float(total),
                "count": int(count),
            }
        out[fq] = per
    return out


def local_slo_histograms(baseline: Optional[dict] = None) -> dict:
    """Current process-local SLO histograms, optionally as the DELTA since
    ``baseline`` (an earlier ``local_slo_histograms()`` result). Histograms
    are cumulative, so grading a canary means grading the difference:
    pre-canary traffic must not vote."""
    snap = _slo_snapshot()
    if baseline is None:
        return snap
    for name, per in snap.items():
        base_per = baseline.get(name) or {}
        for tag, h in per.items():
            b = base_per.get(tag)
            if b is None:
                continue
            h["buckets"] = [max(0, n - m) for n, m in zip(h["buckets"], b["buckets"])]
            h["sum"] = max(0.0, h["sum"] - b["sum"])
            h["count"] = max(0, h["count"] - b["count"])
    return snap


def _resident_adapter(engine: Any, adapter_id: str, targets) -> Optional[dict]:
    """The adapter tensors a replica is actually serving (its slot slices of
    the stacked LoRA buffers), or None when not resident."""
    slot = engine._lora_slots.get(adapter_id)
    if slot is None:
        return None
    return {t: (engine._lora[f"{t}_A"][:, slot], engine._lora[f"{t}_B"][:, slot])
            for t in targets}


def bitwise_equal(a: Any, b: Any) -> bool:
    """Bit-for-bit identity of two trees, the promotion gate: ``a`` is what
    an engine serves, ``b`` what it should serve, cast to ``a``'s dtype
    (``params_bitwise_equal`` with the served tree as the dtype side). A
    rollout that changed anything it wasn't asked to change is refused."""
    return params_bitwise_equal(b, a)


def shares_storage(a: Any, b: Any) -> bool:
    """True when a leaf of one tree and a leaf of the other start at the
    same address: two replicas, or a replica and a retained copy, that
    alias each other pass any equality check trivially."""
    def starts(tree):
        return {(str(t.device), t.data_ptr()) for t in tree_leaves(tree) if t.numel()}
    return bool(starts(a) & starts(b))


class FleetWeightPlane:
    """The fleet's weight-distribution control plane. One instance per
    FleetManager; replicas attach/detach as pools grow and shrink."""

    def __init__(self, manager: Any, namespace: str = "fleet-weights",
                 thresholds: Optional[SLOThresholds] = None):
        self.manager = manager
        self.thresholds = thresholds or SLOThresholds()
        self.transport = DeviceTransport(
            namespace=namespace, devices=[resolve_device(getattr(manager, "device", "cuda"))])
        self._lock = threading.RLock()
        self._pubs: Dict[str, WeightPublisher] = {}      # model -> publisher
        self._subs: Dict[str, WeightSubscriber] = {}     # tag -> base sub
        self._targets: Dict[str, tuple] = {}             # tag -> base target
        self._adapter_eps: Dict[str, str] = {}           # tag -> endpoint id
        self._adapter_targets: Dict[str, tuple] = {}     # tag -> send target
        # the version vector: (model, adapter|None) -> fleet-wide version
        self.versions: Dict[Tuple[str, Optional[str]], int] = {}
        # newest registered adapter payloads ({target: (A, B)}, host-side)
        self._adapters: Dict[Tuple[str, str], dict] = {}
        # what each replica is actually serving: (tag, adapter) -> version
        self._resident: Dict[Tuple[str, str], int] = {}
        self._canary: Optional[dict] = None
        self.timeline: List[dict] = []
        self._t0 = time.monotonic()

    # -- replica attach/detach ------------------------------------------------

    def _publisher(self, model_id: str) -> WeightPublisher:
        with self._lock:
            pub = self._pubs.get(model_id)
            if pub is None:
                pub = WeightPublisher(transport=self.transport)
                self._pubs[model_id] = pub
            return pub

    def attach_replica(self, replica: Any) -> None:
        """Register a replica's base + adapter endpoints on its cache
        device; a late joiner (pool scale-up after a publish) streams the
        fleet's current base weights at the current version before taking
        traffic."""
        pub = self._publisher(replica.model_id)
        device = replica.engine.kv_cache_device()
        base_ep = f"fleet/{replica.tag}/base"
        target = pub.register_rollout(base_ep, device=device)
        adapter_ep = f"fleet/{replica.tag}/adapters"
        adapter_target = self.transport.register_endpoint(adapter_ep, device=device)
        with self._lock:
            self._targets[replica.tag] = target
            self._subs[replica.tag] = WeightSubscriber(self.transport, base_ep)
            self._adapter_eps[replica.tag] = adapter_ep
            self._adapter_targets[replica.tag] = adapter_target
        if pub.latest_version > 0:
            try:
                pub.publish_latest(target)
                self._apply_base(replica)
            except WeightSyncError:
                logger.exception("late-join stream to %s failed", replica.tag)

    def detach_replica(self, replica: Any) -> None:
        with self._lock:
            self._targets.pop(replica.tag, None)
            sub = self._subs.pop(replica.tag, None)
            adapter_ep = self._adapter_eps.pop(replica.tag, None)
            self._adapter_targets.pop(replica.tag, None)
            for key in [k for k in self._resident if k[0] == replica.tag]:
                self._resident.pop(key, None)
        if sub is not None:
            sub.close()
        if adapter_ep is not None:
            try:
                while self.transport.recv_arrays(adapter_ep, timeout_s=0.0) is not None:
                    pass
            except FabricTransferError:
                pass

    def _event(self, event: str, **fields) -> dict:
        row = {"t_s": round(time.monotonic() - self._t0, 4), "event": event, **fields}
        with self._lock:
            self.timeline.append(row)
        return row

    # -- base-weight distribution ---------------------------------------------

    def _apply_base(self, replica: Any) -> Optional[int]:
        """Apply the replica's newest bundle on its loop thread, between two
        steps (the subscriber writes the engine's tensors in place)."""
        with self._lock:
            sub = self._subs.get(replica.tag)
        if sub is None:
            return None
        return replica.runner.call(lambda: sub.apply_to_engine(replica.runner.engine))

    def publish_base(self, model_id: str, params: Any, exclude: tuple = ()) -> int:
        """Ship a new base-weight version to every replica of ``model_id``
        (minus ``exclude`` tags) and apply it. Returns the published
        version; the version vector advances."""
        replicas = [r for r in self.manager.replicas(model_id) if r.tag not in exclude]
        pub = self._publisher(model_id)
        with self._lock:
            targets = [self._targets[r.tag] for r in replicas]
        version = pub.publish(params, targets)
        for r in replicas:
            self._apply_base(r)
        with self._lock:
            self.versions[(model_id, None)] = version
        self._event("publish_base", model=model_id, version=version,
                    replicas=[r.tag for r in replicas])
        return version

    # -- adapter distribution (same fabric, per-replica endpoints) ------------

    def _ship_adapter(self, tag: str, model_id: str, adapter_id: str, payload: dict,
                      version: int, timeout_s: float = 30.0) -> dict:
        """Send one adapter bundle over the fabric to a replica's adapter
        endpoint and receive it back verified: the adapter path gets the
        same checksum gate as base weights. Returns the RECEIVED payload
        (the tensors the replica will actually load)."""
        with self._lock:
            ep = self._adapter_eps.get(tag)
            send_target = self._adapter_targets.get(tag)
        if ep is None or send_target is None:
            raise FleetError(f"replica {tag!r} not attached")
        arrays = {}
        for t, (A, B) in payload.items():
            arrays[f"{t}.A"] = torch.as_tensor(A)
            arrays[f"{t}.B"] = torch.as_tensor(B)
        meta = {"kind": "adapter", "model": model_id, "adapter": adapter_id,
                "version": int(version), "targets": sorted(payload)}
        try:
            self.transport.send_arrays(send_target, arrays, meta=meta, timeout_s=timeout_s,
                                       bundle_id=f"adapter-{adapter_id}-v{version}")
        except FabricTransferError as e:
            raise WeightSyncError(
                f"adapter publish {adapter_id!r} v{version} to {tag} failed: {e}"
            ) from e
        newest = None
        while True:
            b = self.transport.recv_arrays(ep, timeout_s=timeout_s)
            if b is None:
                break
            timeout_s = 0.0
            if not b.verify():
                continue
            if newest is None or int(b.meta["version"]) >= int(newest.meta["version"]):
                newest = b
        if newest is None:
            raise WeightSyncError(
                f"adapter bundle {adapter_id!r} v{version} never arrived verified at {tag}"
            )
        return {t: (newest.arrays[f"{t}.A"], newest.arrays[f"{t}.B"])
                for t in newest.meta["targets"]}

    def _swap_adapter(self, replica: Any, adapter_id: str, payload: dict, version: int) -> bool:
        """Load ``payload`` as ``adapter_id`` on one replica (removing the
        resident copy first: a scoped prefix drop for exactly this
        adapter's salt). Returns False when in-flight requests pin the slot
        (the replica keeps serving its resident version)."""
        received = self._ship_adapter(replica.tag, replica.model_id, adapter_id, payload,
                                      version)

        def swap() -> bool:
            eng = replica.runner.engine
            if adapter_id in eng._lora_slots:
                try:
                    eng.remove_lora(adapter_id)
                except ValueError:
                    return False  # in-flight refs pin the old version
            eng.add_lora(adapter_id, received, evict=True)
            return True

        if not replica.runner.call(swap):
            return False
        with self._lock:
            self._resident[(replica.tag, adapter_id)] = version
        fleet_metrics.adapter_load_counter().inc(1, tags={"model": replica.model_id})
        return True

    def publish_adapter(self, model_id: str, adapter_id: str, payload: dict) -> int:
        """Register (or version-bump) an adapter. Replicas where it is
        resident are swapped in place over the fabric; elsewhere it loads
        lazily at routing time. Returns the new version."""
        with self._lock:
            version = self.versions.get((model_id, adapter_id), 0) + 1
            self.versions[(model_id, adapter_id)] = version
            self._adapters[(model_id, adapter_id)] = dict(payload)
        deferred = []
        for r in self.manager.replicas(model_id):
            if adapter_id in r.engine._lora_slots:
                if not self._swap_adapter(r, adapter_id, payload, version):
                    deferred.append(r.tag)
        self._event("publish_adapter", model=model_id, adapter=adapter_id, version=version,
                    deferred=deferred)
        return version

    def adapter_payload(self, model_id: str, adapter_id: str) -> dict:
        with self._lock:
            payload = self._adapters.get((model_id, adapter_id))
        if payload is None:
            raise FleetError(f"adapter {adapter_id!r} not registered for model {model_id!r}")
        return payload

    def adapter_version(self, model_id: str, adapter_id: str) -> int:
        with self._lock:
            return self.versions.get((model_id, adapter_id), 0)

    def resident_version(self, tag: str, adapter_id: str) -> int:
        with self._lock:
            return self._resident.get((tag, adapter_id), 0)

    def note_resident(self, tag: str, adapter_id: str, version: int) -> None:
        with self._lock:
            self._resident[(tag, adapter_id)] = version

    def resident_payloads(self, model_id: str):
        """(adapter_id, payload) pairs for every registered adapter of a
        model: the rung-3 engine-rebuild reload set."""
        with self._lock:
            return [(aid, dict(p)) for (mid, aid), p in self._adapters.items()
                    if mid == model_id]

    # -- the canary ladder ----------------------------------------------------

    @property
    def canary(self) -> Optional[dict]:
        with self._lock:
            return dict(self._canary) if self._canary else None

    def begin_canary(self, model_id: str, params: Any = None, adapter_id: Optional[str] = None,
                     payload: Optional[dict] = None) -> dict:
        """Apply a candidate version to exactly ONE replica and start
        grading it. Pass ``params`` for a base rollout or ``adapter_id`` +
        ``payload`` for an adapter rollout."""
        if (params is None) == (payload is None):
            raise ValueError("pass exactly one of params / adapter payload")
        with self._lock:
            if self._canary is not None:
                raise CanaryStateError(
                    f"canary already in flight: {self._canary['model']} "
                    f"v{self._canary['version']}"
                )
        replicas = self.manager.replicas(model_id)
        canary = replicas[-1]  # newest replica: least accumulated history
        if params is not None:
            pub = self._publisher(model_id)
            prev = pub._latest_params
            if prev is None:
                # the canary's own tensors are about to be overwritten in
                # place: keep a copy of what it serves now
                prev = canary.runner.call(lambda: snapshot(canary.runner.engine.params))
            with self._lock:
                target = self._targets[canary.tag]
            version = pub.publish(params, [target])
            self._apply_base(canary)
            kind = "base"
        else:
            if adapter_id is None:
                raise ValueError("adapter canary needs adapter_id + payload")
            with self._lock:
                prev = self._adapters.get((model_id, adapter_id))
                version = self.versions.get((model_id, adapter_id), 0) + 1
            if not self._swap_adapter(canary, adapter_id, payload, version):
                raise CanaryStateError(
                    f"canary slot for {adapter_id!r} pinned by in-flight requests on "
                    f"{canary.tag}"
                )
            kind = "adapter"
        state = {
            "model": model_id, "kind": kind, "adapter": adapter_id,
            "version": version, "replica": canary.tag,
            "prev": prev, "new": params if params is not None else payload,
            "baseline": _slo_snapshot(),
        }
        with self._lock:
            self._canary = state
        fleet_metrics.canary_counter().inc(1, tags={"model": model_id, "outcome": "started"})
        self._event("canary_begin", model=model_id, kind=kind, adapter=adapter_id,
                    version=version, replica=canary.tag)
        return {k: state[k] for k in ("model", "kind", "adapter", "version", "replica")}

    def _require_canary(self) -> dict:
        with self._lock:
            if self._canary is None:
                raise CanaryStateError("no canary in flight")
            return self._canary

    def canary_grade(self) -> dict:
        """Grade the canary replica on traffic SINCE the canary began.
        Returns {"grade", "detail"}: the grade ladder's verdict scoped to
        the one replica-tagged series."""
        state = self._require_canary()
        hists = local_slo_histograms(baseline=state["baseline"])
        report = evaluate_slo(hists, self.thresholds)
        entry = report["model_tags"].get(state["replica"])
        grade = entry["grade"] if entry else "no_data"
        self._event("canary_grade", replica=state["replica"], grade=grade)
        return {"grade": grade, "detail": entry}

    def _canary_replica(self, state: dict) -> Any:
        for r in self.manager.replicas(state["model"]):
            if r.tag == state["replica"]:
                return r
        raise FleetError(f"canary replica {state['replica']} left the pool")

    def promote(self) -> dict:
        """Roll the canary's version out to every other replica, gated on
        bitwise identity: after the fan-out, each replica's weights must
        equal the canary's bit for bit, on storages of its own."""
        state = self._require_canary()
        model_id, version = state["model"], state["version"]
        canary = self._canary_replica(state)
        others = [r for r in self.manager.replicas(model_id) if r.tag != canary.tag]
        if state["kind"] == "base":
            pub = self._publisher(model_id)
            with self._lock:
                targets = [self._targets[r.tag] for r in others]
            if targets:
                pub.publish(state["new"], targets, version=version)
            for r in others:
                self._apply_base(r)
            with self._lock:
                self.versions[(model_id, None)] = version
            served = canary.engine.params
            mismatched = [
                r.tag for r in others
                if not bitwise_equal(r.engine.params, served)
                or shares_storage(r.engine.params, served)
            ]
        else:
            adapter_id = state["adapter"]
            with self._lock:
                self.versions[(model_id, adapter_id)] = version
                self._adapters[(model_id, adapter_id)] = dict(state["new"])
            canary_resident = _resident_adapter(canary.engine, adapter_id, state["new"])
            mismatched = []
            for r in others:
                if adapter_id not in r.engine._lora_slots:
                    continue  # loads lazily (and freshly) at routing time
                if not self._swap_adapter(r, adapter_id, state["new"], version):
                    mismatched.append(r.tag)
                    continue
                resident = _resident_adapter(r.engine, adapter_id, state["new"])
                if canary_resident is None or resident is None or not all(
                        bitwise_equal(resident[t], canary_resident[t])
                        and not shares_storage(resident[t], canary_resident[t])
                        for t in state["new"]):
                    mismatched.append(r.tag)
        if mismatched:
            fleet_metrics.canary_counter().inc(
                1, tags={"model": model_id, "outcome": "promote_failed"})
            self._event("canary_promote_failed", model=model_id, version=version,
                        mismatched=mismatched)
            raise WeightSyncError(
                f"promote v{version} refused: replicas {mismatched} are not bitwise-identical "
                "to the canary after fan-out"
            )
        with self._lock:
            self._canary = None
        fleet_metrics.canary_counter().inc(1, tags={"model": model_id, "outcome": "promoted"})
        self._event("canary_promote", model=model_id, version=version,
                    replicas=[r.tag for r in others])
        return {"outcome": "promoted", "model": model_id, "version": version,
                "replicas": [r.tag for r in others]}

    def rollback(self) -> dict:
        """Revert the canary replica to the retained pre-canary weights.
        Subscribers never apply backwards, so the old weights ship as a NEW
        monotonic version, gated on bitwise identity with the retained
        copy (cast to the engine's dtype), on storages of the canary's
        own."""
        state = self._require_canary()
        model_id = state["model"]
        canary = self._canary_replica(state)
        prev = state["prev"]
        if prev is None:
            raise WeightSyncError(
                f"rollback of {state['adapter']!r}: no previous version retained (canary was "
                "the first publish)"
            )
        if state["kind"] == "base":
            pub = self._publisher(model_id)
            with self._lock:
                target = self._targets[canary.tag]
            rb_version = pub.publish(prev, [target])
            self._apply_base(canary)
            served = canary.engine.params
            identical = bitwise_equal(served, prev) and not shares_storage(served, prev)
        else:
            adapter_id = state["adapter"]
            rb_version = state["version"] + 1
            ok = self._swap_adapter(canary, adapter_id, prev, rb_version)
            resident = _resident_adapter(canary.engine, adapter_id, prev) if ok else None
            identical = resident is not None and all(
                bitwise_equal(resident[t], prev[t]) for t in prev)
            with self._lock:
                # the fleet's registered payload stays the pre-canary one
                self._adapters[(model_id, adapter_id)] = dict(prev)
                self.versions[(model_id, adapter_id)] = rb_version
        with self._lock:
            self._canary = None
        if not identical:
            fleet_metrics.canary_counter().inc(
                1, tags={"model": model_id, "outcome": "rollback_failed"})
            raise WeightSyncError(
                f"rollback on {canary.tag} is NOT bitwise-identical to the retained pre-canary "
                "weights"
            )
        fleet_metrics.canary_counter().inc(1, tags={"model": model_id, "outcome": "rolled_back"})
        self._event("canary_rollback", model=model_id, version=rb_version, replica=canary.tag)
        return {"outcome": "rolled_back", "model": model_id, "version": rb_version,
                "replica": canary.tag}

    def decide(self, grade: Optional[str] = None) -> dict:
        """The closed-loop step: promote on green, roll back on red, hold
        on yellow/no_data (more traffic decides)."""
        if grade is None:
            grade = self.canary_grade()["grade"]
        if grade == GRADE_GREEN:
            return self.promote()
        if grade == GRADE_RED:
            return self.rollback()
        self._event("canary_hold", grade=grade)
        return {"outcome": "hold", "grade": grade}

    # -- observability / lifecycle --------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            canary = self._canary
            return {
                "versions": {
                    f"{m}:{a}" if a else m: v
                    for (m, a), v in sorted(self.versions.items(),
                                            key=lambda kv: (kv[0][0], kv[0][1] or ""))
                },
                "registered_adapters": sorted(f"{m}:{a}" for m, a in self._adapters),
                "canary": ({k: canary[k] for k in
                            ("model", "kind", "adapter", "version", "replica")}
                           if canary else None),
                "timeline_events": len(self.timeline),
            }

    def close(self) -> None:
        with self._lock:
            pubs = list(self._pubs.values())
            subs = list(self._subs.values())
            self._pubs.clear()
            self._subs.clear()
            self._targets.clear()
            self._adapter_eps.clear()
        for sub in subs:
            sub.close()
        for pub in pubs:
            pub.close()
        self.transport.close()
