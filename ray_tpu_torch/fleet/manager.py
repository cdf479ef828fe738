"""FleetManager: {base models x LoRA adapters x tenants} onto replica pools
(counterpart of ``ray_tpu/fleet/manager.py``).

 * **replica pools**: per base model, each replica an ``LLMEngine`` behind
   the serving front end's ``_EngineRunner`` loop (crash recovery,
   idempotent delivery and the three-rung ladder come with it);
 * **model-aware routing**: ``route()`` scores each replica by
   tier-discounted resident prefix tokens (adapter ids salt the chains),
   an adapter-residency bonus and its load;
 * **dynamic adapter residency**: ``ensure_adapter`` loads a requested
   adapter into the replica's slot budget, LRU-evicting an idle one when
   full (``AdapterSlotsExhausted`` falls back to the next-best replica);
 * **tenant QoS**: admission rides ``qos.TenantQoSController``; the
   tenant's priority rides every request into the engine, where it orders
   admission and arms priority preemption.

Replica engine tags are replica-scoped (``model@rN``) so the SLO plane can
grade one replica (the canary ladder's input); tenant-scoped series ride
each request's ``slo_tag``.

Where the port differs from the reference:

 * **Replicas own their weights.** The weight plane writes weights into
   an engine's tensors in place (CUDA graphs read them by address), so two
   replicas built from one params tree would share storages and a canary
   apply would change both. The first replica of a model takes the given
   tree itself; every later one takes a clone.
 * **No runner lock.** The port's runner drains an inbox at step
   boundaries instead of holding a lock across a step, so adapter loads
   and weight applies run through ``runner.call`` on the loop thread.
 * **A rebuilt replica keeps its version.** The runner's full-rebuild
   rung builds the fresh engine over the torn engine's weight tensors (the
   version it was serving, unchanged by a failed step) and its
   ``weight_version``, never the spawn-time tree.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue as queue_mod
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.fleet import metrics as fleet_metrics
from ray_tpu_torch.fleet.config import FleetError, FleetSpec, UnknownModelError
from ray_tpu_torch.fleet.qos import TenantQoSController
from ray_tpu_torch.llm.engine import AdapterSlotsExhausted, EngineConfig, LLMEngine
from ray_tpu_torch.llm.openai_api import _EngineRunner
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.train.weight_sync import snapshot

logger = logging.getLogger("ray_tpu_torch.fleet.manager")

# routing weights: a discounted resident-prefix token is worth admitting
# ~W_PREFIX queue positions of extra load (same shape as the disagg
# decode pick); adapter residency saves a load+possible-evict, priced as
# a flat bonus
W_PREFIX = 0.05
W_LOAD = 1.0
RESIDENT_BONUS = 2.0


class FleetAdmissionRejected(FleetError):
    """QoS shed: carries the 429/503 OpenAI-style payload."""

    def __init__(self, payload: dict):
        self.payload = payload
        err = payload.get("error", {})
        super().__init__(err.get("message", "admission rejected"))

    @property
    def code(self) -> int:
        return int(self.payload.get("error", {}).get("code", 429))


@dataclasses.dataclass
class FleetTicket:
    """One admitted request: the runner queue to consume plus the
    bookkeeping ``collect``/``abort`` need to settle QoS state."""

    request_id: str
    queue: Any
    replica: "FleetReplica"
    tenant_id: str
    model_id: str
    adapter_id: Optional[str] = None
    _released: bool = False


class FleetReplica:
    """One serving replica: an engine behind an _EngineRunner loop."""

    def __init__(self, model_id: str, tag: str, runner: _EngineRunner):
        self.model_id = model_id
        self.tag = tag
        self.runner = runner

    @property
    def engine(self) -> LLMEngine:
        return self.runner.engine

    def load(self) -> int:
        waiting, running = self.runner.depths()
        return waiting + running

    def resident_adapters(self) -> List[str]:
        return list(self.engine._lora_slots)

    def prefix_score(self, prompt_ids: list, adapter_id: Optional[str]) -> float:
        """Tier-discounted resident prefix tokens for this prompt under the
        right LoRA salt (0.0 when the adapter isn't resident: its chains
        can't be resident either). A read-only probe, as the disaggregated
        decode pick makes from its own thread."""
        eng = self.engine
        if adapter_id is not None and adapter_id not in eng._lora_slots:
            return 0.0
        try:
            got = eng.peek_prefix_tiered(prompt_ids, lora_id=adapter_id)
            return float(got.get("discounted", 0.0))
        except Exception:  # noqa: BLE001 — scoring must not fail routing
            return 0.0

    def shutdown(self) -> None:
        self.runner.shutdown()


class FleetManager:
    """The fleet control plane: pools, routing, QoS, adapter residency.

    ``engine_config`` may be one EngineConfig for every model, a
    {model_id: EngineConfig} dict, or a callable model_id -> config; same
    for ``params`` (None = random init per engine seed). Engines run on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        spec: FleetSpec,
        engine_config: Any = None,
        params: Any = None,
        seed: int = 0,
        thresholds: Any = None,
        device: Any = "cuda",
    ):
        from ray_tpu_torch.fleet.weights import FleetWeightPlane

        self.spec = spec
        self.seed = seed
        self.device = device
        self._engine_config = engine_config
        self._params = params
        self.qos = TenantQoSController(spec)
        self._lock = threading.RLock()
        self._replicas: Dict[str, List[FleetReplica]] = {}
        self._replica_seq = itertools.count()
        # models whose given params tree a replica already holds: later
        # replicas take a clone (each replica owns its weight tensors)
        self._params_taken: set = set()
        # lifetime routed-request counts: an epsilon tiebreak so equal
        # instantaneous load round-robins instead of pinning the first
        # replica (a sequential submit-collect client would otherwise
        # never exercise replica N — including the canary)
        self._routed: Dict[str, int] = {}
        self.weights = FleetWeightPlane(self, thresholds=thresholds)
        self._closed = False
        for m in spec.models:
            for _ in range(m.replicas):
                self._spawn_replica(m.model_id)

    # -- replica lifecycle ----------------------------------------------------

    def _config_for(self, model_id: str) -> EngineConfig:
        ec = self._engine_config
        if callable(ec):
            cfg = ec(model_id)
        elif isinstance(ec, dict):
            cfg = ec.get(model_id) or EngineConfig()
        else:
            cfg = ec or EngineConfig()
        # replicas must not share a mutable config object (the serving
        # layer writes eos_token_id into it)
        return dataclasses.replace(cfg)

    def _params_for(self, model_id: str) -> Any:
        p = self._params
        if callable(p):
            p = p(model_id)
        elif isinstance(p, dict):
            p = p.get(model_id)
        if p is None:
            return None
        with self._lock:
            first = model_id not in self._params_taken
            self._params_taken.add(model_id)
        return p if first else snapshot(p)

    def _spawn_replica(self, model_id: str) -> FleetReplica:
        cfg = self._config_for(model_id)
        params = self._params_for(model_id)
        tag = f"{model_id}@r{next(self._replica_seq)}"
        weights = self.weights
        replica: Optional[FleetReplica] = None

        def _build() -> LLMEngine:
            # the runner's full-rebuild rung: the fresh engine takes the
            # torn engine's weight tensors (the version this replica
            # serves; a failed step never writes them) and its version
            torn = replica.runner.engine
            eng = LLMEngine(cfg, params=torn.params, seed=self.seed, device=self.device)
            eng.model_tag = tag
            eng.weight_version = torn.weight_version
            # a rebuilt engine lost its adapter slots: reload what the
            # registry holds so in-flight lora requests can recompute
            for aid, payload in weights.resident_payloads(model_id):
                try:
                    eng.add_lora(aid, payload)
                except Exception:  # noqa: BLE001 — slot budget may differ
                    logger.exception("adapter %r reload failed", aid)
            return eng

        engine = LLMEngine(cfg, params=params, seed=self.seed, device=self.device)
        engine.model_tag = tag
        runner = _EngineRunner(engine, engine_factory=_build)
        replica = FleetReplica(model_id, tag, runner)
        with self._lock:
            self._replicas.setdefault(model_id, []).append(replica)
        # late joiner: stream the fleet's current base weights at the
        # current version (the cold-start path, reused per model)
        self.weights.attach_replica(replica)
        logger.info("spawned replica %s", tag)
        return replica

    def replicas(self, model_id: str) -> List[FleetReplica]:
        with self._lock:
            reps = self._replicas.get(model_id)
            if not reps:
                raise UnknownModelError(f"no replicas for model {model_id!r}")
            return list(reps)

    # -- per-model pool targets (the autoscale surface) -----------------------

    def pool_state(self) -> Dict[str, dict]:
        """The pool-actuator surface: pools are base models."""
        with self._lock:
            return {
                mid: {"replicas_running": len(reps), "replicas_target": len(reps)}
                for mid, reps in self._replicas.items()
            }

    def set_pool_target(self, model_id: str, target: int,
                        drain_timeout_s: float = 5.0) -> int:
        """Converge one model's pool to ``target`` replicas. Scale-up
        spawns (weights stream from the plane's latest publish);
        scale-down retires only replicas that drain idle within the
        timeout — a busy replica is left serving. Returns the resulting
        replica count."""
        self.spec.model(model_id)  # raises UnknownModelError
        target = max(1, int(target))
        while True:
            with self._lock:
                have = len(self._replicas.get(model_id, ()))
            if have >= target:
                break
            self._spawn_replica(model_id)
        while True:
            with self._lock:
                reps = self._replicas.get(model_id, [])
                if len(reps) <= target:
                    break
                victim = reps[-1]
            deadline = time.monotonic() + drain_timeout_s
            while victim.runner.busy() and time.monotonic() < deadline:
                time.sleep(0.02)
            if victim.runner.busy():
                logger.warning("pool %s: replica %s still busy; not retiring",
                               model_id, victim.tag)
                break
            with self._lock:
                reps = self._replicas.get(model_id, [])
                if victim in reps:
                    reps.remove(victim)
            self.weights.detach_replica(victim)
            victim.shutdown()
            logger.info("retired replica %s", victim.tag)
        with self._lock:
            return len(self._replicas.get(model_id, ()))

    def autoscaler_pool_targets(self, slo_report: Optional[dict] = None) -> Dict[str, int]:
        """Per-model pool targets from the SLO grades: any replica of a
        model graded red asks for one more replica; a model whose replicas
        all grade green may give one back (never below its spec floor).
        Advice only: apply it with set_pool_target."""
        if slo_report is None:
            from ray_tpu_torch.fleet.weights import local_slo_histograms
            from ray_tpu_torch.obs.telemetry import evaluate_slo

            slo_report = evaluate_slo(local_slo_histograms(), self.weights.thresholds)
        tags = slo_report.get("model_tags", {})
        targets: Dict[str, int] = {}
        with self._lock:
            pools = {mid: list(reps) for mid, reps in self._replicas.items()}
        for mid, reps in pools.items():
            floor = self.spec.model(mid).replicas
            grades = [tags[r.tag]["grade"] for r in reps if r.tag in tags]
            n = len(reps)
            if any(g == "red" for g in grades):
                targets[mid] = n + 1
            elif grades and all(g == "green" for g in grades) and n > floor:
                targets[mid] = n - 1
            else:
                targets[mid] = n
        return targets

    # -- adapter residency ----------------------------------------------------

    def register_adapter(self, model_id: str, adapter_id: str, payload: dict) -> int:
        """Register (or version-bump) an adapter's weights with the fleet;
        replicas load it on demand at routing time. Returns the new
        version."""
        self.spec.model(model_id)
        return self.weights.publish_adapter(model_id, adapter_id, payload)

    def ensure_adapter(self, replica: FleetReplica, adapter_id: str) -> None:
        """Make ``adapter_id`` resident on ``replica``, LRU-evicting an idle
        adapter if the slot budget is full. Raises AdapterSlotsExhausted
        when every slot is pinned by in-flight requests (route() falls back
        to another replica)."""
        payload = self.weights.adapter_payload(replica.model_id, adapter_id)

        def load() -> bool:
            eng = replica.engine
            if adapter_id in eng._lora_slots:
                return False
            try:
                eng.add_lora(adapter_id, payload)
            except AdapterSlotsExhausted:
                if eng.evict_lru_lora() is None:
                    raise
                fleet_metrics.adapter_evict_counter().inc(1, tags={"model": replica.model_id})
                eng.add_lora(adapter_id, payload)
            return True

        if replica.runner.call(load):
            fleet_metrics.adapter_load_counter().inc(1, tags={"model": replica.model_id})

    # -- routing --------------------------------------------------------------

    def route(self, model_id: str, adapter_id: Optional[str], prompt_ids: list) -> FleetReplica:
        """Model-aware least-loaded pick, prefix- and residency-aware:
        score = W_PREFIX * discounted_resident_prefix_tokens
              + RESIDENT_BONUS (adapter already in a slot)
              - W_LOAD * (waiting + running)."""
        reps = self.replicas(model_id)
        best, best_score = None, None
        for r in reps:
            score = -W_LOAD * r.load()
            score += W_PREFIX * r.prefix_score(prompt_ids, adapter_id)
            if adapter_id is not None and adapter_id in r.engine._lora_slots:
                score += RESIDENT_BONUS
            score -= 1e-4 * self._routed.get(r.tag, 0)
            if best_score is None or score > best_score:
                best, best_score = r, score
        with self._lock:
            self._routed[best.tag] = self._routed.get(best.tag, 0) + 1
        return best

    # -- request path ---------------------------------------------------------

    def submit(
        self,
        tenant_id: str,
        model_ref: str,
        prompt_ids: list,
        sampling_params: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        trace: Any = None,
    ) -> FleetTicket:
        """Admit (per-tenant QoS), route, and start one request. Raises
        FleetAdmissionRejected (shed), UnknownTenantError /
        UnknownModelError (bad identity), AdapterSlotsExhausted (every
        replica's slots pinned)."""
        tenant = self.spec.tenant(tenant_id)
        model_id, adapter_id = FleetSpec.parse_model_ref(model_ref)
        mspec = self.spec.model(model_id)
        if adapter_id is not None and mspec.adapter(adapter_id) is None:
            # not declared up front: still servable if registered at
            # runtime — only a never-registered adapter is a 404
            self.weights.adapter_payload(model_id, adapter_id)
        running = sum(r.runner.depths()[1] for r in self.replicas(model_id))
        rejection = self.qos.admit(tenant, num_running=running)
        if rejection is not None:
            raise FleetAdmissionRejected(rejection)
        try:
            reps_tried: List[str] = []
            replica = self.route(model_id, adapter_id, prompt_ids)
            if adapter_id is not None:
                # slot-budget fallback: a replica whose every slot is
                # pinned by in-flight work yields to the next-best
                for candidate in sorted(self.replicas(model_id), key=lambda r: r is not replica):
                    try:
                        self.ensure_adapter(candidate, adapter_id)
                        replica = candidate
                        break
                    except AdapterSlotsExhausted:
                        reps_tried.append(candidate.tag)
                else:
                    raise AdapterSlotsExhausted(
                        f"adapter {adapter_id!r}: all slots in use on every replica "
                        f"({reps_tried})"
                    )
            rid, q = replica.runner.submit(
                prompt_ids,
                sampling_params or SamplingParams(),
                request_id=request_id,
                trace=trace,
                lora_id=adapter_id,
                priority=tenant.priority,
                tenant=tenant_id,
                slo_tag=tenant.slo_tag,
            )
        except BaseException:
            self.qos.release(tenant_id)
            raise
        fleet_metrics.tenant_requests_counter().inc(
            1, tags={"tenant": tenant_id, "model": model_id}
        )
        return FleetTicket(rid, q, replica, tenant_id, model_id, adapter_id)

    def _release(self, ticket: FleetTicket) -> None:
        if not ticket._released:
            ticket._released = True
            self.qos.release(ticket.tenant_id)

    def collect(self, ticket: FleetTicket, timeout_s: float = 60.0) -> Any:
        """Drain a ticket to completion; returns the final RequestOutput.
        Raises on engine failure or timeout. Always settles QoS state."""
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise TimeoutError(
                        f"request {ticket.request_id} did not finish in {timeout_s}s"
                    )
                try:
                    out = ticket.queue.get(timeout=min(remain, 1.0))
                except queue_mod.Empty:
                    continue
                if out is None:
                    raise FleetError(f"request {ticket.request_id} aborted")
                if isinstance(out, BaseException):
                    raise out
                if out.finished:
                    return out
        finally:
            self._release(ticket)

    def abort(self, ticket: FleetTicket) -> None:
        try:
            ticket.replica.runner.abort(ticket.request_id)
        finally:
            self._release(ticket)

    # -- observability / lifecycle --------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            pools = {mid: list(reps) for mid, reps in self._replicas.items()}
        models: dict = {}
        for mid, reps in pools.items():
            rows = []
            n_adapters = 0
            for r in reps:
                eng = r.engine
                waiting, running = r.runner.depths()
                resident = r.runner.call(lambda e=eng: list(e._lora_slots))
                n_adapters += len(resident)
                rows.append({
                    "tag": r.tag,
                    "waiting": waiting,
                    "running": running,
                    "resident_adapters": resident,
                    "weight_version": eng.weight_version,
                    "num_recoveries": r.runner.num_recoveries,
                })
            try:
                fleet_metrics.resident_adapters_gauge().set(n_adapters, tags={"model": mid})
            except Exception:  # noqa: BLE001
                pass
            models[mid] = {"replicas": rows}
        return {"models": models, "qos": self.qos.stats(), "weights": self.weights.stats()}

    def drain(self) -> None:
        self.qos.start_drain()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pools, self._replicas = self._replicas, {}
        for reps in pools.values():
            for r in reps:
                r.shutdown()
        self.weights.close()
