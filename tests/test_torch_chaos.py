"""ray_tpu_torch.chaos held against ray_tpu.chaos on the CPU, and the
engine's ``llm.engine.step`` hook.

 * the same seeded FaultSchedule fed the same call sequence fires the same
   faults, with the same log, in both packages; specs validate and
   serialize as the reference's;
 * the engine hook: PREEMPT_ENGINE / KILL_WORKER raise EnginePreempted
   before the step mutates anything, DELAY_RPC slows it; both engines
   running one schedule log the same faults;
 * an injected PREEMPT_ENGINE through the port's LLMServer drives the
   runner's crash recovery back to the clean run's tokens (as
   ``tests/test_chaos.py`` drives the reference's).

Every test that installs a schedule uninstalls it (fixture): a schedule
is process-wide.
"""

import asyncio
import dataclasses
import json
import random
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import chaos as jchaos
from ray_tpu.chaos import schedule as jschedule
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.serve.proxy import Request
from ray_tpu_torch import chaos, obs
from ray_tpu_torch.chaos import schedule as tschedule
from ray_tpu_torch.llm import EngineConfig, EnginePreempted, LLMConfig, LLMEngine, LLMServer
from ray_tpu_torch.llm import SamplingParams
from ray_tpu_torch.llm import engine as tengine_mod
from ray_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
ENGINE_KW = dict(num_blocks=64, block_size=4, max_num_seqs=4, max_prefill_len=32,
                 pipeline_decode=False, decode_chunk=2)
GREEDY = dict(temperature=0.0, ignore_eos=True)


@pytest.fixture(autouse=True)
def _chaos_off():
    yield
    chaos.uninstall()
    jchaos.uninstall()


def _specs(mod):
    return [
        mod.FaultSpec(mod.DROP_RPC, site="rpc.*", match={"method": "push*"}, p=0.3,
                      max_fires=5),
        mod.FaultSpec(mod.DELAY_RPC, site="*", every_n=3, start_after=2, delay_s=0.0),
        mod.FaultSpec(mod.PREEMPT_ENGINE, site="llm.engine.step", start_after=4, max_fires=1),
        mod.FaultSpec(mod.PREEMPT_NODE, at_s=1.0, target="node-1"),
        mod.FaultSpec(mod.CORRUPT_KV_TRANSFER, site="disagg.kv_transfer", p=0.5),
        mod.FaultSpec(mod.DROP_KV_TRANSFER, site="disagg.kv_transfer",
                      match={"request_id": "r[13]"}),
    ]


def _calls(seed: int, n: int = 200) -> list:
    """A seeded sequence of hook calls: (site, kinds or None, attrs)."""
    rng = random.Random(seed)
    sites = [("rpc.call", None, "method"), ("rpc.send", None, "method"),
             ("llm.engine.step", ("preempt_engine", "kill_worker", "delay_rpc"), "running"),
             ("disagg.kv_transfer", ("drop_kv_transfer", "corrupt_kv_transfer", "delay_rpc"),
              "request_id")]
    out = []
    for _ in range(n):
        site, kinds, key = rng.choice(sites)
        val = {"method": rng.choice(["push_task", "pull", "push_obj"]),
               "running": rng.randint(0, 4), "request_id": f"r{rng.randint(0, 4)}"}[key]
        out.append((site, kinds, {key: val}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_same_schedule_same_faults_as_reference(seed):
    scheds = [mod.FaultSchedule(seed, _specs(mod)) for mod in (jschedule, tschedule)]
    for site, kinds, attrs in _calls(seed):
        hits = [s.fire(site, kinds=kinds, **attrs) for s in scheds]
        assert [h.kind for h in hits[1]] == [h.kind for h in hits[0]]
    ref, port = scheds
    assert port.decisions() == ref.decisions()
    assert len(port.decisions()) > 10
    assert [(f.seq, f.kind, f.site, f.spec_index, f.attrs) for f in port.log] == [
        (f.seq, f.kind, f.site, f.spec_index, f.attrs) for f in ref.log]
    assert port.orchestrated() == [(i, s) for i, s in enumerate(port.specs)
                                   if s.kind == chaos.PREEMPT_NODE]
    assert [i for i, _ in port.orchestrated()] == [i for i, _ in ref.orchestrated()]
    assert port.pick(3, ["n2", "n1", "n3"]) == ref.pick(3, ["n2", "n1", "n3"])
    # the JSON form is the reference's, and either side reads the other's
    assert json.loads(port.to_wire()) == json.loads(ref.to_wire())
    again = chaos.FaultSchedule.from_wire(ref.to_wire())
    for site, kinds, attrs in _calls(seed):
        again.fire(site, kinds=kinds, **attrs)
    assert again.decisions() == ref.decisions()


BAD_SPECS = {
    "unknown_kind": dict(kind="melt_down"),
    "p_out_of_range": dict(kind="drop_rpc", p=1.5),
    "every_n_zero": dict(kind="drop_rpc", every_n=0),
    "restart_not_gcs": dict(kind="drop_rpc", restart_after_s=1.0),
    "window_not_partition": dict(kind="drop_rpc", window_s=1.0),
    "partition_no_window": dict(kind="partition_gcs_pair"),
    "at_s_in_process": dict(kind="drop_rpc", at_s=2.0),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_validation_equals_reference(case):
    msgs = []
    for mod in (jchaos, chaos):
        with pytest.raises(ValueError) as ei:
            mod.FaultSpec(**BAD_SPECS[case])
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    assert chaos.KINDS == jchaos.KINDS


@pytest.mark.parametrize("body", [b"", b"x", b"abcdefgh", bytes(range(40))])
def test_corrupt_frame_equals_reference(body):
    assert chaos.corrupt_frame(body) == jchaos.corrupt_frame(body)


def test_fire_mirrors_each_fault_into_the_flight_recorder():
    assert chaos.fire("llm.engine.step", running=1) == []  # nothing installed
    sched = chaos.install(chaos.FaultSchedule(1, [chaos.FaultSpec(chaos.DELAY_RPC,
                                                                  site="llm.*")]))
    assert chaos.ACTIVE is sched and chaos.active() is sched
    with obs.span("test.root") as ctx:
        hits = chaos.fire("llm.engine.step", kinds=(chaos.DELAY_RPC,), running=2)
        assert chaos.fire("llm.engine.step", kinds=(chaos.DROP_RPC,)) == []
    assert [h.kind for h in hits] == [chaos.DELAY_RPC]
    ev = [s for s in obs.get_recorder().get(ctx.trace_id) if s.name == "chaos.delay_rpc"]
    assert len(ev) == 1 and ev[0].status == "error"
    assert ev[0].attrs == {"site": "llm.engine.step", "running": "2"}
    assert [f.kind for f in chaos.fault_log()] == [chaos.DELAY_RPC]
    chaos.uninstall()
    assert chaos.ACTIVE is None and chaos.fault_log() == []


# ---------------------------------------------------------------------------
# the engine's llm.engine.step hook
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(J_FP32_TINY, jax.random.key(0)))


def _port(tree, **kw):
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    return LLMEngine(EngineConfig(model=FP32_TINY, **{**ENGINE_KW, **kw}), params=params,
                     device="cpu")


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in (7, 12, 5)]


def _drain(eng) -> dict:
    out = {}
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                out[o.request_id] = o.output_token_ids
    return out


@pytest.mark.parametrize("kind", ["preempt_engine", "kill_worker"])
def test_step_hook_preempts_before_mutating(tree, kind):
    eng = _port(tree)
    clean = eng.generate(_prompts(), SamplingParams(max_tokens=8, **GREEDY))
    eng = _port(tree)
    sched = chaos.install(chaos.FaultSchedule(0, [chaos.FaultSpec(
        kind, site="llm.engine.step", start_after=2, max_fires=1)]))
    rids = [eng.add_request(p, SamplingParams(max_tokens=8, **GREEDY)) for p in _prompts()]
    eng.step()
    eng.step()
    before = {r: list(eng.requests[r].output_token_ids) for r in rids}
    with pytest.raises(EnginePreempted):
        eng.step()
    assert {r: eng.requests[r].output_token_ids for r in rids} == before  # nothing mutated
    assert isinstance(EnginePreempted("x"), chaos.FaultInjected)
    assert eng.recover(rebuild_kv=False)
    out = _drain(eng)
    assert [out[r] for r in rids] == clean
    assert sched.decisions() == [(kind, "llm.engine.step", 0)]


def test_engines_log_the_same_faults_as_the_reference(tree):
    """One seeded DELAY_RPC schedule (zero delay, p = 0.5) over both engines'
    step sequences: the same decisions with the same running/waiting attrs."""
    logs = []
    for mod, eng, sp in (
        (jchaos, JLLMEngine(JEngineConfig(model=J_FP32_TINY, **ENGINE_KW),
                            params=jax.tree.map(jnp.asarray, tree)), JSamplingParams),
        (chaos, _port(tree), SamplingParams),
    ):
        sched = mod.install(mod.FaultSchedule(5, [mod.FaultSpec(
            mod.DELAY_RPC, site="llm.engine.step", p=0.5, delay_s=0.0)]))
        try:
            eng.generate(_prompts(), sp(max_tokens=20, **GREEDY))
        finally:
            mod.uninstall()
        logs.append([(f.kind, f.site, f.attrs) for f in sched.log])
    assert logs[1] == logs[0]
    assert len(logs[1]) >= 3


def _req(body):
    return Request("POST", "/v1/completions", {}, {}, json.dumps(body).encode())


def test_injected_preemption_recovers_through_the_server(tree):
    """As tests/test_chaos.py's acceptance: a PREEMPT_ENGINE at
    llm.engine.step mid-burst; every request completes once, with the clean
    run's tokens, through one clean recovery (``reason=recover``)."""
    model_id = f"chaos-{uuid.uuid4().hex[:8]}"
    server = LLMServer(LLMConfig(
        model_id=model_id, params=tllama.params_from_numpy(tree, FP32_TINY, device="cpu"),
        device="cpu", engine=EngineConfig(model=FP32_TINY, **ENGINE_KW)))
    bodies = [{"prompt": f"hello {i}", "max_tokens": 10, "temperature": 0.0} for i in range(6)]

    async def burst():
        return await asyncio.gather(*[server(_req(b)) for b in bodies])

    try:
        clean = asyncio.run(burst())
        sched = chaos.install(chaos.FaultSchedule(11, [chaos.FaultSpec(
            chaos.PREEMPT_ENGINE, site="llm.engine.step", start_after=3, max_fires=1)]))
        faulted = asyncio.run(burst())
        chaos.uninstall()
        stats = server.stats()
    finally:
        server.shutdown()
    assert sched.fired_kinds() == [chaos.PREEMPT_ENGINE]
    assert [r["choices"][0]["text"] for r in faulted] == [r["choices"][0]["text"] for r in clean]
    assert len({r["id"] for r in faulted}) == len(bodies)
    assert stats["engine_recoveries"] == 1
    assert stats["num_preemptions"] >= 1
    series = tengine_mod.preemption_counter().series()
    assert series[(model_id, "", "recover")] == stats["num_preemptions"]
    recovered = [r for r in faulted
                 if "engine.recover" in {s["name"] for s in server.request_trace(r["id"])["spans"]}]
    assert recovered
