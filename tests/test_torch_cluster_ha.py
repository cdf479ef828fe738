"""The slice end to end on the CPU: a LLAMA_TINY fp32 actor of a port
cluster whose GCS has a warm standby keeps giving the reference engine's
greedy tokens across a ``KILL_GCS_PRIMARY``.

The cluster (``LocalCluster(standby=True)``, a GCS pair, one node) is
attached with ``ray_tpu_torch.init(address=c.address)``, where the address
names both endpoints. A seeded ``DROP_RPC`` on ``telemetry_push``, carried
to the worker by the environment, drops some of the actor's telemetry
pushes. The actor serves the prompts three times: with the primary up,
while the chaos runner kills the primary, and after the standby promoted.
Then the promoted GCS reports the failover (term + 1, one failover, no
fenced write), its merged TTFT histogram equals the worker's own bucket
for bucket, the node's gauges arrived, the status text names the new
primary, and nothing of the cluster (standby included) is left after
shutdown. The GCS, the standby and the daemon never load torch.
"""

import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch import chaos
from ray_tpu_torch.chaos.runner import ChaosRunner
from ray_tpu_torch.cluster import LocalCluster
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

register_pickle_by_value(sys.modules[__name__])

WAIT_S = 60  # every wait on a task, an actor or the control plane fails past this
J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
ENGINE = dict(num_blocks=128, block_size=4, max_num_seqs=8, max_prefill_len=64)
TTFT = "ray_tpu_llm_ttft_seconds"


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in [7, 33, 12, 48, 20, 9]]


def _loads_libtorch(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


class TinyHost:
    """A port engine on the worker's CPU from a reference params tree, and
    a telemetry reporter to both GCS endpoints."""

    def __init__(self, tree, endpoints, tag):
        import dataclasses

        import torch

        from ray_tpu_torch.llm import EngineConfig, LLMEngine
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.obs.telemetry import TelemetryReporter

        torch.set_num_threads(2)
        cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
        params = llama.params_from_numpy(tree, cfg, device="cpu")
        self.eng = LLMEngine(EngineConfig(model=cfg, **ENGINE), params=params, device="cpu")
        self.eng.model_tag = tag  # the SLO label of this host's requests
        self.reporter = TelemetryReporter(tuple(map(tuple, endpoints)), reporter_id="tiny-host",
                                          kind="engine", interval_s=0.5,
                                          collect=[self.eng.update_telemetry_gauges]).start()

    def generate(self, prompts, max_tokens):
        from ray_tpu_torch.llm import SamplingParams

        self.eng.allocator.drop_prefix_cache()
        return self.eng.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                                         ignore_eos=True))

    def flush_telemetry(self, attempts: int = 20) -> dict:
        """Push until one push lands (drops are seeded); the worker's own
        TTFT histogram and the reporter's counts."""
        from ray_tpu_torch.obs import slo

        landed = any(self.reporter.push_once() for _ in range(attempts))
        return {"landed": landed, "ok": self.reporter.num_ok, "dropped": self.reporter.num_dropped,
                "ttft": {",".join(k): list(b) for k, (b, _s, _n)
                         in slo.ttft_histogram().hist_data().items()}}


def test_tiny_llama_actor_rides_a_gcs_failover_with_the_reference_tokens():
    import ray_tpu_torch

    ref = JLLMEngine(JEngineConfig(model=J_FP32_TINY, **ENGINE), seed=0)
    want = ref.generate(_prompts(), JSamplingParams(max_tokens=12, temperature=0.0,
                                                    ignore_eos=True))
    tree = jax.tree.map(np.asarray, ref.params)
    drops = chaos.FaultSchedule(19, [chaos.FaultSpec(
        chaos.DROP_RPC, site="rpc.call", match={"method": "telemetry_push"}, every_n=3)])
    chaos.install(drops, propagate_env=True)  # before the cluster: its processes copy the env
    c = LocalCluster(node_death_timeout_s=10.0, standby=True)
    try:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="head")
        c.wait_for_nodes(1)
        assert c.address.count(",") == 1
        ray_tpu_torch.init(address=c.address)
        try:
            gcs = ray_tpu_torch.core.api._cluster().client.gcs
            assert gcs.endpoints == c.gcs_endpoints
            term0 = gcs.call("ha_status", {}, timeout=15)["term"]
            host = ray_tpu_torch.remote(TinyHost).remote(ray_tpu_torch.put(tree),
                                                         c.gcs_endpoints, "tiny-ha")
            got = {"r": ray_tpu_torch.get(host.generate.remote(_prompts(), 12), timeout=WAIT_S)}
            runner = ChaosRunner(chaos.FaultSchedule(3, [chaos.FaultSpec(
                chaos.KILL_GCS_PRIMARY, at_s=0.3)]), cluster=c)
            ref_s = host.generate.remote(_prompts(), 12)
            runner.start()
            got["s"] = ray_tpu_torch.get(ref_s, timeout=WAIT_S)
            runner.join(timeout=WAIT_S)
            runner.stop()
            assert [f.kind for f in runner.executed] == [chaos.KILL_GCS_PRIMARY]
            deadline = time.monotonic() + 15
            ha = {}
            while ha.get("term") != term0 + 1:
                assert time.monotonic() < deadline, f"no promotion within 15 s: {ha}"
                try:
                    ha = gcs.call("ha_status", {}, timeout=5)
                except Exception:  # noqa: BLE001 — the promotion window
                    time.sleep(0.1)
            got["t"] = ray_tpu_torch.get(host.generate.remote(_prompts(), 12), timeout=WAIT_S)
            for tag, toks in got.items():
                assert toks == want, tag
            assert ha["role"] == "primary" and ha["term"] == term0 + 1
            assert ha["failovers_total"] == 1 and ha["fenced_writes_total"] == 0
            assert gcs.addr == c.standby_addr

            flushed = ray_tpu_torch.get(host.flush_telemetry.remote(), timeout=WAIT_S)
            assert flushed["landed"] and flushed["dropped"] > 0
            agg = gcs.call("telemetry_cluster", {}, timeout=15)
            merged = agg["histograms"][TTFT]["series"]["model=tiny-ha"]
            assert merged["buckets"] == flushed["ttft"]["tiny-ha"]
            assert merged["count"] == 3 * len(_prompts())
            slo = gcs.call("telemetry_slo", {}, timeout=15)
            assert slo["model_tags"]["tiny-ha"]["grade"] != "no_data"
            deadline = time.monotonic() + 20
            while True:
                series = (gcs.call("telemetry_cluster", {}, timeout=15)["gauges"]
                          .get("ray_tpu_node_workers", {}).get("series", {}))
                if "node=head" in series or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            assert "node=head" in series
            from ray_tpu_torch.obs.telemetry import format_status

            text = format_status(gcs.call("telemetry_status", {}, timeout=15))
            assert "role primary" in text and f"term {term0 + 1}" in text
            assert "failovers 1" in text
            ray_tpu_torch.kill(host)
        finally:
            ray_tpu_torch.shutdown()
        for pid in c.pids():  # the new primary (the old one is dead) and the daemon
            assert not _loads_libtorch(pid), pid
    finally:
        chaos.uninstall()
        c.shutdown()
    left = c.leftovers()
    assert left == {"processes": [], "store_files": []}, left
    assert os.environ.get(chaos.ENV_VAR) is None
