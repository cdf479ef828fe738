"""The port stands alone: no module of ray_tpu_torch and no line of
chip_smoke.py imports JAX, optax or the JAX package, and the package
imports with JAX, the JAX package and triton made unimportable."""

import os
import re
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|optax|ray_tpu)(\.|\s|$)")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_pattern_separates_the_packages():
    assert FORBIDDEN.match("import jax")
    assert FORBIDDEN.match("from ray_tpu.llm import engine")
    assert FORBIDDEN.match("    import optax")
    assert not FORBIDDEN.match("from ray_tpu_torch.llm import engine")
    assert not FORBIDDEN.match("import jaxlib_free_name")


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if FORBIDDEN.match(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not bad, bad


def test_port_imports_without_jax_triton_or_gpu():
    """Every module of the port imports with jax, optax, ray_tpu and triton
    blocked, and the plain path runs pipelined and speculative decoding,
    disaggregated serving and a train step on the CPU."""
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "ray_tpu", "triton"):
    sys.modules[name] = None
import ray_tpu_torch
import ray_tpu_torch.llm, ray_tpu_torch.llm.decode_loop
import ray_tpu_torch.llm.graphs, ray_tpu_torch.llm.pipeline, ray_tpu_torch.llm.spec
import ray_tpu_torch.ops._build, ray_tpu_torch.ops.ragged
import ray_tpu_torch.ops.attention, ray_tpu_torch.ops.flash
import ray_tpu_torch.nn.layers, ray_tpu_torch.models.llama
import ray_tpu_torch.train, ray_tpu_torch.train.step
import ray_tpu_torch.models.registry, ray_tpu_torch.obs, ray_tpu_torch.util.metrics
import ray_tpu_torch.llm.admission, ray_tpu_torch.llm.openai_api, ray_tpu_torch.llm.batch
import ray_tpu_torch.llm.disagg, ray_tpu_torch.llm.disagg.orchestrator
import dataclasses, torch
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import LLAMA_TINY
from ray_tpu_torch.train import TrainState, adamw, make_train_step
assert EngineConfig(model="llama-tiny").model is LLAMA_TINY
eng = LLMEngine(EngineConfig(model=LLAMA_TINY, num_blocks=32, block_size=4,
                             max_num_seqs=2, max_prefill_len=32), device="cpu")
out = eng.generate([[5, 6, 7]], SamplingParams(max_tokens=3, temperature=0.0))
assert len(out[0]) == 3 and eng.stats()["pipeline"]["dispatches"] > 0
from ray_tpu_torch.llm.spec import SpecConfig
spec = LLMEngine(EngineConfig(model=LLAMA_TINY, num_blocks=32, block_size=4, max_num_seqs=2,
                              max_prefill_len=32, spec=SpecConfig(num_draft_tokens=2)),
                 device="cpu")
assert len(spec.generate([[5, 6, 5, 6, 5]], SamplingParams(max_tokens=4))[0]) == 4
from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator
orch = DisaggOrchestrator(DisaggConfig(engine=EngineConfig(
    model=LLAMA_TINY, num_blocks=32, block_size=4, max_num_seqs=2, max_prefill_len=32)),
    device="cpu")
assert len(orch.generate([[5, 6, 7]], SamplingParams(max_tokens=3, temperature=0.0))[0]) == 3
orch.shutdown()
cfg = dataclasses.replace(LLAMA_TINY, attention_impl="flash", remat=True)
state = TrainState.create(llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                          adamw())
step = make_train_step(lambda p, b: llama.loss_and_weight_fn(p, b, cfg))
toks = torch.randint(0, cfg.vocab_size, (2, 17))
state, m = step(state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
assert torch.isfinite(m["loss"]) and state.step == 1
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
