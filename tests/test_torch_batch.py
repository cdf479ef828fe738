"""The batch processor of ray_tpu_torch held against ray_tpu.llm.batch.

``_EngineStage`` on the same dict batch (a prompt column, then a messages
column) gives the reference's ``generated_text`` (greedy fp32, the same
weights, EOS stripped), and ``build_processor`` hands a dataset's
``map_batches`` the reference's arguments. Over a port ``Dataset`` on the
port's runtime, ``build_processor`` gives the rows the reference's gives
over a reference ``Dataset``: their order, the carried columns and the
generated text.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu_torch import data as tdata
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt
import numpy as np
import pytest
import torch

from ray_tpu.llm.batch import ProcessorConfig as JProcessorConfig
from ray_tpu.llm.batch import _EngineStage as JEngineStage
from ray_tpu.llm.batch import build_processor as jbuild_processor
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import EngineConfig, ProcessorConfig, SamplingParams, build_processor
from ray_tpu_torch.llm.batch import _EngineStage
from ray_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
# tests/test_llm.py::test_batch_processor's engine
ENGINE_KW = dict(num_blocks=64, block_size=4, max_num_seqs=4, max_prefill_len=64)

BATCHES = {
    "prompt": (dict(), {"prompt": [f"item {i}" for i in range(6)] + ["hello world"],
                        "row": list(range(7))}),
    "messages": (dict(messages_column="messages", output_column="reply"),
                 {"messages": [[{"role": "user", "content": f"q{i}"}] for i in range(3)]
                  + [[{"role": "system", "content": "terse"},
                      {"role": "user", "content": "The cat"}]]}),
}


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


def _configs(weights, **kw):
    """The same processor configuration in both packages; greedy, EOS live
    (so a stream that ends on it has the token stripped)."""
    sp = dict(max_tokens=8, temperature=0.0)
    ref = JProcessorConfig(engine=JEngineConfig(model=J_FP32_TINY, **ENGINE_KW),
                           params=weights[0], sampling=JSamplingParams(**sp), batch_size=4, **kw)
    port = ProcessorConfig(engine=EngineConfig(model=FP32_TINY, **ENGINE_KW),
                           params=weights[1], sampling=SamplingParams(**sp), batch_size=4,
                           device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("column", sorted(BATCHES))
def test_engine_stage_equals_reference(weights, column):
    kw, batch = BATCHES[column]
    ref_cfg, port_cfg = _configs(weights, **kw)
    ref = JEngineStage(ref_cfg)(dict(batch))
    got = _EngineStage(port_cfg)(dict(batch))
    out_col = kw.get("output_column", "generated_text")
    assert got == ref
    assert set(got) == set(batch) | {out_col}
    assert len(got[out_col]) == len(next(iter(batch.values())))
    assert any(got[out_col])  # some row decodes to visible text


class _Dataset:
    """A dataset stand-in recording what map_batches is handed."""

    def __init__(self):
        self.calls = []

    def map_batches(self, fn, **kwargs):
        self.calls.append((fn, kwargs))
        return self


def test_build_processor_hands_map_batches_the_reference_arguments(weights):
    ref_cfg, port_cfg = _configs(weights)
    ref_ds, port_ds = _Dataset(), _Dataset()
    assert jbuild_processor(ref_cfg)(ref_ds) is ref_ds
    assert build_processor(port_cfg)(port_ds) is port_ds
    (ref_fn, ref_kw), = ref_ds.calls
    (port_fn, port_kw), = port_ds.calls
    assert ref_fn is JEngineStage and port_fn is _EngineStage
    assert port_kw["fn_constructor_args"] == (port_cfg,)
    strip = lambda kw: {k: v for k, v in kw.items() if k != "fn_constructor_args"}  # noqa: E731
    assert strip(port_kw) == strip(ref_kw) == {"batch_size": 4, "concurrency": 1}


def _rows(batch: dict) -> list:
    n = len(next(iter(batch.values())))
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


def _on_runtime(api, runtime, serve, fn):
    """``fn()`` on a fresh runtime of this package (4 CPUs), torn down
    after, Serve first."""
    serve.shutdown()
    if runtime.is_initialized():
        runtime.shutdown_runtime()
    api.init(num_cpus=4)
    try:
        return fn()
    finally:
        serve.shutdown()
        runtime.shutdown_runtime()


@pytest.mark.parametrize("column", sorted(BATCHES))
def test_build_processor_over_a_dataset_equals_reference(weights, column):
    """The stage on an actor pool of one, batch_size 4: the port's rows
    equal the reference's, in order, every column carried. Prompts come in
    2 blocks; messages in 1, since both packages build a block of equally
    long message lists as a 2-D column, which a ragged block's 1-D one
    cannot be concatenated with."""
    kw, batch = BATCHES[column]
    ref_cfg, port_cfg = _configs(weights, **kw)
    rows, blocks = _rows(batch), 1 if column == "messages" else 2
    ref = _on_runtime(ray_tpu, jrt, jserve, lambda: jbuild_processor(ref_cfg)(
        jdata.from_items(rows, parallelism=blocks)).take_all())
    got = _on_runtime(ray_tpu_torch, trt, tserve, lambda: build_processor(port_cfg)(
        tdata.from_items(rows, parallelism=blocks)).take_all())
    out_col = kw.get("output_column", "generated_text")
    assert len(got) == len(rows) and [set(r) for r in got] == [set(batch) | {out_col}] * len(rows)
    for k in batch:
        assert [np.asarray(r[k]).tolist() for r in got] == [np.asarray(r[k]).tolist()
                                                            for r in ref]
    assert [str(r[out_col]) for r in got] == [str(r[out_col]) for r in ref]
    assert [type(r[out_col]) for r in got] == [type(r[out_col]) for r in ref]
    assert any(r[out_col] for r in got)
