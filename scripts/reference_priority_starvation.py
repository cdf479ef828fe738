#!/usr/bin/env python3
"""The reference LLMServer's runner and a priority submit, by hand on the CPU.

    JAX_PLATFORMS=cpu python scripts/reference_priority_starvation.py [--trials 10]

``ray_tpu.llm.openai_api._EngineRunner`` holds its lock through each
``engine.step()`` and retakes it at once. Two priority-0 requests (60
greedy tokens each) fill ``max_num_seqs=2``; once both run, a priority-2
request is submitted from the caller's thread. Per trial: how long the
submit waited, how many engine steps ran meanwhile, the engine's
``num_preemptions`` and its ``llm_preemptions_total{reason="priority"}``
series. The port's runner takes the same submit at the next step boundary
(``tests/test_torch_metrics.py::test_priority_submit_preempts_at_the_next_step_boundary``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ray_tpu.llm.engine import EngineConfig, preemption_counter
    from ray_tpu.llm.openai_api import LLMConfig, LLMServer
    from ray_tpu.llm.sampling import SamplingParams
    from ray_tpu.models import llama

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=10)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=jnp.float32)
    for trial in range(args.trials):
        model_id = f"refprio{trial}"
        srv = LLMServer(LLMConfig(model_id=model_id, engine=EngineConfig(
            model=cfg, num_blocks=64, block_size=4, max_num_seqs=2, max_prefill_len=32,
            pipeline_decode=False)))
        eng, runner = srv.engine, srv.runner
        steps = [0]
        step = eng.step

        def counted():
            steps[0] += 1
            return step()

        eng.step = counted
        sp = SamplingParams(max_tokens=60, temperature=0.0, ignore_eos=True)
        queues = [runner.submit([1, 5, 9, 13], sp, tenant="batch")[1],
                  runner.submit([1, 7, 7], sp, tenant="batch")[1]]
        deadline = time.time() + 60
        while len(eng.running) < 2:
            if time.time() > deadline:
                raise RuntimeError("the two priority-0 rows never ran together")
            time.sleep(0.001)
        s0, t0 = steps[0], time.time()
        _rid, q = runner.submit([1, 2, 3], sp, priority=2, tenant="gold")
        waited_s, waited_steps = time.time() - t0, steps[0] - s0
        for qq in queues + [q]:
            out = qq.get(timeout=120)
            while not out.finished:
                out = qq.get(timeout=120)
        prio = preemption_counter().series().get((model_id, "batch", "priority"), 0.0)
        print(f"trial {trial}: submit_wait_s={waited_s:.3f} steps_waited={waited_steps} "
              f"num_preemptions={eng.num_preemptions} priority_series={prio}", flush=True)
        srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
