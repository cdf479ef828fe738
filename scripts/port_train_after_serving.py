#!/usr/bin/env python3
"""Does the train step run slower after the serving phases, in one process, and why?

    python3 scripts/port_train_after_serving.py

On one GPU: chip_smoke.py's train phase (LLAMA_400M, B 8 x S 1024, its
gates) in a fresh process, then chip_smoke's serving phases in the order
its main runs them (engine, lora, api, disagg, parity, spec at LLAMA3_8B),
then the train phase three times: as the serving phases left the process;
after the port's span recorder and metric registry are cleared and a full
collection; after ``gc.freeze()`` (every object alive moved out of the
collector's reach). Each train line carries step ms, the garbage
collector's pauses in the 40 timed steps by generation, and the host
state (threads, recorder traces, registry series, tracked objects). Run
beside an earlier tree's chip_smoke.py (copy this file into its
``scripts/``), the fields its train phase does not print read null. One
JSON line per reading; needs CUDA (exits 1 without it). Imports nothing
of JAX.
"""

from __future__ import annotations

import gc
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def _train(dev, label: str) -> None:
    res = cs.train_phase(dev)
    cs.emit({"control": label, "step_ms": res["step_ms"],
             "linearity_ratio": res["linearity_ratio"],
             **{k: res.get(k) for k in ("gc_pause_ms_timed_steps",
                                        "gc_by_generation_timed_steps",
                                        "left_by_earlier_phases")}})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_train_after_serving: CUDA is not available", file=sys.stderr)
        return 1
    from ray_tpu_torch import obs
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.util import metrics

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.emit({"nvidia_smi": cs.nvidia_smi_line(), "torch": torch.__version__})
    _build.build()
    _train(dev, "fresh process")

    params, params_s = cs.params_8b(dev)
    engine_res = cs.engine_phase(dev, params, params_s)
    cs.lora_phase(dev, params, engine_res)
    cs.api_phase(dev, params, engine_res)
    cs.disagg_phase(dev, params, engine_res)
    del engine_res
    cs.parity_phase(dev)
    cs.spec_phase(dev, params)
    del params
    torch.cuda.empty_cache()

    _train(dev, "after the serving phases")
    # an earlier tree may have neither
    for clear in (getattr(obs.get_recorder(), "clear", None),
                  getattr(metrics, "clear_registry", None)):
        if clear is not None:
            clear()
    gc.collect()
    _train(dev, "after clearing the recorder and registry, and gc.collect()")
    gc.collect()
    gc.freeze()
    _train(dev, "after gc.freeze()")
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
