"""ray_tpu_torch: the PyTorch + CUDA port of ray_tpu, for an NVIDIA H100.

The JAX package ``ray_tpu`` is the reference; this package mirrors its
module paths (``ray_tpu_torch/llm/engine.py`` <-> ``ray_tpu/llm/engine.py``)
and public names, and imports nothing from it. Subpackages load lazily,
so ``import ray_tpu_torch`` needs neither a GPU, ``nvcc`` nor ``triton``:
CUDA kernels are compiled at their first launch (``ops/_build.py``).

Entry points (``LLMEngine``, ``init_params``, ``init_cache``) default to
``device="cuda"``; the CPU is used only when the caller passes
``device="cpu"``, and then every kernel runs as its plain PyTorch version.

The core API (``init``, ``shutdown``, ``remote``, ``get``, ``put``,
``wait``, ``get_actor``, ``kill``, ...) is re-exported lazily from
``ray_tpu_torch.core.api``, as ``ray_tpu`` re-exports its own.
"""

from __future__ import annotations

import importlib

__all__ = ["autoscale", "chaos", "cluster", "cluster_utils", "core", "dashboard", "data",
           "fabric", "fleet", "job_submission", "llm", "models", "nn", "obs", "ops",
           "resolve_device", "scripts", "serve", "train", "util", "utils"]

_SUBPACKAGES = ("autoscale", "chaos", "cluster", "cluster_utils", "core", "dashboard", "data",
                "fabric", "fleet", "job_submission", "llm", "models", "nn", "obs", "ops",
                "scripts", "serve", "train", "util", "utils")


def resolve_device(device) -> "torch.device":  # noqa: F821
    """The torch device an entry point runs on. A CUDA device that is not
    present raises: the port never falls back to the CPU on its own."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    if not name.startswith("__"):
        api = importlib.import_module(f"{__name__}.core.api")
        if hasattr(api, name):
            return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
