"""Train-step construction (counterpart of ``ray_tpu/train/step.py``).

``make_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, {"loss", "grad_norm"})``: forward, backward and the optimizer
update, run eagerly. The reference compiles one donated jitted program;
here the step updates the params and optimizer state in place and
returns the same ``TrainState``, which is the torch form of donation.
The metrics stay on the device, so a loop of steps needs no host sync.

The optimizer is a factory that ``TrainState.create`` binds to the param
leaves; ``adamw`` gives optax.adamw's update with its defaults.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping, Optional

import torch

Params = dict[str, Any]
OptimizerFactory = Callable[[list], torch.optim.Optimizer]


def adamw(learning_rate: float = 3e-4, *, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> OptimizerFactory:
    """optax.adamw as a torch optimizer factory. Same update: bias-corrected
    moments, eps outside the square root, decoupled weight decay applied to
    every leaf (norms and embeddings too, as optax without a mask). The
    decay default is optax's 1e-4, not torch.optim.AdamW's 1e-2."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def param_leaves(params: Params) -> list[torch.Tensor]:
    """The weight tensors of a params dict, in a fixed (insertion) order."""
    out: list[torch.Tensor] = []
    for v in params.values():
        out.extend(param_leaves(v) if isinstance(v, Mapping) else [v])
    return out


@dataclasses.dataclass
class TrainState:
    params: Params
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, params: Params, optimizer: OptimizerFactory) -> "TrainState":
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return cls(params=params, optimizer=optimizer(leaves), step=0)


def _loss_and_weight(out) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, weight); weight 1 for a loss fn that returns a scalar."""
    if isinstance(out, (tuple, list)):
        return out[0], out[1].detach().float()
    return out, torch.ones((), dtype=torch.float32, device=out.device)


def make_train_step(
    loss_fn: Callable[[Params, Any], Any],
    optimizer: Optional[OptimizerFactory] = None,
    mesh=None,
    grad_accum: int = 1,
    profile: bool = False,
):
    """Build ``step(state, batch) -> (state, metrics)``.

    loss_fn(params, batch) -> scalar loss, or (loss, weight) where weight
    is the number of valid tokens the mean was taken over. With
    grad_accum > 1 the batch's leading dim is split into microbatches whose
    losses and grads are combined weighted by ``weight``, so masked batches
    match the unaccumulated result; scalar-returning loss fns get weight 1.
    ``grad_norm`` is the global L2 norm of the grads before the update
    (optax.global_norm). ``optimizer`` is accepted for the reference's
    signature; the step uses the one bound in ``state``.
    """
    if mesh is not None:
        raise NotImplementedError("sharded train steps come with the parallel-training slice")
    if profile:
        raise NotImplementedError("ProfiledTrainStep comes with the measurement slice")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        leaves = param_leaves(state.params)
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss, _ = _loss_and_weight(loss_fn(state.params, batch))
            loss.backward()
        else:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"batch size {n} not divisible by grad_accum {grad_accum}")
            loss_sum = w_sum = 0.0
            for i in range(grad_accum):
                mb = {k: v.chunk(grad_accum, dim=0)[i] for k, v in batch.items()}
                loss_i, w = _loss_and_weight(loss_fn(state.params, mb))
                (loss_i * w).backward()  # grads accumulate g_i * w_i
                loss_sum = loss_sum + loss_i.detach() * w
                w_sum = w_sum + w
            loss = loss_sum / w_sum
            for p in leaves:
                if p.grad is not None:
                    p.grad.div_(w_sum)
        grads = [p.grad for p in leaves if p.grad is not None]
        grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
