"""OneCycle schedules and the AdamW optimizer that uses them (port of
df3d/train/schedules.py).

`adam_onecycle` is the JAX package's optax chain written out:
`clip_by_global_norm(grad_clip)`, then AdamW (b2 0.999, eps 1e-8,
eps_root 0) whose learning rate and b1 come from the OneCycle schedules at
the step count before the update (`optax.inject_hyperparams`). Three
details of optax are kept that `torch.optim` does differently:

* clipping scales by max_norm / norm only when norm >= max_norm, as
  (g / norm) * max_norm (`clip_grad_norm_` divides by norm + 1e-6);
* weight decay reaches every parameter, biases and norm scales too;
* the bias correction 1 - b1^t uses the current b1 of the schedule.

The schedules are evaluated in float32, as the JAX package's jnp code is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from df3d_torch.core import ieee

F32 = np.float32


def _cos_anneal(start: float, end: float, pct) -> np.float32:
    return F32(end) + F32((start - end) / 2.0) * (
        np.cos(F32(np.pi) * pct) + F32(1.0))


def one_cycle_lr(lr_max: float, total_steps: int, div_factor: float = 10.0,
                 pct_start: float = 0.4, final_div: float = 1e4):
    """step -> float32 learning rate: cosine warm-up from lr_max /
    div_factor to lr_max over pct_start of the steps, then cosine down to
    lr_max / final_div."""
    warm = int(total_steps * pct_start)

    def sched(step: int) -> np.float32:
        step = F32(min(step, total_steps))
        if step < warm:
            return _cos_anneal(lr_max / div_factor, lr_max,
                               step / F32(max(warm, 1)))
        return _cos_anneal(lr_max, lr_max / final_div,
                           (step - F32(warm)) / F32(max(total_steps - warm, 1)))

    return sched


def one_cycle_momentum(total_steps: int, moms=(0.95, 0.85),
                       pct_start: float = 0.4):
    """step -> float32 b1, annealed opposite to the learning rate."""
    warm = int(total_steps * pct_start)

    def sched(step: int) -> np.float32:
        step = F32(min(step, total_steps))
        if step < warm:
            return _cos_anneal(moms[0], moms[1], step / F32(max(warm, 1)))
        return _cos_anneal(moms[1], moms[0],
                           (step - F32(warm)) / F32(max(total_steps - warm, 1)))

    return sched


@dataclasses.dataclass
class AdamState:
    """The optimizer's moments, one tensor per parameter, and its count."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every squared gradient entry (optax's
    `global_norm`)."""
    return ieee.sqrt(torch.stack([g.square().sum() for g in grads]).sum())


@dataclasses.dataclass
class AdamOneCycle:
    """Clip, then AdamW with OneCycle learning rate and b1."""

    lr: Callable[[int], np.float32]
    b1: Callable[[int], np.float32]
    weight_decay: float = 0.01
    grad_clip: float = 10.0
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: list[torch.Tensor]) -> AdamState:
        return AdamState([torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The gradients scaled to the global norm `grad_clip` when their
        norm reaches it (one host read of the norm)."""
        norm = float(global_norm(grads))
        if norm < self.grad_clip:
            return list(grads)
        clipped = torch._foreach_div(grads, norm)
        torch._foreach_mul_(clipped, self.grad_clip)
        return clipped

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: AdamState,
               params: list[torch.Tensor]) -> None:
        """One step: `params` and `state` are updated in place (the
        parameters are the model's own tensors)."""
        lr, b1 = self.lr(state.count), self.b1(state.count)
        count = state.count + 1
        g = self.clip(grads)
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(state.mu, float(b1))
        torch._foreach_add_(state.mu, torch._foreach_mul(g, float(F32(1) - b1)))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, float(F32(1 - self.b2)))
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_add_(state.nu, g2)
        mu_hat = torch._foreach_div(state.mu, float(F32(1) - b1 ** F32(count)))
        nu_hat = torch._foreach_div(
            state.nu, float(F32(1) - F32(self.b2) ** F32(count)))
        denom = ieee.foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(upd, torch._foreach_mul(params,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, -float(lr))
        torch._foreach_add_(params, upd)
        state.count = count


def adam_onecycle(lr_max: float, total_steps: int, weight_decay: float = 0.01,
                  grad_clip: float = 10.0, div_factor: float = 10.0,
                  pct_start: float = 0.4) -> AdamOneCycle:
    """pcdet's adam_onecycle: AdamW with OneCycle learning rate and
    momentum and global-norm gradient clipping."""
    return AdamOneCycle(
        one_cycle_lr(lr_max, total_steps, div_factor, pct_start),
        one_cycle_momentum(total_steps, pct_start=pct_start),
        weight_decay, grad_clip)
