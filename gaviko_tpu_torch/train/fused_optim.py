"""Global-norm clip + Adam (per-step beta1) + parameter apply.

Port of ``gaviko_tpu/train/fused_optim.py`` (the JAX package's default
optimizer, XLA there, plain PyTorch here: its Pallas leaf kernel is off by
default and cannot take a cycled beta1). The math is the reference's
torch.optim.Adam + clip_grad_norm_ (src/train.py:185-206, 315-316) with the
JAX package's conventions, which differ from torch's own classes in three
places:

- the clip scale is ``1 if norm < clip else clip / norm`` (torch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6``);
- the lr is the schedule at the count before the step;
- the bias correction uses the count after the step and that step's beta1.

The state is ``FusedAdamState(count, mu, nu)``, as in the JAX package, with
``count`` a host int. A step returns new tensors and leaves its inputs as
they are, as the JAX step does.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
B2 = 0.999  # Adam's beta2, fixed as in the reference
Scalar = Union[float, Callable[[int], float]]


class FusedAdamState(NamedTuple):
    count: int  # completed steps
    mu: Params
    nu: Params


def init(params: Params) -> FusedAdamState:
    return FusedAdamState(
        count=0,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32, on the device."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


@torch.no_grad()
def step(grads: Params, state: FusedAdamState, params: Params, sched: Scalar,
         clip: float = 1.0, b1: Scalar = 0.9, eps: float = 1e-8):
    """-> (new_params, new_state). ``sched`` and ``b1`` are floats or host
    schedules of the pre-step count. The scalars are rounded to f32 as the
    JAX package computes them; the clip scale stays on the device."""
    gn = global_norm(grads)
    scale = torch.where(gn < clip, torch.ones_like(gn), clip / gn)
    f32 = np.float32
    lr = f32(sched(state.count) if callable(sched) else sched)
    beta1 = f32(b1(state.count) if callable(b1) else b1)
    count = state.count + 1
    c1 = f32(1.0) - beta1 ** f32(count)
    c2 = f32(1.0) - f32(B2) ** f32(count)
    new_p, new_m, new_v = {}, {}, {}
    for k, g in grads.items():
        p = params[k]
        g = g * scale.to(g.dtype)
        m = float(beta1) * state.mu[k].float() + float(f32(1.0) - beta1) * g.float()
        v = B2 * state.nu[k].float() + (1.0 - B2) * g.float().square()
        update = (m / float(c1)) / (torch.sqrt(v / float(c2)) + eps)
        # Moments and params keep their storage dtype; the arithmetic is f32.
        new_p[k] = p - (float(lr) * update).to(p.dtype)
        new_m[k] = m.to(p.dtype)
        new_v[k] = v.to(p.dtype)
    return new_p, FusedAdamState(count=count, mu=new_m, nu=new_v)
