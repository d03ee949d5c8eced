"""Global-norm clip + Adam (per-step beta1) + parameter apply.

Port of ``gaviko_tpu/train/fused_optim.py`` (the JAX package's default
optimizer). The math is the reference's torch.optim.Adam + clip_grad_norm_
(src/train.py:185-206, 315-316) with the JAX package's conventions, which
differ from torch's own classes in three places:

- the clip scale is ``1 if norm < clip else clip / norm`` (torch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6``);
- the lr is the schedule at the count before the step;
- the bias correction uses the count after the step and that step's beta1.

On CUDA tensors a step is kernel B13 (``ops/fused_adam.py``,
``csrc/fused_adam.cu``): one multi-tensor sum of squares and one update
over every leaf, in place, as the JAX step donates its inputs. On CPU
tensors, and inside ``_build.plain_versions()``, it is the plain per-leaf
version, which returns new tensors. Nothing falls back: a CUDA step launches
the kernel or raises.

The state is ``FusedAdamState(count, mu, nu)``, as in the JAX package, with
``count`` a host int. With ``train.fused_optimizer: false`` the JAX package
runs the optax chain clip -> Adam -> lr schedule instead: the same math, and
a state whose leaves are ``[count, *mu, *nu, count]`` (the clip has none, the
schedule its own count). ``ChainState`` holds that layout and :func:`step`
steps it the same way, by B13. After a step on the card its ``mu`` also carries the
kernel's table of leaves (``ops.fused_adam.AdamTable``), so the next step
rewrites only the grad pointers.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.fused_adam import B2, AdamTable, fused_adam

Params = Dict[str, torch.Tensor]
Scalar = Union[float, Callable[[int], float]]


class FusedAdamState(NamedTuple):
    count: int  # completed steps
    mu: Params
    nu: Params


class ChainState(NamedTuple):
    """The optax chain's state (``fused_optimizer: false``): Adam's count and
    moments; the lr schedule's count, its last leaf, always equals
    ``count``."""
    count: int
    mu: Params
    nu: Params


class _Moments(dict):
    """The first-moment dict of a state stepped on the card, with the
    AdamTable of that step's tensors (which the next step reuses if it
    still holds them)."""
    table = None


def init(params: Params, chain: bool = False) -> Union[FusedAdamState, ChainState]:
    return (ChainState if chain else FusedAdamState)(
        count=0,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def step_scalars(count: int, sched: Scalar, b1: Scalar):
    """(lr, beta1, c1, c2) of the step after ``count`` completed ones,
    rounded to f32 as the JAX package computes them."""
    f32 = np.float32
    lr = f32(sched(count) if callable(sched) else sched)
    beta1 = f32(b1(count) if callable(b1) else b1)
    c1 = f32(1.0) - beta1 ** f32(count + 1)
    c2 = f32(1.0) - f32(B2) ** f32(count + 1)
    return float(lr), float(beta1), float(c1), float(c2)


@torch.no_grad()
def step(grads: Params, state: Union[FusedAdamState, ChainState], params: Params,
         sched: Scalar, clip: float = 1.0, b1: Scalar = 0.9, eps: float = 1e-8):
    """-> (new_params, new_state of the state's class). ``sched`` and ``b1``
    are floats or host schedules of the pre-step count; the clip scale stays
    on the device."""
    keys = list(grads)
    lr, beta1, c1, c2 = step_scalars(state.count, sched, b1)
    mu, nu, p = ([d[k] for k in keys] for d in (state.mu, state.nu, params))
    table = None
    if keys and _build.use_kernel(p[0]):
        table = getattr(state.mu, "table", None)
        if table is None or not table.holds(mu, nu, p):
            table = AdamTable(mu, nu, p)
    new_p, new_m, new_v = fused_adam([grads[k] for k in keys], mu, nu, p, lr, beta1, c1, c2,
                                     clip=clip, eps=eps, table=table)
    new_mu = _Moments(zip(keys, new_m))
    new_mu.table = table
    return (dict(zip(keys, new_p)),
            state._replace(count=state.count + 1, mu=new_mu, nu=dict(zip(keys, new_v))))


class MultiStepState(NamedTuple):
    """The state of :func:`multi_step`: optax ``MultiStepsState``'s counters
    and accumulated gradients around the fused step's state."""
    mini_step: int  # micro-steps accumulated since the last update
    gradient_step: int  # updates applied
    inner: FusedAdamState  # or a mesh rank's ``ShardedAdamState``
    acc: Params  # running mean of this cycle's micro-step gradients


def init_multi_steps(params: Params) -> MultiStepState:
    return MultiStepState(0, 0, init(params), {k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def multi_step(grads: Params, state: MultiStepState, params: Params, k_steps: int,
               update: Callable):
    """Gradient accumulation with optax ``MultiSteps(every_k_schedule=k_steps,
    use_grad_mean=True)`` semantics around ``update(grads, inner, params) ->
    (params, inner)`` (:func:`step`, or a mesh's sharded step on its slices):
    the running mean ``acc + (g - acc) / (n + 1)`` of the micro-step
    gradients, and every k-th micro-step one update on it (the schedules
    count updates, not micro-steps); the params are unchanged in between."""
    n = state.mini_step
    acc = {k: a + (grads[k] - a) / (n + 1) for k, a in state.acc.items()}
    if n + 1 < k_steps:
        return params, MultiStepState(n + 1, state.gradient_step, state.inner, acc)
    params, inner = update(acc, state.inner, params)
    zeros = {k: torch.zeros_like(a) for k, a in acc.items()}
    return params, MultiStepState(0, state.gradient_step + 1, inner, zeros)
