"""OneCycle learning rate and Adam beta1 schedules, as host floats.

Port of ``gaviko_tpu/train/schedule.py``, matching
torch.optim.lr_scheduler.OneCycleLR (ref: train.py:197-206): cosine anneal,
two phases, initial_lr = max_lr / div_factor, min_lr = initial_lr /
final_div_factor, warmup of pct_start * total_steps, each schedule called
with the number of completed updates.

OneCycleLR also cycles Adam's beta1 by default (cycle_momentum=True):
max_momentum (0.95) -> base_momentum (0.85) -> max_momentum, inverse to the
lr, and Adam's bias correction uses the step's beta1 (PARITY #19).
``scheduler.cycle_momentum: false`` opts out (fixed beta1 = 0.9).

The schedules are host functions of the step count, so a step needs no
device round trip to know its lr and beta1. torch's own Adam + OneCycleLR
is not used: the optimizer is ``train/fused_optim.py``, whose counting
conventions are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def _anneal(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))


def _two_phase(total_steps: int, pct_start: float, begin: float, peak: float,
               end: float) -> Schedule:
    # torch phase boundaries (OneCycleLR._schedule_phases).
    up_steps = float(pct_start * total_steps) - 1.0
    down_steps = float(total_steps - up_steps - 1.0)

    def schedule(count: int) -> float:
        c = min(float(count), total_steps - 1.0)
        if c <= up_steps:
            pct = min(max(c / max(up_steps, 1e-9), 0.0), 1.0) if up_steps > 0 else 1.0
            return _anneal(begin, peak, pct)
        pct = min(max((c - up_steps) / max(down_steps, 1e-9), 0.0), 1.0)
        return _anneal(peak, end, pct)

    return schedule


def onecycle_cos(max_lr: float, total_steps: int, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    initial_lr = max_lr / div_factor
    return _two_phase(total_steps, pct_start, initial_lr, max_lr,
                      initial_lr / final_div_factor)


def onecycle_cos_host(max_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """The JAX package's host twin of the lr schedule, which ``run_training``
    writes into the CSV's ``lr`` column. It differs from :func:`onecycle_cos`
    only where the warmup is shorter than one step: its pct at step 0 is 0
    (the initial lr), not 1."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps = float(pct_start * total_steps) - 1.0
    down_steps = float(total_steps - up_steps - 1.0)

    def schedule(count: int) -> float:
        c = min(float(count), total_steps - 1.0)
        if c <= up_steps:
            pct = min(max(c / max(up_steps, 1e-9), 0.0), 1.0)
            return _anneal(initial_lr, max_lr, pct)
        pct = min(max((c - up_steps) / max(down_steps, 1e-9), 0.0), 1.0)
        return _anneal(max_lr, min_lr, pct)

    return schedule


def onecycle_beta1(total_steps: int, pct_start: float = 0.3,
                   base_momentum: float = 0.85, max_momentum: float = 0.95) -> Schedule:
    """Adam's beta1 under OneCycleLR: max_momentum at the ends,
    base_momentum at the lr peak."""
    return _two_phase(total_steps, pct_start, max_momentum, base_momentum,
                      max_momentum)


def beta1_from_config(sch_cfg: dict, total_steps: int) -> Optional[Schedule]:
    """The beta1 cycle the reference's scheduler applies, or None when
    ``scheduler.cycle_momentum: false`` opts out (fixed beta1 = 0.9)."""
    if not sch_cfg.get("cycle_momentum", True):
        return None
    return onecycle_beta1(
        total_steps=total_steps,
        pct_start=sch_cfg.get("pct_start", 0.3),
        base_momentum=sch_cfg.get("base_momentum", 0.85),
        max_momentum=sch_cfg.get("max_momentum", 0.95),
    )


def from_config(sch_cfg: dict, total_steps: int) -> Schedule:
    if sch_cfg.get("anneal_strategy", "cos") != "cos":
        raise ValueError("only anneal_strategy: cos is supported")
    if sch_cfg.get("three_phase", False):
        raise ValueError("three_phase is not supported")
    return onecycle_cos(
        max_lr=sch_cfg["max_lr"],
        total_steps=total_steps,
        pct_start=sch_cfg.get("pct_start", 0.3),
        div_factor=sch_cfg.get("div_factor", 25.0),
        final_div_factor=sch_cfg.get("final_div_factor", 1e4),
    )
