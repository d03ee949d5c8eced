"""Train, eval and predict steps over fp32 master params.

Port of the step half of ``gaviko_tpu/train/loop.py`` (:58-188):

- params split into trainable and frozen dicts; gradients flow only to the
  trainable side (the PEFT contract);
- one ``train_step``: forward with dropout, focal loss (or CE), backward,
  then global-norm clip 1.0 + Adam with the OneCycle lr and cycled beta1
  (``train/fused_optim.py``);
- mixed precision as in the JAX package: the params stay f32 masters, and
  each step casts every f32 param to the compute dtype (``train.precision``:
  bf16 or fp32) inside the differentiated function, so the gradients reach
  the f32 masters through the cast.

A step takes its dropout seeds as an input (a ``SeedStream``, or the seeds
themselves), the counterpart of the JAX step's ``rng``. The epoch
orchestration (``run_training``, the CSV logger, checkpoints, resume,
preemption) is the next slice of the port (ROADMAP Queue A item 8).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch

from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import Model
from gaviko_tpu_torch.train import fused_optim
from gaviko_tpu_torch.train import schedule as schedule_lib

Params = Dict[str, torch.Tensor]
Seeds = Union[SeedStream, Iterable[int], None]


def split_params(model: Model, params: Params) -> Tuple[Params, Params]:
    trainable = {k: v for k, v in params.items() if model.trainable(k)}
    frozen = {k: v for k, v in params.items() if not model.trainable(k)}
    return trainable, frozen


def make_optimizer(train_cfg: dict, total_steps: int) -> dict:
    """The fused clip + Adam spec (ref: train.py:185-206, 315-316):
    ``{"sched", "clip", "eps", "b1"}``, b1 the cycled schedule unless
    ``scheduler.cycle_momentum: false``. Weight decay stays off, as in the
    reference's actual optimizer."""
    accum = int(train_cfg.get("accumulation_steps", 1) or 1)
    if accum > 1:
        raise NotImplementedError(
            "accumulation_steps > 1 is not ported yet (ROADMAP Queue A item 8: "
            "the epoch loop, with the JAX package's MultiSteps accumulation)")
    if not train_cfg.get("fused_optimizer", True):
        raise NotImplementedError(
            "the optax-chain optimizer (fused_optimizer: false) is not ported: "
            "the port has the fused step only (ROADMAP Queue A item 8)")
    sched = schedule_lib.from_config(train_cfg["scheduler"], total_steps)
    b1 = schedule_lib.beta1_from_config(train_cfg["scheduler"], total_steps)
    eps = 1e-4 if train_cfg.get("fp16") else 1e-8  # ref: train.py:185-189
    return {"sched": sched, "clip": 1.0, "eps": eps,
            "b1": b1 if b1 is not None else 0.9}


def compute_dtype_of(train_cfg: dict) -> torch.dtype:
    """``train.precision``: bf16 computes in bfloat16 over f32 masters."""
    precision = train_cfg.get("precision")
    if precision == "pure_bf16":
        raise NotImplementedError(
            "precision: pure_bf16 (bf16 master params) is not ported yet "
            "(ROADMAP Queue A item 8)")
    return torch.bfloat16 if precision == "bf16" else torch.float32


def init_opt_state(trainable: Params) -> fused_optim.FusedAdamState:
    return fused_optim.init(trainable)


def apply_optimizer(fused: dict, grads: Params, opt_state: fused_optim.FusedAdamState,
                    trainable: Params):
    return fused_optim.step(grads, opt_state, trainable, fused["sched"],
                            clip=fused["clip"], eps=fused["eps"], b1=fused["b1"])


def _seed_stream(seeds: Seeds) -> Optional[SeedStream]:
    if seeds is None or isinstance(seeds, SeedStream):
        return seeds
    return SeedStream(seeds)


def make_loss_and_grads(model: Model, criterion: Callable,
                        compute_dtype: torch.dtype = torch.float32) -> Callable:
    """``loss_and_grads(trainable, frozen, inputs, labels, seeds) -> (loss,
    logits, grads)``: the differentiated part of a train step, gradients
    with respect to the f32 trainable masters."""

    def loss_and_grads(trainable: Params, frozen: Params, inputs: torch.Tensor,
                       labels: torch.Tensor, seeds: Seeds):
        leaves = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
        with torch.enable_grad():
            logits = _forward(model, compute_dtype, {**frozen, **leaves}, inputs,
                              True, _seed_stream(seeds))
            loss = criterion(logits.float(), labels)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        return loss.detach(), logits.detach(), grads

    return loss_and_grads


def _forward(model: Model, compute_dtype: torch.dtype, params: Params,
             inputs: torch.Tensor, train: bool, seeds: Optional[SeedStream]):
    if compute_dtype != torch.float32:
        params = {k: v.to(compute_dtype) if v.dtype == torch.float32 else v
                  for k, v in params.items()}
    return model.apply(params, inputs.to(compute_dtype), model.spec, train=train,
                       seeds=seeds)


def make_steps(model: Model, criterion: Callable, fused: dict,
               compute_dtype: torch.dtype = torch.float32):
    """-> (train_step, eval_step, predict_step).

    ``train_step(trainable, opt_state, frozen, inputs, labels, seeds) ->
    (trainable, opt_state, loss, correct)``;
    ``eval_step(trainable, frozen, inputs, labels) -> (loss, correct,
    logits)``; ``predict_step(trainable, frozen, inputs) -> logits`` (f32).
    Loss and counts stay on the device: reading them waits for it."""
    loss_and_grads = make_loss_and_grads(model, criterion, compute_dtype)

    def train_step(trainable, opt_state, frozen, inputs, labels, seeds):
        loss, logits, grads = loss_and_grads(trainable, frozen, inputs, labels, seeds)
        trainable, opt_state = apply_optimizer(fused, grads, opt_state, trainable)
        correct = (logits.float().argmax(dim=1) == labels).sum()
        return trainable, opt_state, loss, correct

    @torch.no_grad()
    def eval_step(trainable, frozen, inputs, labels):
        logits = _forward(model, compute_dtype, {**frozen, **trainable}, inputs,
                          False, None).float()
        loss = criterion(logits, labels)
        correct = (logits.argmax(dim=1) == labels).sum()
        return loss, correct, logits

    @torch.no_grad()
    def predict_step(trainable, frozen, inputs):
        return _forward(model, compute_dtype, {**frozen, **trainable}, inputs,
                        False, None).float()

    return train_step, eval_step, predict_step
