"""Training loop: train, eval and predict steps, and the epoch orchestration.

Port of ``gaviko_tpu/train/loop.py``:

- params split into trainable and frozen dicts; gradients flow only to the
  trainable side (the PEFT contract);
- one ``train_step``: forward with dropout, focal loss (or CE), backward,
  then global-norm clip 1.0 + Adam with the OneCycle lr and cycled beta1
  (``train/fused_optim.py``: kernel B13 on the card), or, with
  ``accumulation_steps > 1``, optax ``MultiSteps`` accumulation around it;
  ``fused_optimizer: false`` keeps the optax chain's state layout (the
  same B13 step);
- mixed precision as in the JAX package: with ``train.precision: bf16`` the
  params stay f32 masters and each step casts every f32 param to bf16
  inside the differentiated function, so the gradients reach the f32
  masters through the cast; ``pure_bf16`` casts the params to bf16 once and
  keeps bf16 moments (the reference's ``model.half()``);
- ``run_training``, the reference's orchestration (src/train.py:80-504):
  epochs, the 15-field per-step CSV with the ``len(ds) * (epoch + 1)``
  normalisation (PARITY #15), validation, the trainable-only best
  checkpoint gated on ``save_threshold``, early stopping, resume (``auto``
  or a path; an npz file or, with ``checkpoint_backend: orbax``, an orbax
  directory) with rate-limited epoch-boundary saves, mid-epoch preemption,
  ``train.profile`` through ``torch.profiler`` and ``debug_nans`` as
  autograd anomaly detection.

A step takes its dropout seeds as an input (a ``SeedStream``, or the seeds
themselves), the counterpart of the JAX step's ``rng``; ``run_training``
draws each step's from a ``torch.Generator`` keyed by ``train.seed`` and the
global step, or from ``step_seeds`` (tests feed the JAX package's). With
``train.device_augment`` the loader yields raw volumes: the train step
augments its batch on the device (``ops/augment.py``) with the draws it is
given, drawn the same way (``step_augment``), and eval and predict rescale
on the device.

With ``train.parallel.enabled`` the run is one rank of a data x model mesh
(``parallel/mesh.py``; the process group is joined before, by
``cli/train.py`` or the caller): each rank trains on its loader shard of
every global batch through ``ParallelTrainer``'s step (ZeRO-sharded Adam
with ``zero: true``, tensor-parallel blocks with ``model`` > 1), and the
augmentation draws are the global batch's. Rank 0 makes the decisions a
wall clock or a signal drives (the rate-limited resume save, preemption)
and every rank learns them before any enters the gather of a save; rank 0
alone writes the CSV log, the resume state and the best checkpoint, each
gathered whole.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import Model
from gaviko_tpu_torch.ops.augment import (AugmentParams, draw_augment_params, eval_rescale,
                                          train_augment)
from gaviko_tpu_torch.train import fused_optim
from gaviko_tpu_torch.train import schedule as schedule_lib
from gaviko_tpu_torch.train.losses import make_criterion
from gaviko_tpu_torch.train.preemption import PreemptionGuard

Params = Dict[str, torch.Tensor]
Seeds = Union[SeedStream, Iterable[int], None]
OptState = Union[fused_optim.FusedAdamState, fused_optim.ChainState,
                 fused_optim.MultiStepState]


def split_params(model: Model, params: Params) -> Tuple[Params, Params]:
    trainable = {k: v for k, v in params.items() if model.trainable(k)}
    frozen = {k: v for k, v in params.items() if not model.trainable(k)}
    return trainable, frozen


def make_optimizer(train_cfg: dict, total_steps: int) -> dict:
    """The clip + Adam spec (ref: train.py:185-206, 315-316):
    ``{"sched", "clip", "eps", "b1", "accum", "chain"}``, b1 the cycled
    schedule unless ``scheduler.cycle_momentum: false``, the schedules over
    ``total_steps // accumulation_steps`` updates. Weight decay stays off,
    as in the reference's actual optimizer. ``chain``: the state takes the
    optax chain's layout (``fused_optimizer: false`` at
    ``accumulation_steps: 1``; the JAX package's ``MultiSteps`` wraps that
    chain whatever the flag says). B13 steps either."""
    accum = int(train_cfg.get("accumulation_steps", 1) or 1)
    sched_steps = max(total_steps // accum, 1)
    sched = schedule_lib.from_config(train_cfg["scheduler"], sched_steps)
    b1 = schedule_lib.beta1_from_config(train_cfg["scheduler"], sched_steps)
    eps = 1e-4 if train_cfg.get("fp16") else 1e-8  # ref: train.py:185-189
    return {"sched": sched, "clip": 1.0, "eps": eps,
            "b1": b1 if b1 is not None else 0.9, "accum": accum,
            "chain": accum == 1 and not train_cfg.get("fused_optimizer", True)}


def compute_dtype_of(train_cfg: dict) -> torch.dtype:
    """``train.precision``: bf16 and pure_bf16 compute in bfloat16."""
    precision = train_cfg.get("precision")
    return torch.bfloat16 if precision in ("bf16", "pure_bf16") else torch.float32


def init_opt_state(trainable: Params, fused: Optional[dict] = None) -> OptState:
    """``FusedAdamState`` (``ChainState`` in the chain's layout), or with
    ``accum > 1`` the accumulating ``MultiStepState`` around it."""
    if fused is not None and fused["accum"] > 1:
        return fused_optim.init_multi_steps(trainable)
    return fused_optim.init(trainable, chain=bool(fused and fused.get("chain")))


def opt_template(params: Params, fused: dict) -> OptState:
    """A state of ``fused``'s layout whose tensors are ``params`` (no copy):
    the template a resume file is read into."""
    if fused["accum"] > 1:
        return fused_optim.MultiStepState(0, 0, fused_optim.FusedAdamState(0, params, params),
                                          params)
    return (fused_optim.ChainState if fused.get("chain") else fused_optim.FusedAdamState)(
        0, params, params)


def apply_optimizer(fused: dict, grads: Params, opt_state: OptState, trainable: Params):
    def update(g, state, params):
        return fused_optim.step(g, state, params, fused["sched"], clip=fused["clip"],
                                eps=fused["eps"], b1=fused["b1"])

    if isinstance(opt_state, fused_optim.MultiStepState):
        return fused_optim.multi_step(grads, opt_state, trainable, fused["accum"], update)
    return update(grads, opt_state, trainable)


def _seed_stream(seeds: Seeds) -> Optional[SeedStream]:
    if seeds is None or isinstance(seeds, SeedStream):
        return seeds
    return SeedStream(seeds)


def make_loss_and_grads(model: Model, criterion: Callable,
                        compute_dtype: torch.dtype = torch.float32,
                        device_augment: bool = False) -> Callable:
    """``loss_and_grads(trainable, frozen, inputs, labels, seeds, augment=None)
    -> (loss, logits, grads)``: the differentiated part of a train step,
    gradients with respect to the f32 trainable masters. With
    ``device_augment`` the inputs are raw volumes, augmented first with the
    draws ``augment``."""

    def loss_and_grads(trainable: Params, frozen: Params, inputs: torch.Tensor,
                       labels: torch.Tensor, seeds: Seeds,
                       augment: Optional[AugmentParams] = None):
        if device_augment:
            if augment is None:
                raise ValueError("train.device_augment: the train step needs its "
                                 "augmentation draws (AugmentParams)")
            inputs = train_augment(inputs, augment)
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
               compute_dtype: torch.dtype = torch.float32, device_augment: bool = False):
    """-> (train_step, eval_step, predict_step).

    ``train_step(trainable, opt_state, frozen, inputs, labels, seeds,
    augment=None) -> (trainable, opt_state, loss, correct)``;
    ``eval_step(trainable, frozen, inputs, labels) -> (loss, correct,
    logits)``; ``predict_step(trainable, frozen, inputs) -> logits`` (f32).
    Loss and counts stay on the device: reading them waits for it.

    ``device_augment``: the inputs are RAW volumes. The train step warps,
    flips and rescales them on their device with the draws ``augment``
    (``ops/augment.train_augment``, in f32 before the cast to the compute
    dtype); eval and predict rescale them (``eval_rescale``)."""
    loss_and_grads = make_loss_and_grads(model, criterion, compute_dtype, device_augment)
    prepare = eval_rescale if device_augment else (lambda x: x)

    def train_step(trainable, opt_state, frozen, inputs, labels, seeds, augment=None):
        loss, logits, grads = loss_and_grads(trainable, frozen, inputs, labels, seeds,
                                             augment)
        trainable, opt_state = apply_optimizer(fused, grads, opt_state, trainable)
        correct = (logits.float().argmax(dim=1) == labels).sum()
        return trainable, opt_state, loss, correct

    @torch.no_grad()
    def eval_step(trainable, frozen, inputs, labels):
        logits = _forward(model, compute_dtype, {**frozen, **trainable}, prepare(inputs),
                          False, None).float()
        loss = criterion(logits, labels)
        correct = (logits.argmax(dim=1) == labels).sum()
        return loss, correct, logits

    @torch.no_grad()
    def predict_step(trainable, frozen, inputs):
        return _forward(model, compute_dtype, {**frozen, **trainable}, prepare(inputs),
                        False, None).float()

    return train_step, eval_step, predict_step


def default_step_seeds(seed: int) -> Callable[[int], SeedStream]:
    """Each step's dropout seeds from a ``torch.Generator`` keyed by
    ``train.seed`` and the global step (as the JAX step's rng is
    ``fold_in(PRNGKey(seed), global_step)``), so a resumed run draws the
    seeds the uninterrupted run would have."""
    def seeds(global_step: int) -> SeedStream:
        gen = torch.Generator().manual_seed((seed * 1_000_003 + global_step) % (2 ** 63))
        return SeedStream(generator=gen)

    return seeds


def default_step_augment(seed: int) -> Callable[[int, int], AugmentParams]:
    """Each step's augmentation draws (``draw_augment_params``) from a CPU
    ``torch.Generator`` keyed by ``train.seed`` and the global step, apart
    from the dropout seeds' (as the JAX step splits its rng in two), so a
    resumed run draws what the uninterrupted run would have."""
    def augment(global_step: int, batch: int) -> AugmentParams:
        key = ((seed * 1_000_003 + global_step) * 2 + 1) % (2 ** 63)
        return draw_augment_params(torch.Generator().manual_seed(key), batch)

    return augment


class _NoLog:
    """The CSV log of a rank other than 0 on a mesh: rank 0 writes it."""

    def log(self, data: Dict) -> None:
        pass

    def get_file_path(self) -> None:
        return None


def _host_stats(step_stats) -> Tuple[np.ndarray, np.ndarray]:
    """One device-to-host transfer for an epoch's (loss, correct) scalars."""
    if not step_stats:
        return np.zeros(0), np.zeros(0)
    losses = torch.stack([s[0].float() for s in step_stats]).cpu().numpy()
    corrects = torch.stack([s[1] for s in step_stats]).cpu().numpy()
    return losses.astype(np.float64), corrects.astype(np.float64)


def run_training(config: dict, model: Model, params: Params, loaders, time_stamp: str,
                 step_seeds: Optional[Callable[[int], Seeds]] = None,
                 step_augment: Optional[Callable[[int, int], AugmentParams]] = None) -> dict:
    """The epoch orchestration (ref: train.py:80-504). ``loaders`` is
    (train_loader, val_loader, train_len, val_len) of host batches; the
    params' device is the device the run trains on, and there B13 updates
    the trainable tensors of ``params`` in place (the JAX step donates
    them). ``step_seeds`` maps the global step to that step's dropout seeds
    (default: :func:`default_step_seeds`); with ``train.device_augment``,
    ``step_augment`` maps (global step, batch size) to that step's
    augmentation draws (default: :func:`default_step_augment`).

    Runs under a :class:`PreemptionGuard`: SIGTERM / SIGINT checkpoint the
    full train state at the next step boundary (mid-epoch, with the
    intra-epoch step index) and return with ``result["preempted"] = True``;
    a rerun with ``train.resume: auto`` continues from the exact next batch."""
    with PreemptionGuard() as guard:
        return _run_training(config, model, params, loaders, time_stamp, guard, step_seeds,
                             step_augment)


def _run_training(config: dict, model: Model, params: Params, loaders, time_stamp: str,
                  guard: PreemptionGuard, step_seeds, step_augment) -> dict:
    from gaviko_tpu_torch.data.device_prefetch import DevicePrefetcher, stage_batch, wait_staged
    from gaviko_tpu_torch.utils.checkpoint import (load_train_state, require_tensorstore,
                                                   save_train_state, save_train_state_orbax)
    from gaviko_tpu_torch.utils.logging import (
        TRAIN_LOG_FIELDS, CSVLogger, MemoryUsageLogger, analyze_model_computation,
        forward_flops)
    from gaviko_tpu_torch.weights.torch_io import save_pt

    train_loader, val_loader, train_len, val_len = loaders
    train_cfg = dict(config["train"])
    train_cfg.setdefault("fp16", config["model"].get("fp16", False))
    num_epochs = train_cfg["num_epochs"]
    total_steps = len(train_loader) * num_epochs
    device = next(iter(params.values())).device

    par_cfg = train_cfg.get("parallel") or {}
    mesh = None
    if par_cfg.get("enabled"):
        import torch.distributed as dist

        from gaviko_tpu_torch.parallel.mesh import make_mesh, mesh_axes

        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh(*mesh_axes(par_cfg, world))
    lead = mesh is None or mesh.rank == 0
    csv_logger = (CSVLogger(log_dir=config["utils"]["log_dir"],
                            filename_prefix=f"{config['model']['method']}_training_log",
                            fields=TRAIN_LOG_FIELDS) if lead else _NoLog())
    criterion = make_criterion(train_cfg)
    fused = make_optimizer(train_cfg, total_steps)
    compute_dtype = compute_dtype_of(train_cfg)

    trainable, frozen = split_params(model, params)
    if train_cfg.get("precision") == "pure_bf16":
        # The reference's primary mode is model.half(): fp16 params, grads
        # and Adam moments (train.py:157-159, 185-189). Its analog: params
        # cast once to bf16, bf16 grads and moments (B13's bf16 storage).
        trainable = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                     for k, v in trainable.items()}
        frozen = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                  for k, v in frozen.items()}
    n_tr = sum(v.numel() for v in trainable.values())
    logging.info(f"There are {len(trainable)} trainable params tensors "
                 f"({n_tr:,} elements); {len(frozen)} frozen tensors.")
    device_augment = bool(train_cfg.get("device_augment", False))
    par = None
    if mesh is not None:
        from gaviko_tpu_torch.parallel.mesh import ParallelTrainer

        logging.info(f"Parallel training on mesh data={mesh.data} x model={mesh.model} "
                     f"(rank {mesh.rank})")
        par = ParallelTrainer(model, criterion, fused, mesh, trainable, frozen,
                              zero=bool(par_cfg.get("zero", True)),
                              compute_dtype=compute_dtype, device_augment=device_augment)
        trainable, frozen, opt_state = par.trainable, par.frozen, par.opt_state
        train_step, eval_step = par.train_step, par.eval_step
    else:
        opt_state = init_opt_state(trainable, fused)
        train_step, eval_step, _ = make_steps(model, criterion, fused, compute_dtype,
                                              device_augment)
    step_seeds = step_seeds or default_step_seeds(int(train_cfg.get("seed", 0)))
    step_augment = step_augment or default_step_augment(int(train_cfg.get("seed", 0)))

    # H2D pipelining (train.h2d_prefetch, default on): the next batch
    # uploads on a side stream while the current step computes.
    h2d_prefetch = bool(train_cfg.get("h2d_prefetch", True))

    def _iter_staged(loader):
        if h2d_prefetch:
            return iter(DevicePrefetcher(loader, device))

        def inline():
            for inputs, labels, n in loader:
                x, y, event = stage_batch(inputs, labels, device,
                                          torch.cuda.current_stream(device)
                                          if device.type == "cuda" else None)
                wait_staged(x, y, event)
                yield x, y, n

        return inline()

    memory_logger = MemoryUsageLogger(verbose=train_cfg.get("memory_verbose", False))
    memory_logger.set_sizes(model_bytes=sum(v.numel() * v.element_size()
                                            for v in {**frozen, **trainable}.values()))

    # Debug and observability (SURVEY.md §5): autograd anomaly detection is
    # the eager counterpart of jax_debug_nans (it raises where a backward
    # produces a NaN); torch.profiler is the timeline tracer.
    anomaly_before = torch.is_anomaly_enabled()
    if train_cfg.get("debug_nans"):
        logging.info("debug_nans: torch.autograd anomaly detection is on (it raises where "
                     "a backward function returns NaN)")
        torch.autograd.set_detect_anomaly(True)
    prof_cfg = train_cfg.get("profile") or {}
    prof_start = int(prof_cfg.get("start_step", 10)) if prof_cfg.get("enabled") else -1
    prof_steps = int(prof_cfg.get("num_steps", 3))
    prof_dir = os.path.join(config["utils"]["log_dir"], "profile")
    profiler = None

    val_acc_max = 0.0
    best_epoch = 0
    epoch_since_improvement = 0
    patience = train_cfg["patience"]
    current_epoch = 0
    start_epoch = 0
    resume_skip = 0  # batches of start_epoch already consumed before a preemption
    val_acc = val_loss = train_acc = train_loss = 0.0
    val_step_acc = val_step_loss = train_step_acc = train_step_loss = 0.0
    train_step_n = val_step_n = 0
    flops_done = False
    batch_bytes_set = False
    best_ckpt_path = None
    global_step = 0

    resume_path = train_cfg.get("resume")
    method = config["model"]["method"]
    # train.checkpoint_backend: npz (one file) or orbax (a directory); a
    # resume path loads by what it is, as in the JAX package.
    orbax = train_cfg.get("checkpoint_backend", "npz") == "orbax"
    if orbax:
        require_tensorstore()  # raise before training, not at the first save
    resume_dir = os.path.join(train_cfg["save_dir"], "experiments", method)
    auto_resume = os.path.join(resume_dir, "resume_state" if orbax else "resume_state.npz")
    if resume_path == "auto" and os.path.exists(auto_resume):
        resume_path = auto_resume
    if resume_path and resume_path != "auto" and os.path.exists(resume_path):
        if par is None:
            trainable, opt_state, meta = load_train_state(resume_path, trainable, opt_state)
        else:
            # Every rank reads the whole state and keeps its shard of it.
            whole = par.full_template
            whole, whole_opt, meta = load_train_state(resume_path, whole,
                                                      opt_template(whole, fused))
            trainable, opt_state = par.shard_state(whole, whole_opt)
        start_epoch = meta["epoch"]
        current_epoch = meta["epoch"]
        global_step = meta["global_step"]
        val_acc_max = meta["best_val_acc"]
        best_epoch = meta["best_epoch"]
        epoch_since_improvement = meta["epoch_since_improvement"]
        # Preemption states carry the intra-epoch step index; epoch-boundary
        # states default to 0.
        resume_skip = int(meta.get("step_in_epoch", 0) or 0)
        logging.info(f"Resumed from {resume_path} at epoch {start_epoch}"
                     + (f", step {resume_skip}" if resume_skip else ""))

    sch_cfg = train_cfg["scheduler"]
    sched_host = schedule_lib.onecycle_cos_host(
        sch_cfg["max_lr"], total_steps, sch_cfg.get("pct_start", 0.3),
        sch_cfg.get("div_factor", 25.0), sch_cfg.get("final_div_factor", 1e4))

    def _base_row():
        return {"train_epoch_acc": train_acc, "train_epoch_loss": train_loss,
                "val_epoch_acc": val_acc, "val_epoch_loss": val_loss,
                "best_epoch": best_epoch, "best_val_acc": val_acc_max,
                "time_stamp": time_stamp, "epoch": current_epoch}

    # Optional wandb (ref: train.py:354-361), gated on the config as in the
    # JAX package; cli/train.py turns the flag off when wandb is absent.
    wandb_on = config.get("wandb", {}).get("enable", False) and lead

    def _wandb_log(payload, step):
        if wandb_on:
            import wandb

            wandb.log(payload, step=step)

    def _save_resume(epoch_done: int, step_in_epoch: int = 0):
        """Full train state (params + optimizer + progress). ``step_in_epoch``
        > 0 marks a mid-epoch preemption state; 0 is an epoch boundary. On a
        mesh every rank joins the gather of the whole state and rank 0
        writes it."""
        if not train_cfg.get("save_resume_state", True):
            return None
        whole, whole_opt = ((trainable, opt_state) if par is None
                            else par.gather_state(trainable, opt_state))
        if not lead:
            return None
        os.makedirs(resume_dir, exist_ok=True)
        saver = save_train_state_orbax if orbax else save_train_state
        saver(auto_resume, whole, whole_opt, meta={
            "epoch": epoch_done, "step_in_epoch": step_in_epoch,
            "global_step": global_step, "best_val_acc": val_acc_max,
            "best_epoch": best_epoch, "epoch_since_improvement": epoch_since_improvement})
        return auto_resume

    if mesh is not None:
        from gaviko_tpu_torch.parallel.mesh import host_any, host_decide

    stop_now = False

    def _agreed_preempted() -> bool:
        """Whether to stop for a signal; on a mesh, whether any rank got
        one (every rank learns it at the same step)."""
        nonlocal stop_now
        stop_now = guard.preempted if mesh is None else host_any(guard.preempted, mesh)
        return stop_now

    preempted = False
    # Epoch-boundary saves are rate-limited by wall time
    # (train.resume_save_interval_s, default 600; 0 = every epoch); the first
    # boundary, the final epoch, early stopping and preemption always save.
    resume_interval = float(train_cfg.get("resume_save_interval_s", 600.0))
    last_resume_save = float("-inf")
    try:
        for epoch in range(start_epoch, num_epochs):
            t_epoch = time.time()
            # Resume-exact data order: the loader's RNG follows the true epoch.
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            skip = resume_skip if epoch == start_epoch else 0
            if skip and hasattr(train_loader, "skip_batches"):
                train_loader.skip_batches(min(skip, len(train_loader)))
                logging.info(f"Mid-epoch resume: skipping {skip} already-trained batches "
                             f"of epoch {epoch}")
            elif skip:
                skip = 0  # the loader cannot fast-forward; re-run the epoch fully
            # Loss and #correct stay on the device in the hot loop; one
            # transfer at the end of the epoch.
            step_stats = []  # (loss, correct, n_valid)
            for index, (inputs, labels, n_valid) in enumerate(_iter_staged(train_loader),
                                                              start=skip):
                memory_logger.index = index
                memory_logger.display_before_forward_pass()
                if global_step == prof_start:
                    os.makedirs(prof_dir, exist_ok=True)
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.__enter__()
                    logging.info(f"Profiler trace started -> {prof_dir}")
                memory_logger.display_after_moving_data_to_gpu()
                if not batch_bytes_set:
                    memory_logger.set_sizes(batch_bytes=inputs.numel() * inputs.element_size())
                    batch_bytes_set = True
                # The global batch's draws: a data shard takes its rows.
                augment = (step_augment(global_step,
                                        inputs.shape[0] * (mesh.data if mesh else 1))
                           if device_augment else None)
                trainable, opt_state, loss, correct = train_step(
                    trainable, opt_state, frozen, inputs, labels, step_seeds(global_step),
                    augment)
                memory_logger.display_after_forward_pass()
                memory_logger.display_after_backward_pass()
                memory_logger.display_after_optimization_step()
                global_step += 1
                # n_valid (not the batch size): pad rows carry ignore_index
                # labels that the loss skipped.
                step_stats.append((loss, correct, n_valid))
                if profiler is not None and global_step == prof_start + prof_steps:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profiler.__exit__(None, None, None)
                    profiler.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
                    profiler = None
                    logging.info("Profiler trace stopped")
                if _agreed_preempted():
                    break
            if stop_now:
                # Mid-epoch preemption: the in-flight step finished; save the
                # state pointing at the next unconsumed batch (this partial
                # epoch's CSV rows are dropped, as in the JAX package).
                path = _save_resume(epoch, skip + len(step_stats))
                logging.info("Preempted at epoch %d step %d — resume state saved to %s",
                             epoch, skip + len(step_stats), path)
                preempted = True
                break
            losses, corrects = _host_stats(step_stats)
            current_lr = sched_host(max(global_step - 1, 0))
            num_acc = 0.0
            running_loss = 0.0
            for index, ((loss_v, correct_v), (_, _, bs)) in enumerate(
                    zip(zip(losses, corrects), step_stats), start=skip):
                running_loss += loss_v * bs
                num_acc += correct_v
                # Reference per-step normalization quirk (train.py:329-330).
                train_step_acc = num_acc / (train_len * (epoch + 1))
                train_step_loss = running_loss / (train_len * (epoch + 1))
                train_step_n = epoch * len(train_loader) + index + 1
                lr = sched_host(epoch * len(train_loader) + index)
                csv_logger.log({**_base_row(), "train_step_acc": train_step_acc,
                                "train_step_loss": train_step_loss,
                                "val_step_acc": val_step_acc, "val_step_loss": val_step_loss,
                                "lr": lr, "train_step": train_step_n,
                                "val_step": val_step_n})
                _wandb_log({"train_step_acc": train_step_acc,
                            "train_step_loss": train_step_loss, "lr": lr,
                            "epoch": current_epoch, "train_step": train_step_n},
                           step=train_step_n)
            train_loss = running_loss / max(len(train_loader), 1)
            train_acc = num_acc / max(train_len, 1)
            logging.info(f"Epoch {epoch}: lr={current_lr:.6f} ({time.time() - t_epoch:.1f}s)")

            # ---- validation ----
            val_stats = []
            for index_val, (inputs, labels, n_valid) in enumerate(_iter_staged(val_loader)):
                loss, correct, _ = eval_step(trainable, frozen, inputs, labels)
                if (index_val == 0 and train_cfg.get("flops_calculation")
                        and not flops_done):
                    # On a mesh: this rank's forward of its shard.
                    x = eval_rescale(inputs) if device_augment else inputs
                    apply = (par.forward if par is not None
                             else lambda p, x: model.apply(p, x, model.spec))
                    flops = forward_flops(apply, {**frozen, **trainable}, x.to(compute_dtype))
                    n_total = sum(v.numel() for v in {**frozen, **trainable}.values())
                    analyze_model_computation(n_total, flops, verbose=True)
                    flops_done = True
                val_stats.append((loss, correct, n_valid))
            val_losses, val_corrects = _host_stats(val_stats)
            num_val_acc = 0.0
            running_val_loss = 0.0
            for index_val, ((loss_v, correct_v), (_, _, bs)) in enumerate(
                    zip(zip(val_losses, val_corrects), val_stats)):
                running_val_loss += loss_v * bs
                num_val_acc += correct_v
                val_step_acc = num_val_acc / (val_len * (epoch + 1))
                val_step_loss = running_val_loss / (val_len * (epoch + 1))
                val_step_n = epoch * len(val_loader) + index_val + 1
                csv_logger.log({**_base_row(), "train_step_acc": train_step_acc,
                                "train_step_loss": train_step_loss,
                                "val_step_acc": val_step_acc, "val_step_loss": val_step_loss,
                                "lr": current_lr, "train_step": train_step_n,
                                "val_step": val_step_n})
                _wandb_log({"val_step_acc": val_step_acc, "val_step_loss": val_step_loss,
                            "epoch": current_epoch, "val_step": val_step_n},
                           step=train_step_n)
            val_loss = running_val_loss / max(len(val_loader), 1)
            val_acc = num_val_acc / max(val_len, 1)
            _wandb_log({"train_epoch_loss": train_loss, "train_epoch_acc": train_acc,
                        "val_epoch_loss": val_loss, "val_epoch_acc": val_acc,
                        "best_val_acc": val_acc_max}, step=train_step_n)

            current_epoch += 1
            if val_acc > val_acc_max:
                logging.info(f"Validation accuracy increased ({val_acc_max:.6f} --> "
                             f"{val_acc:.6f}).")
                val_acc_max = val_acc
                best_epoch = current_epoch
                if val_acc_max > train_cfg["save_threshold"]:
                    backbone = config["model"]["backbone"].replace("-", "_")
                    path = os.path.join(
                        resume_dir,
                        f"{method}_{backbone}_best_model_epoch{current_epoch}"
                        f"_acc{val_acc:.4f}.pt")
                    whole = trainable if par is None else par.gather_trainable(trainable)
                    if lead:  # on a mesh rank 0 writes the gathered tensors
                        best_ckpt_path = path
                        os.makedirs(resume_dir, exist_ok=True)
                        save_pt(best_ckpt_path, whole)  # trainable-only (train.py:472-483)
                        logging.info(f"Model saved to {best_ckpt_path}")
                epoch_since_improvement = 0
            else:
                epoch_since_improvement += 1
                logging.info(f"There's no improvement for {epoch_since_improvement} epochs.")
                if epoch_since_improvement >= patience:
                    logging.info("The training halted by early stopping criterion.")
                    # Persist this epoch's boundary state before leaving, so a
                    # rerun with a higher patience does not replay it.
                    _save_resume(current_epoch)
                    break
            logging.info(f"Epoch {epoch + 1}: loss {train_loss:.4f} acc "
                         f"{train_acc * 100:.2f}% | val loss {val_loss:.4f} val acc "
                         f"{val_acc * 100:.2f}%")

            stop_now = _agreed_preempted()
            save_now = (epoch == num_epochs - 1 or resume_interval <= 0 or stop_now
                        or time.monotonic() - last_resume_save >= resume_interval)
            if mesh is not None:
                save_now = host_decide(save_now, mesh)
            if save_now:
                _save_resume(current_epoch)
                last_resume_save = time.monotonic()
            if stop_now:
                # The signal arrived during validation: the epoch is complete
                # and its boundary state saved; stop before the next.
                logging.info("Preempted at the epoch %d boundary.", epoch)
                preempted = True
                break
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
        torch.autograd.set_detect_anomaly(anomaly_before)

    if preempted:
        logging.info("Training preempted — rerun with `--resume auto` to continue.")
    else:
        logging.info("Training completed.")
    return {"best_val_acc": val_acc_max, "best_epoch": best_epoch,
            "best_ckpt_path": best_ckpt_path, "params": {**frozen, **trainable},
            "csv_log": csv_logger.get_file_path(), "preempted": preempted}
