"""Training entry point of the PyTorch port — the JAX package's contract:

    python -m gaviko_tpu_torch.cli.train --config <yaml> --method <m> \
        --results_dir <dir> [--resume auto|<resume_state.npz>] [--device cuda|cpu]

Port of ``gaviko_tpu/cli/train.py``: config groups utils / data / model /
train / wandb; per-step CSV logging with the reference's 15 fields;
trainable-only best checkpoints; early stopping; resume and preemption
(``train/loop.py``). The run trains on the CUDA card (``--device cuda``, the
default); without one it stops with an error unless ``--device cpu`` asks
for the CPU, where every kernel runs its plain version. wandb is optional and
gated on ``config['wandb']['enable']``.

With ``train.parallel.enabled`` each process is one rank of the mesh
(``parallel/mesh.py``): launch N of them, e.g. ``torchrun --nproc_per_node N
-m gaviko_tpu_torch.cli.train ...``, or give ``train.parallel``'s
``coordinator_address`` / ``num_processes`` / ``process_id``. Each rank
trains on ``cuda:(LOCAL_RANK % cards)``; ranks that share a card talk over
gloo, else NCCL. One process (``data: auto``) is a 1 x 1 mesh.
"""

from __future__ import annotations

import argparse
import functools
import logging
from datetime import datetime

import torch

from gaviko_tpu_torch.config import METHODS, apply_method_override, load_config
from gaviko_tpu_torch.data import transforms as T
from gaviko_tpu_torch.data.pipeline import (
    dataset_from_dataframe, pick_loader, read_csv, split_dataframe)
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.models.pretrained import build_params
from gaviko_tpu_torch.train.loop import run_training
from gaviko_tpu_torch.utils.compile_cache import enable_compilation_cache
from gaviko_tpu_torch.utils.logging import setup_logging


def resolve_device(device: str) -> torch.device:
    """The device a CLI runs on: a CUDA device must exist; the CPU only when
    asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found: the port runs on the card; pass "
                         "--device cpu to run the plain versions on the CPU")
    return device


def make_loaders(config: dict, shard=(0, 1)):
    """CSV split -> train / val loaders (ref: train.py:33-78); ``shard`` is
    (this rank's index on the data axis, its size): each loader yields that
    shard's rows of every global batch."""
    df = read_csv(config["data"]["data_path"])
    image_folder = config["data"].get("image_folder")
    if config["train"].get("device_augment"):
        # Raw volumes to the card; the step augments and rescales them there
        # (ops/augment.py).
        train_tf, val_tf = T.raw_volume, T.raw_volume
    else:
        train_tf = functools.partial(T.train_transform,
                                     intensity_augs=config["data"].get("intensity_augs", False))
        val_tf = T.eval_transform
    train_ds = dataset_from_dataframe(split_dataframe(df, "train"), train_tf, True,
                                      image_folder)
    val_ds = dataset_from_dataframe(split_dataframe(df, "val"), val_tf, False, image_folder)
    bs = config["data"]["batch_size"]
    nw = config["data"].get("num_workers", 8)
    loader_cls = pick_loader(config)
    # train.seed drives the data stream too (shuffle order and augmentation
    # draws); pad_to_batch keeps every batch one shape, pad rows labelled -100.
    seed = int(config.get("train", {}).get("seed", 0))
    train_loader = loader_cls(train_ds, bs, shuffle=True, num_workers=nw, seed=seed,
                              pad_to_batch=True, shard=shard)
    val_loader = loader_cls(val_ds, bs, shuffle=False, num_workers=nw, seed=seed,
                            pad_to_batch=True, shard=shard)
    return train_loader, val_loader, len(train_ds), len(val_ds)


def train(config: dict, device="cuda") -> dict:
    device = resolve_device(device)
    par_cfg = config["train"].get("parallel") or {}
    shard = (0, 1)
    if par_cfg.get("enabled"):
        from gaviko_tpu_torch.parallel.mesh import init_distributed, mesh_axes, rank_device

        rank, world = init_distributed(par_cfg, device.type)
        data, model_ax = mesh_axes(par_cfg, world)
        device = rank_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        shard = (rank // model_ax, data)
    time_stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    if config.get("wandb", {}).get("enable"):
        try:
            import wandb

            wandb.init(project=config["wandb"]["project"], config=config,
                       name=config["wandb"].get("name", f"run_{time_stamp}"),
                       dir=config["utils"]["log_dir"], save_code=True)
        except ImportError:
            logging.warning("wandb not installed; continuing without it.")
            config["wandb"]["enable"] = False
    logging.info(f"Device: {device}"
                 + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    logging.info(f"Phase: {config['utils'].get('phase')}")

    loaders = make_loaders(config, shard)
    model = build_model(config["model"])
    gen = torch.Generator().manual_seed(int(config["train"].get("seed", 0)))
    params = build_params(model, gen,
                          pretrained_dir=config["model"].get("pretrained_dir", "./pretrained"))
    params = {k: v.to(device) for k, v in params.items()}
    result = run_training(config, model, params, loaders, time_stamp)
    if config.get("wandb", {}).get("enable"):
        import wandb

        wandb.finish()
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description="Training script for Gaviko model (PyTorch port)")
    parser.add_argument("--config", type=str, default="gaviko_tpu_torch/configs/gaviko.yaml",
                        help="Path to the configuration file")
    parser.add_argument("--method", type=str, default="gaviko", choices=list(METHODS),
                        help="Model to train")
    parser.add_argument("--results_dir", type=str, default=None,
                        help="Directory to save results")
    parser.add_argument("--resume", type=str, default=None,
                        help="Path to a resume_state.npz, or 'auto' to pick up the latest "
                             "state in save_dir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    enable_compilation_cache()
    config = load_config(args.config)
    apply_method_override(config, args.method)
    if args.results_dir is not None:
        config["train"]["save_dir"] = args.results_dir
    if args.resume is not None:
        config["train"]["resume"] = args.resume
    setup_logging(log_dir=config["utils"]["log_dir"])
    logging.info(f"Config: {config}")
    try:
        result = train(config, args.device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    if result.get("preempted"):
        logging.info("Preempted cleanly. Continue with: python -m gaviko_tpu_torch.cli.train "
                     "--config %s --method %s --resume auto", args.config, args.method)
    return result


if __name__ == "__main__":
    main()
