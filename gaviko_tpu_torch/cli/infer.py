"""Folder inference entry point of the PyTorch port — the JAX package's contract:

    python -m gaviko_tpu_torch.cli.infer --config <yaml> --method <m> \
        --checkpoint <ckpt> --results_dir <dir> [--device cuda|cpu]

Port of ``gaviko_tpu/cli/infer.py``: scans ``data.image_folder`` for
``*.npz``, predicts argmax classes and writes the versioned
``{method}_{backbone}_inference_results_v{N}.csv``. ``--artifact`` is not
ported (ROADMAP Queue A item 14).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from gaviko_tpu_torch.cli.evaluate import load_model, versioned_path, write_outputs
from gaviko_tpu_torch.cli.train import resolve_device
from gaviko_tpu_torch.config import METHODS, apply_method_override, load_config
from gaviko_tpu_torch.data import transforms as T
from gaviko_tpu_torch.data.device_prefetch import stage_batch, wait_staged
from gaviko_tpu_torch.data.pipeline import dataset_from_dataframe, pick_loader, scan_folder
from gaviko_tpu_torch.train.loop import make_steps
from gaviko_tpu_torch.train.losses import cross_entropy_loss
from gaviko_tpu_torch.utils.logging import setup_logging


def inference(config: dict, device="cuda") -> str:
    device = resolve_device(device)
    logging.info(f"Device: {device}")
    test_df = scan_folder(config["data"]["image_folder"])
    ds = dataset_from_dataframe(test_df, T.eval_transform, False)
    loader = pick_loader(config)(ds, config["data"]["batch_size"], shuffle=False,
                                 num_workers=config["data"].get("num_workers", 8),
                                 pad_to_batch=True)
    model, trainable, frozen = load_model(config, device)
    _, _, predict_step = make_steps(model, cross_entropy_loss, None)

    outputs = []
    for inputs, _, n_valid in loader:
        x, _, event = stage_batch(inputs, None, device)
        wait_staged(x, None, event)
        logits = predict_step(trainable, frozen, x).cpu().numpy()
        outputs.append(np.argmax(logits[:n_valid], axis=1))
    outputs = np.concatenate(outputs, axis=0) if outputs else np.zeros(0, int)
    logging.info(f"Final outputs shape: {outputs.shape}")

    results_dir = config["utils"]["results_dir"]
    os.makedirs(results_dir, exist_ok=True)
    backbone = config["model"]["backbone"].replace("-", "_")
    csv_path = versioned_path(
        results_dir,
        f"{config['model']['method']}_{backbone}_inference_results_v{{version}}.csv")
    write_outputs(csv_path, [row["mri_path"] for row in test_df], outputs.tolist())
    logging.info(f"Results saved to {csv_path}")
    return csv_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Inference script for Gaviko model "
                                                 "(PyTorch port)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--artifact", type=str, default=None,
                        help="not ported yet (ROADMAP Queue A item 14)")
    parser.add_argument("--results_dir", type=str, default="./outputs")
    parser.add_argument("--checkpoint", type=str, required=False)
    parser.add_argument("--method", type=str, default="gaviko", choices=list(METHODS))
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    if args.artifact is not None:
        parser.error("--artifact is not ported yet (ROADMAP Queue A item 14)")
    if args.config is None:
        parser.error("--config is required")
    config = load_config(args.config)
    apply_method_override(config, args.method)
    config["utils"]["results_dir"] = args.results_dir or config["utils"].get("results_dir")
    config["utils"]["checkpoint"] = args.checkpoint
    os.makedirs(config["utils"]["results_dir"], exist_ok=True)
    setup_logging(log_dir=config["utils"]["results_dir"])
    logging.info(f"Config: {config}")
    return inference(config, args.device)


if __name__ == "__main__":
    main()
