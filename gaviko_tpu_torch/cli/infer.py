"""Folder inference entry point of the PyTorch port — the JAX package's contract:

    python -m gaviko_tpu_torch.cli.infer --config <yaml> --method <m> \
        --checkpoint <ckpt> --results_dir <dir> [--device cuda|cpu]

Port of ``gaviko_tpu/cli/infer.py``: scans ``data.image_folder`` for
``*.npz``, predicts argmax classes and writes the versioned
``{method}_{backbone}_inference_results_v{N}.csv``. ``--artifact
model.gaviko --image_folder <dir>`` runs a deployment artifact
(``cli.export``) instead, with no config and no model build (a mesh
artifact under ``torchrun --nproc_per_node <data x tp>``: rank 0 writes
the CSV, the other ranks follow it).
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
from gaviko_tpu_torch.utils.compile_cache import enable_compilation_cache
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


def inference_artifact(artifact: str, image_folder: str, results_dir: str,
                       device="cuda") -> str:
    """Folder inference from a deployment artifact: the outputs of
    :func:`inference`, the forward from the artifact's program on
    ``device``. A mesh artifact runs on the data x tp ranks of torchrun's
    launch: rank 0 writes the CSV (and returns its path), the others follow
    it (and return None)."""
    from gaviko_tpu_torch.deploy import run_on_ranks

    paths = [row["mri_path"] for row in scan_folder(image_folder)]

    def work(pred):
        outputs = []
        # One device batch of volumes in host memory at a time.
        for i in range(0, len(paths), pred.batch_size):
            vols = []
            for p in paths[i: i + pred.batch_size]:
                with np.load(p) as z:
                    vols.append(z["data"])
            outputs.extend(int(c) for c in pred.predict(vols))
        os.makedirs(results_dir, exist_ok=True)
        mc = pred.meta["model_config"]
        backbone = str(mc.get("backbone", "none")).replace("-", "_")
        csv_path = versioned_path(
            results_dir, f"{mc['method']}_{backbone}_inference_results_v{{version}}.csv")
        write_outputs(csv_path, paths, outputs)
        logging.info(f"Results saved to {csv_path}")
        return csv_path

    return run_on_ranks(artifact, resolve_device(device), work)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Inference script for Gaviko model "
                                                 "(PyTorch port)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--artifact", type=str, default=None,
                        help="run a deployment artifact (cli.export output) instead of "
                             "building from --config; requires --image_folder")
    parser.add_argument("--image_folder", type=str, default=None,
                        help="npz folder to scan (with --artifact; --config runs take it "
                             "from data.image_folder)")
    parser.add_argument("--results_dir", type=str, default="./outputs")
    parser.add_argument("--checkpoint", type=str, required=False)
    parser.add_argument("--method", type=str, default="gaviko", choices=list(METHODS))
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    if (args.config is None) == (args.artifact is None):
        parser.error("exactly one of --config or --artifact is required")
    enable_compilation_cache()
    if args.artifact is not None:
        if args.image_folder is None:
            parser.error("--artifact requires --image_folder")
        if args.checkpoint is not None:
            parser.error("--checkpoint is baked into the artifact at export time; not "
                         "accepted with --artifact")
        os.makedirs(args.results_dir, exist_ok=True)
        setup_logging(log_dir=args.results_dir)
        return inference_artifact(args.artifact, args.image_folder, args.results_dir,
                                  device=args.device)
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
