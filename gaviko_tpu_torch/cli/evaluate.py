"""Evaluation entry point of the PyTorch port — the JAX package's contract:

    python -m gaviko_tpu_torch.cli.evaluate --config <yaml> --method <m> \
        --checkpoint <ckpt> --results_dir <dir> [--device cuda|cpu]

Port of ``gaviko_tpu/cli/evaluate.py``: evaluates on the CSV's ``val``
subset, overlays the trainable-only checkpoint on the model's params,
reports accuracy, quadratic Cohen's kappa and macro one-vs-rest ROC-AUC
(``train/metrics.py``), and writes the versioned
``{method}_{backbone}_eval_results_v{N}.csv`` and its ``_metrics.txt``.
``--quantize int8`` evaluates with the int8 backbone GEMMs (the serving
path's sidecars, added after the checkpoint overlay).

``--artifact model.gaviko --data_path <labels csv> [--image_folder <dir>]``
evaluates a deployment artifact (``cli.export``) instead: the same metrics
and files, the forward from the artifact's program, with no config and no
model build, so the unit that will be served is the one validated. A mesh
artifact runs under ``torchrun --nproc_per_node <data x tp>``: rank 0
evaluates, the other ranks follow it.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os

import numpy as np
import torch

from gaviko_tpu_torch.cli.train import resolve_device
from gaviko_tpu_torch.config import METHODS, apply_method_override, load_config
from gaviko_tpu_torch.data import transforms as T
from gaviko_tpu_torch.data.device_prefetch import stage_batch, wait_staged
from gaviko_tpu_torch.data.pipeline import (
    dataset_from_dataframe, pick_loader, read_csv, split_dataframe)
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.models.pretrained import build_params
from gaviko_tpu_torch.train.loop import make_steps, split_params
from gaviko_tpu_torch.train.losses import make_criterion
from gaviko_tpu_torch.train.metrics import accuracy, cohen_kappa_quadratic, roc_auc_ovr_macro
from gaviko_tpu_torch.utils.compile_cache import enable_compilation_cache
from gaviko_tpu_torch.utils.logging import setup_logging


def versioned_path(results_dir: str, base: str) -> str:
    version = 1
    while True:
        path = os.path.join(results_dir, base.format(version=version))
        if not os.path.exists(path):
            return path
        version += 1


def write_outputs(path: str, mri_paths, outputs) -> None:
    """The two-column ``mri_path,outputs`` CSV (basenames, class ids), as the
    JAX package's pandas ``to_csv(index=False)`` writes it."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["mri_path", "outputs"])
        for p, o in zip(mri_paths, outputs):
            w.writerow([os.path.basename(p), int(o)])


def _finish_eval(valid_df, y_test, y_pred, y_proba, results_dir: str, method: str,
                 backbone: str) -> dict:
    """Metrics + versioned CSV + txt."""
    y_test, y_pred, y_proba = np.asarray(y_test), np.asarray(y_pred), np.asarray(y_proba)
    test_acc = accuracy(y_test, y_pred)
    test_qkv = cohen_kappa_quadratic(y_test, y_pred)
    test_auc = roc_auc_ovr_macro(y_test, y_proba)
    logging.info(f"Test Accuracy: {test_acc}")
    logging.info(f"Test Quadratic Kappa: {test_qkv}")
    logging.info(f"Test AUC: {test_auc}")

    os.makedirs(results_dir, exist_ok=True)
    csv_path = versioned_path(
        results_dir, f"{method}_{backbone.replace('-', '_')}_eval_results_v{{version}}.csv")
    write_outputs(csv_path, [row["mri_path"] for row in valid_df], y_pred.tolist())
    logging.info(f"Results saved to {csv_path}")
    with open(os.path.splitext(csv_path)[0] + "_metrics.txt", "w") as f:
        f.write(f"Test Accuracy: {test_acc}\n")
        f.write(f"Test Quadratic Kappa: {test_qkv}\n")
        f.write(f"Test AUC: {test_auc}\n")
    return {"accuracy": test_acc, "kappa": test_qkv, "auc": test_auc, "csv": csv_path}


def evaluate_artifact(artifact: str, data_path: str, results_dir: str,
                      image_folder: str | None = None, device="cuda") -> dict:
    """Evaluate a deployment artifact on the CSV's ``val`` subset: the
    metrics and files of :func:`evaluate`, the forward from the artifact
    (``deploy.DeployedPredictor``) on ``device``. A mesh artifact runs on
    the data x tp ranks of torchrun's launch: rank 0 evaluates (and
    returns the metrics), the others follow it (and return None)."""
    from gaviko_tpu_torch.deploy import run_on_ranks

    valid_df = split_dataframe(read_csv(data_path), "val")
    if not valid_df:
        raise ValueError(f"no rows with subset=='val' in {data_path}")
    paths = [os.path.join(image_folder, row["mri_path"]) if image_folder else row["mri_path"]
             for row in valid_df]
    y_test = [int(row["kl_grade"]) for row in valid_df]

    def work(pred):
        y_pred, y_proba = [], []
        # One device batch of volumes in host memory at a time.
        for i in range(0, len(paths), pred.batch_size):
            vols = []
            for p in paths[i: i + pred.batch_size]:
                with np.load(p) as z:
                    vols.append(z["data"])
            logits = pred.predict_logits(vols)
            y_pred.extend(np.argmax(logits, axis=1).tolist())
            p = np.exp(logits - logits.max(-1, keepdims=True))
            y_proba.extend((p / p.sum(-1, keepdims=True)).tolist())
        mc = pred.meta["model_config"]
        return _finish_eval(valid_df, y_test, y_pred, y_proba, results_dir, mc["method"],
                            str(mc.get("backbone", "none")))

    return run_on_ranks(artifact, resolve_device(device), work)


def load_model(config: dict, device: torch.device, quantize=None):
    """(model, trainable, frozen) on ``device``: init from seed 0, then the
    ``utils.checkpoint`` overlay (a missing path is an error), then, with
    ``quantize="int8"``, the int8 sidecars."""
    model = build_model(config["model"])
    ckpt = config["utils"].get("checkpoint")
    if ckpt and not os.path.exists(ckpt):
        raise FileNotFoundError(f"Model weights not found at {ckpt}. Please check the path.")
    if not ckpt:
        logging.info(f"Model path is not provided. {config['model']['method']} weights "
                     "are initialized randomly.")
    params = build_params(model, torch.Generator().manual_seed(0),
                          pretrained_dir=config["model"].get("pretrained_dir", "./pretrained"),
                          checkpoint_path=ckpt)
    if quantize == "int8":
        from gaviko_tpu_torch.ops.int8_linear import quantize_backbone

        logging.info("Evaluating with int8 (w8a8) backbone GEMMs")
        params = quantize_backbone(params, model.spec.depth)
    trainable, frozen = split_params(model, {k: v.to(device) for k, v in params.items()})
    return model, trainable, frozen


def evaluate(config: dict, device="cuda") -> dict:
    device = resolve_device(device)
    logging.info(f"Device: {device}")
    valid_df = split_dataframe(read_csv(config["data"]["data_path"]), "val")
    if not valid_df:
        raise ValueError(f"no rows with subset=='val' in {config['data']['data_path']}")
    ds = dataset_from_dataframe(valid_df, T.eval_transform, False,
                                config["data"].get("image_folder"))
    loader = pick_loader(config)(ds, config["data"]["batch_size"], shuffle=False,
                                 num_workers=config["data"].get("num_workers", 8),
                                 pad_to_batch=True)
    model, trainable, frozen = load_model(config, device, config["utils"].get("quantize"))
    _, eval_step, _ = make_steps(model, make_criterion(config["train"]), None)

    y_test, y_pred, y_proba = [], [], []
    for inputs, labels, n_valid in loader:
        x, y, event = stage_batch(inputs, labels, device)
        wait_staged(x, y, event)
        _, _, logits = eval_step(trainable, frozen, x, y)
        logits = logits.cpu().numpy()[:n_valid]
        y_test.extend(labels[:n_valid].tolist())
        y_pred.extend(np.argmax(logits, axis=1).tolist())
        p = np.exp(logits - logits.max(-1, keepdims=True))
        y_proba.extend((p / p.sum(-1, keepdims=True)).tolist())

    return _finish_eval(valid_df, y_test, y_pred, y_proba, config["utils"]["results_dir"],
                        config["model"]["method"], config["model"]["backbone"])


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluation script for Gaviko model "
                                                 "(PyTorch port)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--artifact", type=str, default=None,
                        help="evaluate a deployment artifact (cli.export output) instead of "
                             "building from --config; requires --data_path")
    parser.add_argument("--data_path", type=str, default=None,
                        help="labels CSV (with --artifact; --config runs read data.data_path)")
    parser.add_argument("--image_folder", type=str, default=None,
                        help="npz folder the CSV's mri_path is relative to (with --artifact)")
    parser.add_argument("--results_dir", type=str, default="./outputs")
    parser.add_argument("--checkpoint", type=str, required=False)
    parser.add_argument("--method", type=str, default=None, choices=list(METHODS))
    parser.add_argument("--quantize", type=str, default=None, choices=["int8"],
                        help="evaluate with int8 (w8a8) backbone GEMMs")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    if (args.config is None) == (args.artifact is None):
        parser.error("exactly one of --config or --artifact is required")
    enable_compilation_cache()
    if args.artifact is not None:
        if args.data_path is None:
            parser.error("--artifact requires --data_path (labels CSV)")
        if args.checkpoint is not None:
            parser.error("--checkpoint is baked into the artifact at export time; not "
                         "accepted with --artifact")
        if args.method is not None:
            parser.error("--method is baked into the artifact at export time; not accepted "
                         "with --artifact")
        if args.quantize is not None:
            parser.error("--quantize applies to --config runs; artifacts bake their "
                         "precision in at export time")
        os.makedirs(args.results_dir, exist_ok=True)
        setup_logging(log_dir=args.results_dir)
        return evaluate_artifact(args.artifact, args.data_path, args.results_dir,
                                 image_folder=args.image_folder, device=args.device)
    if args.data_path is not None:
        parser.error("--data_path applies to --artifact runs only; --config runs read "
                     "data.data_path from the YAML")
    if args.image_folder is not None:
        parser.error("--image_folder applies to --artifact runs only; --config runs read "
                     "data.image_folder from the YAML")
    config = load_config(args.config)
    # No --method and none in the YAML: the reference's default ("gaviko").
    if args.method is None and not config["model"].get("method"):
        args.method = "gaviko"
    apply_method_override(config, args.method)
    config["utils"]["results_dir"] = args.results_dir or config["utils"].get("results_dir")
    config["utils"]["checkpoint"] = args.checkpoint
    if args.quantize is not None:
        config["utils"]["quantize"] = args.quantize
    os.makedirs(config["utils"]["results_dir"], exist_ok=True)
    setup_logging(log_dir=config["utils"]["results_dir"])
    logging.info(f"Config: {config}")
    return evaluate(config, args.device)


if __name__ == "__main__":
    main()
