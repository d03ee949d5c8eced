"""Observability: versioned CSV step logs, python logging, FLOPs and memory.

Port of ``gaviko_tpu/utils/logging.py``: ``CSVLogger`` with versioned
``{prefix}_v{N}.csv`` filenames and the reference's 15 train fields;
``setup_logging`` to a timestamped file and the console;
``analyze_model_computation``'s parameter, FLOP and memory summary. The
FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over one
forward (the JAX package asks XLA's cost analysis), and the memory logger
reads ``torch.cuda``'s allocator statistics at the reference's five hook
points of the first step.
"""

from __future__ import annotations

import csv
import logging
import os
from datetime import datetime
from typing import Callable, Dict, Iterable, Optional

import torch


class CSVLogger:
    """Versioned per-step CSV logger (ref: logging.py:9-54)."""

    def __init__(self, log_dir: str, filename_prefix: str = "train_log",
                 fields: Iterable[str] = ("epoch", "loss", "acc", "lr")):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        version = 1
        while True:
            filename = f"{filename_prefix}_v{version}.csv"
            self.filename = os.path.join(log_dir, filename)
            if not os.path.exists(self.filename):
                break
            version += 1
        self.fields = list(fields)
        with open(self.filename, "w", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fields).writeheader()

    def log(self, data: Dict) -> None:
        with open(self.filename, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fields).writerow(data)

    def get_file_path(self) -> str:
        return self.filename


TRAIN_LOG_FIELDS = [
    "epoch", "train_step_acc", "train_step_loss", "train_epoch_loss",
    "val_step_acc", "val_step_loss", "val_epoch_loss", "lr",
    "best_epoch", "best_val_acc", "time_stamp", "train_step", "val_step",
    "train_epoch_acc", "val_epoch_acc",
]  # ref: train.py:85-88


def setup_logging(log_level=logging.INFO, log_dir: str = "./log") -> None:
    os.makedirs(log_dir, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = os.path.join(log_dir, f"{timestamp}.log")
    logging.basicConfig(
        level=log_level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=[logging.FileHandler(log_file, encoding="utf-8"),
                  logging.StreamHandler()],
        force=True,
    )
    logging.info(f"Logging initialized. Log file: {log_file}")


def analyze_model_computation(parameters: int, flops: Optional[int], verbose=True) -> dict:
    """Param-count memory + FLOP summary (ref: logging.py:77-141)."""
    memory_fp32_mb = parameters * 4 / (1024 * 1024)
    results = {
        "parameters": parameters,
        "parameters_millions": round(parameters / 1e6, 2),
        "memory_mb": {
            "fp32": round(memory_fp32_mb, 1),
            "fp16": round(parameters * 2 / (1024 * 1024), 1),
            "int8": round(parameters / (1024 * 1024), 1),
        },
        "training_memory_gb": round(memory_fp32_mb * 3 / 1024, 1),
    }
    if flops is not None:
        results.update({
            "flops": flops,
            "gflops": round(flops / 1e9, 2),
            "tflops": round(flops / 1e12, 3),
        })
    if verbose:
        logging.info(f"MODEL ANALYSIS: {results}")
    return results


def forward_flops(fn: Callable, *args) -> int:
    """FLOPs of one call of ``fn(*args)`` as PyTorch's FlopCounterMode
    counts them (matrix products and convolutions; the hand-written
    kernels are not seen by it)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return int(counter.get_total_flops())


class MemoryUsageLogger:
    """Device-memory snapshots at the reference's five hook points of step 0
    (ref: logging.py:146-340), from ``torch.cuda``'s allocator statistics.

    Eager PyTorch runs the forward, backward and update as separate host
    calls, but the port's train step is one function, so the after-forward
    and after-backward hooks sample the post-step state; the step's
    high-water mark is the ``peak`` field. model_size / data_size mirror the
    reference's fields. On a run without a CUDA device it logs that the
    statistics are unavailable.
    """

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.index = 0
        self.model_bytes: Optional[int] = None
        self.batch_bytes: Optional[int] = None

    def set_sizes(self, model_bytes: Optional[int] = None,
                  batch_bytes: Optional[int] = None) -> None:
        if model_bytes is not None:
            self.model_bytes = model_bytes
        if batch_bytes is not None:
            self.batch_bytes = batch_bytes

    def _snapshot(self, tag: str) -> None:
        if not self.verbose or self.index != 0:
            return
        sizes = ""
        if self.model_bytes is not None:
            sizes += f" model_size={self.model_bytes / 2**20:.1f}MiB"
        if self.batch_bytes is not None:
            sizes += f" data_size={self.batch_bytes / 2**20:.1f}MiB"
        if not torch.cuda.is_available():
            logging.info(f"[memory:{tag}] memory_stats unavailable (no CUDA device){sizes}")
            return
        used = torch.cuda.memory_allocated() / 2**20
        peak = torch.cuda.max_memory_allocated() / 2**20
        limit = torch.cuda.get_device_properties(0).total_memory / 2**20
        logging.info(f"[memory:{tag}] in_use={used:.1f}MiB peak={peak:.1f}MiB "
                     f"limit={limit:.1f}MiB{sizes}")

    def display_before_forward_pass(self, **_):
        self._snapshot("before_forward")

    def display_after_moving_data_to_gpu(self, **_):
        self._snapshot("after_h2d")

    def display_after_forward_pass(self, **_):
        self._snapshot("after_forward")

    def display_after_backward_pass(self, **_):
        self._snapshot("after_backward")

    def display_after_optimization_step(self, **_):
        self._snapshot("after_step")
