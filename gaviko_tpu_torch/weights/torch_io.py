"""Checkpoints: ``.pt`` (torch) and ``.npz``, read and written.

Port of ``gaviko_tpu/weights/torch_io.py``. The checkpoint contract is the
reference's: the best-val checkpoint holds only the trainable parameters,
and evaluation, inference and serving overlay it on the full params. A
checkpoint written by the JAX trainer (``.pt`` or ``.npz``, bf16 included)
loads here, and a ``.pt`` written here loads in the JAX package's
``load_pt`` and ``build_params``: a plain ``torch.save`` of a name -> CPU
tensor dict, bf16 kept as torch bf16.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gaviko_tpu_torch.weights.from_jax import array_to_tensor


def load_pt(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().clone() for k, v in sd.items()}


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: array_to_tensor(z[k]) for k in z.files}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor, from a ``.npz`` or a torch ``.pt`` file."""
    if path.endswith(".npz"):
        return load_npz(path)
    return load_pt(path)


def save_pt(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """name -> tensor (any device) as a ``.pt`` of contiguous CPU tensors."""
    torch.save({k: v.detach().cpu().contiguous().clone() for k, v in state.items()}, path)
