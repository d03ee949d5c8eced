"""Assemble model params: init, then an optional checkpoint overlay.

Port of ``gaviko_tpu/models/pretrained.py``. A missing timm backbone file
warns and continues with random init, as in the JAX package; converting a
timm file that is present is not ported yet (ROADMAP Queue A item 12), so
that raises rather than silently serving random weights.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from gaviko_tpu_torch.core.layers import Params
from gaviko_tpu_torch.models.factory import Model
from gaviko_tpu_torch.weights.state_dict import load_state_dict, merge_states

TIMM_MODEL_NAMES = {
    "vit-b16": "vit_base_patch16_224_in21k",
    "vit-t16": "vit_tiny_patch16_224_in21k",
    "vit-s16": "vit_small_patch16_224_in21k",
    "vit-l16": "vit_large_patch16_224_in21k",
}


def pretrained_key_prefix(method: str) -> str:
    """The prefix the converted timm keys take to reach a wrapped model's
    inner ViT: ``vision_transformer.`` for the VPTs, ``lora_vit.`` for
    MeLO, none elsewhere (the reference loads the inner ViT inside its own
    ctor before wrapping it)."""
    if method in ("deep_vpt", "shallow_vpt"):
        return "vision_transformer."
    if method == "melo":
        return "lora_vit."
    return ""


def _timm_file(backbone: str, pretrained_dir: str) -> Optional[str]:
    name = TIMM_MODEL_NAMES.get(backbone.lower().replace("_", "-"))
    if name is None:
        raise ValueError(f"Unsupported backbone: {backbone}")
    for cand in (name, name + ".pt", name + ".npz"):
        path = os.path.join(pretrained_dir, cand)
        if os.path.exists(path):
            return path
    return None


def build_params(model: Model, gen: torch.Generator,
                 pretrained_dir: Optional[str] = "./pretrained",
                 checkpoint_path: Optional[str] = None) -> Params:
    """init (f32, on ``gen``'s device) -> optional checkpoint overlay."""
    params = model.init(gen, model.spec)
    spec = model.spec
    # The converted timm backbone goes here once A12 is ported, its keys
    # under pretrained_key_prefix(spec.method).
    state = {}
    if spec.backbone is not None and pretrained_dir is not None:
        path = _timm_file(spec.backbone, pretrained_dir)
        if path is not None:
            raise NotImplementedError(
                f"found {path}, but converting timm weights is not ported yet "
                "(ROADMAP Queue A item 12); pass pretrained_dir=None to serve "
                "random init plus a checkpoint")
        logging.warning(
            f"No pretrained weights for {spec.backbone} under {pretrained_dir} "
            "— continuing with random init.")
    if checkpoint_path:
        from gaviko_tpu_torch.weights.torch_io import load_checkpoint

        state = merge_states(state, load_checkpoint(checkpoint_path))
        logging.info(f"Loaded checkpoint overlay from {checkpoint_path}")
    if state:
        params, _, unexpected = load_state_dict(params, state)
        if unexpected:
            logging.info(f"Ignored {len(unexpected)} unmatched checkpoint keys")
    return params
