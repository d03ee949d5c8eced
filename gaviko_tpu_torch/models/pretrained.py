"""Assemble params: init, the timm-converted backbone, a checkpoint overlay.

Port of ``gaviko_tpu/models/pretrained.py``, the reference's loading
topology:
- at build time each model loads the converted timm dict
  (``weights/convert.py``) with strict=False name intersection, so only the
  keys that match land (SURVEY §3.5);
- for wrapped models the converted keys take the wrapper's module name
  (``vision_transformer.`` for VPT, ``lora_vit.`` for MeLO) to reach the
  inner ViT, because the reference loads the inner ViT inside its own ctor
  before wrapping it;
- evaluation, inference and serving overlay the trainable-only checkpoint
  ({**vanilla, **ckpt}, load_pretrained.py:150-156).

A missing timm file warns and continues with random init, as in the JAX
package, unless ``require_pretrained`` is set.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from gaviko_tpu_torch.core.layers import Params
from gaviko_tpu_torch.models.factory import Model
from gaviko_tpu_torch.weights import convert
from gaviko_tpu_torch.weights.state_dict import load_state_dict, merge_states


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


def build_params(model: Model, gen: torch.Generator,
                 pretrained_dir: Optional[str] = "./pretrained",
                 checkpoint_path: Optional[str] = None,
                 require_pretrained: bool = False) -> Params:
    """init (f32, on ``gen``'s device) -> the timm-converted backbone from
    ``pretrained_dir`` if a file is there -> optional checkpoint overlay."""
    params = model.init(gen, model.spec)
    spec = model.spec
    state = {}
    if spec.backbone is not None and pretrained_dir is not None:
        try:
            conv = convert.load_pretrain(spec.backbone, spec.num_patches,
                                         spec.frame_patch_size, pretrained_dir)
            prefix = pretrained_key_prefix(spec.method)
            state = {prefix + k: v for k, v in conv.items()}
            logging.info(f"Loaded pretrained {spec.backbone} from {pretrained_dir}")
        except FileNotFoundError as e:
            if require_pretrained:
                raise
            logging.warning(f"{e} — continuing with random init.")
    if checkpoint_path:
        from gaviko_tpu_torch.weights.torch_io import load_checkpoint

        state = merge_states(state, load_checkpoint(checkpoint_path))
        logging.info(f"Loaded checkpoint overlay from {checkpoint_path}")
    if state:
        params, _, unexpected = load_state_dict(params, state)
        if unexpected:
            logging.info(f"Ignored {len(unexpected)} unmatched checkpoint keys")
    return params
