"""Model factory + trainable-parameter masks.

Port of ``gaviko_tpu/models/factory.py`` for the methods ported so far:
``gaviko``, and ``linear`` / ``fft`` / ``bitfit`` (the plain ViT of
``core/vit.py`` with a trainable-name filter). Every other method raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from gaviko_tpu_torch.config import METHODS, ModelSpec, make_spec
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import Params

_BACKBONE_NAMES = ("transformer", "cls_token", "conv_proj", "pos_embedding")

_NOT_PORTED = {
    "deep_vpt": "Queue A item 11 (models/vpt.py)",
    "shallow_vpt": "Queue A item 11 (models/vpt.py)",
    "adaptformer": "Queue A item 11 (models/adaptformer.py)",
    "ssf": "Queue A item 11 (models/ssf.py)",
    "melo": "Queue A item 11 (models/melo.py)",
    "dvpt": "Queue A item 11 (models/dvpt.py)",
    "evp": "Queue A item 11 (models/evp.py)",
}


def _is_backbone(name: str) -> bool:
    return any(s in name for s in _BACKBONE_NAMES)


def _trainable_linear(name: str, spec: ModelSpec) -> bool:
    # ref: train.py:114-121 — head-only.
    return "head" in name


def _trainable_fft(name: str, spec: ModelSpec) -> bool:
    return True


def _trainable_bitfit(name: str, spec: ModelSpec) -> bool:
    # ref: train.py:129-137 — any bias, plus the head.
    return "bias" in name or "head" in name


_VIT_MASKS = {"linear": _trainable_linear, "fft": _trainable_fft,
              "bitfit": _trainable_bitfit}


def _trainable_gaviko(name: str, spec: ModelSpec) -> bool:
    # ref: gaviko.py:429-434 (applies only when freeze_vit). The aliases are
    # state_dict duplicates that torch's named_parameters() never lists.
    if ".global_query." in name or ".local_query." in name:
        return False
    if not spec.freeze_vit:
        return True
    trainable = True
    if _is_backbone(name):
        trainable = False
    if "head" in name or "prompt" in name or "local_attn" in name:
        trainable = True
    return trainable


@dataclasses.dataclass(frozen=True)
class Model:
    spec: ModelSpec
    init: Callable[..., Params]
    apply: Callable[..., torch.Tensor]
    _trainable: Callable[[str, ModelSpec], bool]

    def trainable(self, name: str) -> bool:
        return self._trainable(name, self.spec)

    def trainable_names(self, params: Params) -> list[str]:
        return [k for k in params if self.trainable(k)]

    def trainable_mask(self, params: Params) -> Dict[str, bool]:
        return {k: self.trainable(k) for k in params}


def build_model(model_cfg: dict) -> Model:
    """config['model'] -> Model with init/apply/trainable."""
    spec = make_spec(model_cfg)
    method = spec.method
    if method in _VIT_MASKS:
        return Model(spec, vit_core.vit_init, vit_core.vit_apply, _VIT_MASKS[method])
    if method == "gaviko":
        from gaviko_tpu_torch.models import gaviko

        return Model(spec, gaviko.init, gaviko.apply, _trainable_gaviko)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported to PyTorch yet: ROADMAP "
            f"{_NOT_PORTED[method]}")
    raise ValueError(f"Unknown method: {method} (known: {METHODS})")
