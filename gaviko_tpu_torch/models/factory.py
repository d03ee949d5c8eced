"""Model factory + trainable-parameter masks for every method.

Port of ``gaviko_tpu/models/factory.py``: each of the eleven methods of
``config.METHODS`` builds a :class:`Model` with ``init(gen, spec) ->
params`` (flat dict, the reference's state_dict names), ``apply(params,
img, spec, train=..., seeds=...) -> logits`` and the reference's
``requires_grad`` semantics as ``trainable(name)``: ``gaviko``; ``linear``
/ ``fft`` / ``bitfit`` (the plain ViT of ``core/vit.py`` with a
trainable-name filter); ``deep_vpt`` / ``shallow_vpt``, ``adaptformer``,
``ssf``, ``melo``, ``dvpt`` and ``evp`` (``models/<method>.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from gaviko_tpu_torch.config import METHODS, ModelSpec, make_spec
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import Params

_BACKBONE_NAMES = ("transformer", "cls_token", "conv_proj", "pos_embedding")


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


def _trainable_vpt(name: str, spec: ModelSpec) -> bool:
    # ref: vpt.py:91-94 — freezes backbone names *inside* the wrapped ViT.
    if not spec.freeze_vit:
        return True
    if name.startswith("vision_transformer."):
        return not _is_backbone(name[len("vision_transformer."):])
    return True


def _frozen_backbone_but(*keep: str) -> Callable[[str, ModelSpec], bool]:
    """The masks of adaptformer (ref: adaptformer.py:164-169), dvpt
    (dvpt.py:156-161), evp (evp.py:322-327) and ssf (ssf.py:204-209): with
    ``freeze_vit`` every backbone name is frozen, then names holding one
    of ``keep`` train again; other names keep their ctor default
    (trainable: evp's and ssf's heads)."""
    def mask(name: str, spec: ModelSpec) -> bool:
        if not spec.freeze_vit:
            return True
        return not _is_backbone(name) or any(k in name for k in keep)

    return mask


def _trainable_melo(name: str, spec: ModelSpec) -> bool:
    # ref: melo.py:62-91 — everything frozen except the LoRA A/B factors and
    # the freshly replaced head.
    return "linear_a_" in name or "linear_b_" in name or "mlp_head" in name


# method -> (module under gaviko_tpu_torch/models, trainable mask)
_PEFT = {
    "deep_vpt": ("vpt", _trainable_vpt),
    "shallow_vpt": ("vpt", _trainable_vpt),
    "adaptformer": ("adaptformer", _frozen_backbone_but("adapter", "head")),
    "dvpt": ("dvpt", _frozen_backbone_but("prompt", "head")),
    "ssf": ("ssf", _frozen_backbone_but("scale", "shift")),
    "evp": ("evp", _frozen_backbone_but("prompt_generator")),
    "melo": ("melo", _trainable_melo),
}


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
    if method in _PEFT:
        import importlib

        name, mask = _PEFT[method]
        module = importlib.import_module(f"gaviko_tpu_torch.models.{name}")
        return Model(spec, module.init, module.apply, mask)
    raise ValueError(f"Unknown method: {method} (known: {METHODS})")
