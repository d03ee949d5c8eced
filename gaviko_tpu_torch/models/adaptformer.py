"""AdaptFormer: a parallel bottleneck adapter beside each MLP block.

Port of ``gaviko_tpu/models/adaptformer.py`` (ref: src/model/adaptformer.py).
A layer runs ``x = attn(x) + x; residual = adapter(x); x = ff(x) + x +
residual``, the adapter LN('in') -> down Linear(dim -> 64) -> ReLU -> up
Linear(64 -> dim) (its dropout has p=0 and its scale is 1.0 in every
config). Layer params: ``transformer.layers.{i}.{0,1,2}`` = attention,
adapter, MLP (the MLP moves from slot 1 to slot 2).

The stream is padded once to a multiple of 8 rows (the adapter and the MLP
act per row, so pad rows are inert); in the CLS-fast last layer the adapter
follows the CLS row. With ``freeze_vit`` the backbone stays in eval, and
the adapters carry no live dropout, so a train step draws no seed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core import init as tinit
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import Params, SeedStream, dropout, layer_norm, linear

ADAPTER_DOWN_DIM = 64  # Adapter ctor default (adaptformer.py:24); no config overrides it


def _adapter(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(p, f"{prefix}.adapter_layer_norm_before", x)  # option 'in'
    h = torch.relu(linear(p, f"{prefix}.down_adapter_proj", h))
    return linear(p, f"{prefix}.up_adapter_proj", h)


def apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
          train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    bb_train = train and not spec.freeze_vit
    x = vit_core.patchify_embed(params, "conv_proj.0", img, spec)
    x = vit_core.add_cls_and_pos(params, x)
    x = dropout(x, spec.emb_dropout, bb_train, seeds)
    n_true = x.shape[1]
    pad = (-n_true) % 8
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    fast = vit_core.cls_fast_enabled(spec)
    for i in range(spec.depth):
        pre = f"transformer.layers.{i}"
        if fast and i == spec.depth - 1:
            c = x[:, 0] + vit_core.attention_cls_branch(
                params, f"{pre}.0", x, spec, n_true=n_true, train=bb_train, seeds=seeds)
            residual = _adapter(params, f"{pre}.1", c)
            c = vit_core.feedforward_cls_branch(params, f"{pre}.2", c, spec, train=bb_train,
                                                seeds=seeds) + c + residual
            return linear(params, "mlp_head", layer_norm(params, "transformer.norm", c))
        x = vit_core.attention_block(params, f"{pre}.0", x, spec, train=bb_train,
                                     seeds=seeds, n_true=n_true) + x
        residual = _adapter(params, f"{pre}.1", x)
        x = vit_core.feedforward_block(params, f"{pre}.2", x, spec, train=bb_train,
                                       seeds=seeds) + x + residual
    x = layer_norm(params, "transformer.norm", x[:, :n_true])
    return vit_core.pool_and_head(params, x, spec)


def init(gen: torch.Generator, spec: ModelSpec) -> Params:
    """Random f32 params on ``gen``'s device under the reference's names;
    the adapters' up projections start at zero (adaptformer.py:49-56)."""
    dev = gen.device
    p: Params = {k.replace(".1.net.", ".2.net."): v
                 for k, v in vit_core.vit_init(gen, spec).items()}
    dim, dd = spec.dim, ADAPTER_DOWN_DIM
    for i in range(spec.depth):
        a = f"transformer.layers.{i}.1"
        p[f"{a}.adapter_layer_norm_before.weight"] = torch.ones(dim, device=dev)
        p[f"{a}.adapter_layer_norm_before.bias"] = torch.zeros(dim, device=dev)
        p[f"{a}.down_adapter_proj.weight"] = tinit.kaiming_uniform(gen, (dd, dim), dim)
        p[f"{a}.down_adapter_proj.bias"] = torch.zeros(dd, device=dev)
        p[f"{a}.up_adapter_proj.weight"] = torch.zeros(dim, dd, device=dev)
        p[f"{a}.up_adapter_proj.bias"] = torch.zeros(dim, device=dev)
    # init_head_weights (adaptformer.py:171-174)
    p["mlp_head.weight"] = tinit.xavier_uniform(gen, (spec.num_classes, dim))
    p["mlp_head.bias"] = torch.zeros(spec.num_classes, device=dev)
    return p
