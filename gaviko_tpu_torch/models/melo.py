"""MeLO: LoRA on q and v of the attention qkv projections.

Port of ``gaviko_tpu/models/melo.py`` (ref: src/model/melo.py). The wrapped
ViT is frozen; each layer of ``lora_layers`` (null: every layer) computes
its packed qkv as ``qkv(h)`` plus rank-r deltas on the q and v thirds,
scaled by ``alpha // r`` (integer division, as in the reference), and
hands it to ``core/vit.attention_block`` as ``qkv_override``: the fused
MHSA runs on it, and under a gradient its backward carries the LoRA
factors' gradients through the packed qkv. The head is a fresh Linear.
Params carry the reference's ``lora_vit.`` prefix, and adapted layers the
nested ``to_qkv.qkv.weight`` name.

MeLO has no custom ``train()``: in training every dropout of the frozen
backbone is live, the embedding's included. The stream is padded once to
a multiple of 8 rows; in the CLS-fast last layer K and V (with the v
delta) span every row and Q (with the q delta) is computed for row 0
alone, by plain GEMMs as in the JAX package.

Under tensor parallelism the LoRA-merged layers run whole on every model
rank (the JAX package splits their qkv rows: the same numbers), and the
layers without LoRA split by heads as the plain ViT's do.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core import init as tinit
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import Params, SeedStream, dropout, layer_norm, linear, proj
from gaviko_tpu_torch.parallel import shard

PREFIX = "lora_vit."


def _lora_layers(spec: ModelSpec):
    return spec.lora_layers if spec.lora_layers is not None else tuple(range(spec.depth))


def _delta(vt: Params, qp: str, ab: str, h: torch.Tensor, scaling: int) -> torch.Tensor:
    return scaling * proj(proj(h, vt[f"{qp}.linear_a_{ab}.weight"]),
                          vt[f"{qp}.linear_b_{ab}.weight"])


def _lora_qkv(vt: Params, qp: str, scaling: int, h: torch.Tensor) -> torch.Tensor:
    """The adapted layer's packed qkv of LN output h: qkv(h) with the
    scaled deltas on its q and v thirds."""
    w = vt[f"{qp}.qkv.weight"]
    dim = w.shape[1]
    qkv = proj(h, w)
    return torch.cat([qkv[..., :dim] + _delta(vt, qp, "q", h, scaling), qkv[..., dim:-dim],
                      qkv[..., -dim:] + _delta(vt, qp, "v", h, scaling)], dim=-1)


def apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
          train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    with shard.within(PREFIX):  # a tensor-parallel shard names the inner ViT's weights
        return _apply(params, img, spec, train=train, seeds=seeds)


def _apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
           train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    vt = {k[len(PREFIX):]: v for k, v in params.items() if k.startswith(PREFIX)}
    lora = set(_lora_layers(spec))
    scaling = spec.alpha // spec.r

    x = vit_core.patchify_embed(vt, "conv_proj.0", img, spec)
    x = vit_core.add_cls_and_pos(vt, x)
    x = dropout(x, spec.emb_dropout, train, seeds)
    n_true = x.shape[1]
    pad = (-n_true) % 8
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    fast = vit_core.cls_fast_enabled(spec)
    for i in range(spec.depth):
        a = f"transformer.layers.{i}.0"
        qp = f"{a}.to_qkv"
        if fast and i == spec.depth - 1:
            # A layer without LoRA may be split over the model ranks: its heads.
            s = None if i in lora else shard.part(f"{a}.to_qkv.weight")
            heads, head0 = vit_core._local_heads(spec, s)
            xn = layer_norm(vt, f"{a}.norm", shard.copy_in(x, s))
            w = vt[f"{qp}.qkv.weight"] if i in lora else vt[f"{a}.to_qkv.weight"]
            dim = w.shape[1] if s is None else w.shape[0] // 3
            kv = proj(xn, w[dim:])
            q0 = proj(xn[:, 0], w[:dim])
            if i in lora:
                kv = torch.cat([kv[..., :dim], kv[..., dim:] + _delta(vt, qp, "v", xn, scaling)],
                               dim=-1)
                q0 = q0 + _delta(vt, qp, "q", xn[:, 0], scaling)
            out = vit_core.cls_attend(kv, q0, spec, n_true=n_true, train=train, seeds=seeds,
                                      heads=heads, head0=head0)
            out = shard.reduce_out(vit_core._out_proj(vt, f"{a}.to_out.0", out.to(x.dtype), s),
                                   s)
            c = x[:, 0] + dropout(out, spec.dropout, train, seeds)
            c = c + vit_core.feedforward_cls_branch(vt, f"transformer.layers.{i}.1", c, spec,
                                                    train=train, seeds=seeds)
            return linear(vt, "mlp_head", layer_norm(vt, "transformer.norm", c))
        override = functools.partial(_lora_qkv, vt, qp, scaling) if i in lora else None
        x = vit_core.attention_block(vt, a, x, spec, train=train, seeds=seeds,
                                     qkv_override=override, n_true=n_true) + x
        x = vit_core.feedforward_block(vt, f"transformer.layers.{i}.1", x, spec, train=train,
                                       seeds=seeds) + x
    x = layer_norm(vt, "transformer.norm", x[:, :n_true])
    return vit_core.pool_and_head(vt, x, spec)


def init(gen: torch.Generator, spec: ModelSpec) -> Params:
    """Random f32 params on ``gen``'s device under the reference's names;
    the LoRA B factors start at zero."""
    lora = set(_lora_layers(spec))
    nested = {f"transformer.layers.{i}.0.to_qkv.weight" for i in lora}
    p: Params = {}
    for k, v in vit_core.vit_init(gen, spec).items():
        p[PREFIX + (k.replace("to_qkv.weight", "to_qkv.qkv.weight") if k in nested else k)] = v
    dim, r = spec.dim, spec.r
    for i in sorted(lora):
        qp = f"{PREFIX}transformer.layers.{i}.0.to_qkv"
        for ab in ("q", "v"):
            p[f"{qp}.linear_a_{ab}.weight"] = tinit.kaiming_uniform(gen, (r, dim), dim)
            p[f"{qp}.linear_b_{ab}.weight"] = torch.zeros(dim, r, device=gen.device)
    # The fresh replacement head keeps torch's default Linear init (melo.py:90-91).
    p[PREFIX + "mlp_head.weight"] = tinit.torch_linear_weight(gen, spec.num_classes, dim)
    p[PREFIX + "mlp_head.bias"] = tinit.torch_linear_bias(gen, spec.num_classes, dim)
    return p
