"""DVPT: dynamic visual prompt tuning with a gated shared-MLP prompt refresher.

Port of ``gaviko_tpu/models/dvpt.py`` (ref: src/model/dvpt.py). The prompt
tokens and their positional rows are prepended at the input: [prompts (P)
| cls | N patches], 1,051 rows at vit-b16, with no padding. A layer runs
``x = attn(x) + x; prompt = share_MLP(x); x = mlp(x) + x + prompt``, where
share_MLP is QuickGELU -> Linear(dim -> 20) -> a prompt-to-token softmax
cross-attention in the latent (scores in f32, scaled by the FULL model
dim ** -0.5, then cast back after the softmax) -> Linear(20 -> dim) *
``prompt_gate`` (init 0: the refresher starts contributing nothing).

Pool quirk (dvpt.py:77-83): with ``pool: mean`` (the shipped config) the
head sees the mean of ``LN(x[:, :P+1])``, the prompts and cls only, and no
layer runs CLS-query only. With ``freeze_vit`` the backbone stays in eval
and a train step draws no seed. Layer names:
``transformer.layers.{i}.0.{attn,mlp,prompt_proj}``.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core import init as tinit
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import (
    Params, SeedStream, dropout, layer_norm, linear, quick_gelu)

SHARE_MLP_LATENT = 20  # share_MLP ctor constant (dvpt.py:28)


def _share_mlp(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    P = spec.num_prompts
    h = linear(p, f"{prefix}.prompt_key_proj_d", quick_gelu(x))  # [B, P+1+N, 20]
    prompt, cls, tokens = h[:, :P], h[:, P:P + 1], h[:, P + 1:]
    dots = torch.matmul(prompt.float(), tokens.float().transpose(1, 2)) * spec.dim ** -0.5
    attn = torch.softmax(dots, dim=-1).to(h.dtype)
    out = torch.cat([torch.matmul(attn, tokens), cls, tokens], dim=1)
    return linear(p, f"{prefix}.prompt_key_proj_u", out) * p[f"{prefix}.prompt_gate"]


def apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
          train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    bb_train = train and not spec.freeze_vit
    x = vit_core.patchify_embed(params, "conv_proj.0", img, spec)
    B, dt, P = x.shape[0], x.dtype, spec.num_prompts
    cls = params["cls_token"].to(dt).expand(B, 1, spec.dim)
    prompts = params["prompt_embeddings"].to(dt).expand(B, P, spec.dim)
    pos = torch.cat([params["prompt_positional_embedding"], params["pos_embedding"]],
                    dim=1).to(dt)
    x = dropout(torch.cat([prompts, cls, x], dim=1) + pos, spec.emb_dropout, bb_train, seeds)
    for i in range(spec.depth):
        blk = f"transformer.layers.{i}.0"
        x = vit_core.attention_block(params, f"{blk}.attn", x, spec, train=bb_train,
                                     seeds=seeds) + x
        prompt = _share_mlp(params, f"{blk}.prompt_proj", x, spec)
        x = vit_core.feedforward_block(params, f"{blk}.mlp", x, spec, train=bb_train,
                                       seeds=seeds) + x + prompt
    x = layer_norm(params, "transformer.norm", x if spec.pool == "cls" else x[:, :P + 1])
    pooled = x.mean(dim=1) if spec.pool == "mean" else x[:, 0]
    return linear(params, "mlp_head", pooled)


def init(gen: torch.Generator, spec: ModelSpec) -> Params:
    """Random f32 params on ``gen``'s device under the reference's names;
    the gates start at zero."""
    dev = gen.device
    p: Params = {}
    for k, v in vit_core.vit_init(gen, spec).items():
        # ResidualAttentionBlock nests attn / mlp under slot 0 by name.
        for old, new in ((".0.norm.", ".0.attn.norm."), (".0.to_qkv.", ".0.attn.to_qkv."),
                         (".0.to_out.", ".0.attn.to_out."), (".1.net.", ".0.mlp.net.")):
            k = k.replace(old, new)
        p[k] = v
    dim, lat = spec.dim, SHARE_MLP_LATENT
    for i in range(spec.depth):
        s = f"transformer.layers.{i}.0.prompt_proj"
        p[f"{s}.prompt_key_proj_d.weight"] = tinit.torch_linear_weight(gen, lat, dim)
        p[f"{s}.prompt_key_proj_d.bias"] = tinit.torch_linear_bias(gen, lat, dim)
        p[f"{s}.prompt_key_proj_u.weight"] = tinit.torch_linear_weight(gen, dim, lat)
        p[f"{s}.prompt_key_proj_u.bias"] = tinit.torch_linear_bias(gen, dim, lat)
        p[f"{s}.prompt_gate"] = torch.zeros(1, device=dev)
    p["prompt_positional_embedding"] = tinit.normal(gen, (1, spec.num_prompts, dim),
                                                    dim ** -0.5)
    p["prompt_embeddings"] = tinit.normal(gen, (1, spec.num_prompts, dim))
    # init_head_weights (dvpt.py:163-166)
    p["mlp_head.weight"] = tinit.xavier_uniform(gen, (spec.num_classes, dim))
    p["mlp_head.bias"] = torch.zeros(spec.num_classes, device=dev)
    return p
