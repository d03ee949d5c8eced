"""VPT: shallow and deep visual prompt tuning over a wrapped plain ViT.

Port of ``gaviko_tpu/models/vpt.py`` (ref: src/model/vpt.py). Prompts live
in a ``prompt_dim`` space and are projected up by ``prompt_proj``, then
dropped out (``prompt_dropout``; one seed a projection).

- Shallow: the prompts go in once, after the cls row; every layer runs.
- Deep: layer 0 inserts its prompts; each later layer splices in fresh
  ones while dropping the rows at [1, 1 + prompt_dim), as the reference
  indexes ``deep_prompt_embeddings[i].shape[1]``, which is PROMPT_DIM, not
  the number of prompts: at ``prompt_dim`` 64 and 8 prompts the stream
  shrinks by 56 rows a layer (1,009 -> 393 at vit-b16). Each layer's row
  count differs, and the fused route pads it around the fused MHSA.

Training: with ``freeze_vit`` the wrapped ViT stays in eval (no embedding,
attention or MLP dropout) while the prompt dropout stays live, as the
reference's custom ``train()`` leaves them. The last layer runs CLS-query
only where ``cls_fast_enabled`` holds. Params carry the reference's
``vision_transformer.`` prefix on the inner ViT.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core import init as tinit
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import Params, SeedStream, dropout, layer_norm, linear
from gaviko_tpu_torch.parallel import shard

PREFIX = "vision_transformer."


def apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
          train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    with shard.within(PREFIX):  # a tensor-parallel shard names the inner ViT's weights
        return _apply(params, img, spec, train=train, seeds=seeds)


def _apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
           train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    bb_train = train and not spec.freeze_vit
    vt = {k[len(PREFIX):]: v for k, v in params.items() if k.startswith(PREFIX)}

    x = vit_core.patchify_embed(vt, "conv_proj.0", img, spec)
    x = vit_core.add_cls_and_pos(vt, x)
    x = dropout(x, spec.emb_dropout, bb_train, seeds)
    B, P = x.shape[0], spec.num_prompts

    def project_prompts(emb: torch.Tensor) -> torch.Tensor:
        pr = linear(params, "prompt_proj", emb)
        pr = pr.reshape(1, P, -1).expand(B, P, pr.shape[-1]).to(x.dtype)
        return dropout(pr, spec.prompt_dropout, train, seeds)

    def layer(x: torch.Tensor, i: int) -> torch.Tensor:
        a, f = f"transformer.layers.{i}.0", f"transformer.layers.{i}.1"
        x = vit_core.attention_block(vt, a, x, spec, train=bb_train, seeds=seeds) + x
        return vit_core.feedforward_block(vt, f, x, spec, train=bb_train, seeds=seeds) + x

    def last_layer_cls(x: torch.Tensor, i: int) -> torch.Tensor:
        c = x[:, 0] + vit_core.attention_cls_branch(
            vt, f"transformer.layers.{i}.0", x, spec, n_true=x.shape[1], train=bb_train,
            seeds=seeds)
        c = c + vit_core.feedforward_cls_branch(vt, f"transformer.layers.{i}.1", c, spec,
                                                train=bb_train, seeds=seeds)
        return linear(vt, "mlp_head", layer_norm(vt, "transformer.norm", c))

    fast = vit_core.cls_fast_enabled(spec)
    last = spec.depth - 1
    if spec.deep_prompt:
        table = params["deep_prompt_embeddings"]  # (layers, P, prompt_dim)
        for i in range(spec.depth):
            pr = project_prompts(table[i])
            # Not 1 + P: the reference drops 1 + prompt_dim positions.
            x = torch.cat([x[:, :1], pr, x[:, 1 if i == 0 else 1 + spec.prompt_dim:]], dim=1)
            if fast and i == last:
                return last_layer_cls(x, i)
            x = layer(x, i)
    else:
        pr = project_prompts(params["prompt_embeddings"][0])
        x = torch.cat([x[:, :1], pr, x[:, 1:]], dim=1)
        for i in range(spec.depth):
            if fast and i == last:
                return last_layer_cls(x, i)
            x = layer(x, i)
    x = layer_norm(vt, "transformer.norm", x)
    pooled = x.mean(dim=1) if spec.pool == "mean" else x[:, 0]
    return linear(vt, "mlp_head", pooled)


def init(gen: torch.Generator, spec: ModelSpec) -> Params:
    """Random f32 params on ``gen``'s device under the reference's names."""
    p: Params = {PREFIX + k: v for k, v in vit_core.vit_init(gen, spec).items()}
    p["prompt_proj.weight"] = tinit.xavier_uniform(gen, (spec.dim, spec.prompt_dim))
    p["prompt_proj.bias"] = torch.zeros(spec.dim, device=gen.device)
    if spec.deep_prompt:
        p["deep_prompt_embeddings"] = tinit.xavier_uniform(
            gen, (spec.depth, spec.num_prompts, spec.prompt_dim))
    else:
        p["prompt_embeddings"] = tinit.xavier_uniform(
            gen, (1, spec.num_prompts, spec.prompt_dim))
    # init_head_weights (vpt.py:96-99) re-inits the inner ViT head.
    p[PREFIX + "mlp_head.weight"] = tinit.xavier_uniform(gen, (spec.num_classes, spec.dim))
    p[PREFIX + "mlp_head.bias"] = torch.zeros(spec.num_classes, device=gen.device)
    return p
