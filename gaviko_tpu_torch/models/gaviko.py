"""GAViKO: dual-stream prompt-fused 3D ViT (the flagship model).

Port of ``gaviko_tpu/models/gaviko.py``. Forward: patchify -> global stream
= [prompts(P) | cls | N image tokens] + [prompt pos-emb | pos-emb]; local
stream = image tokens + pos_emb[1:]. Per layer i, with j = i // share_factor:

    local  = local_attns[j](local) + local     # masked 1-head attn, 20-d latent
    global = attns[i](global) + global         # full MHSA
    prompt = prompt_projs[j](global, local)    # Awakening_Prompt (GPA)
    global = mlps[i](global) + global + prompt

Head: Linear over the mean of [prompts | cls].

Reproduced reference quirks (as in the JAX package):
- local attention scales scores by the FULL model dim ** -0.5, not the 20-d
  latent;
- the GPA's global context double-slices ``global_img_latent[:, P+1:]``;
- the GPA passes cls/image/pad rows through proj_up unscaled;
- ``global_query``/``local_query`` are state_dict aliases of the fusion
  ``query_proj`` entries, held as separate copies;
- init zeroes local proj_down.bias and never proj_up.bias.

Training (``train=True``): the local branch trains with ``attn_drop``
inside the local attention kernel and ``proj_drop`` after its proj_up, two
seeds a layer. With ``freeze_vit: true``, the shipped config, the backbone
stays in eval (no embedding, attention or MLP dropout; gradients still flow
through every frozen global layer to the prompts). With ``freeze_vit:
false`` the backbone trains too, as the reference's custom ``train()``
leaves it: both embedding dropouts, then per layer the attention's and
the MLP's dropout sites of ``core/vit.py``, in the JAX package's seed order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core import init as tinit
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import (
    Params, SeedStream, dropout, gelu, layer_norm, linear, quick_gelu)
from gaviko_tpu_torch.ops.local_attention import masked_local_attention
from gaviko_tpu_torch.parallel import shard


def n_unique(spec: ModelSpec) -> int:
    return math.ceil(spec.depth / spec.share_factor)


def aliases(spec: ModelSpec) -> dict[str, str]:
    """alias key -> canonical key (duplicate state_dict entries in torch)."""
    out = {}
    for j in range(n_unique(spec)):
        pp = f"transformer.prompt_projs.{j}"
        for kind, attn in (("global", "global_attention"), ("local", "local_attention")):
            for leaf in ("weight", "bias"):
                out[f"{pp}.{kind}_query.{leaf}"] = f"{pp}.{attn}.query_proj.{leaf}"
    return out


def _local_self_attention(p: Params, prefix: str, x: torch.Tensor,
                          spec: ModelSpec, *, train: bool = False,
                          seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """Branch output (the caller adds the residual). In training, attention
    dropout runs inside the kernel (one seed), then proj_drop (one seed)."""
    h = layer_norm(p, f"{prefix}.norm", x)
    h = linear(p, f"{prefix}.proj_down", h)  # [B, N, local_dim]
    qkv = F.linear(h, p[f"{prefix}.qkv.weight"])  # qkv_bias=False
    q, k, v = qkv.chunk(3, dim=-1)  # strided views; the kernel reads them
    drop = spec.attn_drop if train else 0.0
    # The kernels' salt is the batch row: a data shard folds its first row in.
    out = masked_local_attention(
        q, k, v, scale=spec.dim ** -0.5,  # full model dim (reference quirk)
        DHW=spec.DHW, local_k=spec.local_k,
        seed=shard.fold_seed(seeds.next_seed(), salts=1) if drop > 0.0 else None,
        dropout_rate=drop)
    out = linear(p, f"{prefix}.proj_up", out)
    return dropout(out, spec.proj_drop, train, seeds)


def _fusion_cross_attention(q: torch.Tensor, tokens: torch.Tensor,
                            latent_dim: int) -> torch.Tensor:
    """Single-head cross-attention in the latent space, f32 scores."""
    dots = torch.matmul(q.float(), tokens.float().transpose(1, 2)) * latent_dim ** -0.5
    attn = torch.softmax(dots, dim=-1).to(tokens.dtype)
    return torch.matmul(attn, tokens)


def _awakening_prompt(p: Params, prefix: str, x: torch.Tensor,
                      local_tokens: torch.Tensor, spec: ModelSpec,
                      n_true: Optional[int] = None,
                      rows_out: Optional[int] = None) -> torch.Tensor:
    """GPA module. ``n_true`` marks the real global stream length when it
    carries tail padding: pad rows are left out of the cross-attention token
    sets and ride through proj_up in place. ``rows_out`` emits only the
    first ``rows_out`` rows (the last-layer fast path)."""
    P = spec.num_prompts
    lat = spec.prompt_latent_dim
    n_true = x.shape[1] if n_true is None else n_true

    both = quick_gelu(linear(p, f"{prefix}.proj_down.0",
                             torch.cat([x, local_tokens], dim=1)))
    x_latent = both[:, : x.shape[1]]
    local_latent = both[:, x.shape[1]:]
    prompts_latent = x_latent[:, :P]
    cls_latent = x_latent[:, P:P + 1]
    global_img_latent = x_latent[:, P + 1:n_true]  # excludes tail padding

    # PromptRelevantEstimator: LN -> Linear(lat, 64) -> GELU -> Linear(64, P) -> Sigmoid
    ca = f"{prefix}.cls_analyzer.cls_analyzer_"
    h = gelu(linear(p, f"{ca}.1", layer_norm(p, f"{ca}.0", cls_latent)))
    prompt_importance = torch.sigmoid(linear(p, f"{ca}.3", h))  # [B, 1, P]

    # PromptContextFusion: LN -> Linear(lat, 1) -> Sigmoid
    gb = f"{prefix}.gl_balancer.gl_balancer_"
    g = torch.sigmoid(linear(p, f"{gb}.1", layer_norm(p, f"{gb}.0", cls_latent)))

    q_g = linear(p, f"{prefix}.global_attention.query_proj", prompts_latent)
    global_context = _fusion_cross_attention(q_g, global_img_latent[:, P + 1:], lat)
    q_l = linear(p, f"{prefix}.local_attention.query_proj", prompts_latent)
    local_context = _fusion_cross_attention(q_l, local_latent, lat)

    fused = g * global_context + (1 - g) * local_context
    enhanced = fused * prompt_importance.transpose(1, 2)  # [B, P, lat]

    parts = [enhanced, cls_latent, global_img_latent]
    if n_true != x.shape[1]:
        parts.append(x_latent[:, n_true:])  # pad rows ride along unscaled
    combined = torch.cat(parts, dim=1)
    if rows_out is not None:
        combined = combined[:, :rows_out]
    return linear(p, f"{prefix}.proj_up", combined)


def apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
          train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """img [B, C, D, H, W] in the working dtype -> logits [B, num_classes].
    ``train`` turns on the local branch's dropout, and the backbone's unless
    ``freeze_vit``, drawing one seed a site from ``seeds`` (the JAX
    package's ``rng``)."""
    bb_train = train and not spec.freeze_vit
    P = spec.num_prompts
    x = vit_core.patchify_embed(params, "conv_proj.0", img, spec)
    B, _, _ = x.shape
    dt = x.dtype

    cls = params["cls_token"].to(dt).expand(B, 1, spec.dim)
    prompts = params["prompt_embeddings"].to(dt).expand(B, P, spec.dim)
    pos = torch.cat([params["prompt_positional_embedding"],
                     params["pos_embedding"]], dim=1).to(dt)
    global_tokens = dropout(torch.cat([prompts, cls, x], dim=1) + pos, spec.emb_dropout,
                            bb_train, seeds)
    local_tokens = dropout(x + params["pos_embedding"][:, 1:, :].to(dt), spec.emb_dropout,
                           bb_train, seeds)

    # Pad the global stream once to a multiple of 8 (P+1+N = 1033 -> 1040 at
    # the shipped config): attention masks keys >= n_true and the GPA leaves
    # pad rows out of its token sets, so the result is exact.
    n_true = global_tokens.shape[1]
    g_pad = (-n_true) % 8
    if g_pad:
        global_tokens = F.pad(global_tokens, (0, 0, 0, g_pad))

    # Last-layer fast path: the head pools rows [0, P+1) only, so the last
    # MLP, proj_up and final LN shrink to those rows (the last global
    # attention still runs full width: the GPA reads its output).
    for i in range(spec.depth):
        last = i == spec.depth - 1
        j = i // spec.share_factor
        local_tokens = _local_self_attention(
            params, f"transformer.local_attns.{j}", local_tokens, spec,
            train=train, seeds=seeds) + local_tokens
        global_tokens = vit_core.attention_block(
            params, f"transformer.attns.{i}", global_tokens, spec, train=bb_train,
            seeds=seeds, n_true=n_true) + global_tokens
        prompt = _awakening_prompt(
            params, f"transformer.prompt_projs.{j}", global_tokens, local_tokens,
            spec, n_true=n_true, rows_out=P + 1 if last else None)
        if last:
            rows = global_tokens[:, : P + 1]
            rows = vit_core.feedforward_block(
                params, f"transformer.mlps.{i}", rows, spec, train=bb_train,
                seeds=seeds) + rows + prompt
            out = layer_norm(params, "transformer.norm", rows)
            return linear(params, "mlp_head.head", out.mean(dim=1))
        global_tokens = vit_core.feedforward_block(
            params, f"transformer.mlps.{i}", global_tokens, spec, train=bb_train,
            seeds=seeds) + global_tokens + prompt
    raise ValueError("spec.depth must be >= 1")


def init(gen: torch.Generator, spec: ModelSpec) -> Params:
    """Random f32 params on ``gen``'s device, under the torch state_dict names."""
    dim, mlp, lat, ldim = spec.dim, spec.mlp_dim, spec.prompt_latent_dim, spec.local_dim
    inner = spec.heads * spec.dim_head
    P = spec.num_prompts
    pd = spec.frame_patch_size
    ph, pw = spec.image_patch_size
    dev = gen.device

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    p: Params = {}
    p["conv_proj.0.weight"] = tinit.torch_conv3d_weight(gen, dim, spec.channels, (pd, ph, pw))
    p["conv_proj.0.bias"] = tinit.torch_conv3d_bias(gen, dim, spec.channels, (pd, ph, pw))
    p["pos_embedding"] = tinit.normal(gen, (1, spec.num_patches + 1, dim))
    p["cls_token"] = tinit.normal(gen, (1, 1, dim))

    for i in range(spec.depth):
        a = f"transformer.attns.{i}"
        p[f"{a}.norm.weight"] = ones(dim)
        p[f"{a}.norm.bias"] = zeros(dim)
        p[f"{a}.to_qkv.weight"] = tinit.torch_linear_weight(gen, inner * 3, dim)
        p[f"{a}.to_out.0.weight"] = tinit.torch_linear_weight(gen, dim, inner)
        p[f"{a}.to_out.0.bias"] = tinit.torch_linear_bias(gen, dim, inner)
        f = f"transformer.mlps.{i}"
        p[f"{f}.net.0.weight"] = ones(dim)
        p[f"{f}.net.0.bias"] = zeros(dim)
        p[f"{f}.net.1.weight"] = tinit.torch_linear_weight(gen, mlp, dim)
        p[f"{f}.net.1.bias"] = tinit.torch_linear_bias(gen, mlp, dim)
        p[f"{f}.net.4.weight"] = tinit.torch_linear_weight(gen, dim, mlp)
        p[f"{f}.net.4.bias"] = tinit.torch_linear_bias(gen, dim, mlp)
    p["transformer.norm.weight"] = ones(dim)
    p["transformer.norm.bias"] = zeros(dim)

    for j in range(n_unique(spec)):
        la = f"transformer.local_attns.{j}"
        p[f"{la}.norm.weight"] = ones(dim)
        p[f"{la}.norm.bias"] = zeros(dim)
        p[f"{la}.proj_down.weight"] = tinit.xavier_uniform(gen, (ldim, dim), gain=0.5)
        p[f"{la}.proj_down.bias"] = zeros(ldim)
        p[f"{la}.qkv.weight"] = tinit.xavier_uniform(gen, (ldim * 3, ldim), gain=1.0)
        p[f"{la}.proj_up.weight"] = tinit.xavier_uniform(gen, (dim, ldim), gain=0.5)
        p[f"{la}.proj_up.bias"] = tinit.torch_linear_bias(gen, dim, ldim)

        pp = f"transformer.prompt_projs.{j}"
        p[f"{pp}.proj_down.0.weight"] = tinit.xavier_uniform(gen, (lat, dim), gain=0.7)
        p[f"{pp}.proj_down.0.bias"] = zeros(lat)
        p[f"{pp}.proj_up.weight"] = tinit.xavier_uniform(gen, (dim, lat), gain=0.7)
        p[f"{pp}.proj_up.bias"] = zeros(dim)
        ca = f"{pp}.cls_analyzer.cls_analyzer_"
        p[f"{ca}.0.weight"] = ones(lat)
        p[f"{ca}.0.bias"] = zeros(lat)
        p[f"{ca}.1.weight"] = tinit.xavier_uniform(gen, (64, lat), gain=1.0)
        p[f"{ca}.1.bias"] = zeros(64)
        p[f"{ca}.3.weight"] = tinit.xavier_uniform(gen, (P, 64), gain=1.0)
        p[f"{ca}.3.bias"] = zeros(P)
        gb = f"{pp}.gl_balancer.gl_balancer_"
        p[f"{gb}.0.weight"] = ones(lat)
        p[f"{gb}.0.bias"] = zeros(lat)
        p[f"{gb}.1.weight"] = tinit.xavier_uniform(gen, (1, lat), gain=1.0)
        p[f"{gb}.1.bias"] = 0.5 * ones(1)  # sigmoid ~0.62 global at start
        p[f"{pp}.global_attention.query_proj.weight"] = tinit.orthogonal(gen, (lat, lat))
        p[f"{pp}.global_attention.query_proj.bias"] = zeros(lat)
        p[f"{pp}.local_attention.query_proj.weight"] = tinit.orthogonal(gen, (lat, lat))
        p[f"{pp}.local_attention.query_proj.bias"] = zeros(lat)

    # Prompt tables: trunc-normal std .02 clamped +-2 std; pos-emb normal std .01.
    p["prompt_embeddings"] = tinit.trunc_normal(gen, (1, P, dim), std=0.02)
    p["prompt_positional_embedding"] = tinit.normal(gen, (1, P, dim), std=0.01)

    p["mlp_head.head.weight"] = tinit.xavier_uniform(gen, (spec.num_classes, dim))
    p["mlp_head.head.bias"] = zeros(spec.num_classes)

    # Alias entries mirror torch's duplicated state_dict rows, as copies.
    for alias, canon in aliases(spec).items():
        p[alias] = p[canon].clone()
    return p
