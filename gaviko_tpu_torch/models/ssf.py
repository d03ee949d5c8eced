"""SSF: scale-and-shift after every op of the frozen ViT.

Port of ``gaviko_tpu/models/ssf.py`` (ref: src/model/ssf.py). ``ssf_ada(x)
= x * scale + shift`` follows the patch embed, each attention's LN, packed
qkv and out-projection, each MLP's LN, fc1 and fc2, and the final norm;
scale ~ N(1, .02), shift ~ N(0, .02). The reference's LayerScale is
Identity and carries no params.

SSF keeps its own blocks rather than ``core/vit.attention_block``: the
qkv is a plain GEMM, ``ssf_1`` scales the packed qkv, and that goes
through ``ops/attention.self_attention`` (the fused MHSA kernel where
its gate holds, with its backward under a gradient); the MLP is plain
GEMMs with ``ssf_ada`` between them, so SSF runs neither the fused
LN+linear nor the fused MLP. In the CLS-fast last layer ``ssf_1`` is
sliced into its kv and q thirds. The stream is padded once to a multiple
of 8 rows. ``quantize_backbone`` refuses SSF, as in the JAX package.

Under tensor parallelism a split block runs its heads (or hidden columns)
between ``copy_in`` and ``reduce_out`` as ``core/vit``'s blocks do, with
``ssf_1`` split as the qkv's (fc1's) rows (``parallel/mesh.tp_plan``) and
``ssf_2`` applied to the summed output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core import init as tinit
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import (
    Params, SeedStream, dropout, gelu_spec, layer_norm, linear, proj, ssf_ada)
from gaviko_tpu_torch.ops.attention import self_attention
from gaviko_tpu_torch.parallel import shard


def _ssf(p: Params, prefix: str, idx: int, x: torch.Tensor) -> torch.Tensor:
    return ssf_ada(x, p[f"{prefix}.ssf_scale_{idx}"], p[f"{prefix}.ssf_shift_{idx}"])


def _attn_block(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                train: bool, seeds: Optional[SeedStream], n_true: int) -> torch.Tensor:
    s = shard.part(f"{prefix}.to_qkv.weight")
    heads, head0 = vit_core._local_heads(spec, s)
    h = _ssf(p, prefix, 0, layer_norm(p, f"{prefix}.norm", shard.copy_in(x, s)))
    qkv = _ssf(p, prefix, 1, proj(h, p[f"{prefix}.to_qkv.weight"]))
    dh = spec.dim_head
    out = self_attention(qkv, heads, dh, dh ** -0.5, n_true,
                         spec.dropout if train else 0.0, seeds, spec.heads, head0)
    out = shard.reduce_out(vit_core._out_proj(p, f"{prefix}.to_out.0", out, s), s)
    return dropout(_ssf(p, prefix, 2, out), spec.dropout, train, seeds)


def _ff_block(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
              train: bool, seeds: Optional[SeedStream]) -> torch.Tensor:
    s = shard.part(f"{prefix}.net.1.weight")
    h = _ssf(p, prefix, 0, layer_norm(p, f"{prefix}.net.0", shard.copy_in(x, s)))
    h = gelu_spec(_ssf(p, prefix, 1, linear(p, f"{prefix}.net.1", h)), spec.gelu)
    h = dropout(h, spec.dropout, train, seeds, col_offset=s.m * h.shape[-1] if s else 0)
    h = shard.reduce_out(vit_core._out_proj(p, f"{prefix}.net.4", h, s), s)
    return dropout(_ssf(p, prefix, 2, h), spec.dropout, train, seeds)


def _attn_cls_branch(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                     train: bool, seeds: Optional[SeedStream], n_true: int) -> torch.Tensor:
    """``_attn_block(...)[:, 0]`` for the CLS query alone (the last-layer
    fast path), ``ssf_1`` sliced to the kv and q thirds of the packed qkv."""
    s = shard.part(f"{prefix}.to_qkv.weight")
    heads, head0 = vit_core._local_heads(spec, s)
    h = _ssf(p, prefix, 0, layer_norm(p, f"{prefix}.norm", shard.copy_in(x, s)))
    w = p[f"{prefix}.to_qkv.weight"]
    inner = w.shape[0] // 3
    sc, sh = p[f"{prefix}.ssf_scale_1"], p[f"{prefix}.ssf_shift_1"]
    kv = proj(h, w[inner:]) * sc[inner:] + sh[inner:]
    q0 = proj(h[:, 0], w[:inner]) * sc[:inner] + sh[:inner]
    out = vit_core.cls_attend(kv, q0, spec, n_true=n_true, train=train, seeds=seeds,
                              heads=heads, head0=head0)
    out = shard.reduce_out(vit_core._out_proj(p, f"{prefix}.to_out.0", out.to(x.dtype), s), s)
    return dropout(_ssf(p, prefix, 2, out), spec.dropout, train, seeds)


def apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
          train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """With ``freeze_vit`` the whole backbone stays in eval (ssf.py:216-228),
    so a train step draws no seed."""
    bb_train = train and not spec.freeze_vit
    x = vit_core.patchify_embed(params, "conv_proj.0", img, spec)
    x = ssf_ada(x, params["ssf_scale_1"], params["ssf_shift_1"])
    x = vit_core.add_cls_and_pos(params, x)
    x = dropout(x, spec.emb_dropout, bb_train, seeds)
    n_true = x.shape[1]
    pad = (-n_true) % 8
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    fast = vit_core.cls_fast_enabled(spec)
    kw = dict(train=bb_train, seeds=seeds)
    for i in range(spec.depth):
        a, f = f"transformer.layers.{i}.0", f"transformer.layers.{i}.1"
        if fast and i == spec.depth - 1:
            c = x[:, 0] + _attn_cls_branch(params, a, x, spec, n_true=n_true, **kw)
            c = c + _ff_block(params, f, c, spec, **kw)
            c = layer_norm(params, "transformer.norm", c)
            c = ssf_ada(c, params["transformer.ssf_scale_1"], params["transformer.ssf_shift_1"])
            return linear(params, "mlp_head", c)
        x = _attn_block(params, a, x, spec, n_true=n_true, **kw) + x
        x = _ff_block(params, f, x, spec, **kw) + x
    x = layer_norm(params, "transformer.norm", x[:, :n_true])
    x = ssf_ada(x, params["transformer.ssf_scale_1"], params["transformer.ssf_shift_1"])
    return vit_core.pool_and_head(params, x, spec)


def init(gen: torch.Generator, spec: ModelSpec) -> Params:
    """Random f32 params on ``gen``'s device under the reference's names."""
    p = vit_core.vit_init(gen, spec)
    inner3 = spec.heads * spec.dim_head * 3

    def scale_shift(prefix: str, idx: int, n: int) -> None:
        p[f"{prefix}ssf_scale_{idx}"] = 1.0 + tinit.normal(gen, (n,), 0.02)
        p[f"{prefix}ssf_shift_{idx}"] = tinit.normal(gen, (n,), 0.02)

    scale_shift("", 1, spec.dim)  # after the patch embed
    scale_shift("transformer.", 1, spec.dim)  # after the final norm
    for i in range(spec.depth):
        a, f = f"transformer.layers.{i}.0.", f"transformer.layers.{i}.1."
        for idx, n in enumerate((spec.dim, inner3, spec.dim)):
            scale_shift(a, idx, n)
        for idx, n in enumerate((spec.dim, spec.mlp_dim, spec.dim)):
            scale_shift(f, idx, n)
    # init_head_weights (ssf.py:211-214)
    p["mlp_head.weight"] = tinit.xavier_uniform(gen, (spec.num_classes, spec.dim))
    p["mlp_head.bias"] = torch.zeros(spec.num_classes, device=gen.device)
    return p
