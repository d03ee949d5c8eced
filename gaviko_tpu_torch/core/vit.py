"""Shared 3D-ViT building blocks.

Port of the blocks of ``gaviko_tpu/core/vit.py`` that GAViKO runs:

- ``patchify_embed``: the Conv3d(kernel=stride=patch) embed, as the patchify
  kernel on CUDA (``ops/patchify.py``);
- ``attention_block``: pre-norm MHSA. LN and the qkv / output projections are
  plain GEMMs (the JAX package leaves them to XLA at vit-l16, where its fused
  LN+qkv kernel is off); attention reads the packed qkv through the fused
  MHSA kernel. When a gradient is needed, the qkv projection and the
  attention run under ``mhsa_qkv_proj``, whose backward is the fused MHSA
  backward kernel. The stream may carry tail padding: keys >= ``n_true``
  are masked and padded rows carry bounded garbage by contract;
- ``feedforward_block``: LN -> Linear -> GELU -> Dropout -> Linear ->
  Dropout, plain GEMMs (the JAX package's fused MLP kernel is off at
  vit-l16).

The attention has no dropout: a trainable backbone (``freeze_vit: false``)
needs dropout inside the MHSA kernels, which a later slice ports, and
``models/gaviko.apply`` refuses to train one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core.layers import (
    Params, SeedStream, dropout, gelu_spec, layer_norm, linear)
from gaviko_tpu_torch.ops.attention import self_attention, self_attention_train
from gaviko_tpu_torch.ops.patchify import patchify_fused


def patchify_embed(p: Params, prefix: str, img: torch.Tensor,
                   spec: ModelSpec) -> torch.Tensor:
    """[B, C, D, H, W] -> [B, N, dim] tokens in (d, h, w) row-major order."""
    w = p[f"{prefix}.weight"]  # (dim, C, pd, ph, pw)
    if tuple(w.shape[2:]) != (spec.frame_patch_size, *spec.image_patch_size):
        raise ValueError(f"{prefix}.weight {tuple(w.shape)} does not match the "
                         "spec's patch size")
    return patchify_fused(img, w, p[f"{prefix}.bias"])


def attention_block(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                    n_true: Optional[int] = None) -> torch.Tensor:
    """Pre-norm MHSA branch output (the caller adds the residual). Unlike
    the TPU kernel, the CUDA kernel takes any row count, so no per-call pad."""
    dh = spec.dim_head
    n_true = x.shape[1] if n_true is None else n_true
    h = layer_norm(p, f"{prefix}.norm", x)
    w = p[f"{prefix}.to_qkv.weight"]
    if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
        out = self_attention_train(h, w, spec.heads, dh, dh ** -0.5, n_true)
    else:
        out = self_attention(F.linear(h, w), spec.heads, dh, dh ** -0.5, n_true)
    return linear(p, f"{prefix}.to_out.0", out)


def feedforward_block(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                      train: bool = False,
                      seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """LN -> Linear -> GELU -> Dropout -> Linear -> Dropout branch output;
    dropout (``spec.dropout``) only when ``train``, one seed per site."""
    h = layer_norm(p, f"{prefix}.net.0", x)
    h = gelu_spec(linear(p, f"{prefix}.net.1", h), spec.gelu)
    h = dropout(h, spec.dropout, train, seeds)
    h = linear(p, f"{prefix}.net.4", h)
    return dropout(h, spec.dropout, train, seeds)
