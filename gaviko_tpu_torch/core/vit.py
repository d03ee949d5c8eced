"""Shared 3D-ViT building blocks and the plain VisionTransformer model.

Port of ``gaviko_tpu/core/vit.py``. The routes follow the JAX package's
dispatch predicates, copied into the port, so one configuration takes the
same route in both packages; the device picks kernel or plain version.

- ``patchify_embed``: the Conv3d(kernel=stride=patch) embed as the patchify
  kernel, with optional positional rows in its epilogue;
- ``attention_block``: pre-norm MHSA. Given ``qkv_override`` (MeLO's
  LoRA-augmented projection) the packed qkv is that function of LN(x);
  else the qkv source is picked in the JAX
  package's order (``_qkv``): int8 sidecars when not training; the fused
  LN+linear kernel B9 when not training where ``ln_linear_supported``
  holds (vit-b16 and smaller in bf16, vit-s16 in fp32), with B12 as its
  backward when a gradient flows (GAViKO's frozen global layers); in
  training with ``GAVIKO_LNQKV_HYBRID=1``, ``ln_linear_hybrid`` (LN and a
  GEMM forward, B12 backward) where its gate holds; elsewhere LN, and the
  projection and attention run under ``mhsa_qkv_proj`` (dropout inside the
  kernel, one seed; its backward is the fused MHSA backward kernel) in
  training or under a gradient, or a plain GEMM at inference. A packed qkv
  goes through the fused MHSA kernel where ``fused_mhsa_supported`` holds
  (its backward kernel B under a gradient). Elsewhere (vit-t16's 3 heads,
  N > 2048) the rows are sliced to ``n_true`` and
  ``ops/attention.multi_head_attention`` runs the flash attention kernel,
  or plain attention with ``layers.dropout`` on the probabilities when
  dropout is on. Then dropout after the out-projection. The stream may
  carry tail padding: keys >= ``n_true`` are masked, padded rows carry
  bounded garbage (zeros on the unfused route). Weights of another dtype
  than the stream's (EVP's f32 stream in bf16) are promoted, as JAX
  promotes mixed operands;
- int8 serving (``ops/int8_linear.py``, sites carrying ``::int8`` sidecars,
  inference only; training ignores the sidecars): the qkv projection with
  its LN, the out-projection with its bias and the whole MLP (the residual
  fused in for ``_res``) run the int8 kernels, and the CLS-fast last layer
  defers to them;
- ``feedforward_block(_res)``: LN -> Linear -> GELU -> Dropout -> Linear ->
  Dropout. The fused MLP kernel (dropout inside it, one seed; the residual
  fused in for ``_res``) wherever ``fused_mlp_supported`` holds, in training
  and under a gradient too (its backward is the fused MLP backward kernel),
  else plain GEMMs and ``layers.dropout``: the JAX package's TPU route;
- the CLS-fast last layer (``attention_cls_branch``, ``cls_attend``,
  ``feedforward_cls_branch``): with ``pool='cls'`` only row 0 of the last
  layer is used, so it runs one query row, through the CLS attention kernel
  at inference and a differentiable form with dropout on the probabilities
  in training;
- ``vit_apply`` / ``vit_init``: the plain 3D ViT of methods ``fft``,
  ``linear`` and ``bitfit``; ``train=True`` turns every dropout on, the
  embedding dropout included, drawing seeds in the order of the JAX
  package's ``RngStream``;
- tensor parallelism (``parallel/shard.py``): in a sharded forward a block
  whose ``to_qkv`` (or ``net.1``) weight is split over the model group runs
  on its heads (or hidden columns), between ``copy_in`` and
  ``reduce_out``, with its output bias (and the fused MLP's residual) on
  model rank 0 only. Every route gate reads the whole layer's widths, so a
  rank takes the route one process takes.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core import init as tinit
from gaviko_tpu_torch.core.layers import (
    Params, SeedStream, dropout, gelu_spec, layer_norm, linear, proj, site_seed)
from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.attention import self_attention, self_attention_train
from gaviko_tpu_torch.ops.cls_attention import (
    cls_attention, cls_attention_reference, cls_attention_supported)
from gaviko_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_supported
from gaviko_tpu_torch.ops.int8_linear import (
    INT8_SUFFIX, SCALE_SUFFIX, has_int8, int8_linear, int8_mlp)
from gaviko_tpu_torch.ops.ln_linear import (
    fused_ln_linear, ln_linear_hybrid, ln_linear_hybrid_supported, ln_linear_supported)
from gaviko_tpu_torch.ops.patchify import patchify_fused
from gaviko_tpu_torch.parallel import shard


def patchify_embed(p: Params, prefix: str, img: torch.Tensor, spec: ModelSpec,
                   pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, C, D, H, W] -> [B, N, dim] tokens in (d, h, w) row-major order;
    ``pos`` (N, dim) rows fold into the kernel's epilogue."""
    w = p[f"{prefix}.weight"]  # (dim, C, pd, ph, pw)
    if tuple(w.shape[2:]) != (spec.frame_patch_size, *spec.image_patch_size):
        raise ValueError(f"{prefix}.weight {tuple(w.shape)} does not match the "
                         "spec's patch size")
    return patchify_fused(img, w, p[f"{prefix}.bias"], pos)


def _ln_proj(p: Params, prefix: str, x: torch.Tensor, w: torch.Tensor,
             train: bool = False, out_total: Optional[int] = None) -> torch.Tensor:
    """LN(x) @ w.T: when not training, the fused kernel where the JAX
    package's gate holds for the layer's ``out_total`` rows (w's own by
    default; B9, and under a gradient B12 as its backward), else LN and a
    plain GEMM."""
    gamma, beta = p[f"{prefix}.norm.weight"], p[f"{prefix}.norm.bias"]
    out_total = w.shape[0] if out_total is None else out_total
    if (not train and w.dtype == x.dtype
            and ln_linear_supported(x.shape[-1], out_total, x.dtype)):
        return fused_ln_linear(x, gamma, beta, w)
    return proj(layer_norm(p, f"{prefix}.norm", x), w)


def lnqkv_hybrid_enabled() -> bool:
    """The JAX package's ``GAVIKO_LNQKV_HYBRID`` switch, read per call."""
    return os.environ.get("GAVIKO_LNQKV_HYBRID", "0") == "1"


def _qkv(p: Params, prefix: str, x: torch.Tensor, w: torch.Tensor,
         train: bool, out: int) -> Optional[torch.Tensor]:
    """The packed qkv, in the JAX package's order of routes: the int8
    kernel when not training where the site has sidecars; the fused LN+linear
    (B9, with B12 as its backward under a gradient) when not training where
    its gate holds; in training with ``GAVIKO_LNQKV_HYBRID=1``, the hybrid
    route (LN and a GEMM, B12 backward) where its gate holds. None elsewhere:
    ``mhsa_qkv_proj`` then owns the GEMM. The gates read the layer's ``out``
    rows (a tensor-parallel rank's w holds a slice of them)."""
    gamma, beta = p[f"{prefix}.norm.weight"], p[f"{prefix}.norm.bias"]
    dim = x.shape[-1]
    if not train and has_int8(p, f"{prefix}.to_qkv.weight"):
        return _int8(p, f"{prefix}.to_qkv.weight", x, gamma=gamma, beta=beta)
    if w.dtype != x.dtype:
        return None
    if not train and ln_linear_supported(dim, out, x.dtype):
        return fused_ln_linear(x, gamma, beta, w)
    if train and lnqkv_hybrid_enabled() and ln_linear_hybrid_supported(dim, out, x.dtype):
        return ln_linear_hybrid(x, gamma, beta, w)
    return None


def attention_block(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                    train: bool = False, seeds: Optional[SeedStream] = None,
                    n_true: Optional[int] = None,
                    qkv_override: Optional[Callable] = None) -> torch.Tensor:
    """Pre-norm MHSA branch output (the caller adds the residual). In
    training the attention drops probabilities (one seed) and the
    out-projection's output is dropped (a second seed). A fused-route
    stream whose length is no multiple of 8 is padded around the fused
    MHSA, as in the JAX package. ``qkv_override(LN(x)) -> qkv`` replaces
    the projection (MeLO's LoRA-augmented qkv; no ``to_qkv.weight`` is
    looked up), and the packed qkv goes through ``self_attention``."""
    dh = spec.dim_head
    n_true = x.shape[1] if n_true is None else n_true
    rate = spec.dropout if train else 0.0
    s = None if qkv_override is not None else shard.part(f"{prefix}.to_qkv.weight")
    heads, head0 = _local_heads(spec, s)
    x = shard.copy_in(x, s)
    if qkv_override is not None:
        w, qkv = None, qkv_override(layer_norm(p, f"{prefix}.norm", x))
    else:
        w = p[f"{prefix}.to_qkv.weight"]
        qkv = _qkv(p, prefix, x, w, train, 3 * spec.heads * dh)
    if qkv is None and (train or _build.needs_grad(
            x, w, p[f"{prefix}.norm.weight"], p[f"{prefix}.norm.bias"])):
        h = layer_norm(p, f"{prefix}.norm", x)
        out = self_attention_train(h, w.to(h.dtype), heads, dh, dh ** -0.5, n_true,
                                   rate, seeds, spec.heads, head0)
    else:
        if qkv is None:
            qkv = proj(layer_norm(p, f"{prefix}.norm", x), w)
        out = self_attention(qkv, heads, dh, dh ** -0.5, n_true, rate, seeds, spec.heads,
                             head0)
    if not train and has_int8(p, f"{prefix}.to_out.0.weight"):
        out = _int8(p, f"{prefix}.to_out.0.weight", out, bias=p[f"{prefix}.to_out.0.bias"])
    else:
        out = shard.reduce_out(_out_proj(p, f"{prefix}.to_out.0", out, s), s)
    return dropout(out, spec.dropout, train, seeds)


def _local_heads(spec: ModelSpec, s: Optional[shard.Shard]):
    """(heads, first head) of this rank's slice of a layer (all of it unsplit)."""
    if s is None:
        return spec.heads, 0
    heads = spec.heads // s.tp
    return heads, s.m * heads


def _out_proj(p: Params, prefix: str, x: torch.Tensor, s: Optional[shard.Shard]):
    """The out-projection of a block; on a split block's model ranks > 0 its
    bias is left out (the all-reduced sum takes it once)."""
    if shard.rank0(s):
        return linear(p, prefix, x)
    return proj(x, p[f"{prefix}.weight"])


def _int8(p: Params, key: str, x: torch.Tensor, **kw) -> torch.Tensor:
    """The int8 serving GEMM of site ``key`` from its sidecars."""
    return int8_linear(x, p[key + INT8_SUFFIX], p[key + SCALE_SUFFIX], **kw)


def attention_block_res(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                        train: bool = False, seeds: Optional[SeedStream] = None,
                        n_true: Optional[int] = None) -> torch.Tensor:
    """x + attention branch."""
    return attention_block(p, prefix, x, spec, train=train, seeds=seeds, n_true=n_true) + x


def _int8_mlp(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec,
              residual: bool) -> torch.Tensor:
    """The int8 serving MLP from the site's sidecars (dropout is off at
    inference)."""
    w1, w2 = f"{prefix}.net.1.weight", f"{prefix}.net.4.weight"
    return int8_mlp(x, p[f"{prefix}.net.0.weight"], p[f"{prefix}.net.0.bias"],
                    p[w1 + INT8_SUFFIX], p[w1 + SCALE_SUFFIX], p[f"{prefix}.net.1.bias"],
                    p[w2 + INT8_SUFFIX], p[w2 + SCALE_SUFFIX], p[f"{prefix}.net.4.bias"],
                    1e-5, spec.gelu, residual=residual)


def _mlp_fused(p: Params, prefix: str, x: torch.Tensor,
               s: Optional[shard.Shard] = None) -> bool:
    """The fused MLP route: wherever the JAX package's gate holds for the
    layer's hidden width (a tensor-parallel rank holds 1 / tp of it)."""
    hidden = p[f"{prefix}.net.1.weight"].shape[0] * (s.tp if s is not None else 1)
    return fused_mlp_supported(x.shape[-1], hidden, x.dtype)


def _fused_mlp(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec,
               residual: bool, train: bool, seeds: Optional[SeedStream],
               s: Optional[shard.Shard] = None) -> torch.Tensor:
    """The fused MLP; weights of another dtype than x's (EVP's f32 stream in
    bf16) are cast to it, as JAX promotes them. On a split MLP each rank runs
    its hidden columns (their dropout bits at the layer's columns), with b2
    and the residual on model rank 0 only, and the outputs are summed."""
    rate = spec.dropout if train else 0.0
    ws = [p[f"{prefix}.net.{i}.{leaf}"].to(x.dtype)
          for i in (0, 1, 4) for leaf in ("weight", "bias")]
    seed = site_seed(rate, seeds)
    if seed is not None:
        seed = shard.fold_seed(seed, rows=shard.rows_per_sample(x))
    if s is None:
        return fused_mlp(x, *ws, 1e-5, spec.gelu, rate, residual, seed)
    if not shard.rank0(s):
        ws[-1], residual = torch.zeros_like(ws[-1]), False
    out = fused_mlp(x, *ws, 1e-5, spec.gelu, rate, residual, seed,
                    hidden_col0=s.m * ws[2].shape[0])
    return shard.reduce_out(out, s)


def feedforward_block(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                      train: bool = False,
                      seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """LN -> Linear -> GELU -> Dropout -> Linear -> Dropout branch output;
    dropout (``spec.dropout``) only when ``train``: one seed for the fused
    kernel's two sites, else one per site. At inference int8 sidecars take
    the int8 MLP kernel."""
    if not train and has_int8(p, f"{prefix}.net.1.weight"):
        return _int8_mlp(p, prefix, x, spec, False)
    s = shard.part(f"{prefix}.net.1.weight")
    x = shard.copy_in(x, s)
    if _mlp_fused(p, prefix, x, s):
        return _fused_mlp(p, prefix, x, spec, False, train, seeds, s)
    return _plain_mlp(p, prefix, x, spec, train, seeds, s)


def _plain_mlp(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, train: bool,
               seeds: Optional[SeedStream], s: Optional[shard.Shard]) -> torch.Tensor:
    """LN -> Linear -> GELU -> Dropout -> Linear -> Dropout in plain GEMMs;
    on a split MLP, this rank's hidden columns (x already past ``copy_in``)."""
    h = layer_norm(p, f"{prefix}.net.0", x)
    h = gelu_spec(linear(p, f"{prefix}.net.1", h), spec.gelu)
    h = dropout(h, spec.dropout, train, seeds, col_offset=s.m * h.shape[-1] if s else 0)
    h = shard.reduce_out(_out_proj(p, f"{prefix}.net.4", h, s), s)
    return dropout(h, spec.dropout, train, seeds)


def feedforward_block_res(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                          train: bool = False,
                          seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """x + MLP branch; on the fused and int8 routes the residual add runs
    inside the kernel."""
    if not train and has_int8(p, f"{prefix}.net.1.weight"):
        return _int8_mlp(p, prefix, x, spec, True)
    s = shard.part(f"{prefix}.net.1.weight")
    if _mlp_fused(p, prefix, x, s):
        return _fused_mlp(p, prefix, shard.copy_in(x, s), spec, True, train, seeds, s)
    return feedforward_block(p, prefix, x, spec, train=train, seeds=seeds) + x


def cls_attend(kv: torch.Tensor, q0: torch.Tensor, spec: ModelSpec, *,
               n_true: int, train: bool = False,
               seeds: Optional[SeedStream] = None, heads: Optional[int] = None,
               head0: int = 0) -> torch.Tensor:
    """Single-query attention core: kv (B, N, 2*inner) packed [K | V], q0
    (B, inner) -> (B, inner); the kernel at inference where the JAX
    package's gate holds, in training a differentiable form with dropout
    (one seed) on the (B, N, heads) probabilities, else the kernel's plain
    version (the JAX package's XLA twin). ``heads`` and ``head0``: a
    tensor-parallel rank's heads [head0, head0 + heads) of the layer's."""
    dh = spec.dim_head
    heads = spec.heads if heads is None else heads
    B, N, _ = kv.shape
    inner = heads * dh
    if (not train and not _build.needs_grad(kv, q0)
            and cls_attention_supported(spec.heads, dh, N, kv.dtype)):
        return cls_attention(kv, q0, heads, dh, dh ** -0.5, n_true)
    if train and spec.dropout > 0.0:
        k, v = kv[..., :inner].float(), kv[..., inner:].float()
        s = (k * q0[:, None, :].float()).reshape(B, N, heads, dh).sum(-1) * dh ** -0.5
        if n_true != N:
            s = s.masked_fill((torch.arange(N, device=s.device) >= n_true)[:, None],
                              float("-inf"))
        a = dropout(torch.softmax(s, dim=1), spec.dropout, train, seeds, col_offset=head0)
        return (v.reshape(B, N, heads, dh) * a[..., None]).sum(1).reshape(B, inner)
    return cls_attention_reference(kv, q0, heads, dh, dh ** -0.5, n_true)


def attention_cls_branch(p: Params, prefix: str, x: torch.Tensor, spec: ModelSpec, *,
                         n_true: int, train: bool = False,
                         seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """Attention branch output for query row 0 only, (B, dim): exactly
    ``attention_block(...)[:, 0]``. K and V span every real row; Q, the
    scores and the out-projection are needed for one row."""
    s = shard.part(f"{prefix}.to_qkv.weight")
    heads, head0 = _local_heads(spec, s)
    inner = heads * spec.dim_head
    x = shard.copy_in(x, s)
    wq = p[f"{prefix}.to_qkv.weight"]  # (3*inner, dim); rows = [q | k | v]
    kv = _ln_proj(p, prefix, x, wq[inner:], train, 2 * spec.heads * spec.dim_head)
    q0 = proj(layer_norm(p, f"{prefix}.norm", x[:, 0]), wq[:inner])
    out = cls_attend(kv, q0, spec, n_true=n_true, train=train, seeds=seeds, heads=heads,
                     head0=head0)
    out = shard.reduce_out(_out_proj(p, f"{prefix}.to_out.0", out.to(x.dtype), s), s)
    return dropout(out, spec.dropout, train, seeds)


def _has_int8_last(params: Params, spec: ModelSpec) -> bool:
    """True when the last layer carries int8 serving weights: the CLS-fast
    path then defers to the int8 kernels at inference."""
    pre = f"transformer.layers.{spec.depth - 1}"
    return (has_int8(params, f"{pre}.0.to_qkv.weight")
            or has_int8(params, f"{pre}.1.net.1.weight"))


def cls_fast_enabled(spec: ModelSpec) -> bool:
    """Shared gate of the last-layer fast path (pool='cls' models)."""
    return spec.pool == "cls" and os.environ.get("GAVIKO_CLS_FAST", "1") == "1"


def feedforward_cls_branch(p: Params, prefix: str, c: torch.Tensor,
                           spec: ModelSpec, *, train: bool = False,
                           seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """MLP branch on the pooled (B, dim) CLS rows (last-layer fast path)."""
    s = shard.part(f"{prefix}.net.1.weight")
    return _plain_mlp(p, prefix, shard.copy_in(c, s), spec, train, seeds, s)


def add_cls_and_pos(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Prepend the cls token and add the positional embedding."""
    B, n, dim = tokens.shape
    cls = p["cls_token"].to(tokens.dtype).expand(B, 1, dim)
    x = torch.cat([cls, tokens], dim=1)
    return x + p["pos_embedding"][:, : n + 1].to(tokens.dtype)


def pool_and_head(p: Params, x: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    pooled = x.mean(dim=1) if spec.pool == "mean" else x[:, 0]
    return linear(p, "mlp_head", pooled)


def vit_apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
              train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    """Forward of the plain 3D ViT: img [B, C, D, H, W] in the working dtype
    -> logits [B, num_classes]. The stream is padded once to a multiple of 8
    rows (1001 -> 1008 at 120x160x160); keys >= n_true are masked and pad
    rows are cut before pooling. ``train`` turns on every dropout (the
    reference's methods fft / linear / bitfit train in train mode
    throughout), drawing one seed a site from ``seeds``."""
    pos = params["pos_embedding"]
    x = patchify_embed(params, "conv_proj.0", img, spec,
                       pos=pos[0, 1:1 + spec.num_patches])
    B, _, dim = x.shape
    cls = (params["cls_token"][0] + pos[:, 0]).to(x.dtype)
    x = torch.cat([cls.expand(B, 1, dim), x], dim=1)
    x = dropout(x, spec.emb_dropout, train, seeds)
    n_true = x.shape[1]
    pad = (-n_true) % 8
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    last = spec.depth - 1
    # Training ignores int8 sidecars, so only inference defers to them.
    fast_cls = (cls_fast_enabled(spec)
                and f"transformer.layers.{last}.0.to_qkv.weight" in params
                and (train or not _has_int8_last(params, spec)))
    for i in range(last if fast_cls else spec.depth):
        x = attention_block_res(params, f"transformer.layers.{i}.0", x, spec, train=train,
                                seeds=seeds, n_true=n_true)
        x = feedforward_block_res(params, f"transformer.layers.{i}.1", x, spec, train=train,
                                  seeds=seeds)
    if fast_cls:
        c = x[:, 0] + attention_cls_branch(params, f"transformer.layers.{last}.0", x, spec,
                                           n_true=n_true, train=train, seeds=seeds)
        c = c + feedforward_cls_branch(params, f"transformer.layers.{last}.1", c, spec,
                                       train=train, seeds=seeds)
        return linear(params, "mlp_head", layer_norm(params, "transformer.norm", c))
    if spec.pool == "cls":
        # LN is per row, so pooling row 0 first is exact.
        return linear(params, "mlp_head",
                      layer_norm(params, "transformer.norm", x[:, 0]))
    x = layer_norm(params, "transformer.norm", x[:, :n_true])
    return pool_and_head(params, x, spec)


def vit_init(gen: torch.Generator, spec: ModelSpec) -> Params:
    """Random f32 params on ``gen``'s device under the reference's names,
    with torch's default distributions."""
    dim, mlp = spec.dim, spec.mlp_dim
    inner = spec.heads * spec.dim_head
    kdhw = (spec.frame_patch_size, *spec.image_patch_size)
    dev = gen.device

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    p: Params = {}
    p["conv_proj.0.weight"] = tinit.torch_conv3d_weight(gen, dim, spec.channels, kdhw)
    p["conv_proj.0.bias"] = tinit.torch_conv3d_bias(gen, dim, spec.channels, kdhw)
    p["pos_embedding"] = tinit.normal(gen, (1, spec.num_patches + 1, dim))
    p["cls_token"] = tinit.normal(gen, (1, 1, dim))
    for i in range(spec.depth):
        a = f"transformer.layers.{i}.0"
        p[f"{a}.norm.weight"] = ones(dim)
        p[f"{a}.norm.bias"] = zeros(dim)
        p[f"{a}.to_qkv.weight"] = tinit.torch_linear_weight(gen, inner * 3, dim)
        p[f"{a}.to_out.0.weight"] = tinit.torch_linear_weight(gen, dim, inner)
        p[f"{a}.to_out.0.bias"] = tinit.torch_linear_bias(gen, dim, inner)
        f = f"transformer.layers.{i}.1"
        p[f"{f}.net.0.weight"] = ones(dim)
        p[f"{f}.net.0.bias"] = zeros(dim)
        p[f"{f}.net.1.weight"] = tinit.torch_linear_weight(gen, mlp, dim)
        p[f"{f}.net.1.bias"] = tinit.torch_linear_bias(gen, mlp, dim)
        p[f"{f}.net.4.weight"] = tinit.torch_linear_weight(gen, dim, mlp)
        p[f"{f}.net.4.bias"] = tinit.torch_linear_bias(gen, dim, mlp)
    p["transformer.norm.weight"] = ones(dim)
    p["transformer.norm.bias"] = zeros(dim)
    p["mlp_head.weight"] = tinit.torch_linear_weight(gen, spec.num_classes, dim)
    p["mlp_head.bias"] = tinit.torch_linear_bias(gen, spec.num_classes, dim)
    return p
