"""Multi-head self-attention dispatch for the 3D ViT token stream.

Port of ``gaviko_tpu/ops/attention.py``, on the routes the JAX package takes
on its TPU. The device picks kernel or plain version, not an option: a CUDA
tensor launches the kernels, a CPU tensor runs their plain versions.

- Where ``fused_mhsa_supported`` holds, the fused MHSA kernels read the
  packed qkv (dropout inside them, one seed);
- elsewhere (odd head counts such as vit-t16's, N > 2048) heads are split,
  the rows sliced to ``n_true`` and :func:`multi_head_attention` runs: the
  flash attention kernel (B10) at eval and in dropout-free training, and
  :func:`_xla_attention`, plain PyTorch on both devices, when dropout is on
  (``layers.dropout`` on the flattened probabilities, as the JAX package
  runs XLA there); the output is padded back with zero rows.

:func:`self_attention` takes a packed qkv; :func:`self_attention_train` takes
the LN output and the qkv weight. Both are differentiable, with dropout
drawn from a seed stream.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.core.layers import SeedStream, site_seed
from gaviko_tpu_torch.ops.flash_attention import (
    _split_heads,
    flash_attention,
    fused_mhsa,
    fused_mhsa_supported,
    mhsa_qkv_proj,
)
from gaviko_tpu_torch.ops.hash_dropout import keep_mask
from gaviko_tpu_torch.parallel import shard


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float, dropout_rate: float = 0.0,
                         dropout_enabled: bool = False,
                         seeds: Optional[SeedStream] = None,
                         heads_total: Optional[int] = None, head0: int = 0) -> torch.Tensor:
    """q, k, v: [B, H, N, Dh] -> [B, H, N, Dh]; ``heads_total`` and
    ``head0`` place the H heads in a wider layer, for the dropout bits."""
    if dropout_enabled and dropout_rate > 0.0:
        return _xla_attention(q, k, v, scale=scale, dropout_rate=dropout_rate,
                              dropout_enabled=True, seeds=seeds, heads_total=heads_total,
                              head0=head0)
    return flash_attention(q, k, v, scale)


def _probs_dropout(attn: torch.Tensor, rate: float, seeds: Optional[SeedStream],
                   heads_total: Optional[int], head0: int) -> torch.Tensor:
    """``layers.dropout`` of the [B, H, n, m] probabilities flattened to
    [B * H * n, m] rows, at the rows the whole batch and layer give them:
    row ((b0 + b) * heads_total + head0 + h) * n + i."""
    seed = site_seed(rate, seeds)
    B, H, n, m = attn.shape
    total = H if heads_total is None else heads_total
    s = shard.current()
    b0 = s.b0 if s is not None else 0
    keep = torch.stack([
        keep_mask((H * n, m), seed, rate, row_offset=((b0 + b) * total + head0) * n,
                  device=attn.device).reshape(H, n, m) for b in range(B)])
    return torch.where(keep, attn / (1.0 - rate), torch.zeros_like(attn))


def _xla_attention(q, k, v, *, scale, dropout_rate, dropout_enabled, seeds,
                   heads_total=None, head0=0):
    dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(dots, dim=-1).to(v.dtype)
    if dropout_enabled and dropout_rate > 0.0:
        attn = _probs_dropout(attn, dropout_rate, seeds, heads_total, head0)
    return torch.matmul(attn, v)


def _unfused(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, n_true: int,
             dropout_rate: float, seeds: Optional[SeedStream],
             heads_total: Optional[int] = None, head0: int = 0) -> torch.Tensor:
    """Split heads, slice the rows to n_true (the dropout mask's coordinates
    depend on it), attend, merge heads and pad back with zero rows."""
    B, N, _ = qkv.shape
    q, k, v = (t[:, :, :n_true] for t in _split_heads(qkv, heads, dim_head))
    out = multi_head_attention(q, k, v, scale=scale, dropout_rate=dropout_rate,
                               dropout_enabled=dropout_rate > 0.0, seeds=seeds,
                               heads_total=heads_total, head0=head0)
    out = out.transpose(1, 2).reshape(B, n_true, heads * dim_head)
    return F.pad(out, (0, 0, 0, N - n_true)) if n_true != N else out


def self_attention(qkv: torch.Tensor, heads: int, dim_head: int, scale: float,
                   n_true: int, dropout_rate: float = 0.0,
                   seeds: Optional[SeedStream] = None,
                   heads_total: Optional[int] = None, head0: int = 0) -> torch.Tensor:
    """Packed qkv [B, N, 3*heads*dim_head] -> [B, N, heads*dim_head], keys
    >= n_true masked, dropout on the probabilities at rate > 0 (one seed from
    ``seeds``), differentiable in qkv.

    On the fused route a stream whose length is no multiple of 8 is padded
    to one around ``fused_mhsa`` (its backward is kernel B) and sliced back,
    as in the JAX package. A tensor-parallel rank's call holds heads
    [head0, head0 + heads) of ``heads_total``: the route is the whole
    layer's, and so are the dropout bits."""
    n = qkv.shape[1]
    total = heads if heads_total is None else heads_total
    if not fused_mhsa_supported(total, dim_head, n):
        return _unfused(qkv, heads, dim_head, scale, n_true, dropout_rate, seeds, heads_total,
                        head0)
    seed = site_seed(dropout_rate, seeds)
    pad = (-n) % 8
    if pad:
        qkv = F.pad(qkv, (0, 0, 0, pad))
    out = fused_mhsa(qkv, heads, dim_head, scale, n_true, dropout_rate,
                     seed=0 if seed is None else shard.fold_seed(seed, salts=total),
                     heads_total=total, head0=head0)
    return out[:, :n] if pad else out


def self_attention_train(h: torch.Tensor, w: torch.Tensor, heads: int,
                         dim_head: int, scale: float, n_true: int,
                         dropout_rate: float = 0.0,
                         seeds: Optional[SeedStream] = None,
                         heads_total: Optional[int] = None, head0: int = 0) -> torch.Tensor:
    """LN output h [B, N, dim] and qkv weight w [3*inner, dim] -> attention
    output [B, N, inner], differentiable in h and w, with dropout on the
    probabilities (one seed from ``seeds`` at rate > 0).

    As in the JAX package: on the fused route a stream whose length is a
    multiple of 8 goes through ``mhsa_qkv_proj``; elsewhere the packed qkv
    goes through :func:`self_attention`."""
    n = h.shape[1]
    total = heads if heads_total is None else heads_total
    if not fused_mhsa_supported(total, dim_head, n) or n % 8:
        return self_attention(F.linear(h, w), heads, dim_head, scale, n_true, dropout_rate,
                              seeds, heads_total, head0)
    seed = site_seed(dropout_rate, seeds)
    if seed is not None:
        seed = shard.fold_seed(seed, salts=total)
    return mhsa_qkv_proj(h, w, heads, dim_head, scale, n_true, dropout_rate, seed,
                         heads_total=total, head0=head0)
