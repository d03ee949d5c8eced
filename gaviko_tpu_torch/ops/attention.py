"""Multi-head self-attention dispatch for the 3D ViT token stream.

Port of ``gaviko_tpu/ops/attention.py``. The device picks the path, not an
option: a CUDA tensor goes to the fused MHSA kernels, a CPU tensor to their
plain versions. On CUDA a shape the kernels do not take raises: the JAX
package sends those (odd head counts such as vit-t16's) to
``flash_attention``, which is not ported yet (ROADMAP Queue B).

- :func:`self_attention` takes a packed qkv and needs no gradient (eval);
- :func:`self_attention_train` takes the LN output and the qkv weight and is
  differentiable, with dropout: the projection and the attention run under
  ``mhsa_qkv_proj``, whose backward is the fused MHSA backward kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.flash_attention import (
    fused_mhsa,
    fused_mhsa_supported,
    mhsa_qkv_proj,
    mhsa_reference,
)


def _unsupported(heads: int, dim_head: int, n: int) -> NotImplementedError:
    return NotImplementedError(
        f"heads={heads}, dim_head={dim_head}, N={n} needs the flash_attention "
        "kernel, which is not ported yet (ROADMAP Queue B)")


def self_attention(qkv: torch.Tensor, heads: int, dim_head: int, scale: float,
                   n_true: int) -> torch.Tensor:
    """Packed qkv [B, N_pad, 3*heads*dim_head] -> [B, N_pad, heads*dim_head],
    keys >= n_true masked (eval: no dropout)."""
    if not _build.use_kernel(qkv):
        return mhsa_reference(qkv, heads, dim_head, scale, n_true)
    if not fused_mhsa_supported(heads, dim_head, qkv.shape[1]):
        raise _unsupported(heads, dim_head, qkv.shape[1])
    return fused_mhsa(qkv, heads, dim_head, scale, n_true)


def self_attention_train(h: torch.Tensor, w: torch.Tensor, heads: int,
                         dim_head: int, scale: float, n_true: int,
                         dropout_rate: float = 0.0, seed: Optional[int] = None) -> torch.Tensor:
    """LN output h [B, N_pad, dim] and qkv weight w [3*inner, dim] ->
    attention output [B, N_pad, inner], differentiable in h and w, with
    dropout on the probabilities (``seed``, the MHSA kernels' mask).

    As in the JAX package, a stream whose length is a multiple of 8 goes
    through ``mhsa_qkv_proj``. Any other length takes the plain version on
    the CPU (at rate 0: the JAX package drops elsewhere there) and raises on
    CUDA, as does a shape the kernels do not take."""
    n = h.shape[1]
    if fused_mhsa_supported(heads, dim_head, n) and n % 8 == 0:
        return mhsa_qkv_proj(h, w, heads, dim_head, scale, n_true, dropout_rate, seed)
    if _build.use_kernel(h) or dropout_rate > 0.0:
        raise _unsupported(heads, dim_head, n)
    return mhsa_reference(F.linear(h, w), heads, dim_head, scale, n_true)
