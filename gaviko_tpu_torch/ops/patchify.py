"""Patchify embed: non-overlapping Conv3d (kernel == stride) as one GEMM.

Port of ``gaviko_tpu/ops/patchify.py`` (forward). On the card it runs the
implicit-GEMM kernel in ``csrc/patchify.cu``, which reads every patch straight
from the volume; ``patchify_reference`` is its plain PyTorch version.

Both compute ``(x @ W^T + pos).to(dtype) + bias`` with an f32 accumulator,
where row ``(b, t)`` of ``x`` is patch ``t`` of volume ``b`` in ``(d, h, w)``
token order and columns in ``(c, pd, ph, pw)`` order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gaviko_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P) + (_I,) * 9 + (_P,)


def _geometry(img: torch.Tensor, weight: torch.Tensor):
    B, C, D, H, W = img.shape
    dim, wc, pd, ph, pw = weight.shape
    if wc != C:
        raise ValueError(f"weight has {wc} input channels, volume has {C}")
    if D % pd or H % ph or W % pw:
        raise ValueError(
            f"volume {(D, H, W)} is not divisible by the patch {(pd, ph, pw)}")
    return B, C, D, H, W, dim, pd, ph, pw


def patchify_reference(img: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor,
                       pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """img [B, C, D, H, W], weight (dim, C, pd, ph, pw), bias (dim,),
    pos (N, dim) or None -> [B, N, dim] in ``img``'s dtype."""
    B, C, D, H, W, dim, pd, ph, pw = _geometry(img, weight)
    gd, gh, gw = D // pd, H // ph, W // pw
    x = img.reshape(B, C, gd, pd, gh, ph, gw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, gd * gh * gw, -1)
    y = torch.matmul(x.float(), weight.reshape(dim, -1).float().t())
    if pos is not None:
        y = y + pos.float()
    return y.to(img.dtype) + bias.to(img.dtype)


def patchify_fused(img: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same contract as :func:`patchify_reference`; the kernel on CUDA,
    whose output has no backward: a call that needs a gradient raises there
    (GAViKO's conv_proj is frozen and its input needs none)."""
    if not _build.use_kernel(img):
        return patchify_reference(img, weight, bias, pos)
    _build.refuse_grad(
        "patchify_fused", "ROADMAP Queue B item 5: save_rows and the dW backward",
        *(t for t in (img, weight, bias, pos) if t is not None))
    B, C, D, H, W, dim, pd, ph, pw = _geometry(img, weight)
    dt = img.dtype
    weight, bias = weight.to(dt).contiguous(), bias.to(dt).contiguous()
    n_tok = (D // pd) * (H // ph) * (W // pw)
    tensors = [img, weight, bias]
    if pos is not None:
        pos = pos.to(dt).contiguous()
        if tuple(pos.shape) != (n_tok, dim):
            raise ValueError(f"pos must be {(n_tok, dim)}, got {tuple(pos.shape)}")
        tensors.append(pos)
    _build.check_cuda("patchify_fused", *tensors)
    out = torch.empty((B, n_tok, dim), device=img.device, dtype=dt)
    _build.launch(
        "patchify", f"gaviko_patchify_{_build.dtype_suffix(img)}", _ARGTYPES,
        img.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if pos is None else pos.data_ptr(), out.data_ptr(),
        B, C, D, H, W, pd, ph, pw, dim, _build.stream_of(img))
    patchify_fused.launches += 1
    return out


patchify_fused.launches = 0
