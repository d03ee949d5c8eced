"""Patchify embed: non-overlapping Conv3d (kernel == stride) as one GEMM.

Port of ``gaviko_tpu/ops/patchify.py``. On the card a call is two launches
of ``csrc/patchify.cu``, as ``ops/gemm_plan.py:patchify_plan`` plans them: a
rows pass that gathers the patch matrix from the volume, then one product
of it with the weight on the port's Hopper GEMM (``csrc/gemm_sm90.cuh``:
wgmma fed by TMA in bf16, 3xTF32 on the tensor cores in f32), pos and the
bias added in its epilogue. ``patchify_reference`` is its plain PyTorch
version, and :func:`rows_reference` the rows pass's.

Both compute ``(x @ W^T + pos).to(dtype) + bias`` with an f32 accumulator,
where row ``(b, t)`` of ``x`` is patch ``t`` of volume ``b`` in ``(d, h, w)``
token order and columns in ``(c, pd, ph, pw)`` order.

:func:`patchify_fused` is differentiable, as the JAX package's custom VJP:
when the weight needs a gradient the rows pass writes that patch matrix as
an output (``save_rows``), and dW is one product ``rows^T dy`` (JAX computes
it outside its kernel too); dpos is the sum of dy over the batch and dbias
the sum of dpos. The gradient with respect to the volume, which training
never asks for, goes through the plain version's autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.gemm_plan import _scratch, patchify_plan

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 13 + (_P,)


def _geometry(img: torch.Tensor, weight: torch.Tensor):
    B, C, D, H, W = img.shape
    dim, wc, pd, ph, pw = weight.shape
    if wc != C:
        raise ValueError(f"weight has {wc} input channels, volume has {C}")
    if D % pd or H % ph or W % pw:
        raise ValueError(
            f"volume {(D, H, W)} is not divisible by the patch {(pd, ph, pw)}")
    return B, C, D, H, W, dim, pd, ph, pw


def patch_rows(img: torch.Tensor, patch) -> torch.Tensor:
    """img [B, C, D, H, W] -> the patch matrix [B, N, C * pd * ph * pw]:
    row (b, t) is patch t of volume b in (d, h, w) token order, columns in
    (c, pd, ph, pw) order."""
    B, C, D, H, W = img.shape
    pd, ph, pw = patch
    gd, gh, gw = D // pd, H // ph, W // pw
    x = img.reshape(B, C, gd, pd, gh, ph, gw, pw)
    return x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, gd * gh * gw, -1)


def rows_reference(img: torch.Tensor, patch, kp: int) -> torch.Tensor:
    """The rows pass's plain version: the patch matrix [B * N, kp] of
    :func:`patch_rows`, zero in its columns past C * pd * ph * pw."""
    x = patch_rows(img, patch)
    x = x.reshape(-1, x.shape[-1])
    return F.pad(x, (0, kp - x.shape[1]))


def patchify_reference(img: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor,
                       pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """img [B, C, D, H, W], weight (dim, C, pd, ph, pw), bias (dim,),
    pos (N, dim) or None -> [B, N, dim] in ``img``'s dtype."""
    B, C, D, H, W, dim, pd, ph, pw = _geometry(img, weight)
    x = patch_rows(img, (pd, ph, pw))
    y = torch.matmul(x.float(), weight.reshape(dim, -1).float().t())
    if pos is not None:
        y = y + pos.float()
    return y.to(img.dtype) + bias.to(img.dtype)


def patchify_kernel(img: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    pos: Optional[torch.Tensor] = None, save_rows: bool = False,
                    block: Optional[int] = None):
    """Same contract as :func:`patchify_reference`, with no gradient; the
    kernel on CUDA. With ``save_rows`` it returns (out, rows), rows the patch
    matrix [B * N, C * pd * ph * pw] (on the card a view of the rows pass's
    [B * N, kp]; on the CPU from :func:`patch_rows`). ``block`` forces the
    GEMM's tile rows (an A/B run; ``ops/_blocks.py`` chooses otherwise)."""
    B, C, D, H, W, dim, pd, ph, pw = _geometry(img, weight)
    if not _build.use_kernel(img):
        out = patchify_reference(img, weight, bias, pos)
        if not save_rows:
            return out
        return out, patch_rows(img, (pd, ph, pw)).reshape(out.shape[0] * out.shape[1], -1)
    if torch.compiler.is_exporting():
        if save_rows:
            raise NotImplementedError("an exported forward saves no patch rows")
        return _build.op("patchify")(img, weight, bias, pos)
    _build.refuse_grad("patchify_kernel", "the gradient goes through patchify_fused",
                       *(t for t in (img, weight, bias, pos) if t is not None))
    dt = img.dtype
    plan = patchify_plan(B, C, (D, H, W), (pd, ph, pw), dim, dt, save_rows, block)
    weight = weight.to(dt).reshape(dim, plan.k)
    if plan.kp > plan.k:
        weight = F.pad(weight, (0, plan.kp - plan.k))
    weight, bias = weight.contiguous(), bias.to(dt).contiguous()
    n_tok = plan.rows // B
    tensors = [img, weight, bias]
    if pos is not None:
        pos = pos.to(dt).contiguous()
        if tuple(pos.shape) != (n_tok, dim):
            raise ValueError(f"pos must be {(n_tok, dim)}, got {tuple(pos.shape)}")
        tensors.append(pos)
    _build.check_cuda("patchify_fused", *tensors)
    out = torch.empty((B, n_tok, dim), device=img.device, dtype=dt)
    if save_rows:
        rows = torch.empty((plan.rows, plan.kp), device=img.device, dtype=dt)
        rows_ptr = rows.data_ptr()
    else:
        sc = _scratch(plan.scratch, plan.scratch_bytes, img.device)
        rows_ptr = sc["rows"]
    _build.launch(
        "patchify", f"gaviko_patchify_{_build.dtype_suffix(img)}", _ARGTYPES,
        img.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if pos is None else pos.data_ptr(), out.data_ptr(), rows_ptr,
        B, C, D, H, W, pd, ph, pw, dim, plan.kp, plan.vector, *plan.products[0][0].tile_shape,
        _build.stream_of(img))
    patchify_fused.launches += 1
    return (out, rows[:, :plan.k]) if save_rows else out


class _Patchify(torch.autograd.Function):
    """The kernel forward (with the patch rows when the weight needs a
    gradient); dW = rows^T dy, dpos = sum_B dy, dbias = sum dpos. The
    backward launches no kernel."""

    @staticmethod
    def forward(ctx, img, weight, bias, pos):
        save_rows = ctx.needs_input_grad[1]
        res = patchify_kernel(img, weight, bias, pos, save_rows)
        out, rows = res if save_rows else (res, None)
        ctx.save_for_backward(img, weight, rows)
        ctx.has_pos = pos is not None
        return out

    @staticmethod
    def backward(ctx, g):
        img, weight, rows = ctx.saved_tensors
        dimg = dweight = dbias = dpos = None
        if ctx.needs_input_grad[0]:
            leaf = img.detach().requires_grad_(True)
            with torch.enable_grad():
                y = patchify_reference(leaf, weight, torch.zeros_like(weight[:, 0, 0, 0, 0]))
            dimg = torch.autograd.grad(y, leaf, g)[0]
        if rows is not None:
            dim = weight.shape[0]
            dweight = torch.matmul(g.reshape(-1, dim).t(), rows).reshape(weight.shape)
        dp = g.float().sum(0)
        if ctx.has_pos and ctx.needs_input_grad[3]:
            dpos = dp.to(g.dtype)
        if ctx.needs_input_grad[2]:
            dbias = dp.sum(0).to(g.dtype)
        return dimg, dweight, dbias, dpos


def patchify_fused(img: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same contract as :func:`patchify_reference`; the kernel on CUDA, and
    differentiable in weight, bias and pos (and, through the plain version,
    the volume). Weight, bias and pos are cast to the volume's dtype."""
    dt = img.dtype
    weight, bias = weight.to(dt), bias.to(dt)
    pos = None if pos is None else pos.to(dt)
    if _build.needs_grad(img, weight, bias, pos):
        return _Patchify.apply(img, weight, bias, pos)
    return patchify_kernel(img, weight, bias, pos)


patchify_fused.launches = 0
