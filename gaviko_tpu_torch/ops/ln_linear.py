"""LayerNorm + bias-free Linear, ``LN(x) @ W^T``, forward and backward kernels.

Port of ``gaviko_tpu/ops/ln_linear.py``. Two kernels:

- B9, the forward (``csrc/ln_linear.cu``), normalises a row tile once into
  shared memory and walks the output columns, so the normalised
  activations never reach device memory; ``ln_linear_reference`` is its
  plain PyTorch version;
- B12, the backward (``csrc/ln_linear_bwd.cu``, :func:`ln_linear_bwd`):
  dx, dgamma, dbeta and dW from x, W and the incoming gradient, LN
  recomputed; ``ln_linear_bwd_reference`` is its plain version.

Two entry points, as in the JAX package:

- :func:`fused_ln_linear`: B9, and under a gradient B12 as its backward
  (JAX's custom VJP) where ``ln_linear_hybrid_supported`` holds; elsewhere
  its backward is autograd through ``ln_linear_reference``, JAX's own XLA
  VJP there. The qkv projection and the CLS-fast kv projection take it at
  inference, and wherever a gradient flows through a layer run with
  ``train=False`` (GAViKO's frozen global layers);
- :func:`ln_linear_hybrid`: the train route behind
  ``GAVIKO_LNQKV_HYBRID=1`` (``core/vit.py``): LN and one GEMM in the
  working dtype forward, B12 backward.

Rounding order (the TPU kernels'): mean and variance in f32,
``(x - mean) * rsqrt(var + eps)`` rounded to the working dtype, ``* gamma``
and ``+ beta`` each rounded in it, then the product accumulated in f32 and
rounded once. The backward keeps xhat in f32 for dgamma and dx, forms dh =
dy W in f32 without rounding it, and rounds dW (f32 sums of dy^T h) once.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.ops import _build

# The JAX package's weight budget (its VMEM residency gate) and the hybrid
# backward's (weights and an f32 dW accumulator resident). Kept as they are
# so one configuration takes the same route in both packages.
_WEIGHT_BUDGET = 4_000_000
_HYBRID_BUDGET = 45_000_000
KERNEL_MAX_DIM = 1024  # widest row the forward kernel stages in shared memory
_ROW_BLOCK = 32  # rows a block of B12's row passes (its column partials)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 5 + (_I,) * 3 + (_F, _P)
_BWD_ARGTYPES = (_P,) * 15 + (_I,) * 3 + (_F, _P)


def ln_linear_supported(dim: int, out_dim: int, dtype: torch.dtype) -> bool:
    return (dim % 128 == 0 and out_dim % 128 == 0
            and dim * out_dim * dtype.itemsize <= _WEIGHT_BUDGET)


def ln_linear_hybrid_supported(dim: int, out_dim: int, dtype: torch.dtype) -> bool:
    """The JAX package's gate of ``ln_linear_hybrid`` and of B12 (its
    backward's VMEM fit: the weight and an f32 dW accumulator)."""
    return (dim % 128 == 0 and out_dim % 128 == 0
            and dim * out_dim * (dtype.itemsize + 4) <= _HYBRID_BUDGET)


def layer_norm_rounded(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """LN with f32 statistics, the normalised value rounded to ``x``'s dtype,
    then ``* gamma`` and ``+ beta`` in that dtype (``F.layer_norm`` in bf16
    rounds elsewhere)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    h = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return h * gamma + beta


def ln_linear_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [..., dim], w (out, dim) torch layout -> [..., out] in x's dtype."""
    h = layer_norm_rounded(x, gamma, beta, eps)
    return torch.matmul(h.float(), w.float().t()).to(x.dtype)


def _ln_linear_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       w: torch.Tensor, eps: float) -> torch.Tensor:
    """B9 on CUDA (its output has no backward), the plain version on the CPU."""
    if not _build.use_kernel(x):
        return ln_linear_reference(x, gamma, beta, w, eps)
    dim = x.shape[-1]
    out_dim = w.shape[0]
    if dim % 64 or dim > KERNEL_MAX_DIM or out_dim % 8 or w.shape[1] != dim:
        raise NotImplementedError(
            f"fused_ln_linear kernel takes dim a multiple of 64 up to "
            f"{KERNEL_MAX_DIM} and out a multiple of 8; got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}")
    if gamma.shape != (dim,) or beta.shape != (dim,):
        raise ValueError(f"gamma and beta must be ({dim},)")
    x = x.contiguous()
    _build.check_cuda("fused_ln_linear", x, gamma, beta, w)
    rows = x.numel() // dim
    out = torch.empty((*x.shape[:-1], out_dim), device=x.device, dtype=x.dtype)
    _build.launch(
        "ln_linear", f"gaviko_ln_linear_{_build.dtype_suffix(x)}", _ARGTYPES,
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), out.data_ptr(),
        rows, dim, out_dim, eps, _build.stream_of(x))
    fused_ln_linear.launches += 1
    return out


def ln_linear_bwd_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                            w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5,
                            need_dw: bool = True):
    """The algebra of B12 (the JAX package's ``_ln_linear_bwd_kernel``) in
    plain PyTorch, f32 sums with the kernel's rounding points: x [..., dim],
    w (out, dim), dy [..., out] -> (dx, dgamma, dbeta, dw), dx in x's dtype,
    dgamma, dbeta and dw in their parameters' dtypes; dw is None unless
    ``need_dw``."""
    dim, out_dim = x.shape[-1], w.shape[0]
    xf = x.reshape(-1, dim).float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    dyf = dy.reshape(-1, out_dim).float()
    dh = torch.matmul(dyf, w.float())
    dgamma = (dh * xhat).sum(0)
    dbeta = dh.sum(0)
    dxhat = dh * gamma.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dw = None
    if need_dw:
        h = xhat.to(x.dtype) * gamma + beta
        dw = torch.matmul(dyf.t(), h.float()).to(w.dtype)
    return (dx.to(x.dtype).reshape(x.shape), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw)


def ln_linear_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5,
                  need_dw: bool = True):
    """Same contract as :func:`ln_linear_bwd_reference`; B12 on CUDA. Rows
    take any count; dim a multiple of 128 and out a multiple of 8 (every
    shape the hybrid gate admits), else it raises."""
    if not _build.use_kernel(x):
        return ln_linear_bwd_reference(x, gamma, beta, w, dy, eps, need_dw)
    dim, out_dim = x.shape[-1], w.shape[0]
    rows = x.numel() // dim
    if dim % 128 or out_dim % 8 or rows < 1:
        raise NotImplementedError(
            f"ln_linear_bwd kernel takes dim a multiple of 128, out a multiple of 8 "
            f"and at least one row; got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if (tuple(w.shape) != (out_dim, dim) or gamma.shape != (dim,) or beta.shape != (dim,)
            or tuple(dy.shape) != (*x.shape[:-1], out_dim)):
        raise ValueError("ln_linear_bwd: w (out, dim), gamma and beta (dim,), "
                         "dy x's shape with out columns")
    x, dy = x.contiguous(), dy.contiguous()
    _build.check_cuda("ln_linear_bwd", x, gamma, beta, w, dy)
    dev, f32 = x.device, torch.float32
    dx, dgamma, dbeta = torch.empty_like(x), torch.empty_like(gamma), torch.empty_like(beta)
    dw = torch.empty_like(w) if need_dw else None
    h = torch.empty((rows, dim), device=dev, dtype=x.dtype) if need_dw else None
    row_blocks = -(-rows // _ROW_BLOCK)
    scratch = (torch.empty((rows, dim), device=dev, dtype=f32),
               torch.empty(rows, device=dev, dtype=f32), torch.empty(rows, device=dev, dtype=f32),
               torch.empty((row_blocks, dim), device=dev, dtype=f32),
               torch.empty((row_blocks, dim), device=dev, dtype=f32))
    _build.launch(
        "ln_linear_bwd", f"gaviko_ln_linear_bwd_{_build.dtype_suffix(x)}", _BWD_ARGTYPES,
        *(t.data_ptr() for t in (x, gamma, beta, w, dy, dx, dgamma, dbeta)),
        None if dw is None else dw.data_ptr(), None if h is None else h.data_ptr(),
        *(t.data_ptr() for t in scratch), rows, dim, out_dim, eps, _build.stream_of(x))
    ln_linear_bwd.launches += 1
    return dx, dgamma, dbeta, dw


ln_linear_bwd.launches = 0


def _backward(ctx, g):
    """The JAX package's ``_ln_linear_bwd``: B12 where the hybrid gate
    holds, else autograd through ``ln_linear_reference`` (its XLA VJP)."""
    x, gamma, beta, w = ctx.saved_tensors
    with _build.plain_versions(ctx.plain):
        if ln_linear_hybrid_supported(x.shape[-1], w.shape[0], x.dtype):
            dx, dgamma, dbeta, dw = ln_linear_bwd(x, gamma, beta, w, g, ctx.eps,
                                                  need_dw=ctx.needs_input_grad[3])
        else:
            leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta, w)]
            with torch.enable_grad():
                y = ln_linear_reference(*leaves, ctx.eps)
            dx, dgamma, dbeta, dw = torch.autograd.grad(y, leaves, g)
    return dx, dgamma, dbeta, dw, None


class _FusedLnLinear(torch.autograd.Function):
    """B9 forward, B12 backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, eps):
        ctx.save_for_backward(x, gamma, beta, w)
        ctx.eps = eps
        ctx.plain = _build.plain_active()
        return _ln_linear_forward(x, gamma, beta, w, eps)

    backward = staticmethod(_backward)


class _LnLinearHybrid(torch.autograd.Function):
    """LN and one working-dtype GEMM forward, B12 backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, eps):
        ctx.save_for_backward(x, gamma, beta, w)
        ctx.eps = eps
        ctx.plain = _build.plain_active()
        return F.linear(layer_norm_rounded(x, gamma, beta, eps), w)

    backward = staticmethod(_backward)


def fused_ln_linear(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Same contract as :func:`ln_linear_reference`; B9 on CUDA, and
    differentiable (B12 backward where the hybrid gate holds)."""
    if _build.needs_grad(x, gamma, beta, w):
        return _FusedLnLinear.apply(x, gamma, beta, w, float(eps))
    return _ln_linear_forward(x, gamma, beta, w, eps)


fused_ln_linear.launches = 0


def ln_linear_hybrid(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``LN(x) @ w.T`` as ``layer_norm_rounded`` and one GEMM in x's dtype
    (the JAX package computes that forward in XLA), differentiable through
    B12."""
    if _build.needs_grad(x, gamma, beta, w):
        return _LnLinearHybrid.apply(x, gamma, beta, w, float(eps))
    return F.linear(layer_norm_rounded(x, gamma, beta, eps), w)
