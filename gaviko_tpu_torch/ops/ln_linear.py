"""Fused LayerNorm + bias-free Linear: ``LN(x) @ W^T`` in one kernel.

Port of ``gaviko_tpu/ops/ln_linear.py`` (forward). On the card it runs the
kernel in ``csrc/ln_linear.cu``, which normalises a row tile once into
shared memory and walks the output columns, so the normalised activations
never reach device memory; ``ln_linear_reference`` is its plain PyTorch
version. The serving path uses it for the qkv projection and for the kv
projection of the CLS-fast last layer (``core/vit.py``).

Rounding order (the TPU kernel's): mean and variance in f32,
``(x - mean) * rsqrt(var + eps)`` rounded to the working dtype, ``* gamma``
and ``+ beta`` each rounded in it, then the product accumulated in f32 and
rounded once. The backward (``ln_linear_hybrid``, off by default in the JAX
package) is not ported: on the card a call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

from gaviko_tpu_torch.ops import _build

# The JAX package's weight budget (its VMEM residency gate). Kept as is so
# one configuration takes the same route in both packages.
_WEIGHT_BUDGET = 4_000_000
KERNEL_MAX_DIM = 1024  # widest row the kernel stages in shared memory

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 5 + (_I,) * 3 + (_F, _P)
_NO_BACKWARD = ("inference only, as in the JAX package: training takes LN and a "
                "GEMM; its backward kernel is ROADMAP Queue B item 12")


def ln_linear_supported(dim: int, out_dim: int, dtype: torch.dtype) -> bool:
    return (dim % 128 == 0 and out_dim % 128 == 0
            and dim * out_dim * dtype.itemsize <= _WEIGHT_BUDGET)


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


def fused_ln_linear(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Same contract as :func:`ln_linear_reference`; the kernel on CUDA,
    whose output has no backward."""
    if not _build.use_kernel(x):
        return ln_linear_reference(x, gamma, beta, w, eps)
    _build.refuse_grad("fused_ln_linear", _NO_BACKWARD, x, gamma, beta, w)
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


fused_ln_linear.launches = 0
