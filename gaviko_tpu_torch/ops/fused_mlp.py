"""Fused transformer MLP: LN -> fc1 + b1 -> GELU -> fc2 + b2 (+ x), forward.

Port of ``gaviko_tpu/ops/fused_mlp.py``. On the card it runs the kernel in
``csrc/fused_mlp.cu``: a block keeps a tile of normalised rows in shared
memory, walks the hidden dimension in chunks, stages each GELU'd chunk in
shared memory and accumulates the fc2 output in registers, so the
``(rows, mlp_dim)`` hidden never reaches device memory. ``mlp_reference`` is
its plain PyTorch version.

Rounding order (the TPU kernel's): LN as in ``ops/ln_linear.py``; fc1
accumulated in f32, ``+ b1`` and the GELU in f32, then rounded to the
working dtype; fc2 accumulated in f32, ``+ b2`` and ``+ x`` in f32, rounded
once. The ``exact`` GELU is the JAX kernel's Abramowitz & Stegun erf
(``erf_f32``), so both packages compute the same function.

Dropout inside the kernel (salts 0 and 1) and the backward kernel wait for
the vit-b16 train slice: ``dropout_rate > 0`` raises, and on the card a call
that needs a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.ln_linear import layer_norm_rounded

# The JAX package's weight budget (its VMEM residency gate), kept as is so
# one configuration takes the same route in both packages.
_WEIGHT_VMEM_BUDGET = 12_000_000
KERNEL_MAX_DIM = 1024  # widest row the kernel takes (output tile in registers)
GELU_MODES = ("exact", "tanh", "erf_fast")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 8 + (_I,) * 5 + (_F, _P)
_TRAIN_SLICE = "the vit-b16 train slice, ROADMAP Queue B items 6-7"

# erf ~= sign(a) * tanh(C1|a| + C3|a|^3 + C5|a|^5): the JAX package's
# erf_fast fit.
_EF_C1 = 1.1281153655981508
_EF_C3 = 0.1041330662360045
_EF_C5 = -0.0017956401545075685


def erf_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 erf by Abramowitz & Stegun 7.1.26 (max abs error ~2.5e-6): the
    TPU kernel's ``exact`` erf."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu_exact_f32(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + erf_f32(x * 0.7071067811865476))


def erf_fast_f32(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    a2 = a * a
    return torch.sign(x) * torch.tanh(a * (_EF_C1 + a2 * (_EF_C3 + a2 * _EF_C5)))


def gelu_erf_fast_f32(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + erf_fast_f32(x * 0.7071067811865476))


def gelu_mode(gelu) -> str:
    """Legacy bools (True = 'tanh') and the spec strings -> a mode string."""
    if gelu is True:
        return "tanh"
    if gelu is False or gelu is None:
        return "exact"
    return str(gelu)


def gelu_by_mode(h: torch.Tensor, gelu) -> torch.Tensor:
    mode = gelu_mode(gelu)
    if mode == "tanh":
        return F.gelu(h, approximate="tanh")
    if mode == "erf_fast":
        return gelu_erf_fast_f32(h)
    return gelu_exact_f32(h)


def _chunk_plan(dim: int, mlp_dim: int, itemsize: int) -> Optional[int]:
    """-> the JAX kernel's hidden chunk (a divisor of mlp_dim, multiple of
    128) whose weight slices fit its budget, or None."""
    chunk = mlp_dim
    while 2 * dim * chunk * itemsize > _WEIGHT_VMEM_BUDGET:
        if chunk % 2 or (chunk // 2) % 128:
            return None
        chunk //= 2
    return chunk


def fused_mlp_supported(dim: int, mlp_dim: int, dtype: torch.dtype) -> bool:
    return (dim % 128 == 0 and mlp_dim % 128 == 0
            and _chunk_plan(dim, mlp_dim, dtype.itemsize) == mlp_dim)


def mlp_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, eps: float = 1e-5, gelu="exact",
                  residual: bool = False) -> torch.Tensor:
    """x [..., dim]; w1 (mlp, dim), w2 (dim, mlp) torch layout -> [..., dim]
    in x's dtype; ``residual`` returns x + branch."""
    h = layer_norm_rounded(x, gamma, beta, eps)
    a = torch.matmul(h.float(), w1.float().t()) + b1.float()
    g = gelu_by_mode(a, gelu).to(x.dtype)
    out = torch.matmul(g.float(), w2.float().t()) + b2.float()
    if residual:
        out = out + x.float()
    return out.to(x.dtype)


def fused_mlp(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              eps: float = 1e-5, gelu="exact", dropout_rate: float = 0.0,
              residual: bool = False) -> torch.Tensor:
    """Same contract as :func:`mlp_reference` at ``dropout_rate`` 0; the
    kernel on CUDA, whose output has no backward."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            f"dropout inside the fused MLP is not ported yet ({_TRAIN_SLICE})")
    if not _build.use_kernel(x):
        return mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps, gelu,
                             residual=residual)
    _build.refuse_grad("fused_mlp", _TRAIN_SLICE, x, gamma, beta, w1, b1, w2, b2)
    mode = gelu_mode(gelu)
    if mode not in GELU_MODES:
        raise ValueError(f"gelu mode must be one of {GELU_MODES}, got {mode!r}")
    dim = x.shape[-1]
    mlp_dim = w1.shape[0]
    if dim % 128 or dim > KERNEL_MAX_DIM or mlp_dim % 128:
        raise NotImplementedError(
            f"fused_mlp kernel takes dim a multiple of 128 up to {KERNEL_MAX_DIM} "
            f"and mlp_dim a multiple of 128; got dim {dim}, mlp_dim {mlp_dim}")
    if (tuple(w1.shape) != (mlp_dim, dim) or tuple(w2.shape) != (dim, mlp_dim)
            or b1.shape != (mlp_dim,) or b2.shape != (dim,)
            or gamma.shape != (dim,) or beta.shape != (dim,)):
        raise ValueError("fused_mlp: w1 (mlp, dim), b1 (mlp,), w2 (dim, mlp), b2, "
                         "gamma and beta (dim,)")
    x = x.contiguous()  # e.g. GAViKO's last layer passes a row slice
    _build.check_cuda("fused_mlp", x, gamma, beta, w1, b1, w2, b2)
    rows = x.numel() // dim
    out = torch.empty_like(x)
    _build.launch(
        "fused_mlp", f"gaviko_fused_mlp_{_build.dtype_suffix(x)}", _ARGTYPES,
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, dim, mlp_dim,
        GELU_MODES.index(mode), int(residual), eps, _build.stream_of(x))
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
