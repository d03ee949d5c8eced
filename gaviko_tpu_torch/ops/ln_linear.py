"""LayerNorm + bias-free Linear, ``LN(x) @ W^T``, forward and backward kernels.

Port of ``gaviko_tpu/ops/ln_linear.py``. Two kernels, both on the port's
Hopper GEMM (``csrc/gemm_sm90.cuh``: bf16 on wgmma fed by TMA, f32 as
3xTF32 on the tensor cores):

- B9, the forward (``csrc/ln_linear.cu``): an LN pass writes the
  normalised activations into scratch, then one product with W as stored,
  rounded once in its epilogue (2 launches a call);
  ``ln_linear_reference`` is its plain PyTorch version;
- B12, the backward (``csrc/ln_linear_bwd.cu``, :func:`ln_linear_bwd`):
  dx, dgamma, dbeta and dW from x, W and the incoming gradient, LN
  recomputed: a row pass, dW and dh in one GEMM launch, the LN backward's
  row pass and the column sums (4 launches);
  ``ln_linear_bwd_reference`` is its plain version.

:func:`ln_linear_plan` is their plan (launches, tiles, scratch), made only
here. They take any width whose rows are whole 16-byte vectors (every shape
JAX's gates admit, and wider), so no width is refused for shared memory.

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
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.ops import _blocks, _build
from gaviko_tpu_torch.ops.gemm_plan import (
    ROW_BLOCK, TILE, GemmProduct, _layout, _scratch, gemm_smem, launch_tiles)

# The JAX package's weight budget (its VMEM residency gate) and the hybrid
# backward's (weights and an f32 dW accumulator resident). Kept as they are
# so one configuration takes the same route in both packages.
_WEIGHT_BUDGET = 4_000_000
_HYBRID_BUDGET = 45_000_000

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 6 + (_I,) * 3 + (_F, _I, _I, _P)
_BWD_ARGTYPES = (_P,) * 15 + (_I,) * 3 + (_F, _I, _I, _P)


def ln_linear_supported(dim: int, out_dim: int, dtype: torch.dtype) -> bool:
    return (dim % 128 == 0 and out_dim % 128 == 0
            and dim * out_dim * dtype.itemsize <= _WEIGHT_BUDGET)


def ln_linear_hybrid_supported(dim: int, out_dim: int, dtype: torch.dtype) -> bool:
    """The JAX package's gate of ``ln_linear_hybrid`` and of B12 (its
    backward's VMEM fit: the weight and an f32 dW accumulator)."""
    return (dim % 128 == 0 and out_dim % 128 == 0
            and dim * out_dim * (dtype.itemsize + 4) <= _HYBRID_BUDGET)


class LnLinearPlan(NamedTuple):
    """What B9 or B12 runs for one call: :func:`ln_linear_plan`."""
    kind: str        # one of KINDS
    rows: int
    dim: int
    out: int
    dtype: torch.dtype
    chunk: int       # depth of a k tile: 128 bytes of columns
    smem: int        # the GEMM's shared memory a CTA, bytes
    # The GEMM launches, each one or more products: B9's h W^T after its LN
    # pass; B12's dW and dh (or dh alone) in one launch after its row pass.
    products: Tuple[Tuple[GemmProduct, ...], ...]
    row_blocks: int  # blocks of B12's LN-backward row pass (a row of partials each); B9: 0
    scratch: Tuple[Tuple[str, Tuple[int, ...], torch.dtype, int], ...]
    scratch_bytes: int
    launches: int    # kernel launches a call


# B9; B12 with dW; B12 without (a frozen W).
KINDS = ("forward", "backward", "backward_dh")


def ln_linear_plan(kind: str, rows: int, dim: int, out: int,
                   dtype: torch.dtype = torch.bfloat16) -> LnLinearPlan:
    """The plan of B9 (``kind`` "forward") or B12 ("backward", or
    "backward_dh" without dW) for ``rows`` rows of width ``dim`` and an
    ``out``-wide projection (made only here; the wrappers hand its scratch
    and tile to the kernels). Every product runs on the GEMM with k tiles of
    128 bytes (64 bf16 / 32 f32 columns), each CTA over its product's whole
    depth, TMA zero-filling past every edge, on its launch's tile
    (``ops/_blocks.py``, resolved here, outside the plan's cache;
    ``GAVIKO_LNL_BLOCK`` overrides it); B12's dW, whose depth is the rows,
    shares a launch with dh, whose tiles fill its last wave. Raises only
    where no kernel can run: a dtype other than bf16 / f32, no rows or
    columns, a K stride (the rows of x and W, and for B12 of dy) that is no
    multiple of 16 bytes (TMA's global strides), or a matrix of 2**31
    elements or more."""
    shapes = ((rows, out),) if kind == "forward" else \
        ((out, dim), (rows, dim)) if kind == "backward" else ((rows, dim),)
    tile = _blocks.gemm_tile(shapes, dtype, _blocks.LNL_ENV) if dtype in _blocks.TILES else TILE
    return _ln_linear_plan(kind, rows, dim, out, dtype, tile)


@functools.lru_cache(maxsize=256)
def _ln_linear_plan(kind: str, rows: int, dim: int, out: int, dtype: torch.dtype,
                    tile) -> LnLinearPlan:
    if kind not in KINDS:
        raise ValueError(f"ln_linear_plan: kind is one of {KINDS}, got {kind!r}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"kernels take bfloat16 or float32, got {dtype}")
    if rows < 1 or dim < 1 or out < 1:
        raise ValueError(f"ln_linear: no rows or columns (rows {rows}, {dim} -> {out})")
    strides = {"dim": dim} if kind == "forward" else {"dim": dim, "out": out}
    for name, n in strides.items():
        if n * dtype.itemsize % 16:
            raise NotImplementedError(
                f"ln_linear kernels take rows of whole 16-byte vectors (TMA's strides): "
                f"{name} {n} in {dtype}")
    if max(rows * dim, rows * out, out * dim) >= 2 ** 31:
        raise NotImplementedError(
            f"ln_linear kernels take matrices under 2**31 elements; got rows {rows}, "
            f"{dim} -> {out}")
    P, dt, f32 = GemmProduct, dtype, torch.float32
    if kind == "forward":
        products = ((P("linear", rows, out, dim, tile),),)
        row_blocks = 0
        scratch = (("h", (rows, dim), dt),)
        launches = 2  # the LN pass, the GEMM
    else:
        dh = P("dh", rows, dim, out, tile)
        products = ((P("dw", out, dim, rows, tile), dh),) if kind == "backward" else ((dh,),)
        row_blocks = -(-rows // ROW_BLOCK)
        scratch = ((("h", (rows, dim), dt),) if kind == "backward" else ()) + (
            ("dh", (rows, dim), f32), ("mean", (rows,), f32), ("rstd", (rows,), f32),
            ("part_dg", (row_blocks, dim), f32), ("part_db", (row_blocks, dim), f32))
        launches = 4  # the row pass, the GEMM, the LN backward's row pass, the sums
    layout, nbytes = _layout(scratch)
    return LnLinearPlan(kind, rows, dim, out, dtype, 128 // dtype.itemsize, gemm_smem(dtype, tile),
                        products, row_blocks, layout, nbytes, launches)


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
    if torch.compiler.is_exporting():
        return _build.op("ln_linear")(x, gamma, beta, w, float(eps))
    dim, out_dim = x.shape[-1], w.shape[0]
    if tuple(w.shape) != (out_dim, dim) or gamma.shape != (dim,) or beta.shape != (dim,):
        raise ValueError(f"fused_ln_linear: w (out, {dim}), gamma and beta ({dim},); got "
                         f"w {tuple(w.shape)}")
    plan = ln_linear_plan("forward", x.numel() // max(dim, 1), dim, out_dim, x.dtype)
    x = x.contiguous()
    _build.check_cuda("fused_ln_linear", x, gamma, beta, w)
    out = torch.empty((*x.shape[:-1], out_dim), device=x.device, dtype=x.dtype)
    sc = _scratch(plan.scratch, plan.scratch_bytes, x.device)
    _build.launch(
        "ln_linear", f"gaviko_ln_linear_{_build.dtype_suffix(x)}", _ARGTYPES,
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), out.data_ptr(),
        sc["h"], plan.rows, dim, out_dim, eps, *launch_tiles(plan.products),
        _build.stream_of(x))
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
    """Same contract as :func:`ln_linear_bwd_reference`; B12 on CUDA (four
    launches: the row pass, dW and dh in one GEMM launch, the LN backward's
    row pass, the column sums), at every shape :func:`ln_linear_plan`
    takes, else it raises."""
    if not _build.use_kernel(x):
        return ln_linear_bwd_reference(x, gamma, beta, w, dy, eps, need_dw)
    dim, out_dim = x.shape[-1], w.shape[0]
    if (tuple(w.shape) != (out_dim, dim) or gamma.shape != (dim,) or beta.shape != (dim,)
            or tuple(dy.shape) != (*x.shape[:-1], out_dim)):
        raise ValueError("ln_linear_bwd: w (out, dim), gamma and beta (dim,), "
                         "dy x's shape with out columns")
    plan = ln_linear_plan("backward" if need_dw else "backward_dh", x.numel() // max(dim, 1),
                          dim, out_dim, x.dtype)
    x, dy = x.contiguous(), dy.contiguous()
    _build.check_cuda("ln_linear_bwd", x, gamma, beta, w, dy)
    dx, dgamma, dbeta = torch.empty_like(x), torch.empty_like(gamma), torch.empty_like(beta)
    dw = torch.empty_like(w) if need_dw else None
    sc = _scratch(plan.scratch, plan.scratch_bytes, x.device)
    _build.launch(
        "ln_linear_bwd", f"gaviko_ln_linear_bwd_{_build.dtype_suffix(x)}", _BWD_ARGTYPES,
        *(t.data_ptr() for t in (x, gamma, beta, w, dy, dx, dgamma, dbeta)),
        None if dw is None else dw.data_ptr(), sc.get("h"),
        *(sc[n] for n in ("dh", "mean", "rstd", "part_dg", "part_db")),
        plan.rows, dim, out_dim, eps, *launch_tiles(plan.products), _build.stream_of(x))
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
