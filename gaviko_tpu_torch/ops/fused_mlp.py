"""Fused transformer MLP: LN -> fc1 + b1 -> GELU -> drop -> fc2 + b2 -> drop
(+ x), forward and backward.

Port of ``gaviko_tpu/ops/fused_mlp.py``. On the card the forward runs kernel
B6 (``csrc/fused_mlp.cu``): an LN row pass into scratch, then fc1 and fc2 on
the port's Hopper GEMM (``csrc/gemm_sm90.cuh``: bf16 on wgmma fed by TMA,
f32 as 3xTF32 on the tensor cores), the bias, GELU, dropout, residual and
roundings in the products' epilogues, the hidden passing through device
memory. The backward, kernel B7 (``csrc/fused_mlp_bwd.cu``), runs from the
pre-GELU hidden ``a`` the forward saved: two row passes, its four products
on the same GEMM and one launch of column sums. :func:`mlp_plan` is their
plan (launches, tiles, scratch), made only here. ``mlp_reference`` and
``mlp_bwd_reference`` are their plain PyTorch versions.

Rounding order (the TPU kernel's): LN as in ``ops/ln_linear.py``; fc1
accumulated in f32, ``+ b1``, the GELU and the dropout in f32, then rounded
to the working dtype; fc2 accumulated in f32, ``+ b2``, the dropout and
``+ x`` in f32, rounded once. The ``exact`` GELU is the JAX kernel's
Abramowitz & Stegun erf (``erf_f32``), so both packages compute the same
function.

Dropout is the TPU kernel's hash (``ops/hash_dropout.py``): salt 0 on the
hidden at (flat row, hidden column), salt 1 on the fc2 output at (flat row,
output column), before the residual; the backward replays both masks. A
tensor-parallel rank holding hidden columns [c0, c0 + mlp) of a wider layer
passes ``hidden_col0=c0``, so its hidden bits are the whole layer's.
:func:`fused_mlp` is differentiable: under a gradient the forward saves
``a`` and the backward is the kernel. B6 and B7 keep their intermediates in
device memory, so they take every width JAX's gate admits (and any multiple
of 128 beyond it); JAX's VMEM gate for its backward (``_mlp_bwd_supported``)
has no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.ops import _blocks, _build
from gaviko_tpu_torch.ops.gemm_plan import (  # noqa: F401 (SMEM_LIMIT, launch_tile: the plan's API)
    ROW_BLOCK, SMEM_LIMIT, TILE, GemmProduct, _layout, _scratch, gemm_smem, launch_tile,
    launch_tiles)
from gaviko_tpu_torch.ops.hash_dropout import dropout_args, keep_mask
from gaviko_tpu_torch.ops.ln_linear import layer_norm_rounded

# The JAX package's weight budget (its VMEM residency gate), kept as is so
# one configuration takes the same route in both packages.
_WEIGHT_VMEM_BUDGET = 12_000_000
GELU_MODES = ("exact", "tanh", "erf_fast")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DROP = (_I, _I, _F)  # seed, threshold, 1 / (1 - rate)
_TILES = (_I,) * 4  # two launches' tiles: (bm, bn) each
_ARGTYPES = (_P,) * 11 + (_I,) * 5 + (_F,) + _DROP + (_I,) + _TILES + (_P,)
_BWD_ARGTYPES = (_P,) * 25 + (_I,) * 5 + (_F,) + _DROP + (_I,) + _TILES + (_P,)


class MlpPlan(NamedTuple):
    """What B6 and B7 run for (rows, dim, mlp, dtype): :func:`mlp_plan`."""
    rows: int
    dim: int
    mlp: int
    dtype: torch.dtype
    chunk: int       # depth of a k tile: 128 bytes of columns
    smem: int        # the GEMM's shared memory a CTA at the largest of its tiles, bytes
    # The GEMM launches, each one or more products: B6's fc1 and fc2 after
    # its LN pass; B7's dg, then dw2, dw1 and dh in one launch.
    forward: Tuple[Tuple[GemmProduct, ...], ...]
    backward: Tuple[Tuple[GemmProduct, ...], ...]
    fwd_scratch: Tuple[Tuple[str, Tuple[int, ...], torch.dtype, int], ...]
    bwd_scratch: Tuple[Tuple[str, Tuple[int, ...], torch.dtype, int], ...]
    fwd_scratch_bytes: int
    bwd_scratch_bytes: int
    launches: Tuple[int, int]  # kernel launches a call of B6, of B7


def mlp_tiles(rows: int, dim: int, mlp: int, dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """The tiles of B6's fc1 and fc2 launches and of B7's dg launch and its
    launch of dW2, dW1 and dh (``ops/_blocks.py``; ``GAVIKO_MLP_BLOCK``
    overrides all four, read at every call)."""
    def tile(*shapes):
        return _blocks.gemm_tile(shapes, dtype, _blocks.MLP_ENV)

    return (tile((rows, mlp)), tile((rows, dim)), tile((rows, mlp)),
            tile((dim, mlp), (mlp, dim), (rows, dim)))


def mlp_plan(rows: int, dim: int, mlp: int, dtype: torch.dtype = torch.bfloat16) -> MlpPlan:
    """The plan of B6 and B7 for ``rows`` rows of width ``dim`` and an
    ``mlp``-wide hidden (made only here; the wrappers hand its scratch and
    tiles to the kernels). Every product runs on the GEMM with k tiles of
    128 bytes (64 bf16 / 32 f32 columns), each CTA over its product's whole
    depth, on its launch's tile (:func:`mlp_tiles`, resolved here, outside
    the plan's cache); the weight gradients, whose depth is the rows, share
    a launch with dh, whose tiles fill their last wave. Raises where the
    kernels cannot run: dim or mlp not a positive multiple of 128, no rows,
    a dtype other than bf16 / f32, or a matrix of 2**31 elements or more."""
    tiles = mlp_tiles(rows, dim, mlp, dtype) if dtype in _blocks.TILES else (TILE,) * 4
    return _mlp_plan(rows, dim, mlp, dtype, tiles)


@functools.lru_cache(maxsize=256)
def _mlp_plan(rows: int, dim: int, mlp: int, dtype: torch.dtype, tiles) -> MlpPlan:
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"kernels take bfloat16 or float32, got {dtype}")
    if dim < 1 or mlp < 1 or dim % _blocks.BN or mlp % _blocks.BN:
        raise NotImplementedError(
            f"fused_mlp kernels take dim and mlp_dim positive multiples of {_blocks.BN}; got "
            f"dim {dim}, mlp_dim {mlp}")
    if rows < 1:
        raise ValueError(f"fused_mlp: no rows ({rows})")
    if rows * max(dim, mlp) >= 2 ** 31 or dim * mlp >= 2 ** 31:
        raise NotImplementedError(
            f"fused_mlp kernels take matrices under 2**31 elements; got rows {rows}, dim "
            f"{dim}, mlp_dim {mlp}")
    chunk = 128 // dtype.itemsize
    f32, dt = torch.float32, dtype
    fc1_tile, fc2_tile, dg_tile, grads_tile = tiles
    # dg's launch writes a row of db1's partials a tile of its rows.
    row_blocks, tiles_m = -(-rows // ROW_BLOCK), -(-rows // dg_tile[0])
    fwd_scratch, fwd_bytes = _layout((("h", (rows, dim), dt), ("g", (rows, mlp), dt)))
    bwd = [("h", (rows, dim), dt), ("dout", (rows, dim), dt), ("gd", (rows, mlp), dt),
           ("da", (rows, mlp), dt), ("dh", (rows, dim), f32), ("mean", (rows,), f32),
           ("rstd", (rows,), f32), ("part_db2", (row_blocks, dim), f32),
           ("part_db1", (tiles_m, mlp), f32), ("part_dg", (row_blocks, dim), f32),
           ("part_db", (row_blocks, dim), f32)]
    bwd_scratch, bwd_bytes = _layout(bwd)
    smem = max(gemm_smem(dtype, t) for t in tiles)
    g = GemmProduct
    return MlpPlan(
        rows, dim, mlp, dtype, chunk, smem,
        ((g("fc1", rows, mlp, dim, fc1_tile),), (g("fc2", rows, dim, mlp, fc2_tile),)),
        ((g("dg", rows, mlp, dim, dg_tile),),
         (g("dw2", dim, mlp, rows, grads_tile), g("dw1", mlp, dim, rows, grads_tile),
          g("dh", rows, dim, mlp, grads_tile))),
        fwd_scratch, bwd_scratch, fwd_bytes, bwd_bytes, (3, 5))


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


def gelu_grad_f32(a: torch.Tensor, gelu) -> torch.Tensor:
    """d/da of :func:`gelu_by_mode` in f32, the JAX kernel's
    ``_gelu_grad_f32`` (for erf_fast and exact, the derivative of the
    approximation computed)."""
    mode = gelu_mode(gelu)
    if mode == "tanh":
        c = 0.7978845608028654
        t = torch.tanh(c * (a + 0.044715 * a * a * a))
        du = c * (1.0 + 3.0 * 0.044715 * a * a)
        return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * du
    if mode == "erf_fast":
        z = a * 0.7071067811865476
        az = z.abs()
        a2 = az * az
        t = torch.tanh(az * (_EF_C1 + a2 * (_EF_C3 + a2 * _EF_C5)))
        dp = _EF_C1 + a2 * (3.0 * _EF_C3 + a2 * (5.0 * _EF_C5))
        return (0.5 * (1.0 + torch.sign(z) * t)
                + a * 0.5 * (1.0 - t * t) * dp * 0.7071067811865476)
    phi = torch.exp(-0.5 * a * a) * 0.3989422804014327  # N(0, 1) pdf
    return 0.5 * (1.0 + erf_f32(a * 0.7071067811865476)) + a * phi


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


def _keep_factor(rows: int, cols: int, seed: int, rate: float, salt: int,
                 device, col0: int = 0) -> torch.Tensor:
    """keep / (1 - rate) over [rows, cols] at (flat row, col0 + column) of
    ``salt``."""
    keep = keep_mask((rows, cols), seed, rate, salt=salt, col_offset=col0, device=device)
    return keep.float() * (1.0 / (1.0 - rate))


def mlp_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, eps: float = 1e-5, gelu="exact",
                  dropout_rate: float = 0.0, residual: bool = False, seed: int = 0,
                  save_a: bool = False, hidden_col0: int = 0):
    """x [..., dim]; w1 (mlp, dim), w2 (dim, mlp) torch layout -> [..., dim]
    in x's dtype; ``residual`` returns x + branch; ``dropout_rate`` > 0 drops
    the hidden and the output with the int32 ``seed``. With ``save_a`` also
    the pre-GELU hidden ``a`` [rows, mlp] in x's dtype, as the kernel saves
    it for its backward."""
    dim, mlp = x.shape[-1], w1.shape[0]
    rows = x.numel() // dim
    h = layer_norm_rounded(x, gamma, beta, eps).reshape(rows, dim)
    a = torch.matmul(h.float(), w1.float().t()) + b1.float()
    g = gelu_by_mode(a, gelu)
    if dropout_rate > 0.0:
        g = g * _keep_factor(rows, mlp, seed, dropout_rate, 0, x.device, hidden_col0)
    out = torch.matmul(g.to(x.dtype).float(), w2.float().t()) + b2.float()
    if dropout_rate > 0.0:
        out = out * _keep_factor(rows, dim, seed, dropout_rate, 1, x.device)
    out = out.reshape(x.shape)
    if residual:
        out = out + x.float()
    out = out.to(x.dtype)
    return (out, a.to(x.dtype)) if save_a else out


def fused_mlp_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      eps: float = 1e-5, gelu="exact", dropout_rate: float = 0.0,
                      residual: bool = False, seed: int = 0, save_a: bool = False,
                      hidden_col0: int = 0):
    """Same contract as :func:`mlp_reference`: kernel B6 on CUDA (its plain
    version on the CPU) -> out, or (out, a) with ``save_a``. Its outputs have
    no backward: the train path differentiates :func:`fused_mlp`."""
    drop = dropout_args(dropout_rate, seed) + (int(hidden_col0),)
    if not _build.use_kernel(x):
        return mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps, gelu, dropout_rate,
                             residual, seed, save_a, hidden_col0)
    _build.refuse_grad("fused_mlp_forward", "the gradient goes through fused_mlp",
                       x, gamma, beta, w1, b1, w2, b2)
    mode = gelu_mode(gelu)
    if mode not in GELU_MODES:
        raise ValueError(f"gelu mode must be one of {GELU_MODES}, got {mode!r}")
    if torch.compiler.is_exporting():
        # hidden_col0 (a mesh rank's hidden slice) moves dropout bits only.
        if dropout_rate > 0.0 or save_a:
            raise NotImplementedError("an exported forward runs fused_mlp without dropout "
                                      "or saved hidden")
        return _build.op("fused_mlp")(x, gamma, beta, w1, b1, w2, b2, float(eps), mode,
                                      bool(residual))
    dim = x.shape[-1]
    mlp_dim = w1.shape[0]
    rows = x.numel() // dim
    plan = mlp_plan(rows, dim, mlp_dim, x.dtype)
    if (tuple(w1.shape) != (mlp_dim, dim) or tuple(w2.shape) != (dim, mlp_dim)
            or b1.shape != (mlp_dim,) or b2.shape != (dim,)
            or gamma.shape != (dim,) or beta.shape != (dim,)):
        raise ValueError("fused_mlp: w1 (mlp, dim), b1 (mlp,), w2 (dim, mlp), b2, "
                         "gamma and beta (dim,)")
    x = x.contiguous()  # e.g. GAViKO's last layer passes a row slice
    _build.check_cuda("fused_mlp", x, gamma, beta, w1, b1, w2, b2)
    out = torch.empty_like(x)
    a = torch.empty((rows, mlp_dim), device=x.device, dtype=x.dtype) if save_a else None
    scratch = _scratch(plan.fwd_scratch, plan.fwd_scratch_bytes, x.device)
    _build.launch(
        "fused_mlp", f"gaviko_fused_mlp_{_build.dtype_suffix(x)}", _ARGTYPES,
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), None if a is None else a.data_ptr(),
        scratch["h"], scratch["g"], rows, dim, mlp_dim, GELU_MODES.index(mode), int(residual),
        eps, *drop, *launch_tiles(plan.forward), _build.stream_of(x))
    fused_mlp.launches += 1
    return (out, a) if save_a else out


class _FusedMlp(torch.autograd.Function):
    """Kernel B6 forward, saving ``a``; kernel B7 backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps, gelu, dropout_rate, residual, seed,
                hidden_col0):
        out, a = fused_mlp_forward(x, gamma, beta, w1, b1, w2, b2, eps, gelu, dropout_rate,
                                   residual, seed, save_a=True, hidden_col0=hidden_col0)
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2, a)
        ctx.cfg = (eps, gelu, dropout_rate, residual, seed, hidden_col0)
        ctx.plain = _build.plain_active()
        return out

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w1, b1, w2, b2, a = ctx.saved_tensors
        eps, gelu, rate, residual, seed, col0 = ctx.cfg
        with _build.plain_versions(ctx.plain):
            grads = fused_mlp_bwd(x, gamma, beta, w1, b1, w2, b2, g, a, eps, gelu, rate,
                                  residual, seed, col0)
        return (*grads, None, None, None, None, None, None)


def fused_mlp(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              eps: float = 1e-5, gelu="exact", dropout_rate: float = 0.0,
              residual: bool = False, seed: Optional[int] = None,
              hidden_col0: int = 0) -> torch.Tensor:
    """Same contract as :func:`mlp_reference`; kernel B6 on CUDA, and
    differentiable (kernel B7 backward). ``seed`` is the int32 dropout seed
    (unused at rate 0)."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")
    args = (x, gamma, beta, w1, b1, w2, b2, eps, gelu, float(dropout_rate), residual,
            0 if seed is None else int(seed), int(hidden_col0))
    if _build.needs_grad(x, gamma, beta, w1, b1, w2, b2):
        return _FusedMlp.apply(*args)
    return fused_mlp_forward(*args[:-1], hidden_col0=args[-1])


fused_mlp.launches = 0


def mlp_bwd_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                      eps: float = 1e-5, gelu="exact", dropout_rate: float = 0.0,
                      residual: bool = False, seed: int = 0, hidden_col0: int = 0):
    """The algebra of kernel B7 (the JAX package's ``_mlp_bwd_kernel``) in
    plain PyTorch, f32 sums with the kernel's rounding points: from x, the
    incoming gradient dy and the saved pre-GELU hidden a [rows, mlp] ->
    (dx, dgamma, dbeta, dw1, db1, dw2, db2), dx in x's dtype and each weight
    gradient in its weight's dtype."""
    dt = x.dtype
    dim, mlp = x.shape[-1], w1.shape[0]
    xf = x.reshape(-1, dim).float()
    rows = xf.shape[0]
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    h = xhat.to(dt) * gamma + beta
    af = a.reshape(rows, mlp).float()
    gdrop = gelu_by_mode(af, gelu)
    dout = dy.reshape(rows, dim).float()
    dx_res = dout if residual else 0.0
    if dropout_rate > 0.0:
        f0 = _keep_factor(rows, mlp, seed, dropout_rate, 0, x.device, hidden_col0)
        gdrop = gdrop * f0
        dout = dout * _keep_factor(rows, dim, seed, dropout_rate, 1, x.device)
    db2 = dout.sum(0)
    dout16 = dout.to(dt).float()
    dw2 = torch.matmul(dout16.t(), gdrop.to(dt).float())
    dg = torch.matmul(dout16, w2.float())
    if dropout_rate > 0.0:
        dg = dg * f0
    da = dg * gelu_grad_f32(af, gelu)
    da16 = da.to(dt).float()
    db1 = da.sum(0)
    dw1 = torch.matmul(da16.t(), h.float())
    dh = torch.matmul(da16, w1.float())
    dgamma = (dh * xhat).sum(0)
    dbeta = dh.sum(0)
    dxhat = dh * gamma.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True)) + dx_res
    return (dx.to(dt).reshape(x.shape), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


def fused_mlp_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  dy: torch.Tensor, a: torch.Tensor, eps: float = 1e-5, gelu="exact",
                  dropout_rate: float = 0.0, residual: bool = False, seed: int = 0,
                  hidden_col0: int = 0):
    """Same contract as :func:`mlp_bwd_reference`; kernel B7 on CUDA."""
    drop = dropout_args(dropout_rate, seed) + (int(hidden_col0),)
    if not _build.use_kernel(x):
        return mlp_bwd_reference(x, gamma, beta, w1, b1, w2, b2, dy, a, eps, gelu,
                                 dropout_rate, residual, seed, hidden_col0)
    mode = gelu_mode(gelu)
    if mode not in GELU_MODES:
        raise ValueError(f"gelu mode must be one of {GELU_MODES}, got {mode!r}")
    dim, mlp_dim = x.shape[-1], w1.shape[0]
    rows = x.numel() // dim
    plan = mlp_plan(rows, dim, mlp_dim, x.dtype)
    if (tuple(w1.shape) != (mlp_dim, dim) or tuple(w2.shape) != (dim, mlp_dim)
            or gamma.shape != (dim,) or beta.shape != (dim,)
            or dy.shape != x.shape or a.numel() != rows * mlp_dim):
        raise ValueError("fused_mlp_bwd: w1 (mlp, dim), w2 (dim, mlp), gamma and beta "
                         "(dim,), dy like x, a (rows, mlp)")
    x, dy, a = x.contiguous(), dy.contiguous(), a.contiguous()
    _build.check_cuda("fused_mlp_bwd", x, gamma, beta, w1, b1, w2, b2, dy, a)
    outs = (torch.empty_like(x), torch.empty_like(gamma), torch.empty_like(beta),
            torch.empty_like(w1), torch.empty_like(b1), torch.empty_like(w2),
            torch.empty_like(b2))
    sc = _scratch(plan.bwd_scratch, plan.bwd_scratch_bytes, x.device)
    _build.launch(
        "fused_mlp_bwd", f"gaviko_fused_mlp_bwd_{_build.dtype_suffix(x)}", _BWD_ARGTYPES,
        *(t.data_ptr() for t in (x, gamma, beta, w1, w2, dy, a, *outs)),
        *(sc[n] for n in ("h", "dout", "gd", "da", "dh", "mean", "rstd", "part_db2",
                          "part_db1", "part_dg", "part_db")),
        rows, dim, mlp_dim, GELU_MODES.index(mode), int(residual), eps, *drop,
        *launch_tiles(plan.backward), _build.stream_of(x))
    fused_mlp_bwd.launches += 1
    return outs


fused_mlp_bwd.launches = 0
