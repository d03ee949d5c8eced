"""Opt-in int8 (w8a8) serving GEMMs: LN + linear, linear, and the whole MLP.

Port of ``gaviko_tpu/ops/int8_linear.py``. Symmetric per-output-channel
int8 weights (offline, :func:`quantize_weight`, kept beside the originals
as ``<key>::int8`` / ``<key>::int8_scale`` sidecars by
:func:`quantize_backbone`) and symmetric per-row dynamic int8 activations
(inside the kernel). On the card :func:`int8_linear` and :func:`int8_mlp`
run the kernels of ``csrc/int8_linear.cu`` (int32 accumulation on the
card's integer MMA, dequantized in f32 before bias, GELU and residual);
``int8_linear_reference`` and ``int8_mlp_reference`` are their plain
PyTorch versions. Serving only, as in the JAX package: a call that needs a
gradient raises.

Numerics, the JAX kernel's to the bit: weight scales divide
(``max(amax, 1e-12) / 127``, then ``w / scale``), activation scales
multiply by reciprocals (``max(amax, 1e-12) * (1 / 127)``, then
``x * (1 / sx)``); round half to even, then clip to [-127, 127]; LN and
GELU in f32, the LN output not rounded to the input dtype before it is
quantized; the int32 sum dequantized as ``float(acc) * (sx * w_scale)``,
with ``+ bias`` fused into that product as one multiply-add (``fma_f32``:
XLA contracts the JAX kernel's ``acc * s + bias`` into an FMA, and a code
of the MLP's hidden moves when the two round differently), then ``+ x``.
The plain versions form the integer products in float64, which is exact
here (127^2 * K < 2^53) where f32 would not be (2^24 is passed from
K = 1041), and run on either device.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional

import torch

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.fused_mlp import GELU_MODES, gelu_by_mode, gelu_mode

# Sidecar param-key suffixes carrying the quantized backbone (the JAX
# package's names, so a quantized dict moves between the packages as is).
INT8_SUFFIX = "::int8"
SCALE_SUFFIX = "::int8_scale"

# GEMM sites quantized (key suffixes; every block-naming scheme: the plain
# ViT's transformer.layers.{i}.{0,1}.*, GAViKO's transformer.attns/mlps.{i}).
_SITE_SUFFIXES = (".to_qkv.weight", ".to_out.0.weight", ".net.1.weight", ".net.4.weight")

KERNEL_MAX_DIM = 2048  # widest row the kernels' LN + quantize prologue takes
_BM, _BK, _RING = 32, 128, 3 * 128 * 144  # the kernels' row block, k tile, ring bytes
_SMEM_LIMIT = 232_448 - 1024  # an H100 block's shared memory, less the static arrays

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LINEAR_ARGTYPES = (_P,) * 7 + (_I,) * 3 + (_F, _P)
_MLP_ARGTYPES = (_P,) * 11 + (_I,) * 3 + (_F, _I, _I, _P)
_SERVING_ONLY = "int8 is serving-only, as in the JAX package: training ignores the sidecars"


def quantize_weight(w: torch.Tensor):
    """(out, in) torch-layout weight -> (int8 (out, in), f32 (1, out) scale):
    symmetric per output channel, scale = amax(|w|, in) / 127."""
    wf = w.float()
    amax = wf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w_i8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_i8, scale.reshape(1, -1)


def quantize_backbone(params: dict, depth: Optional[int] = None) -> dict:
    """A NEW flat dict: ``params`` plus ``<key>::int8`` / ``<key>::int8_scale``
    for every backbone GEMM weight. The originals stay; the model's serving
    path switches to the int8 kernels where it finds the sidecars
    (``core/vit.py``). ``depth`` is unused (sites are found by key). GAViKO's
    local-attention stack is left out (its weights feed its own kernel), and
    SSF models are refused with a warning and returned unchanged: ssf_ada
    sits between LN and every GEMM, so the fused LN would be wrong there."""
    if any("ssf_scale" in k for k in params):
        logging.warning(
            "int8 quantization is not supported for SSF models "
            "(ssf_ada sits between LN and the GEMMs); serving full precision.")
        return dict(params)
    out = dict(params)
    for key in list(params):
        if key.endswith(_SITE_SUFFIXES) and ".local_attns." not in key:
            w_i8, scale = quantize_weight(out[key])
            out[key + INT8_SUFFIX] = w_i8
            out[key + SCALE_SUFFIX] = scale
    return out


def has_int8(params: dict, key: str) -> bool:
    return (key + INT8_SUFFIX) in params


def _ln_f32(xf: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LN entirely in f32 (the port's ``layer_norm`` rounds to the input
    dtype, which the int8 kernels do not)."""
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _quant_rows(xf: torch.Tensor):
    """f32 (rows, d) -> (int8 codes as f32, f32 (rows, 1) scale)."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
    return torch.clamp(torch.round(xf * sx.reciprocal()), -127, 127), sx


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 values rounded once to f32, as a fused
    multiply-add rounds. The product is exact in float64 (24 + 24 bits);
    the sum is rounded to float64 and then to f32, which differs from one
    rounding only where the float64 sum lands exactly on an f32 midpoint
    while the exact sum does not: there the sum is moved one float64 place
    toward the exact value (its error from the two-sum) before the second
    rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # p + c == s + err exactly
    r = s.float().double()
    inf = torch.full_like(s, float("inf"))
    other = torch.nextafter(s.float(), torch.where(s > r, inf, -inf).float()).double()
    tie = (s != r) & (other - s == s - r) & (err != 0)
    s = torch.where(tie, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


def _int8_matmul(codes: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """The exact int32 sum codes . w_i8^T, as f32 (rounded once, as the
    kernel's int32 -> f32 conversion rounds): float64 products are exact."""
    return torch.matmul(codes.double(), w_i8.double().t()).float()


def int8_linear_reference(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          gamma: Optional[torch.Tensor] = None,
                          beta: Optional[torch.Tensor] = None,
                          eps: float = 1e-5) -> torch.Tensor:
    """x [..., in], w_i8 (out, in) int8, w_scale (1, out) f32 -> [..., out]
    in x's dtype; LN first when ``gamma`` is given."""
    xf = x.float()
    if gamma is not None:
        xf = _ln_f32(xf, gamma, beta, eps)
    codes, sx = _quant_rows(xf)
    acc, m = _int8_matmul(codes, w_i8), sx * w_scale.float().reshape(-1)
    out = acc * m if bias is None else fma_f32(acc, m, bias.float())
    return out.to(x.dtype)


def int8_mlp_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       w1_i8: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                       w2_i8: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor,
                       eps: float = 1e-5, approximate="exact",
                       residual: bool = False) -> torch.Tensor:
    """LN -> int8 fc1 + b1 -> GELU (``approximate``: the mode or the legacy
    bool) -> int8 fc2 + b2 (+ x) -> x's dtype."""
    xf = x.float()
    h_codes, sh = _quant_rows(_ln_f32(xf, gamma, beta, eps))
    a = fma_f32(_int8_matmul(h_codes, w1_i8), sh * s1.float().reshape(-1), b1.float())
    g_codes, sg = _quant_rows(gelu_by_mode(a, approximate))
    out = fma_f32(_int8_matmul(g_codes, w2_i8), sg * s2.float().reshape(-1), b2.float())
    if residual:
        out = out + xf
    return out.to(x.dtype)


def _check_weight(name: str, w_i8: torch.Tensor, w_scale: torch.Tensor, din: int) -> int:
    if w_i8.dtype != torch.int8 or w_i8.dim() != 2 or w_i8.shape[1] != din:
        raise ValueError(f"{name}: weight must be int8 (out, {din}), got {w_i8.dtype} "
                         f"{tuple(w_i8.shape)}")
    dout = w_i8.shape[0]
    if not w_scale.is_floating_point() or w_scale.numel() != dout:
        raise ValueError(f"{name}: scale must be floating point with {dout} entries, got "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    return dout


def _check_dims(name: str, k: int, n: int) -> None:
    if k % 16 or k > KERNEL_MAX_DIM or n % 2:
        raise NotImplementedError(
            f"{name} kernel takes rows a multiple of 16 wide up to {KERNEL_MAX_DIM} "
            f"and an even output width; got {k} -> {n}")


def _smem_bytes(k: int) -> int:
    return _RING + _BM * (-(-k // _BK) * _BK + 16)


def int8_linear(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, gamma: Optional[torch.Tensor] = None,
                beta: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Same contract as :func:`int8_linear_reference`; the kernel on CUDA.
    Refuses a gradient on either device."""
    _build.refuse_grad("int8_linear", _SERVING_ONLY, x, bias, gamma, beta)
    if not _build.use_kernel(x):
        return int8_linear_reference(x, w_i8, w_scale, bias, gamma, beta, eps)
    din = x.shape[-1]
    dout = _check_weight("int8_linear", w_i8, w_scale, din)
    _check_dims("int8_linear", din, dout)
    if (gamma is None) != (beta is None):
        raise ValueError("int8_linear: gamma and beta come together")
    x, w_scale = x.contiguous(), w_scale.float().contiguous()
    floats = [t for t in (x, gamma, beta, bias) if t is not None]
    _build.check_cuda("int8_linear", *floats)
    _build.check_cuda("int8_linear", w_i8)
    _build.check_cuda("int8_linear", w_scale)
    for t, n in ((gamma, din), (beta, din), (bias, dout)):
        if t is not None and t.numel() != n:
            raise ValueError(f"int8_linear: expected {n} entries, got {tuple(t.shape)}")
    rows = x.numel() // din
    out = torch.empty((*x.shape[:-1], dout), device=x.device, dtype=x.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch(
        "int8_linear", f"gaviko_int8_linear_{_build.dtype_suffix(x)}", _LINEAR_ARGTYPES,
        x.data_ptr(), ptr(gamma), ptr(beta), w_i8.data_ptr(), w_scale.data_ptr(), ptr(bias),
        out.data_ptr(), rows, din, dout, eps, _build.stream_of(x))
    int8_linear.launches += 1
    return out


int8_linear.launches = 0


def int8_mlp(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             w1_i8: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
             w2_i8: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor,
             eps: float = 1e-5, approximate="exact", residual: bool = False) -> torch.Tensor:
    """Same contract as :func:`int8_mlp_reference`; the kernel on CUDA (one
    launch; the f32 hidden passes through a device scratch). Refuses a
    gradient on either device."""
    _build.refuse_grad("int8_mlp", _SERVING_ONLY, x, gamma, beta, b1, b2)
    if not _build.use_kernel(x):
        return int8_mlp_reference(x, gamma, beta, w1_i8, s1, b1, w2_i8, s2, b2, eps,
                                  approximate, residual)
    dim = x.shape[-1]
    mlp_dim = _check_weight("int8_mlp fc1", w1_i8, s1, dim)
    if _check_weight("int8_mlp fc2", w2_i8, s2, mlp_dim) != dim:
        raise ValueError(f"int8_mlp: fc2 must map {mlp_dim} -> {dim}")
    _check_dims("int8_mlp", dim, mlp_dim)
    if mlp_dim % 16 or _smem_bytes(max(dim, mlp_dim)) > _SMEM_LIMIT:
        raise NotImplementedError(
            f"int8_mlp kernel stages a block's {_BM} hidden rows in shared memory; "
            f"mlp_dim {mlp_dim} does not fit (or is no multiple of 16)")
    x, s1, s2 = x.contiguous(), s1.float().contiguous(), s2.float().contiguous()
    _build.check_cuda("int8_mlp", x, gamma, beta, b1, b2)
    for t in (w1_i8, w2_i8, s1, s2):
        _build.check_cuda("int8_mlp", t)
    if gamma.numel() != dim or beta.numel() != dim or b1.numel() != mlp_dim \
            or b2.numel() != dim:
        raise ValueError("int8_mlp: gamma, beta, b2 must be (dim,) and b1 (mlp_dim,)")
    rows = x.numel() // dim
    hidden = torch.empty((rows, mlp_dim), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    _build.launch(
        "int8_linear", f"gaviko_int8_mlp_{_build.dtype_suffix(x)}", _MLP_ARGTYPES,
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1_i8.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), w2_i8.data_ptr(), s2.data_ptr(), b2.data_ptr(), hidden.data_ptr(),
        out.data_ptr(), rows, dim, mlp_dim, eps, GELU_MODES.index(gelu_mode(approximate)),
        int(residual), _build.stream_of(x))
    int8_mlp.launches += 1
    return out


int8_mlp.launches = 0
