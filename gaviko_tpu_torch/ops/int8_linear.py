"""Opt-in int8 (w8a8) serving GEMMs: LN + linear, linear, and the whole MLP.

Port of ``gaviko_tpu/ops/int8_linear.py``. Symmetric per-output-channel
int8 weights (offline, :func:`quantize_weight`, kept beside the originals
as ``<key>::int8`` / ``<key>::int8_scale`` sidecars by
:func:`quantize_backbone`) and symmetric per-row dynamic int8 activations
(a row pass). On the card :func:`int8_linear` and :func:`int8_mlp` run the
kernels of ``csrc/int8_linear.cu``: a row pass (LN when asked, then each
row's int8 codes and scale into scratch), then the products on the port's
Hopper GEMM (``csrc/gemm_sm90.cuh``: s8 wgmma fed by TMA, int32 sums),
dequantized in f32 before bias, GELU and residual in their epilogues; the
MLP's fc1 writes its f32 GELU output and each row's amax, a row pass turns
it into codes, and fc2 follows. :func:`int8_plan` is their plan
(launches, tiles, padding, scratch), made only here; they take every width
JAX's functions take. ``int8_linear_reference`` and ``int8_mlp_reference``
are their plain PyTorch versions. Serving only, as in the JAX package: a
call that needs a gradient raises.

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
import functools
import logging
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gaviko_tpu_torch.ops import _blocks, _build
from gaviko_tpu_torch.ops.fused_mlp import GELU_MODES, gelu_by_mode, gelu_mode
from gaviko_tpu_torch.ops.gemm_plan import (
    GemmProduct, _layout, _scratch, gemm_smem, launch_tiles)

# Sidecar param-key suffixes carrying the quantized backbone (the JAX
# package's names, so a quantized dict moves between the packages as is).
INT8_SUFFIX = "::int8"
SCALE_SUFFIX = "::int8_scale"

# GEMM sites quantized (key suffixes; every block-naming scheme: the plain
# ViT's transformer.layers.{i}.{0,1}.*, GAViKO's transformer.attns/mlps.{i}).
_SITE_SUFFIXES = (".to_qkv.weight", ".to_out.0.weight", ".net.1.weight", ".net.4.weight")

# The codes' and the weights' row strides are multiples of this many bytes
# (TMA's global strides); a row pass's block takes ROW_BLOCK rows, a warp
# each.
K_ALIGN = 16
ROW_BLOCK = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LINEAR_ARGTYPES = (_P,) * 9 + (_I,) * 4 + (_F, _I, _I, _P)
_MLP_ARGTYPES = (_P,) * 15 + (_I,) * 5 + (_F,) + (_I,) * 6 + (_P,)
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


class Int8Plan(NamedTuple):
    """What B11 runs for one call: :func:`int8_plan`."""
    kind: str        # "linear" or "mlp"
    rows: int
    k: int           # the in-width (the MLP's dim)
    n: int           # the out-width (the MLP's mlp_dim)
    dtype: torch.dtype
    k_pad: int       # k rounded up to K_ALIGN: the row stride of the codes and the weight
    n_pad: int       # the MLP's hidden rounded up to K_ALIGN (its codes, fc2's depth); linear: n
    row_vector: int  # elements a lane of the row pass loads at once (16 bytes, or 1)
    row_blocks: int  # blocks of the row pass
    # The GEMM launches: int8_linear's product after its row pass; the
    # MLP's fc1 after its row pass, then fc2 after the hidden's codes.
    products: Tuple[Tuple[GemmProduct, ...], ...]
    padded: Tuple[str, ...]  # the weights that take a zero-padded copy (K not a multiple)
    scratch: Tuple[Tuple[str, Tuple[int, ...], torch.dtype, int], ...]
    scratch_bytes: int
    smem: int        # the GEMM's shared memory a CTA at the largest of its tiles, bytes
    launches: int    # kernel launches a call


def _pad(k: int) -> int:
    return -(-k // K_ALIGN) * K_ALIGN


def int8_plan(kind: str, rows: int, k: int, n: int, dtype: torch.dtype = torch.bfloat16,
              block=None) -> Int8Plan:
    """The plan of B11 for ``rows`` rows: int8_linear (``kind`` "linear")
    from ``k`` to ``n`` columns, or int8_mlp ("mlp") of width ``k`` with an
    ``n``-wide hidden (made only here; the wrappers hand its scratch, tiles
    and padded weights to the kernels). Any widths: the row pass loops over
    a row, the products run on the int8 tiles of ``ops/_blocks.py``'s
    choice (resolved here, outside the plan's cache; ``block`` forces a
    tile's rows, and no variable overrides it, as in JAX) with 128-code k
    tiles (TMA zero-fills past the edges), and a width that is no multiple
    of 16 is padded to one (codes written by the row pass, weights copied
    once). Raises only where no kernel can run: no rows or columns, a dtype
    other than bf16 / f32, or a matrix of 2**31 elements or more."""
    def tile(m, n_out):
        return _blocks.gemm_tile(((m, n_out),), torch.int8, block=block)

    tiles = (tile(rows, n),) if kind != "mlp" else (tile(rows, n), tile(rows, k))
    return _int8_plan(kind, rows, k, n, dtype, tiles)


@functools.lru_cache(maxsize=256)
def _int8_plan(kind: str, rows: int, k: int, n: int, dtype: torch.dtype, tiles) -> Int8Plan:
    if kind not in ("linear", "mlp"):
        raise ValueError(f"int8_plan: kind is 'linear' or 'mlp', got {kind!r}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"kernels take bfloat16 or float32, got {dtype}")
    if rows < 1 or k < 1 or n < 1:
        raise ValueError(f"int8_{kind}: no rows or columns (rows {rows}, {k} -> {n})")
    k_pad = _pad(k)
    n_pad = _pad(n) if kind == "mlp" else n
    if max(rows, n) * max(k_pad, n_pad) >= 2 ** 31:
        raise NotImplementedError(
            f"int8_{kind} kernels take matrices under 2**31 elements; got rows {rows}, "
            f"{k} -> {n}")
    vec = 16 // dtype.itemsize
    i8, f32 = torch.int8, torch.float32
    P = GemmProduct
    if kind == "linear":
        products = ((P("linear", rows, n, k_pad, tiles[0]),),)
        padded = ("w",) if k_pad != k else ()
        scratch = (("codes", (rows, k_pad), i8), ("sx", (rows,), f32))
    else:
        products = ((P("fc1", rows, n, k_pad, tiles[0]),), (P("fc2", rows, k, n_pad, tiles[1]),))
        padded = tuple(w for w, kk in (("w1", k), ("w2", n)) if _pad(kk) != kk)
        scratch = (("codes_x", (rows, k_pad), i8), ("codes_h", (rows, n_pad), i8),
                   ("hidden", (rows, n), f32), ("sx", (rows,), f32), ("hmax", (rows,), f32))
    layout, nbytes = _layout(scratch)
    smem = max(gemm_smem(torch.int8, t) for t in tiles)
    # The row pass before the products; the MLP's hidden codes between them.
    launches = 1 + len(products) + (kind == "mlp")
    return Int8Plan(kind, rows, k, n, dtype, k_pad, n_pad, vec if k % vec == 0 else 1,
                    -(-rows // ROW_BLOCK), products, padded, layout, nbytes, smem, launches)


# Zero-padded copies of sidecars whose K is no multiple of K_ALIGN, one a
# sidecar: id -> (a weak reference to it, its version, the copy). An entry
# goes when its sidecar does.
_PADDED: Dict[int, Tuple[weakref.ref, int, torch.Tensor]] = {}


def padded_codes(w_i8: torch.Tensor, k_pad: int) -> torch.Tensor:
    """``w_i8`` (out, in) with its rows zero-padded to ``k_pad`` codes (TMA
    reads rows whose bytes are a multiple of 16): the tensor itself where
    they already are, else its copy, made once and kept while the sidecar
    lives and is not written to."""
    if w_i8.shape[1] == k_pad:
        return w_i8
    key = id(w_i8)
    version = 0 if w_i8.is_inference() else w_i8._version  # inference tensors keep none
    hit = _PADDED.get(key)
    if hit is not None and hit[0]() is w_i8 and hit[1] == version:
        return hit[2]
    pad = torch.zeros((w_i8.shape[0], k_pad), dtype=torch.int8, device=w_i8.device)
    pad[:, :w_i8.shape[1]] = w_i8
    if hit is None:
        weakref.finalize(w_i8, _PADDED.pop, key, None)
    _PADDED[key] = (weakref.ref(w_i8), version, pad)
    return pad


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _widened(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """A float parameter narrower than an f32 ``x`` widened to f32, exactly
    as the plain version reads it (EVP's f32 stream on bf16 LN and bias
    weights); anything else as it is."""
    if (t is not None and x.dtype == torch.float32 and t.dtype != x.dtype
            and t.is_floating_point()):
        return t.float()
    return t


def int8_linear(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, gamma: Optional[torch.Tensor] = None,
                beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                block: Optional[int] = None) -> torch.Tensor:
    """Same contract as :func:`int8_linear_reference`; the kernels on CUDA
    (two launches: the row pass, then the GEMM), where an f32 ``x`` takes
    narrower LN and bias weights widened, as the reference reads them.
    Refuses a gradient on either device. ``block`` forces the GEMM's tile
    rows (an A/B run; ``ops/_blocks.py`` chooses otherwise)."""
    _build.refuse_grad("int8_linear", _SERVING_ONLY, x, bias, gamma, beta)
    if not _build.use_kernel(x):
        return int8_linear_reference(x, w_i8, w_scale, bias, gamma, beta, eps)
    if torch.compiler.is_exporting():
        return _build.op("int8_linear")(x, w_i8, w_scale, bias, gamma, beta, float(eps))
    din = x.shape[-1]
    dout = _check_weight("int8_linear", w_i8, w_scale, din)
    if (gamma is None) != (beta is None):
        raise ValueError("int8_linear: gamma and beta come together")
    plan = int8_plan("linear", x.numel() // max(din, 1), din, dout, x.dtype, block)
    x, w_scale = x.contiguous(), w_scale.float().contiguous()
    gamma, beta, bias = (_widened(t, x) for t in (gamma, beta, bias))
    floats = [t for t in (x, gamma, beta, bias) if t is not None]
    _build.check_cuda("int8_linear", *floats)
    for t, n in ((gamma, din), (beta, din), (bias, dout)):
        if t is not None and t.numel() != n:
            raise ValueError(f"int8_linear: expected {n} entries, got {tuple(t.shape)}")
    w = padded_codes(w_i8, plan.k_pad)
    _build.check_cuda("int8_linear", w)
    _build.check_cuda("int8_linear", w_scale)
    out = torch.empty((*x.shape[:-1], dout), device=x.device, dtype=x.dtype)
    scratch = _scratch(plan.scratch, plan.scratch_bytes, x.device)
    _build.launch(
        "int8_linear", f"gaviko_int8_linear_{_build.dtype_suffix(x)}", _LINEAR_ARGTYPES,
        x.data_ptr(), _ptr(gamma), _ptr(beta), w.data_ptr(), w_scale.data_ptr(), _ptr(bias),
        out.data_ptr(), scratch["codes"], scratch["sx"], plan.rows, din, plan.k_pad, dout, eps,
        *launch_tiles(plan.products), _build.stream_of(x))
    int8_linear.launches += 1
    return out


int8_linear.launches = 0


def int8_mlp(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             w1_i8: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
             w2_i8: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor,
             eps: float = 1e-5, approximate="exact", residual: bool = False,
             block: Optional[int] = None) -> torch.Tensor:
    """Same contract as :func:`int8_mlp_reference`; the kernels on CUDA (four
    launches: the row pass, fc1 writing the f32 hidden and its rows' maxima,
    the hidden's codes, fc2), where an f32 ``x`` takes narrower LN and bias
    weights widened, as the reference reads them. Refuses a gradient on
    either device. ``block`` forces both GEMMs' tile rows (an A/B run)."""
    _build.refuse_grad("int8_mlp", _SERVING_ONLY, x, gamma, beta, b1, b2)
    if not _build.use_kernel(x):
        return int8_mlp_reference(x, gamma, beta, w1_i8, s1, b1, w2_i8, s2, b2, eps,
                                  approximate, residual)
    if torch.compiler.is_exporting():
        return _build.op("int8_mlp")(x, gamma, beta, w1_i8, s1, b1, w2_i8, s2, b2, float(eps),
                                     gelu_mode(approximate), bool(residual))
    dim = x.shape[-1]
    mlp_dim = _check_weight("int8_mlp fc1", w1_i8, s1, dim)
    if _check_weight("int8_mlp fc2", w2_i8, s2, mlp_dim) != dim:
        raise ValueError(f"int8_mlp: fc2 must map {mlp_dim} -> {dim}")
    plan = int8_plan("mlp", x.numel() // max(dim, 1), dim, mlp_dim, x.dtype, block)
    x, s1, s2 = x.contiguous(), s1.float().contiguous(), s2.float().contiguous()
    gamma, beta, b1, b2 = (_widened(t, x) for t in (gamma, beta, b1, b2))
    _build.check_cuda("int8_mlp", x, gamma, beta, b1, b2)
    if gamma.numel() != dim or beta.numel() != dim or b1.numel() != mlp_dim \
            or b2.numel() != dim:
        raise ValueError("int8_mlp: gamma, beta, b2 must be (dim,) and b1 (mlp_dim,)")
    w1, w2 = padded_codes(w1_i8, plan.k_pad), padded_codes(w2_i8, plan.n_pad)
    for t in (w1, w2, s1, s2):
        _build.check_cuda("int8_mlp", t)
    out = torch.empty_like(x)
    scratch = _scratch(plan.scratch, plan.scratch_bytes, x.device)
    _build.launch(
        "int8_linear", f"gaviko_int8_mlp_{_build.dtype_suffix(x)}", _MLP_ARGTYPES,
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        scratch["codes_x"], scratch["codes_h"], scratch["hidden"], scratch["sx"],
        scratch["hmax"], plan.rows, dim, plan.k_pad, mlp_dim, plan.n_pad, eps,
        GELU_MODES.index(gelu_mode(approximate)), int(residual), *launch_tiles(plan.products),
        _build.stream_of(x))
    int8_mlp.launches += 1
    return out


int8_mlp.launches = 0
