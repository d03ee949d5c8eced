"""Single-query (CLS) attention over a packed ``[K | V]`` projection.

Port of ``gaviko_tpu/ops/cls_attention.py``. In the last layer of a
``pool='cls'`` model only the CLS row's output is used, so attention there is
one query row ``q0`` against every key (``core/vit.py``'s CLS-fast path). On
the card it runs the kernel in ``csrc/cls_attention.cu``, which reads K
once for the scores and V once for the output;
``cls_attention_reference`` is its plain PyTorch version. The TPU kernel's
head-indicator matmul worked around a Mosaic shape rule and is not ported.
One kernel serves every head dim: its grid is (heads, B, splits), the keys
split into runs (:func:`cls_plan`, made only here) so that the grid fills
two waves of the card's SMs, and the last CTA of each (batch, head)
combines the runs' partial softmax sums in split order (one launch; a
rerun is bit-equal). The tickets that find that CTA and the partials live
in scratch buffers kept a device (the tickets zero between calls), so calls
on one device run on one stream at a time.

Scores, softmax and the weighted sum of V run in f32 over the keys below
``n_true``; the output is rounded once to the working dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from gaviko_tpu_torch.ops import _build

_HP = 128  # the JAX kernel's padded head count
SMS = 132  # the H100's streaming multiprocessors
WAVES = 2  # waves of CTAs the plan fills
MIN_KEYS = 32  # keys a run takes at least
MAX_KEYS = 8192  # keys a run takes at most: its scores sit in shared memory
LANES = 8  # lanes of a key row at most

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 5 + (_I,) * 8 + (_F, _P)
_scratch: Dict[tuple, torch.Tensor] = {}


def cls_attention_supported(heads: int, dim_head: int, n: int,
                            dtype: torch.dtype) -> bool:
    """The JAX package's gate: one (N, 2*inner) block and its f32
    intermediates must fit the TPU kernel's VMEM."""
    inner = heads * dim_head
    if heads > _HP or inner % 128 != 0 or n % 8 != 0:
        return False
    need = n * 2 * inner * dtype.itemsize + 2 * n * inner * 4
    return need <= 28 * 1024 * 1024


class ClsPlan(NamedTuple):
    """The kernel's split of the keys below n_true: ``splits`` runs of
    ``chunk`` keys (the last may hold fewer; none is empty), a CTA a run;
    ``lanes`` the lanes that share a key row."""

    splits: int
    chunk: int
    lanes: int


@functools.lru_cache(maxsize=None)  # read on every launch
def cls_plan(batch: int, heads: int, n_true: int, dim_head: int = 64,
             dtype: torch.dtype = torch.bfloat16) -> ClsPlan:
    """The lanes of a key row: the largest power of two, at most LANES,
    that divides its 16-byte slots (its elements where the head dim is no
    multiple of 16 bytes), each lane taking one slot of a column block. The
    runs: enough that batch * heads * splits CTAs fill WAVES waves of SMS
    SMs, of MIN_KEYS keys at least and MAX_KEYS at most (the wrapper hands
    it to the kernel; it is made nowhere else)."""
    if batch < 1 or heads < 1 or n_true < 1 or dim_head < 1:
        raise ValueError(f"batch, heads, n_true and dim_head must be >= 1, got {batch}, "
                         f"{heads}, {n_true}, {dim_head}")
    vec = 16 // dtype.itemsize
    slots = dim_head // vec if dim_head % vec == 0 else dim_head
    lanes = LANES
    while slots % lanes:
        lanes //= 2
    splits = min(-(-WAVES * SMS // (batch * heads)), n_true // MIN_KEYS)
    splits = max(splits, 1, -(-n_true // MAX_KEYS))
    chunk = -(-n_true // splits)
    return ClsPlan(-(-n_true // chunk), chunk, lanes)


def _scratch_buffer(device: torch.device, kind: str, n: int) -> torch.Tensor:
    """The device's scratch of one kind, n elements at least, kept between
    calls: "tickets" (int32, zero between calls: the kernel's last CTA of
    each (batch, head) sets its ticket back to zero) or "partials" (the
    runs' f32 partial sums)."""
    buf = _scratch.get((device, kind))
    if buf is None or buf.numel() < n:
        dtype = torch.int32 if kind == "tickets" else torch.float32
        buf = torch.zeros(max(n, 1 << 12), dtype=dtype, device=device)
        _scratch[(device, kind)] = buf
    return buf


def cls_attention_reference(kv: torch.Tensor, q0: torch.Tensor, heads: int,
                            dim_head: int, scale: float, n_true: int) -> torch.Tensor:
    """kv (B, N, 2*inner) packed [K | V], q0 (B, inner) -> (B, inner)."""
    B, N, _ = kv.shape
    inner = heads * dim_head
    k = kv[..., :inner].float().reshape(B, N, heads, dim_head)
    v = kv[..., inner:].float().reshape(B, N, heads, dim_head)
    s = (k * q0.float().reshape(B, 1, heads, dim_head)).sum(-1) * scale  # (B, N, heads)
    if n_true != N:
        s = s.masked_fill((torch.arange(N, device=kv.device) >= n_true)[:, None],
                          float("-inf"))
    a = torch.softmax(s, dim=1)
    return (v * a[..., None]).sum(1).reshape(B, inner).to(kv.dtype)


def cls_attention(kv: torch.Tensor, q0: torch.Tensor, heads: int, dim_head: int,
                  scale: float, n_true: int) -> torch.Tensor:
    """Same contract as :func:`cls_attention_reference`; the kernel on CUDA,
    whose output has no backward: as in the JAX package it serves inference,
    and training takes ``core/vit.cls_attend``'s differentiable form."""
    if not _build.use_kernel(kv):
        return cls_attention_reference(kv, q0, heads, dim_head, scale, n_true)
    _build.refuse_grad("cls_attention", "inference only, as in the JAX package: training "
                       "takes cls_attend's differentiable form", kv, q0)
    if torch.compiler.is_exporting():
        return _build.op("cls_attention")(kv, q0, heads, dim_head, scale, n_true)
    B, N, two_inner = kv.shape
    inner = heads * dim_head
    if dim_head < 1:
        raise ValueError(f"dim_head must be >= 1, got {dim_head}")
    if two_inner != 2 * inner:
        raise ValueError(f"cls_attention takes a packed (B, N, 2*heads*dim_head) kv; got "
                         f"{tuple(kv.shape)}, heads={heads}, dim_head={dim_head}")
    if tuple(q0.shape) != (B, inner):
        raise ValueError(f"q0 must be {(B, inner)}, got {tuple(q0.shape)}")
    if not 1 <= n_true <= N:
        raise ValueError(f"n_true {n_true} outside [1, {N}]")
    _build.check_cuda("cls_attention", kv, q0)
    plan = cls_plan(B, heads, n_true, dim_head, kv.dtype)
    out = torch.empty((B, inner), device=kv.device, dtype=kv.dtype)
    part = _scratch_buffer(kv.device, "partials", B * heads * plan.splits * (dim_head + 2))
    tickets = _scratch_buffer(kv.device, "tickets", B * heads)
    _build.launch(
        "cls_attention", f"gaviko_cls_attention_{_build.dtype_suffix(kv)}", _ARGTYPES,
        kv.data_ptr(), q0.data_ptr(), out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B,
        N, heads, dim_head, n_true, plan.splits, plan.chunk, plan.lanes, scale,
        _build.stream_of(kv))
    cls_attention.launches += 1
    return out


cls_attention.launches = 0
