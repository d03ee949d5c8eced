"""Single-query (CLS) attention over a packed ``[K | V]`` projection.

Port of ``gaviko_tpu/ops/cls_attention.py``. In the last layer of a
``pool='cls'`` model only the CLS row's output is used, so attention there is
one query row ``q0`` against every key (``core/vit.py``'s CLS-fast path). On
the card it runs the kernel in ``csrc/cls_attention.cu``, one block per
(batch, head) reading K once for the scores and V once for the output;
``cls_attention_reference`` is its plain PyTorch version. The TPU kernel's
head-indicator matmul worked around a Mosaic shape rule and is not ported.
Head dims 64, 128, 192 and 256 run specialized instances; every other head
dim the gate admits runs the general one (``cls_instance``).

Scores, softmax and the weighted sum of V run in f32 over the keys below
``n_true``; the output is rounded once to the working dtype.
"""

from __future__ import annotations

import ctypes

import torch

from gaviko_tpu_torch.ops import _build

_HP = 128  # the JAX kernel's padded head count
KERNEL_DIM_HEADS = (64, 128, 192, 256)  # head dims the kernel is specialized for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P) + (_I,) * 5 + (_F, _P)


def cls_attention_supported(heads: int, dim_head: int, n: int,
                            dtype: torch.dtype) -> bool:
    """The JAX package's gate: one (N, 2*inner) block and its f32
    intermediates must fit the TPU kernel's VMEM."""
    inner = heads * dim_head
    if heads > _HP or inner % 128 != 0 or n % 8 != 0:
        return False
    need = n * 2 * inner * dtype.itemsize + 2 * n * inner * 4
    return need <= 28 * 1024 * 1024


def cls_instance(dim_head: int) -> str:
    """The instance of the kernel a head dim runs on the card: its
    specialization, else the general one (dim_head at run time; e.g. 96 or
    160, which the gate admits whenever heads * dim_head % 128 == 0)."""
    if dim_head < 1:
        raise ValueError(f"dim_head must be >= 1, got {dim_head}")
    return "specialized" if dim_head in KERNEL_DIM_HEADS else "general"


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
    B, N, two_inner = kv.shape
    inner = heads * dim_head
    cls_instance(dim_head)
    if two_inner != 2 * inner:
        raise ValueError(f"cls_attention takes a packed (B, N, 2*heads*dim_head) kv; got "
                         f"{tuple(kv.shape)}, heads={heads}, dim_head={dim_head}")
    if tuple(q0.shape) != (B, inner):
        raise ValueError(f"q0 must be {(B, inner)}, got {tuple(q0.shape)}")
    if not 1 <= n_true <= N:
        raise ValueError(f"n_true {n_true} outside [1, {N}]")
    _build.check_cuda("cls_attention", kv, q0)
    out = torch.empty((B, inner), device=kv.device, dtype=kv.dtype)
    _build.launch(
        "cls_attention", f"gaviko_cls_attention_{_build.dtype_suffix(kv)}", _ARGTYPES,
        kv.data_ptr(), q0.data_ptr(), out.data_ptr(), B, N, heads, dim_head, n_true, scale,
        _build.stream_of(kv))
    cls_attention.launches += 1
    return out


cls_attention.launches = 0
