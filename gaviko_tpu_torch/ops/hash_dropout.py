"""Counter-based dropout bits, bit-exact with the JAX package.

Port of ``gaviko_tpu/ops/hash_dropout.py``. Every dropout site of the model
derives its bits from a stateless hash of absolute element coordinates, so a
kernel and a plain version (and the JAX package) drop the same elements:

    keep(row, col) = mix(row * R + seed + salt * S + col * C) >= T(rate)
    mix(h) = (h ^ (h >>> 16)) * M          (uint32 arithmetic, signed compare)

torch has no unsigned 32-bit type and ``>>`` on int32 is arithmetic, so the
hash runs on int64 tensors holding uint32 values, reduced modulo 2^32 after
each step; the product of two 32-bit values is split into 16-bit halves so
that no intermediate leaves int64. The same hash runs inside the CUDA
kernels as ``gaviko::keep_bit`` (``csrc/common.cuh``).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_ROW = 0x9E3779B9  # golden ratio
_COL = 0x7FEB352D
_SALT = 0x5851F42D

Int = Union[int, torch.Tensor]


def _threshold(rate: float) -> int:
    """Signed-compare threshold: the mixed hash is uniform over int32, so
    T = (2 * rate - 1) * 2^31 gives P(keep) = 1 - rate to 2^-32."""
    return max(-(1 << 31), min((1 << 31) - 1,
                               round((2.0 * rate - 1.0) * (1 << 31))))


def dropout_args(rate: float, seed: int):
    """(seed, threshold, 1 / (1 - rate)) as the CUDA kernels take them; at
    rate 0 the threshold is INT32_MIN and every element is kept."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate {rate} outside [0, 1)")
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed {seed} is not an int32")
    return int(seed), _threshold(rate), 1.0 / (1.0 - rate)


def _u32(x: Int) -> Int:
    return x & _MASK


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for uint32 values h (int64 tensor) and constant c."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def keep_mask(shape: Sequence[int], seed: Int, rate: float, *, salt: Int = 0,
              row_offset: Int = 0, col_offset: Int = 0,
              device="cpu") -> torch.Tensor:
    """Bool mask over ``shape``, True = keep, P(keep) ~= 1 - rate.

    Elements are identified by their absolute coordinates over the last two
    dims (``row_offset + i``, ``col_offset + j``); leading dims are told
    apart by ``salt``, an int or an int tensor broadcastable to ``shape``.
    ``seed`` is an int32 value (a Python int or a 0-d tensor)."""
    nd = len(shape)
    rows = torch.arange(shape[-2], device=device, dtype=torch.int64) + row_offset
    cols = torch.arange(shape[-1], device=device, dtype=torch.int64) + col_offset
    rows = rows.reshape((1,) * (nd - 2) + (shape[-2], 1))
    cols = cols.reshape((1,) * (nd - 1) + (shape[-1],))
    salt = torch.as_tensor(salt, dtype=torch.int64, device=device)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    fr = _u32(_mul_u32(_u32(rows), _ROW) + _u32(seed) + _mul_u32(_u32(salt), _SALT))
    h = _u32(fr + _mul_u32(_u32(cols), _COL))
    h = _mul_u32(h ^ (h >> 16), _M1)
    signed = h - ((h >> 31) << 32)  # reinterpret uint32 as int32
    return torch.broadcast_to(signed >= _threshold(rate), tuple(shape))


def apply_dropout(x: torch.Tensor, seed: Int, rate: float, *, salt: Int = 0,
                  row_offset: Int = 0, col_offset: Int = 0) -> torch.Tensor:
    """Inverted dropout with ``keep_mask`` bits over x's last two dims."""
    if rate == 0.0:
        return x
    keep = keep_mask(x.shape, seed, rate, salt=salt, row_offset=row_offset,
                     col_offset=col_offset, device=x.device)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))
