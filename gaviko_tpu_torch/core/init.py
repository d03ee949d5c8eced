"""Parameter initializers: PyTorch's defaults and the reference's custom inits.

Port of ``gaviko_tpu/core/init.py``. Every initializer draws from an explicit
``torch.Generator`` and returns an f32 tensor on that generator's device.
The draws are distributionally those of the JAX package, not bitwise: no
parity check relies on random-number equality (weights cross between the
packages through ``weights/from_jax.py``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def _uniform(gen: torch.Generator, shape: Sequence[int], bound: float) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return t.uniform_(-bound, bound, generator=gen)


def normal(gen: torch.Generator, shape: Sequence[int], std: float = 1.0) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return t.normal_(0.0, std, generator=gen)


def kaiming_uniform(gen: torch.Generator, shape: Sequence[int], fan_in: int,
                    a: float = math.sqrt(5.0)) -> torch.Tensor:
    """torch nn.init.kaiming_uniform_: U(-b, b), b = sqrt(6/((1+a^2) fan_in))."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return _uniform(gen, shape, gain * math.sqrt(3.0 / fan_in))


def torch_linear_weight(gen: torch.Generator, out_features: int, in_features: int) -> torch.Tensor:
    """torch nn.Linear default weight init (kaiming_uniform a=sqrt(5))."""
    return kaiming_uniform(gen, (out_features, in_features), in_features)


def torch_linear_bias(gen: torch.Generator, out_features: int, in_features: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
    return _uniform(gen, (out_features,), bound)


def torch_conv3d_weight(gen: torch.Generator, out_ch: int, in_ch: int,
                        kdhw: Tuple[int, int, int]) -> torch.Tensor:
    kd, kh, kw = kdhw
    return kaiming_uniform(gen, (out_ch, in_ch, kd, kh, kw), in_ch * kd * kh * kw)


def torch_conv3d_bias(gen: torch.Generator, out_ch: int, in_ch: int,
                      kdhw: Tuple[int, int, int]) -> torch.Tensor:
    kd, kh, kw = kdhw
    return _uniform(gen, (out_ch,), 1.0 / math.sqrt(in_ch * kd * kh * kw))


def xavier_uniform(gen: torch.Generator, shape: Sequence[int], gain: float = 1.0) -> torch.Tensor:
    """torch nn.init.xavier_uniform_ with torch's fan computation."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_out, fan_in = shape[0] * receptive, shape[1] * receptive
    return _uniform(gen, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))


def orthogonal(gen: torch.Generator, shape: Sequence[int], gain: float = 1.0) -> torch.Tensor:
    """torch nn.init.orthogonal_: QR of a normal draw, sign-corrected."""
    rows, cols = shape[0], math.prod(shape[1:])
    flat = normal(gen, (max(rows, cols), min(rows, cols)))
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.t()
    return gain * q.reshape(tuple(shape)).contiguous()


def trunc_normal(gen: torch.Generator, shape: Sequence[int], std: float,
                 clamp_mult: float = 2.0) -> torch.Tensor:
    """Normal(0, std) then clamp to +-clamp_mult*std (ref: gaviko.py:455-456
    draws normal then clamps; NOT a resampled truncated normal)."""
    return normal(gen, shape, std).clamp_(-clamp_mult * std, clamp_mult * std)


def timm_style_trunc_normal(gen: torch.Generator, shape: Sequence[int], std: float = 0.02,
                            a: float = -2.0, b: float = 2.0) -> torch.Tensor:
    """A true truncated normal by the inverse CDF (ref: evp.py:165-218):
    U(2l - 1, 2u - 1) through erfinv, scaled, clamped to [a, b]."""
    lo = (1.0 + math.erf(a / std / math.sqrt(2.0))) / 2.0
    hi = (1.0 + math.erf(b / std / math.sqrt(2.0))) / 2.0
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    return (torch.erfinv(t) * (std * math.sqrt(2.0))).clamp_(a, b)
