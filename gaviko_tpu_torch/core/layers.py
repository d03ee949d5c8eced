"""Functional neural-net primitives over flat parameter dicts.

Port of ``gaviko_tpu/core/layers.py``. Every model is a function
``apply(params, x, ...)`` where ``params`` is a flat ``dict[str, Tensor]``
keyed by the PyTorch reference's ``state_dict`` names, with Linear weights in
the torch ``(out_features, in_features)`` layout.

Numerics follow the JAX package: LayerNorm uses eps=1e-5 with f32 statistics,
GELU is the exact erf form unless a mode says otherwise. Dropout draws its
bits from the coordinate hash of ``ops/hash_dropout.py`` with one int32 seed
per call site, handed out by a :class:`SeedStream`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.ops.fused_mlp import gelu_erf_fast_f32
from gaviko_tpu_torch.ops.hash_dropout import keep_mask
from gaviko_tpu_torch.ops.ln_linear import layer_norm_rounded
from gaviko_tpu_torch.parallel import shard

Params = Dict[str, torch.Tensor]


class SeedStream:
    """Int32 dropout seeds, one per call site, in the order the sites run:
    the counterpart of the JAX package's ``RngStream.next_seed``.

    The seeds come from an explicit sequence (tests feed the JAX package's
    ``RngStream(key).next_seed()`` values, so both packages drop the same
    elements) or from a ``torch.Generator``. Threefry is not reproduced:
    only the order in which sites consume seeds must match."""

    def __init__(self, seeds: Optional[Iterable[int]] = None,
                 generator: Optional[torch.Generator] = None):
        if (seeds is None) == (generator is None):
            raise ValueError("SeedStream takes seeds or a generator, not both")
        self._seeds = None if seeds is None else [int(s) for s in seeds]
        self._gen = generator
        self.count = 0

    def next_seed(self) -> int:
        self.count += 1
        if self._seeds is None:
            return int(torch.randint(-(1 << 31), 1 << 31, (), dtype=torch.int64,
                                     generator=self._gen))
        if self.count > len(self._seeds):
            raise ValueError(f"dropout site {self.count} has no seed: the stream "
                             f"holds {len(self._seeds)}")
        return self._seeds[self.count - 1]


def _promoted(x: torch.Tensor, *ts: Optional[torch.Tensor]):
    """x and ts cast to their common dtype where it differs from x's, as JAX
    promotes a product's mixed operands (a bf16 weight on an f32 input
    computes in f32); ``F.linear`` does not promote."""
    if all(t is None or t.dtype == x.dtype for t in ts):
        return (x, *ts)
    dt = x.dtype
    for t in ts:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return (x.to(dt), *(None if t is None else t.to(dt) for t in ts))


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ W^T, bias-free, with JAX's dtype promotion."""
    return F.linear(*_promoted(x, w))


def linear(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T + b with torch (out, in) weight layout and JAX's dtype
    promotion."""
    return F.linear(*_promoted(x, p[f"{prefix}.weight"], p.get(f"{prefix}.bias")))


def layer_norm(p: Params, prefix: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Statistics in f32, cast to the working dtype, then ``* w + b`` in that
    dtype: the JAX package's rounding order (``F.layer_norm`` in bf16 rounds
    elsewhere)."""
    return layer_norm_rounded(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"], eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default."""
    return F.gelu(x)


def gelu_spec(x: torch.Tensor, mode: str) -> torch.Tensor:
    """GELU by ``spec.gelu``: 'exact' (erf), 'tanh' (torch's tanh
    approximation) or 'erf_fast' (the tanh-form erf fit)."""
    if mode == "erf_fast":
        return gelu_erf_fast_f32(x)
    return F.gelu(x, approximate="tanh" if mode == "tanh" else "none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) (ref: gaviko.py:15-17)."""
    return x * torch.sigmoid(1.702 * x)


def ssf_ada(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """SSF's scale-and-shift: along the last dim where it matches the
    scale's length, else along dim 1 (ref: ssf.py:24-31)."""
    if scale.shape != shift.shape:
        raise ValueError("ssf_ada: scale and shift differ in shape")
    if x.shape[-1] == scale.shape[0]:
        return x * scale + shift
    if x.dim() >= 2 and x.shape[1] == scale.shape[0]:
        sh = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.reshape(sh) + shift.reshape(sh)
    raise ValueError("the input tensor shape does not match the shape of the scale factor.")


def site_seed(rate: float, seeds: Optional[SeedStream]) -> Optional[int]:
    """The seed of one dropout site; None, consuming no seed, at rate 0."""
    if rate == 0.0:
        return None
    if seeds is None:
        raise ValueError("dropout requested but no seed stream was given")
    return seeds.next_seed()


def dropout(x: torch.Tensor, rate: float, enabled: bool,
            seeds: Optional[SeedStream], col_offset: int = 0) -> torch.Tensor:
    """Inverted dropout over x flattened to [rows, last]; a no-op that
    consumes no seed when disabled or when rate == 0. In a sharded forward
    (``parallel/shard.py``) the seed folds in this rank's first batch row and
    ``col_offset``, the site's first column in a split layer, so the bits
    are the whole batch's."""
    if not enabled or rate == 0.0:
        return x
    seed = shard.fold_seed(site_seed(rate, seeds), rows=shard.rows_per_sample(x),
                           col=col_offset)
    rows = x.numel() // x.shape[-1]
    mask = keep_mask((rows, x.shape[-1]), seed, rate, device=x.device)
    return torch.where(mask.reshape(x.shape), x / (1.0 - rate), torch.zeros_like(x))
