"""What one rank holds of a sharded forward, and what it folds into its work.

A run over a ``data`` x ``model`` mesh (``parallel/mesh.py``) gives each rank
rows [b0, b0 + batch) of the global batch and, where a layer is split over
the ``model`` group (Megatron-style), that layer's heads or hidden columns
[c0, c0 + n) of the whole. The model code reads it from :func:`current`,
which is None outside a sharded step (one process computes as before).

Dropout bits. Every dropout site hashes absolute coordinates
(``ops/hash_dropout.py``): ``h = row * R + seed + salt * S + col * C`` mod
2^32 before it mixes. A shard's coordinates differ from the whole batch's by
a constant offset in row, salt or column, so the offset folds into the seed
(:func:`fold_seed`) and the kernels need no change: the flat row of
``layers.dropout`` (b0 times the rows of a sample), the salt of the local
attention kernels (b0), the salt of the MHSA kernels (b0 times the layer's
heads; their head offset is an argument of the kernels, ``head0``, since
their salt ``b * heads + h`` scales with the local head count), the columns
of a split hidden (``c0``, an argument of the fused MLP kernels: one seed
serves their hidden and output sites).

Tensor parallelism. A split block's input passes :func:`copy_in` (identity
forward, all-reduce of the gradient over ``model`` backward) and its output
:func:`reduce_out` (all-reduce over ``model`` forward, identity backward). The
output bias, and the fused MLP's residual, are added on model rank 0 only
(:func:`rank0`), so the all-reduced sum holds them once. A mesh artifact
(``deploy.py``) traces one program a model rank for that reason.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

_ROW, _SALT, _COL = 0x9E3779B9, 0x5851F42D, 0x7FEB352D  # ops/hash_dropout.py


@dataclass(frozen=True)
class Shard:
    """This rank's part of a sharded forward: rows [b0, b0 + batch) of the
    global batch; index ``m`` of the ``tp`` ranks of the model ``group``;
    ``split`` the names of the weights split over that group."""

    b0: int = 0
    batch: int = 0
    m: int = 0
    tp: int = 1
    group: object = None
    split: frozenset = frozenset()


_state = threading.local()


def current() -> Optional[Shard]:
    return getattr(_state, "shard", None)


@contextlib.contextmanager
def active(shard: Optional[Shard]):
    """Run the block's forward as ``shard`` (None: unsharded) in this thread."""
    before = current()
    _state.shard = shard
    try:
        yield shard
    finally:
        _state.shard = before


@contextlib.contextmanager
def within(prefix: str):
    """Run a model that strips ``prefix`` from its params' names (VPT's
    ``vision_transformer.``, MeLO's ``lora_vit.``): the shard names its split
    weights without it too."""
    s = current()
    if s is None or not s.split:
        yield s
        return
    names = frozenset(k[len(prefix):] for k in s.split if k.startswith(prefix))
    with active(dataclasses.replace(s, split=names)) as inner:
        yield inner


def _int32(h: int) -> int:
    h &= 0xFFFFFFFF
    return h - (1 << 32) if h >= 1 << 31 else h


def fold_seed(seed: int, *, rows: int = 0, salts: int = 0, col: int = 0) -> int:
    """The seed whose bits on this shard are the whole batch's: ``rows`` and
    ``salts`` are a sample's flat rows and dropout planes at the site, ``col``
    the site's first column in the whole layer."""
    s = current()
    b0 = s.b0 if s is not None else 0
    if not (b0 and (rows or salts)) and not col:
        return seed
    return _int32(int(seed) + b0 * rows * _ROW + b0 * salts * _SALT + col * _COL)


def rows_per_sample(x: torch.Tensor) -> int:
    """The flat rows [.., last] of one sample of ``x``, whose leading dim is
    the shard's batch (checked where the shard names it)."""
    s = current()
    if s is not None and s.batch and x.shape[0] != s.batch:
        raise ValueError(f"a dropout site of a sharded forward takes the batch first: "
                         f"leading dim {x.shape[0]}, shard batch {s.batch}")
    return x.numel() // (x.shape[0] * x.shape[-1])


def part(name: str) -> Optional[Shard]:
    """The shard when weight ``name`` is split over the model group, else None."""
    s = current()
    return s if s is not None and s.tp > 1 and name in s.split else None


def rank0(s: Optional[Shard]) -> bool:
    """Whether this rank adds a split block's replicated terms (bias, residual)."""
    return s is None or s.m == 0


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, s: Optional[Shard]) -> torch.Tensor:
    """A split block's input: identity, its gradient all-reduced over model."""
    if s is None:
        return x
    return _Enter.apply(x, s.group) if x.requires_grad else x


def reduce_out(y: torch.Tensor, s: Optional[Shard]) -> torch.Tensor:
    """A split block's output: the sum of the model ranks' partial outputs.
    While ``torch.export`` traces a mesh artifact's program it records the
    op ``gaviko::model_all_reduce`` instead (``ops/library.py``), which sums
    over the model group that the serving predictor binds."""
    if s is None:
        return y
    if torch.compiler.is_exporting():
        from gaviko_tpu_torch.ops import _build

        return _build.op("model_all_reduce")(y)
    if torch.is_grad_enabled() and y.requires_grad:
        return _Exit.apply(y, s.group)
    y = y.contiguous().clone()
    dist.all_reduce(y, group=s.group)
    return y
