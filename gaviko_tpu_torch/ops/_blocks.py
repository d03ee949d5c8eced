"""The tile policy of the port's Hopper GEMM (``csrc/gemm_sm90.cuh``).

Port of ``gaviko_tpu/ops/_blocks.py``. JAX picks the row block of its
row-streamed Pallas kernels (the fused MLP, LN + linear) from the row count,
by on-chip A/B runs, with an environment variable each to override it. On
the H100 the six kernels on the shared GEMM (B6 and B7, the fused MLP; B9
and B12, LN + linear; B11, the int8 GEMMs; patchify) take an output tile of
BM x BN a launch, one of the tiles compiled for the launch's operand type
(:data:`TILES`), BN 128 at every tile. :func:`gemm_tile` chooses a launch's
tile from its products' output shapes and its type; :func:`row_block` keeps
JAX's name and gives the tile's rows.

The overrides are JAX's two variables, read at every call and reaching the
same kernels as there: ``GAVIKO_MLP_BLOCK`` B6 and B7, ``GAVIKO_LNL_BLOCK``
B9 and B12. B11 and patchify read no variable, as in JAX; their wrappers'
``block`` argument forces a tile for an A/B run. A value is a tile's rows. A
value that names no compiled tile of the type raises ``ValueError``: it is
never rounded and never falls back to another tile.

The choice, from ``chip_smoke.py``'s tile phase on an H100 (PERF.md §6,
PR 23), weighs what JAX's docstring weighs on the TPU: the last wave's fill
(there, the pad of a block that does not divide the rows) and a larger
tile's operand reuse.

- 128 rows by default: two CTAs share an SM, one's epilogue running beside
  the other's products. It won every launch at vit-b16 B8 (8,064 rows) and
  B64 (64,512), GAViKO's int8 B8 (8,320) and patchify at GAViKO B8.
- 64 rows (one consumer warpgroup) where a launch's 128-row tiles number
  fewer than the card's SMs (one partial wave) and its operands are int8
  (:data:`WAVE_FILL`): twice the CTAs spread the same work over more SMs.
  GAViKO's int8 last layer (264 rows) ran 11-14% less device time so. bf16
  keeps 128 there: the rule cut four of its five cases below one wave by
  9-18% of device time, but not B7 at 264 rows (its dg launch, one of
  five), and the bar set before that run asked for every case.
- bf16's 64-row tile is compiled for the overrides; f32 has the one tile
  (its 3xTF32 instance spilled more at 64 rows; ``csrc/gemm_sm90.cuh``'s
  ``compiled``).
"""

from __future__ import annotations

import functools
import os
from typing import Iterable, Tuple

import torch

MLP_ENV, LNL_ENV = "GAVIKO_MLP_BLOCK", "GAVIKO_LNL_BLOCK"
SMS = 132  # an H100 SXM's streaming multiprocessors: the wave where no card is present
BN = 128   # a tile's columns, at every tile

# The tiles compiled for each operand type (csrc/gemm_sm90.cuh's
# `compiled`), by their rows.
TILES = {torch.bfloat16: ((64, BN), (128, BN)),
         torch.int8: ((64, BN), (128, BN)),
         torch.float32: ((128, BN),)}
# The operand types whose launches below one wave take 64-row tiles: those
# where the tile phase measured the policy faster in every case there.
WAVE_FILL = frozenset({torch.int8})


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sms() -> int:
    """The streaming multiprocessors of the current card, one wave of CTAs
    (:data:`SMS` where no card is present, as in the CPU tests' plans)."""
    return _device_sms(torch.cuda.current_device()) if torch.cuda.is_available() else SMS


def _tiles(dtype: torch.dtype):
    if dtype not in TILES:
        raise NotImplementedError(f"the GEMM takes bfloat16, float32 or int8 operands, got "
                                  f"{dtype}")
    return TILES[dtype]


def forced_tile(block, dtype: torch.dtype, source: str = "block") -> Tuple[int, int]:
    """The compiled tile of ``block`` rows for ``dtype`` (every tile has
    128 columns); ``ValueError`` naming the values ``dtype`` takes where
    none has them."""
    rows = [bm for bm, _ in _tiles(dtype)]
    try:
        bm = int(str(block).strip())
    except ValueError:
        raise ValueError(f"{source}={block!r}: a tile's rows, one of {rows} for {dtype}") from None
    if bm not in rows:
        raise ValueError(f"{source}={block!r}: no {bm}-row tile is compiled for {dtype}; "
                         f"it takes {rows}")
    return bm, BN


def policy_tile(shapes: Iterable[Tuple[int, int]], dtype: torch.dtype) -> Tuple[int, int]:
    """The measured choice (see the module's docstring) for one launch of
    products with output ``shapes`` [(m, n), ...] and operands of
    ``dtype``."""
    ctas = sum(-(-m // 128) * -(-n // BN) for m, n in shapes)
    if dtype in WAVE_FILL and ctas < sms():
        return 64, BN
    return 128, BN


def gemm_tile(shapes: Iterable[Tuple[int, int]], dtype: torch.dtype, env: str = None,
              block=None) -> Tuple[int, int]:
    """(BM, BN) of one GEMM launch whose products have output ``shapes``
    [(m, n), ...] and operands of ``dtype``: ``block`` where given, else the
    variable ``env`` where it is set, else :func:`policy_tile`."""
    if block is None and env is not None:
        value = os.environ.get(env, "").strip()
        if value:
            return forced_tile(value, dtype, env)
    if block is not None:
        return forced_tile(block, dtype)
    return policy_tile(shapes, dtype)


def row_block(rows: int, env: str, n: int = BN, dtype: torch.dtype = torch.bfloat16) -> int:
    """JAX's name, kept so both packages answer the same question: the rows
    of the tile :func:`gemm_tile` gives one product of ``rows`` x ``n``
    outputs, ``env`` overriding when set. The port's plans call
    :func:`gemm_tile`, which takes a launch's every product."""
    return gemm_tile(((rows, n),), dtype, env)[0]
