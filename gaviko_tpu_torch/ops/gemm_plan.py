"""The plans of the kernels on the port's Hopper GEMM (``csrc/gemm_sm90.cuh``):
B6 and B7 (``ops/fused_mlp.py:mlp_plan``), B9 and B12
(``ops/ln_linear.py:ln_linear_plan``), B11 (``ops/int8_linear.py:int8_plan``)
and patchify (:func:`patchify_plan`, here) share its tiles (each launch's
chosen by ``ops/_blocks.py`` outside the plans' caches and passed in, so an
override set after a first call takes effect), the way its CTAs take a
launch of one or more products, and one buffer for a call's scratch."""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from gaviko_tpu_torch.ops import _blocks

# The default output tile (the tile of every launch before the policy; an
# instance like any other), a CTA's ring of k tiles (128 bytes of depth a
# stage, both operands; bf16 and int8 three stages, f32 four), and the
# card's shared memory a CTA may opt in to on an H100.
TILE = (128, _blocks.BN)
STAGES = {torch.bfloat16: 3, torch.int8: 3, torch.float32: 4}
SMEM_LIMIT = 232_448
ROW_BLOCK = 16  # rows a block of the LN backward's row pass (a row of column partials each)
_SCRATCH_ALIGN = 256


def gemm_smem(dtype: torch.dtype, tile: Tuple[int, int] = TILE) -> int:
    """The GEMM's shared memory a CTA of ``tile`` for operands of
    ``dtype``: the ring (both operands' k tiles; the epilogue stages the f32
    sums over it), its barriers, and a pass of the epilogue's rows (BM / 8:
    its consumer threads over 16 lanes a row) x BN f32 of reductions (the
    column sums' partials or the rows' inputs)."""
    bm, bn = tile
    return 1024 + STAGES[dtype] * ((bm + bn) * 128 + 2 * 8) + bm // 8 * bn * 4


class GemmProduct(NamedTuple):
    """One product C[m, n] = A[m, k] B[k, n] on the GEMM, as its CTAs take
    it: ``tiles_m`` x ``tiles_n`` output tiles of ``tile_shape`` (BM x BN:
    its launch's), each over the whole depth, n fastest where A is the larger
    operand. Any n: the last column tile reads zeros past it and its
    epilogue writes only the columns below it."""
    name: str
    m: int
    n: int
    k: int
    tile_shape: Tuple[int, int] = TILE

    @property
    def tiles_m(self) -> int:
        return -(-self.m // self.tile_shape[0])

    @property
    def tiles_n(self) -> int:
        return -(-self.n // self.tile_shape[1])

    @property
    def n_fast(self) -> bool:
        return self.m >= self.n

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n

    def tile(self, block: int) -> Tuple[int, int]:
        """CTA ``block`` of this product -> (first row, first column) of its
        tile, as the kernel decodes its block index."""
        if self.n_fast:
            tm, tn = divmod(block, self.tiles_n)
        else:
            tn, tm = divmod(block, self.tiles_m)
        return tm * self.tile_shape[0], tn * self.tile_shape[1]


def launch_tile(launch: Tuple[GemmProduct, ...], block: int) -> Tuple[str, int, int]:
    """CTA ``block`` of a launch of one or more products (their CTAs in
    order) -> (product, first row, first column)."""
    for p in launch:
        if block < p.blocks:
            return (p.name, *p.tile(block))
        block -= p.blocks
    raise IndexError(block)


def launch_tiles(launches: Tuple[Tuple[GemmProduct, ...], ...]) -> Tuple[int, ...]:
    """(bm, bn) of each GEMM launch of a plan, flat, as the C entry points
    take them (one tile a launch: its products share it)."""
    return tuple(v for launch in launches for v in launch[0].tile_shape)


def _layout(entries) -> Tuple[Tuple[Tuple[str, Tuple[int, ...], torch.dtype, int], ...], int]:
    """(name, shape, dtype) -> the same with a byte offset, each aligned to
    _SCRATCH_ALIGN in one buffer, and the buffer's bytes."""
    out, at = [], 0
    for name, shape, dtype in entries:
        out.append((name, tuple(shape), dtype, at))
        n = dtype.itemsize
        for d in shape:
            n *= d
        at += -(-n // _SCRATCH_ALIGN) * _SCRATCH_ALIGN
    return tuple(out), at


def _scratch(layout, nbytes: int, device) -> dict:
    """One buffer for a call's scratch -> name -> device pointer."""
    buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    ptrs = {name: base + off for name, _, _, off in layout}
    ptrs["_buffer"] = buf  # keeps it alive until the launch is queued
    return ptrs


class PatchifyPlan(NamedTuple):
    """What patchify (``csrc/patchify.cu``) runs for one call:
    :func:`patchify_plan`."""
    rows: int        # B * n_tok: the patch matrix's rows
    k: int           # C * pd * ph * pw: its columns
    kp: int          # k rounded up to whole 16-byte rows (zero columns past k)
    dim: int
    dtype: torch.dtype
    vector: int      # elements a thread of the rows pass moves: 16 bytes, or 1
    smem: int        # the GEMM's shared memory a CTA, bytes
    products: Tuple[Tuple[GemmProduct, ...], ...]  # the GEMM's launch: rows W^T
    scratch: Tuple[Tuple[str, Tuple[int, ...], torch.dtype, int], ...]
    scratch_bytes: int
    launches: int    # kernel launches a call: the rows pass, the GEMM


def patchify_plan(B: int, C: int, DHW: Tuple[int, int, int], patch: Tuple[int, int, int],
                  dim: int, dtype: torch.dtype = torch.bfloat16, save_rows: bool = False,
                  block=None) -> PatchifyPlan:
    """The plan of patchify for B volumes of C x DHW cut into patches of
    ``patch`` and embedded in ``dim`` columns (made only here; the wrapper
    hands it to the kernels): a rows pass writes the patch matrix [B * n_tok,
    kp], its columns in (c, pd, ph, pw) order and zero from k to kp, kp the
    fewest columns of whole 16-byte rows (TMA's strides), 16 bytes a thread
    where the patch width and the volume width are whole vectors (then kp
    is k), else an element; then one product of it with the weight [dim,
    kp] (padded with zero columns where kp > k) on the GEMM's tiles of
    ``ops/_blocks.py``'s choice (``block`` forces a tile's rows; patchify
    reads no variable, as in JAX) with k tiles of 128 bytes, each CTA over
    the whole depth. The matrix is scratch unless ``save_rows`` asks for it
    (the weight's gradient reads it). Raises where no kernel can run: a
    dtype other than bf16 / f32, a volume the patch does not divide, or a
    matrix of 2**31 elements or more."""
    (D, H, W), (pd, ph, pw) = DHW, patch
    rows = B * (D // max(pd, 1)) * (H // max(ph, 1)) * (W // max(pw, 1))
    tile = _blocks.gemm_tile(((rows, dim),), dtype, block=block) if dtype in _blocks.TILES \
        else TILE
    return _patchify_plan(B, C, tuple(DHW), tuple(patch), dim, dtype, save_rows, tile)


@functools.lru_cache(maxsize=64)
def _patchify_plan(B: int, C: int, DHW: Tuple[int, int, int], patch: Tuple[int, int, int],
                   dim: int, dtype: torch.dtype, save_rows: bool,
                   tile: Tuple[int, int]) -> PatchifyPlan:
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"kernels take bfloat16 or float32, got {dtype}")
    (D, H, W), (pd, ph, pw) = DHW, patch
    if min(B, C, D, H, W, pd, ph, pw, dim) < 1 or D % pd or H % ph or W % pw:
        raise ValueError(f"patchify: volume {B} x {C} x {tuple(DHW)} in patches "
                         f"{tuple(patch)} to {dim}")
    size = dtype.itemsize
    rows, k = B * (D // pd) * (H // ph) * (W // pw), C * pd * ph * pw
    kp = -(-k * size // 16) * 16 // size
    if max(rows * kp, dim * kp) >= 2 ** 31:
        raise NotImplementedError(f"patchify takes matrices under 2**31 elements; got "
                                  f"{rows} x {kp} and {dim} x {kp}")
    vec = 16 // size
    vector = vec if pw % vec == 0 and W % vec == 0 else 1
    scratch = () if save_rows else (("rows", (rows, kp), dtype),)
    layout, nbytes = _layout(scratch)
    return PatchifyPlan(rows, k, kp, dim, dtype, vector, gemm_smem(dtype, tile),
                        ((GemmProduct("patchify", rows, dim, kp, tile),),), layout, nbytes, 2)
