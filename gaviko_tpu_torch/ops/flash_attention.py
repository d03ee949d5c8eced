"""Attention kernels: plain flash attention, the fused MHSA and GAViKO's
masked local attention, forward and backward.

Port of ``gaviko_tpu/ops/flash_attention.py``. Five CUDA kernels:

- ``flash_attention`` (``csrc/flash_attention.cu``, B10): softmax(q k^T
  scale) v on [B, H, N, D], the route where the fused MHSA's gate is false;
  its backward is a rematerialised VJP of the plain version, as in the JAX
  package;
- ``fused_mhsa`` (``csrc/fused_mhsa.cu``, A): MHSA forward reading the
  packed qkv projection in place, optionally writing the per-row statistic
  ``lse = m + log2(l)`` the backward needs; differentiable on the packed
  qkv, its backward being kernel B;
- ``fused_mhsa_bwd`` (``csrc/fused_mhsa_bwd.cu``, B): its backward, dq, dk
  and dv into one packed ``[B, N, 3 * inner]`` buffer;
- ``flash_local_attention``'s forward (``csrc/local_attention.cu``, C): the
  3-D window attention of the latent stream with hash dropout, writing
  ``lse``;
- ``local_attention_bwd`` (``csrc/local_attention_bwd.cu``, D): its
  backward, two passes in one call of its entry point.

``mhsa_qkv_proj`` and ``flash_local_attention`` are autograd functions whose
forward and backward are those kernels. ``flash_attention_reference``,
``mhsa_reference``, ``mhsa_bwd_reference``, ``local_reference`` and
``local_bwd_reference`` are the plain PyTorch versions, run on CPU tensors
and inside ``_build.plain_versions()``.

A and B10 share one forward tile (``csrc/attention_fwd.cuh``): bf16 on
``wgmma`` with a TMA ring of K / V chunk tiles, f32 on the tensor cores as
3xTF32. Each operand is read in place through a TMA descriptor, so A's q,
k and v are the head views of the packed qkv and B10's may be any strided
views with 16-byte rows; a head dim that is not a multiple of 8 is
zero-padded to one (a copy, with the true scale) and the output sliced
back. Head dims up to 256 (128 in f32) run one of the compile-time
instances (1 to 4 groups of 64 columns; a head dim between two of them
reads its missing columns as zeros, no copy); above that the general
instance splits the output over the grid into slices of at most that
width and recomputes S once a slice; above 1280 columns Q's chunks stream
through the ring beside K's. :func:`attention_plan` is that plan, made
only here and handed to the kernel on every launch.

Kernel B is built from the same pieces (``csrc/hopper.cuh``): two passes
with no atomics, the dq pass over the key tiles and the dk/dv pass over
the query tiles, bf16 on ``wgmma``, f32 as 3xTF32, each pass's output
columns in the fewest slices its accumulators hold. :func:`mhsa_bwd_plan`
is its plan, made only here.

Kernels C and D (``csrc/local_window.cuh``) run on the tensor cores too:
a CTA owns up to 16 rows of one depth slab and streams tiles of 32 rows of
the other side (keys in C and D's dq pass, queries in D's dk/dv pass) from
the slabs and h-rows the window reaches, split across 4 warps and combined
in warp order (reruns bit-equal), bf16 on ``mma.sync`` and f32 as 3xTF32.
Each tile's rows are one contiguous byte range of the packed projection,
copied by one bulk copy (the rows are 8-byte aligned, too narrow for a
tensor map); the window, the online softmax and the dropout bit are
applied per element of the accumulators. Any ``local_dim`` up to 1152
(bf16) / 576 (f32) and any patch grid under 1024 high and wide runs:
:func:`local_plan` splits the output into column slices and sizes every
pass's shared memory, which does not grow with the grid.

Dropout in the MHSA kernels is the TPU kernel's: the hash bit of (query
row within the padded stream, key column) in plane ``salt = b *
heads_total + head0 + head`` (``heads_total`` and ``head0`` default to the
call's heads and 0; a tensor-parallel rank holding heads [head0, head0 +
heads) of a layer of ``heads_total`` passes them, so its bits are the whole
layer's) drops an unnormalised probability after the row sum ``l`` is taken,
so the lse the backward reads is the pre-dropout one, and ``1 / (1 -
rate)`` folds into the output. The backward replays the mask and forms
``dS = P~ * dP~ - P * delta`` with ``delta = rowsum(dO * O)``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.hash_dropout import dropout_args, keep_mask
from gaviko_tpu_torch.ops.local_attention import local_mask_additive

NEG_INF = float("-inf")
LOG2E = math.log2(math.e)
WHOLE_K_MAX = 2048
MHSA_DIM_HEADS = (64, 128, 192, 256)  # A and B10's compiled bf16 tiles
# The forward tile of A and B10 (csrc/attention_fwd.cuh): a chunk of the
# head dim is 128 bytes (a TMA box's row, the swizzle span), the K / V ring
# 64 KB of chunk tiles, in at most the 227 KB of shared memory a CTA can
# take.
CHUNK_BYTES, RING_BYTES, SMEM_LIMIT = 128, 65536, 232448
# Kernels C and D (csrc/local_window.cuh): rows of a streamed tile, warps of
# a CTA, the card's SMs and each SM's shared memory.
LOCAL_KEYS, LOCAL_WARPS, SMS, SM_SMEM = 32, 4, 132, 233472

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_DROP = (_I, _I, _F)  # seed, threshold, 1 / (1 - rate)
_SALT = (_I, _I)  # heads_total, head0: the dropout planes of a tensor-parallel shard
_MHSA_ARGTYPES = (_P, _P, _P) + (_I,) * 5 + (_P, _F) + _DROP + _SALT + (_P,)
_MHSA_BWD_ARGTYPES = (_P,) * 6 + (_I,) * 5 + (_P, _F) + _DROP + _SALT + (_P,)
_FLASH_ARGTYPES = (_P,) * 4 + (_I,) * 4 + (_P, _P, _F, _P)
_LOCAL_GEOM = (_I,) * 9 + (_L,) * 6 + (_F, _I, _I, _F, _P, _P, _P)
_LOCAL_ARGTYPES = (_P,) * 5 + _LOCAL_GEOM
_LOCAL_BWD_ARGTYPES = (_P,) * 8 + _LOCAL_GEOM


class AttentionPlan(NamedTuple):
    """How the forward tile of A and B10 runs a head dim, as their C entry
    points take it: ``instance`` "specialized" (a compiled head dim),
    "padded" (the tile of the next compiled width, the missing columns read
    as zeros) or "general"; ``groups`` the groups of 64 output columns a
    CTA's accumulators hold; ``width`` the columns the tile spans;
    ``chunk`` the columns of a 128-byte chunk (a TMA box, a k-chunk of S);
    ``slices`` the (first column, columns) of D each CTA of a query tile
    writes; ``rows`` the query rows of a CTA, ``keys`` of a key tile;
    ``smem`` a CTA's shared memory; ``q_stream`` whether Q's chunks stream
    through the ring beside K's (where they do not fit resident)."""

    instance: str
    groups: int
    width: int
    chunk: int
    slices: Tuple[Tuple[int, int], ...]
    rows: int
    keys: int
    smem: int
    q_stream: bool = False

    @property
    def tile(self) -> Tuple[int, int, int, int, int]:
        """The ``plan`` argument of ``csrc/attention_fwd.cuh:forward``:
        (groups, general, chunks of a slice, rows, Q streamed)."""
        general = self.instance == "general"
        cols = self.slices[0][1] if general else self.width
        return self.groups, int(general), cols // self.chunk, self.rows, int(self.q_stream)


@functools.lru_cache(maxsize=None)  # read on every launch of A and B10
def attention_plan(dim_head: int, dtype: torch.dtype = torch.bfloat16) -> AttentionPlan:
    """The plan the forward tile of A and B10 runs for a head dim (their
    wrappers hand it to the kernel; it is made nowhere else): up to 4
    groups of 64 columns in bf16 (2 in f32, whose P V also holds P's TF32
    halves) one compile-time instance and one output slice; wider head dims
    the general instance, D's chunks split into the fewest slices of at
    most that width, as even as whole chunks allow, 64 query rows a CTA (32
    in f32 where 64 rows of Q do not fit); where no rows of Q fit beside
    the ring (above 1280 columns), Q's chunks stream through it, 64 rows a
    CTA. Any head dim >= 1 has a plan."""
    if dim_head < 1:
        raise ValueError(f"dim_head must be >= 1, got {dim_head}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"kernels take bfloat16 or float32, got {dtype}")
    bf16 = dtype == torch.bfloat16
    chunk = CHUNK_BYTES // (2 if bf16 else 4)
    max_groups = 4 if bf16 else 2
    groups = -(-dim_head // 64)
    keys = 128 if bf16 and groups <= 2 else 64
    stages = RING_BYTES // (keys * CHUNK_BYTES)
    if groups <= max_groups:
        instance = "specialized" if dim_head in MHSA_DIM_HEADS else "padded"
        width = 64 * groups
        n_chunks = per = width // chunk
    else:
        instance, groups, width = "general", max_groups, dim_head
        n_chunks = -(-dim_head // chunk)
        per = -(-n_chunks // -(-dim_head // (64 * max_groups)))
    slices = tuple((c * chunk, min(dim_head, (c + per) * chunk) - c * chunk)
                   for c in range(0, n_chunks, per))
    barriers = 8 * (2 * stages + 1)
    for rows in (64, 32) if instance == "general" and not bf16 else (64,):
        smem = 1024 + n_chunks * rows * CHUNK_BYTES + RING_BYTES + barriers
        if smem <= SMEM_LIMIT:
            return AttentionPlan(instance, groups, width, chunk, slices, rows, keys, smem)
    return AttentionPlan(instance, groups, width, chunk, slices, 64, keys,
                         1024 + RING_BYTES + barriers, q_stream=True)


class MhsaBwdPlan(NamedTuple):
    """How kernel B runs a head dim: for each pass, ``dq`` and ``dkdv``, the
    (first column, columns) of each output slice, one CTA a slice of an
    owned row tile; ``groups`` the groups of 64 columns a CTA's accumulators
    hold in each pass; ``chunk`` the columns of a 128-byte chunk;
    ``own_stream`` whether the owned rows' chunks stream through the ring
    (where they do not fit resident); ``smem`` a CTA's shared memory."""

    chunk: int
    dq: Tuple[Tuple[int, int], ...]
    dkdv: Tuple[Tuple[int, int], ...]
    groups: Tuple[int, int]
    own_stream: bool
    smem: int

    @property
    def arg(self) -> Tuple[int, int, int, int, int]:
        """The ``plan`` argument of ``csrc/fused_mhsa_bwd.cu:backward``:
        (groups, chunks of a slice) of the dq pass and of the dk/dv pass, then
        the owned rows streamed."""
        return (self.groups[0], -(-self.dq[0][1] // self.chunk), self.groups[1],
                -(-self.dkdv[0][1] // self.chunk), int(self.own_stream))


def _slices(dim_head: int, chunk: int, widest: int) -> Tuple[Tuple[int, int], ...]:
    """D's chunks in the fewest slices of at most ``widest`` columns, as even
    as whole chunks allow: (first column, columns) each."""
    n_chunks = -(-dim_head // chunk)
    per = -(-n_chunks // -(-dim_head // widest))
    return tuple((c * chunk, min(dim_head, (c + per) * chunk) - c * chunk)
                 for c in range(0, n_chunks, per))


@functools.lru_cache(maxsize=None)  # read on every launch of B
def mhsa_bwd_plan(dim_head: int, dtype: torch.dtype = torch.bfloat16) -> MhsaBwdPlan:
    """The plan kernel B runs for a head dim (a multiple of 8; the wrapper
    pads any other) (its wrapper hands it to the kernel; it is made nowhere
    else). The dq pass holds one output of at most 256 columns in bf16 (128
    in f32, whose products hold the TF32 halves of their operands); the
    dk/dv pass holds two, dK and dV, of at most 128 columns each (64 in
    f32). Each pass splits D into the fewest slices of that width and
    recomputes S and dP once a slice. The owned rows' chunks (Q and dO, or
    K and V: two of 64 rows each a chunk) stay resident beside the 64 KB
    ring where they fit, and stream through it otherwise, so every head dim
    has a plan."""
    if dim_head < 1 or dim_head % 8:
        raise ValueError(f"dim_head must be a positive multiple of 8, got {dim_head}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"kernels take bfloat16 or float32, got {dtype}")
    bf16 = dtype == torch.bfloat16
    chunk = CHUNK_BYTES // (2 if bf16 else 4)
    widest = (256, 128) if bf16 else (128, 64)
    dq, dkdv = (_slices(dim_head, chunk, w) for w in widest)
    groups = tuple(-(-s[0][1] // 64) for s in (dq, dkdv))
    n_chunks = -(-dim_head // chunk)
    fixed = 1024 + RING_BYTES + 8 * (2 * (RING_BYTES // (64 * CHUNK_BYTES)) + 1) + 1024
    resident = fixed + 2 * n_chunks * 64 * CHUNK_BYTES
    own_stream = resident > SMEM_LIMIT
    return MhsaBwdPlan(chunk, dq, dkdv, groups, own_stream, fixed if own_stream else resident)


@functools.lru_cache(maxsize=None)
def _bwd_arg(dim_head: int, dtype: torch.dtype):
    """The plan's ``arg`` as the C int array the entry points read."""
    return (ctypes.c_int * 5)(*mhsa_bwd_plan(dim_head, dtype).arg)


@functools.lru_cache(maxsize=None)
def _tile_arg(dim_head: int, dtype: torch.dtype):
    """The plan's ``tile`` as the C int array the entry points read (made
    once a head dim and dtype; the kernel only reads it)."""
    return (ctypes.c_int * 5)(*attention_plan(dim_head, dtype).tile)


def _salt_args(heads: int, heads_total: Optional[int], head0: int) -> Tuple[int, int]:
    """(heads_total, head0) of a call on ``heads`` heads, checked."""
    total = heads if heads_total is None else int(heads_total)
    if not 0 <= head0 <= total - heads:
        raise ValueError(f"heads [{head0}, {head0 + heads}) outside a layer of {total}")
    return total, int(head0)


def _mhsa_keep_factor(shape, seed: int, dropout_rate: float, device,
                      heads_total: Optional[int] = None, head0: int = 0) -> torch.Tensor:
    """keep / (1 - rate) over [B, heads, N, N]: the MHSA kernels' mask at
    (query row, key column) in plane b * heads_total + head0 + head."""
    B, heads = shape[0], shape[1]
    total, head0 = _salt_args(heads, heads_total, head0)
    salt = (torch.arange(B, device=device).reshape(B, 1, 1, 1) * total + head0
            + torch.arange(heads, device=device).reshape(1, heads, 1, 1))
    keep = keep_mask(shape, seed, dropout_rate, salt=salt, device=device)
    return keep.float() * (1.0 / (1.0 - dropout_rate))


def fused_mhsa_supported(heads: int, dim_head: int, N: int) -> bool:
    """The JAX package's gate: even heads, 128-lane head pairs, whole-K
    length. Every head dim it admits reaches an instance of A and B."""
    return heads % 2 == 0 and (2 * dim_head) % 128 == 0 and N <= WHOLE_K_MAX


def _heads(t: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    B, n, _ = t.shape
    return t.reshape(B, n, heads, dim_head).transpose(1, 2)


def _unheads(t: torch.Tensor) -> torch.Tensor:
    B, heads, n, dim_head = t.shape
    return t.transpose(1, 2).reshape(B, n, heads * dim_head)


def _split_heads(qkv: torch.Tensor, heads: int, dim_head: int):
    inner = heads * dim_head
    return (_heads(qkv[..., :inner], heads, dim_head),
            _heads(qkv[..., inner:2 * inner], heads, dim_head),
            _heads(qkv[..., 2 * inner:], heads, dim_head))


def _mhsa_scores(q, k, scale, n_true):
    """f32 scores [B, H, N, N] with keys >= n_true at -inf."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if s.shape[-1] != n_true:
        s = s.masked_fill(
            torch.arange(s.shape[-1], device=s.device) >= n_true, NEG_INF)
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """q, k, v [B, H, N, D] -> [B, H, N, D]: f32 scores, softmax over every
    key, the probabilities rounded to v's dtype, then the PV product in v's
    dtype (the JAX package's ``flash_attention`` reference and VJP)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def _flash_strides(name: str, t: torch.Tensor):
    """(batch, head, row) strides of a [B, H, N, D] operand the kernel's TMA
    descriptors can read: unit column stride, 16-byte aligned data and
    strides that are multiples of 8 elements (a dimension of extent 1 has
    no stride to check)."""
    strides = t.stride()
    if (strides[3] != 1 or t.data_ptr() % 16
            or any(x % 8 for x, n in zip(strides[:3], t.shape[:3]) if n > 1)):
        raise ValueError(f"{name}: flash_attention takes unit column stride, strides "
                         f"that are multiples of 8 and 16-byte aligned data; got "
                         f"strides {t.stride()}")
    return strides[:3]


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Kernel B10 on CUDA, :func:`flash_attention_reference` on the CPU; no
    autograd. The kernel reads q, k and v in place and writes o in [B, N, H,
    D] memory, returned as a [B, H, N, D] view, so merging the heads is no
    copy. A head dim that is not a multiple of 8 is zero-padded to the next
    one (a copy; zero columns change neither the scores nor the kept
    columns), with the true ``scale``, and the output sliced back."""
    if not _build.use_kernel(q):
        return flash_attention_reference(q, k, v, scale)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one [B, H, N, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if torch.compiler.is_exporting():
        return _build.op("flash_attention")(q, k, v, scale)
    D = q.shape[-1]
    if D % 8:
        q, k, v = (F.pad(t, (0, (-D) % 8)) for t in (q, k, v))
        return _flash_launch(q, k, v, scale)[..., :D]
    return _flash_launch(q, k, v, scale)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    B, H, N, D = q.shape
    dtype = _build.dtype_suffix(q)
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v must share device and dtype")
    plan = _tile_arg(D, q.dtype)
    o = torch.empty((B, N, H, D), device=q.device, dtype=q.dtype).transpose(1, 2)
    st = [*_flash_strides("q", q), *_flash_strides("k", k), *_flash_strides("v", v),
          *o.stride()[:3]]
    strides = (ctypes.c_longlong * 12)(*st)
    _build.launch("flash_attention", f"gaviko_flash_attention_{dtype}", _FLASH_ARGTYPES,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, N, D,
                  plan, strides, scale, _build.stream_of(q))
    flash_attention.launches += 1
    return o


class _FlashAttention(torch.autograd.Function):
    """Kernel B10 forward; the backward rematerialises the plain version and
    takes its VJP, the JAX package's ``_flash_bwd`` (an XLA VJP there, plain
    PyTorch on either device here)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _flash_forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_reference(*leaves, ctx.scale)
        return (*torch.autograd.grad(out, leaves, g), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Same contract as :func:`flash_attention_reference`; kernel B10 on
    CUDA (q, k, v may be strided head views of a packed projection),
    differentiable through the rematerialised plain version."""
    if not _build.needs_grad(q, k, v):
        return _flash_forward(q, k, v, scale)
    return _FlashAttention.apply(q, k, v, scale)


flash_attention.launches = 0


def mhsa_reference(qkv: torch.Tensor, heads: int, dim_head: int, scale: float,
                   n_true: int, dropout_rate: float = 0.0, with_lse: bool = False,
                   seed: int = 0, heads_total: Optional[int] = None, head0: int = 0):
    """qkv [B, N_pad, 3*heads*dim_head] -> [B, N_pad, heads*dim_head]; keys
    >= n_true are masked. f32 scores and softmax, hash dropout on the
    probabilities (``seed``, the module's mask), PV in qkv's dtype. With
    ``with_lse`` also the per-row log-sum-exp in log2 units [B, heads,
    N_pad] f32 of the scores before dropout, the statistic kernel A hands
    its backward."""
    q, k, v = _split_heads(qkv, heads, dim_head)
    s = _mhsa_scores(q, k, scale, n_true)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        p = p * _mhsa_keep_factor(s.shape, seed, dropout_rate, s.device, heads_total, head0)
    o = _unheads(torch.matmul(p.to(v.dtype), v))
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1) * LOG2E


def _mhsa_forward(qkv: torch.Tensor, heads: int, dim_head: int, scale: float,
                  n_true: int, dropout_rate: float, with_lse: bool, seed: int,
                  heads_total: Optional[int] = None, head0: int = 0):
    """Kernel A on CUDA, :func:`mhsa_reference` on the CPU; no autograd."""
    drop = dropout_args(dropout_rate, seed) + _salt_args(heads, heads_total, head0)
    if not _build.use_kernel(qkv):
        return mhsa_reference(qkv, heads, dim_head, scale, n_true, dropout_rate,
                              with_lse=with_lse, seed=seed, heads_total=heads_total,
                              head0=head0)
    if torch.compiler.is_exporting():
        if dropout_rate > 0.0 or with_lse:
            raise NotImplementedError("an exported forward runs fused_mhsa without dropout "
                                      "or lse")
        return _build.op("fused_mhsa")(qkv, heads, dim_head, scale, n_true)
    B, n_pad, three_inner = qkv.shape
    if three_inner != 3 * heads * dim_head:
        raise ValueError(f"fused_mhsa takes a packed [B, N, 3*heads*dim_head] qkv; got "
                         f"{tuple(qkv.shape)}, heads={heads}, dim_head={dim_head}")
    if not 1 <= n_true <= n_pad:
        raise ValueError(f"n_true {n_true} outside [1, {n_pad}]")
    if dim_head % 8:
        # TMA reads whole 16-byte head columns: zero-pad each head (a copy;
        # zero columns change neither the scores nor the kept columns), with
        # the true scale, and slice the output back.
        wide = dim_head + (-dim_head) % 8
        padded = F.pad(qkv.reshape(B, n_pad, 3 * heads, dim_head), (0, wide - dim_head))
        out, lse = _mhsa_launch(padded.reshape(B, n_pad, 3 * heads * wide), heads, wide,
                                scale, n_true, with_lse, drop)
        out = out.reshape(B, n_pad, heads, wide)[..., :dim_head].reshape(B, n_pad, -1)
    else:
        out, lse = _mhsa_launch(qkv, heads, dim_head, scale, n_true, with_lse, drop)
    return (out, lse) if with_lse else out


def _mhsa_launch(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, n_true: int,
                 with_lse: bool, drop):
    B, n_pad, _ = qkv.shape
    plan = _tile_arg(dim_head, qkv.dtype)
    _build.check_cuda("fused_mhsa", qkv)
    out = torch.empty((B, n_pad, heads * dim_head), device=qkv.device,
                      dtype=qkv.dtype)
    lse = (torch.empty((B, heads, n_pad), device=qkv.device, dtype=torch.float32)
           if with_lse else None)
    _build.launch(
        "fused_mhsa", f"gaviko_fused_mhsa_{_build.dtype_suffix(qkv)}",
        _MHSA_ARGTYPES, qkv.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, n_pad, heads, dim_head, n_true,
        plan, scale, *drop, _build.stream_of(qkv))
    fused_mhsa.launches += 1
    return out, lse


class _FusedMhsa(torch.autograd.Function):
    """The VJP of ``fused_mhsa`` on a given packed qkv, as the JAX package's
    custom VJP: kernel A with lse forward, kernel B (the dropout mask
    replayed from the seed) backward, returning the packed dqkv."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head, scale, n_true, dropout_rate, seed, heads_total,
                head0):
        out, lse = _mhsa_forward(qkv, heads, dim_head, scale, n_true, dropout_rate,
                                 True, seed, heads_total, head0)
        ctx.save_for_backward(qkv, out, lse)
        ctx.cfg = (heads, dim_head, scale, n_true, dropout_rate, seed, heads_total, head0)
        ctx.plain = _build.plain_active()
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _):
        qkv, out, lse = ctx.saved_tensors
        with _build.plain_versions(ctx.plain):
            dqkv = fused_mhsa_bwd(qkv, out, lse, g, *ctx.cfg)
        return dqkv, None, None, None, None, None, None, None, None


def fused_mhsa(qkv: torch.Tensor, heads: int, dim_head: int, scale: float,
               n_true: int, dropout_rate: float = 0.0, with_lse: bool = False,
               seed: int = 0, heads_total: Optional[int] = None, head0: int = 0):
    """Same contract as :func:`mhsa_reference`; kernel A on CUDA. Rows
    >= n_true are padding: their outputs are garbage by contract. When qkv
    needs a gradient the output's backward is kernel B (the lse is not
    differentiable). ``heads_total`` and ``head0`` place the call's heads in
    a wider layer, for the dropout planes only."""
    if not _build.needs_grad(qkv):
        return _mhsa_forward(qkv, heads, dim_head, scale, n_true, dropout_rate,
                             with_lse, seed, heads_total, head0)
    out, lse = _FusedMhsa.apply(qkv, heads, dim_head, scale, n_true,
                                float(dropout_rate), int(seed), heads_total, int(head0))
    return (out, lse) if with_lse else out


fused_mhsa.launches = 0


def mhsa_bwd_reference(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor, heads: int, dim_head: int,
                       scale: float, n_true: int, dropout_rate: float = 0.0,
                       seed: int = 0, heads_total: Optional[int] = None,
                       head0: int = 0) -> torch.Tensor:
    """The algebra of kernel B in plain PyTorch (f32): from the forward's
    output and lse (log2 units), P = exp2(s - lse), f = keep / (1 - rate)
    (the forward's mask, replayed), delta = rowsum(dO * O), dV = (f P)^T dO,
    dS = P (f dP - delta) -> packed dqkv [B, N_pad, 3 * inner] in qkv's
    dtype."""
    q, k, v = (t.float() for t in _split_heads(qkv, heads, dim_head))
    s2 = _mhsa_scores(q, k, scale * LOG2E, n_true)
    p = torch.exp2(s2 - lse.unsqueeze(-1))
    f = (_mhsa_keep_factor(p.shape, seed, dropout_rate, p.device, heads_total, head0)
         if dropout_rate > 0.0 else torch.ones_like(p))
    do = _heads(dout, heads, dim_head).float()
    delta = (do * _heads(out, heads, dim_head).float()).sum(-1, keepdim=True)
    dv = torch.matmul((f * p).transpose(-1, -2), do)
    ds = p * (f * torch.matmul(do, v.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return torch.cat([_unheads(dq), _unheads(dk), _unheads(dv)], dim=-1).to(qkv.dtype)


def fused_mhsa_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                   dout: torch.Tensor, heads: int, dim_head: int, scale: float,
                   n_true: int, dropout_rate: float = 0.0, seed: int = 0,
                   heads_total: Optional[int] = None, head0: int = 0) -> torch.Tensor:
    """Same contract as :func:`mhsa_bwd_reference`; kernel B on CUDA (two
    passes in one call of its entry point). A head dim that is not a
    multiple of 8 runs on copies of qkv, out and dout with each head
    zero-padded to one (zero columns change neither the scores nor the kept
    columns), and dqkv is sliced back."""
    drop = dropout_args(dropout_rate, seed) + _salt_args(heads, heads_total, head0)
    if not _build.use_kernel(qkv):
        return mhsa_bwd_reference(qkv, out, lse, dout, heads, dim_head, scale, n_true,
                                  dropout_rate, seed, heads_total, head0)
    B, n_pad, three_inner = qkv.shape
    inner = heads * dim_head
    if three_inner != 3 * inner:
        raise ValueError(f"fused_mhsa_bwd takes a packed qkv; got {tuple(qkv.shape)}, "
                         f"heads={heads}, dim_head={dim_head}")
    if not 1 <= n_true <= n_pad:
        raise ValueError(f"n_true {n_true} outside [1, {n_pad}]")
    dout = dout.contiguous()
    if tuple(out.shape) != (B, n_pad, inner) or dout.shape != out.shape:
        raise ValueError(f"out and dout must be {(B, n_pad, inner)}")
    if tuple(lse.shape) != (B, heads, n_pad) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, heads, n_pad)}")
    _build.check_cuda("fused_mhsa_bwd", qkv, out, dout)
    _build.check_cuda("fused_mhsa_bwd", lse)
    if dim_head % 8:
        wide = dim_head + (-dim_head) % 8

        def pad(t, n):
            return F.pad(t.reshape(B, n_pad, n, dim_head), (0, wide - dim_head)).reshape(
                B, n_pad, n * wide)

        dqkv = _mhsa_bwd_launch(pad(qkv, 3 * heads), pad(out, heads), pad(dout, heads), lse,
                                heads, wide, scale, n_true, drop)
        return dqkv.reshape(B, n_pad, 3 * heads, wide)[..., :dim_head].reshape(B, n_pad, -1)
    return _mhsa_bwd_launch(qkv, out, dout, lse, heads, dim_head, scale, n_true, drop)


def _mhsa_bwd_launch(qkv, out, dout, lse, heads, dim_head, scale, n_true, drop):
    B, n_pad, _ = qkv.shape
    plan = _bwd_arg(dim_head, qkv.dtype)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    _build.launch(
        "fused_mhsa_bwd", f"gaviko_fused_mhsa_bwd_{_build.dtype_suffix(qkv)}",
        _MHSA_BWD_ARGTYPES, qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), B, n_pad, heads,
        dim_head, n_true, plan, scale, *drop, _build.stream_of(qkv))
    fused_mhsa_bwd.launches += 1
    return dqkv


fused_mhsa_bwd.launches = 0


class _MhsaQkvProj(torch.autograd.Function):
    """qkv = h W^T, then kernel A; the backward runs kernel B (the dropout
    mask replayed from the seed) and the two products of the projection's
    VJP."""

    @staticmethod
    def forward(ctx, h, w, heads, dim_head, scale, n_true, dropout_rate, seed, heads_total,
                head0):
        qkv = F.linear(h, w)
        out, lse = fused_mhsa(qkv, heads, dim_head, scale, n_true, dropout_rate,
                              with_lse=True, seed=seed, heads_total=heads_total, head0=head0)
        ctx.save_for_backward(h, w, qkv, out, lse)
        ctx.cfg = (heads, dim_head, scale, n_true, dropout_rate, seed, heads_total, head0)
        ctx.plain = _build.plain_active()
        return out

    @staticmethod
    def backward(ctx, g):
        h, w, qkv, out, lse = ctx.saved_tensors
        # dq, dk and dv sit side by side in one buffer, so the JAX package's
        # dh = dq Wq + dk Wk + dv Wv is one product with the packed weight.
        with _build.plain_versions(ctx.plain):
            dqkv = fused_mhsa_bwd(qkv, out, lse, g, *ctx.cfg)
        dh = torch.matmul(dqkv, w) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(dqkv.reshape(-1, dqkv.shape[-1]).t(),
                              h.reshape(-1, h.shape[-1]))
        return dh, dw, None, None, None, None, None, None, None, None


def mhsa_qkv_proj(h: torch.Tensor, w: torch.Tensor, heads: int, dim_head: int,
                  scale: float, n_true: int, dropout_rate: float = 0.0,
                  seed: Optional[int] = None, heads_total: Optional[int] = None,
                  head0: int = 0) -> torch.Tensor:
    """``fused_mhsa(h @ w.T)`` under one autograd function: h [B, N_pad, dim]
    (the LN output), w [3*heads*dim_head, dim] (torch layout), ``seed`` the
    int32 dropout seed (unused at rate 0), ``heads_total`` and ``head0`` as
    :func:`fused_mhsa` takes them. The backward forms dW only when ``w``
    needs a gradient."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")
    return _MhsaQkvProj.apply(h, w, heads, dim_head, scale, n_true, float(dropout_rate),
                              0 if seed is None else int(seed), heads_total, int(head0))


def _local_keep(shape, seed: int, dropout_rate: float, device) -> torch.Tensor:
    """The local kernels' mask: rows = query index, cols = key index, salt
    = batch index (the TPU kernel's, ``flash_attention.py:938-942``)."""
    B = shape[0]
    salt = torch.arange(B, device=device).reshape(B, 1, 1)
    return keep_mask(shape, seed, dropout_rate, salt=salt, device=device)


def _local_scores(q, k, scale, DHW, local_k):
    mask = local_mask_additive(DHW, local_k, device=q.device)
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + mask


def local_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, DHW: Tuple[int, int, int],
                    local_k: Tuple[int, int, int], dropout_rate: float = 0.0,
                    seed: int = 0, with_lse: bool = False):
    """q, k, v [B, N, dl], N == prod(DHW) -> [B, N, dl]: softmax over the 3-D
    window (additive mask), then hash dropout on the probabilities, f32
    scores, PV in v's dtype. With ``with_lse`` also the per-row natural
    log-sum-exp [B, N] f32 that kernel C hands its backward."""
    s = _local_scores(q, k, scale, DHW, local_k)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = _local_keep(s.shape, seed, dropout_rate, q.device)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), torch.zeros_like(p))
    o = torch.matmul(p.to(v.dtype), v)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1)


def local_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        scale: float, DHW: Tuple[int, int, int],
                        local_k: Tuple[int, int, int], dropout_rate: float = 0.0,
                        seed: int = 0) -> torch.Tensor:
    """The algebra of kernel D in plain PyTorch (f32): P = exp(s - lse),
    f = keep / (1 - rate), delta = rowsum(dO * O), dS = P (f dP - delta)
    -> packed dqkv [B, N, 3 * dl] in q's dtype."""
    s = _local_scores(q, k, scale, DHW, local_k)
    p = torch.exp(s - lse.unsqueeze(-1))
    f = torch.ones_like(p)
    if dropout_rate > 0.0:
        keep = _local_keep(s.shape, seed, dropout_rate, q.device)
        f = keep.float() * (1.0 / (1.0 - dropout_rate))
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    dv = torch.matmul((f * p).transpose(-1, -2), do)
    ds = p * (f * torch.matmul(do, v.float().transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return torch.cat([dq, dk, dv], dim=-1).to(q.dtype)


class LocalPass(NamedTuple):
    """One pass of kernels C and D as ``csrc/local_window.cuh`` takes it. A
    CTA owns up to 16 rows of one depth slab (query rows in C and D's dq
    pass, key rows in D's dk/dv pass); ``split`` warps take its streamed
    tiles of LOCAL_KEYS rows on ``mma.sync``, each every split-th tile,
    combined in warp order; ``stages`` rounds of tiles in flight (2:
    double-buffered); ``width`` the columns of
    a staged row: dl padded to S's depth, and far enough for every slice,
    or, below dl, the chunk in which S's depth (and D's dP's) streams
    through (see :func:`local_plan`); ``cols`` the output columns a CTA
    accumulates and ``slices`` the CTAs that share the output's columns,
    each recomputing S; ``rs`` the row
    stride (elements) the streamed tiles' stripes are sized for, each tile's
    rows one bulk copy of their contiguous bytes (0: element-wise copies);
    ``kv`` whether K and V share one stripe (C and the dq pass, on views of
    one packed projection); ``smem`` a CTA's shared memory."""

    split: int
    stages: int
    width: int
    cols: int
    slices: int
    rs: int
    kv: int
    smem: int

    @property
    def arg(self) -> Tuple[int, ...]:
        """The seven ints of the kernels' ``Pass``."""
        return self.split, self.stages, self.width, self.cols, self.slices, self.rs, self.kv


class LocalPlan(NamedTuple):
    """The passes of kernel C (``fwd``) and of kernel D (``dq``, ``dkdv``)."""

    fwd: LocalPass
    dq: LocalPass
    dkdv: LocalPass

    @property
    def bwd_arg(self) -> Tuple[int, ...]:
        """D's ``plan`` argument: the dq pass's seven ints, then the dk/dv pass's."""
        return self.dq.arg + self.dkdv.arg


def _local_ld(width: int, size: int) -> int:
    """Elements of a staged row (``csrc/local_window.cuh:ld_of``): whole
    16-byte units, 4 words past a multiple of 8 (conflict-free fragments)."""
    words = width * size // 4
    words += (12 - words % 8) % 8
    return words * 4 // size


def _stripe_region(rs_bytes: int, read_bytes: int, rows: int = LOCAL_KEYS) -> int:
    """Bytes of a stripe of ``rows`` rows (``csrc/local_window.cuh:stripe_region``)."""
    return (32 + (rows - 1) * rs_bytes + read_bytes + 16 + 15) // 16 * 16


def _local_smem(kind: str, split: int, stages: int, width: int, cols: int, size: int,
                rs: int = 0, kv: bool = False, chunked: bool = False) -> int:
    """A CTA's shared memory (``csrc/local_window.cuh:layout``): the owned
    rows (C: Q; dq: Q, dO and two floats a row; dk/dv: K and V), then the
    larger of ``stages`` x ``split`` streamed tiles (C: K and V's slice; dq:
    K and V; dk/dv: Q, dO and two floats a row; as stripes at row stride
    ``rs``, or element-wise with ``rs`` 0; K and V as one stripe with ``kv``;
    each with a coordinate a row) and the split warps' partials for the
    combine, then the mbarriers. With ``chunked`` (S's depth streamed in
    chunks of ``width`` columns, element-wise) every staged row is a chunk
    and the streamed tiles also hold the rows' slice of the output's B
    operand apart (dq: K's; dk/dv: Q's and dO's), so nothing grows with
    dl."""
    rows, kt, ld = 16, LOCAL_KEYS, _local_ld(width, size)
    own = rows * ld * size if kind == "fwd" else (
        2 * rows * ld * size + (8 * rows if kind == "dq" else 0))
    if rs:
        own += ({"fwd": 1, "dq": 3, "dkdv": 2}[kind] * _stripe_region(rs * size, width * size, rows)
                + (_stripe_region(4, 4, rows) if kind == "dq" else 0))
        read_b = cols if kind == "fwd" else width
        floats = 2 * _stripe_region(4, 4) if kind == "dkdv" else 0
        b_rs = width if kind == "dkdv" else rs  # dO's rows are dl <= width apart
        rows_b = (_stripe_region(rs * size, (rs + width) * size) if kv else
                  _stripe_region(rs * size, width * size)
                  + _stripe_region(b_rs * size, read_b * size))
        tile = rows_b + floats + 4 * kt
    else:
        ld_b = _local_ld(cols, size) if kind == "fwd" else ld
        tile = kt * (ld + ld_b) * size + (8 * kt if kind == "dkdv" else 0) + 4 * kt
        if chunked:
            tile += {"fwd": 0, "dq": 1, "dkdv": 2}[kind] * kt * _local_ld(cols, size) * size
    partial = cols + 2 if kind == "fwd" else cols if kind == "dq" else 2 * cols
    return own + max(stages * split * tile, split * 16 * 4 * partial) + 8 * 4 * LOCAL_WARPS


@functools.lru_cache(maxsize=None)  # read on every launch of C and D
def local_plan(DHW: Tuple[int, int, int], local_k: Tuple[int, int, int], dl: int,
               dtype: torch.dtype = torch.bfloat16, B: int = 1, rs: int = 0,
               kv: bool = False) -> LocalPlan:
    """The plan kernels C and D run for a grid, window, latent width, dtype
    and batch (their wrappers hand it to the kernels; it is made nowhere
    else). Each pass splits dl into the fewest column slices of at most 128
    columns (C and the dq pass; 64 in f32) or 64 (the dk/dv pass, which
    holds dK and dV; 32 in f32). A CTA owns up to 16 rows of one depth slab
    with the streamed tiles split across 4 warps (GAViKO's B4: 280 CTAs; on
    the card 16 rows beat 32 and 64 a CTA, and 4 warps beat 2 and 8, at B4
    and B8), double-buffered where the grid's CTAs still fit one wave of
    the SMs' shared memory (a third stage bought nothing); where a CTA's
    shared memory runs short it gives up the second stage, then split
    warps. With ``rs`` (the streamed views' row stride, elements; the
    wrappers give it where their rows may be read in place) the streamed
    tiles are stripes at that stride, else, or where no such plan fits,
    element-wise copies; with ``kv`` (K and V views of one packed
    projection) C and the dq pass take K and V in one stripe. Shared memory
    does not grow with the grid; the window does not change the plan.

    Where no staged row of S's whole depth leaves a tile in shared memory
    (the dq and dk/dv passes above dl 576 in f32 and 1152 in bf16, which
    stage two such rows a streamed key or query; ROADMAP Queue C 12), the
    pass streams S's depth (and D's dP's) through in chunks of ``width`` =
    128 columns in bf16 (64 in f32), below dl: each round copies the owned
    rows' and the streamed tiles' chunk element-wise, one round in flight,
    and accumulates S over the chunks, while the output's B operand (C: V;
    dq: K; dk/dv: Q and dO) comes as its column slice apart. No staged row
    then grows with dl, so every dl >= 1 has a plan; the passes that fit
    whole keep it."""
    D, H, W = (int(x) for x in DHW)
    if dl < 1:
        raise ValueError(f"local_dim must be >= 1, got {dl}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"kernels take bfloat16 or float32, got {dtype}")
    if min(D, H, W) < 1 or max(H, W) > 1023 or min(int(x) for x in local_k) < 1:
        raise ValueError(f"grid {DHW} (H and W 1..1023) or window {local_k} (>= 1)")
    bf16 = dtype == torch.bfloat16
    size, step = (2, 16) if bf16 else (4, 8)
    depth = -(-dl // step) * step
    N = D * H * W

    def one(kind: str, widest: int) -> LocalPass:
        slices = _slices(dl, 8, widest)
        cols = -(-slices[0][1] // 8) * 8
        width = depth if kind == "fwd" else -(-max(depth, len(slices) * cols) // step) * step
        joint = int(kv and kind != "dkdv")
        per_sm = -(-B * D * -(-H * W // 16) * len(slices) // SMS)  # CTAs an SM holds in a wave
        for stride in ((rs, 0) if rs else (0,)):
            for split in (4, 2, 1):
                for stages in (2, 1):
                    smem = _local_smem(kind, split, stages, width, cols, size, stride,
                                       joint and stride > 0)
                    if smem > SMEM_LIMIT or (stages > 1 and per_sm * (smem + 1024) > SM_SMEM):
                        continue
                    return LocalPass(split, stages, width, cols, len(slices), stride,
                                     joint if stride else 0, smem)
        chunk = 256 // size  # S's depth a chunk: 256 bytes a row, 128 bf16 / 64 f32
        for split in (4, 2, 1):
            smem = _local_smem(kind, split, 1, chunk, cols, size, chunked=True)
            if chunk < dl and smem <= SMEM_LIMIT:
                return LocalPass(split, 1, chunk, cols, len(slices), 0, 0, smem)
        raise ValueError(f"local_dim {dl} in {dtype}: a staged row of {width} columns leaves "
                         f"no tile in a CTA's shared memory")

    wide = (128, 64) if bf16 else (64, 32)
    return LocalPlan(one("fwd", wide[0]), one("dq", wide[0]), one("dkdv", wide[1]))


@functools.lru_cache(maxsize=None)
def _local_arg(DHW, local_k, dl: int, dtype: torch.dtype, B: int, rs: int, kv: bool,
               bwd: bool):
    """C's (``bwd`` False) or D's plan argument as the C int array the entry
    points read."""
    plan = local_plan(DHW, local_k, dl, dtype, B, rs, kv)
    ints = plan.bwd_arg if bwd else plan.fwd.arg
    return (ctypes.c_int * len(ints))(*ints)


def _local_geometry(q, k, v, DHW, local_k):
    """The kernels' geometry arguments. Runs on every launch of C and D, so
    it reads each tensor's shape and strides once, as tuples (indexing a
    tensor's ``shape`` or ``stride(i)`` costs microseconds of host time)."""
    shape = tuple(q.shape)
    B, N, dl = shape
    D, H, W = (int(x) for x in DHW)
    kd, kh, kw = (int(x) for x in local_k)
    if N != D * H * W:
        raise ValueError(f"N={N} must equal prod(DHW)={D * H * W}")
    strides = [t.stride() for t in (q, k, v)]
    for t, st in zip((k, v), strides[1:]):
        if tuple(t.shape) != shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v must share shape, device and dtype, with "
                             "unit column stride")
    if any(st[2] != 1 for st in strides):
        raise ValueError("q, k, v must share shape, device and dtype, with "
                         "unit column stride")
    (qb, qr, _), (kb, kr, _), (vb, vr, _) = strides
    return B, N, dl, D, H, W, kd, kh, kw, qb, qr, kb, kr, vb, vr


def _local_plan_arg(geom, views, bwd: bool):
    """The plan argument for these views (q, k, v, and dout for D): streamed
    tiles as stripes at the widest row stride where every view's rows lie on
    4-byte words (the kernels read bf16 pairs), else element-wise."""
    B, _, dl, D, H, W, kd, kh, kw = geom[:9]
    size = views[0].element_size()
    strides = [t.stride() for t in views]
    words = all(t.data_ptr() % 4 == 0 and st[0] * size % 4 == 0 and st[1] * size % 4 == 0
                for t, st in zip(views, strides))
    rs = max(st[1] for st in strides) if words else 0
    k, v = views[1], views[2]
    off = v.data_ptr() - k.data_ptr()
    kv = (rs > 0 and strides[1] == strides[2] and off >= 0 and off // size + dl <= strides[1][1]
          and k.untyped_storage().data_ptr() == v.untyped_storage().data_ptr())
    return _local_arg((D, H, W), (kd, kh, kw), dl, views[0].dtype, B, rs, kv, bwd)


def _storage_ends(*tensors):
    """The first byte past each tensor's storage: bulk copies stop there."""
    ends = [t.untyped_storage().data_ptr() + t.untyped_storage().nbytes() for t in tensors]
    return (ctypes.c_void_p * 7)(*ends, *([None] * (7 - len(ends))))


def _local_forward(q, k, v, scale, DHW, local_k, dropout_rate, seed):
    """Kernel C -> (out [B, N, dl], lse [B, N] f32)."""
    if not _build.use_kernel(q):
        return local_reference(q, k, v, scale, DHW, local_k, dropout_rate, seed,
                               with_lse=True)
    if torch.compiler.is_exporting():
        if dropout_rate > 0.0:
            raise NotImplementedError("an exported forward runs the local attention "
                                      "without dropout")
        return _build.op("local_attention")(q, k, v, scale, list(DHW), list(local_k)), None
    geom = _local_geometry(q, k, v, DHW, local_k)
    drop = dropout_args(dropout_rate, seed)
    B, N, dl = q.shape
    out = torch.empty((B, N, dl), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, N), device=q.device, dtype=torch.float32)
    _build.launch(
        "local_attention", f"gaviko_local_attention_{_build.dtype_suffix(q)}",
        _LOCAL_ARGTYPES, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *geom, scale, *drop, _local_plan_arg(geom, (q, k, v), False),
        _storage_ends(q, k, v), _build.stream_of(q))
    flash_local_attention.launches += 1
    return out, lse


def local_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        scale: float, DHW: Tuple[int, int, int],
                        local_k: Tuple[int, int, int], dropout_rate: float = 0.0,
                        seed: int = 0) -> torch.Tensor:
    """Same contract as :func:`local_bwd_reference`; kernel D on CUDA."""
    if not _build.use_kernel(q):
        return local_bwd_reference(q, k, v, out, lse, dout, scale, DHW, local_k,
                                   dropout_rate, seed)
    geom = _local_geometry(q, k, v, DHW, local_k)
    drop = dropout_args(dropout_rate, seed)
    B, N, dl = q.shape
    dout = dout.contiguous()
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}")
    if tuple(lse.shape) != (B, N) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, N)}")
    _build.check_cuda("local_attention_bwd", out, dout)
    _build.check_cuda("local_attention_bwd", lse)
    dqkv = torch.empty((B, N, 3 * dl), device=q.device, dtype=q.dtype)
    delta = torch.empty_like(lse)
    _build.launch(
        "local_attention_bwd",
        f"gaviko_local_attention_bwd_{_build.dtype_suffix(q)}", _LOCAL_BWD_ARGTYPES,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), *geom, scale, *drop,
        _local_plan_arg(geom, (q, k, v, dout), True),
        _storage_ends(q, k, v, dout, lse, delta, out), _build.stream_of(q))
    local_attention_bwd.launches += 1
    return dqkv


local_attention_bwd.launches = 0


class _LocalAttention(torch.autograd.Function):
    """Kernel C forward; kernel D backward from the saved (out, lse), with
    the dropout bits replayed from (seed, coordinates)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, DHW, local_k, dropout_rate, seed):
        out, lse = _local_forward(q, k, v, scale, DHW, local_k, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (scale, DHW, local_k, dropout_rate, seed)
        ctx.plain = _build.plain_active()
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        with _build.plain_versions(ctx.plain):
            dqkv = local_attention_bwd(q, k, v, out, lse, g, *ctx.cfg)
        dq, dk, dv = dqkv.chunk(3, dim=-1)
        return dq, dk, dv, None, None, None, None, None


def flash_local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, DHW: Tuple[int, int, int],
                          local_k: Tuple[int, int, int],
                          dropout_rate: float = 0.0,
                          seed: Optional[int] = None) -> torch.Tensor:
    """Same contract as :func:`local_reference`, differentiable; kernels C
    and D on CUDA. q, k and v may be strided views (unit column stride),
    e.g. splits of [B, N, 3*dl]. ``seed`` is the int32 dropout seed (unused
    at rate 0)."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")
    return _LocalAttention.apply(q, k, v, scale, tuple(DHW), tuple(local_k),
                                 float(dropout_rate), 0 if seed is None else int(seed))


flash_local_attention.launches = 0
