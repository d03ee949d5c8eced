"""Global-norm clip + Adam over every trainable tensor: kernel B13.

Port of ``gaviko_tpu/ops/fused_adam.py`` (``_adam_leaf_kernel``, the
one-pass Adam leaf update) and of the norm pass before it
(``gaviko_tpu/train/fused_optim.py:step``). On the card one call runs
``csrc/fused_adam.cu`` over every leaf at once: a multi-tensor sum of
squares in f64, then the update, which forms the clip scale from the
partials on the device and updates the parameters and both moments in
place, 16 bytes a load where a leaf's tensors line up. Where the gradients
fit in L2 (:data:`ONE_PASS_BYTES`: GAViKO's) both run in one cooperative
launch with a grid-wide barrier between them, else in two launches. The
TPU kernel runs one launch a leaf, bakes b1 in and is gated to large
leaves; this one takes b1 (the cycled OneCycle beta1) as a per-step scalar
and has no gate.

:func:`adam_reference` is the plain PyTorch version (the port's per-leaf
math before the kernel): it returns new tensors and leaves its inputs as
they are. :func:`fused_adam` runs it on CPU tensors and inside
``_build.plain_versions()``; on CUDA tensors it launches the kernel, which
updates ``params``, ``mu`` and ``nu`` in place (the JAX step donates them)
and returns them.

The kernel's table of leaves (pointers, sizes, chunk starts, each leaf's
alignment and each chunk's leaf), :class:`AdamTable`, is built once for a
set of parameter and moment tensors and held by the caller
(``train/fused_optim.py`` keeps one with the optimizer state); a step
rewrites only the grad pointers and the four step scalars, with one
asynchronous copy from pinned memory, so the step has no host sync.

A sharded step (``parallel/mesh.py``: each rank updates its ZeRO slices and
tensor-parallel shards) passes ``norm_reduce``: the norm launch then writes
the sum of squares of the leaves the rank counts (the first ``n_counted``)
to one f64 on the device, ``norm_reduce`` sums it over the ranks in place,
and the update launch forms the clip scale from it. With one rank that is
bit-equal to the two-launch step.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaviko_tpu_torch.ops import _build

B2 = 0.999  # Adam's beta2, fixed as in the reference
CHUNK = 4096  # elements a block takes at once (csrc/fused_adam.cu)
SUM_BLOCKS = 264  # most blocks of the sum of squares: two a streaming multiprocessor
UPDATE_BLOCKS = 1056  # most blocks of the update: eight a streaming multiprocessor
# Gradients of at most this many bytes take the one-launch step: the update
# re-reads them from the H100's 50 MB L2, beside the moments and params
# streaming through it (GAViKO's 604 f32 leaves: 9.1 MB; vit-b16's: 353 MB).
ONE_PASS_BYTES = 24 << 20

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = (_P, _I, _L, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P)
_SUMSQ_ARGTYPES = (_P, _I, _L, _P, _I, _P, _P)
_APPLY_ARGTYPES = (_P, _I, _L, _P, _I, _F, _F, _F, _F, _P)

Tensors = Sequence[torch.Tensor]


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, summed in f64 and
    rounded once to f32, on the tensors' device."""
    return torch.sqrt(sum(g.double().square().sum() for g in grads)).float()


def sharded_norm(grads: Tensors, norm_reduce, n_counted: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """The global norm of a sharded step: the f64 sum of squares of the first
    ``n_counted`` gradients (the leaves this rank counts), summed over the
    ranks in place by ``norm_reduce``, then sqrt and rounded once to f32."""
    counted = list(grads)[:len(grads) if n_counted is None else n_counted]
    total = torch.zeros((), dtype=torch.float64, device=device or grads[0].device)
    for g in counted:
        total = total + g.double().square().sum()
    norm_reduce(total)
    return torch.sqrt(total).float()


@torch.no_grad()
def adam_reference(grads: Tensors, mu: Tensors, nu: Tensors, params: Tensors,
                   lr: float, b1: float, c1: float, c2: float, clip: float,
                   eps: float, norm_reduce=None,
                   n_counted: Optional[int] = None) -> Tuple[List[torch.Tensor], ...]:
    """-> (new params, new mu, new nu), new tensors. ``lr``, ``b1``, ``c1``
    and ``c2`` are the step's f32 scalars; the clip scale is ``1 if gn <
    clip else clip / gn`` of the global norm, on the device. Every quotient
    divides by a tensor on the operands' device: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which rounds differently
    from the kernel's (and JAX's) IEEE division."""
    if not grads:
        return [], [], []
    gn = global_norm(grads) if norm_reduce is None else sharded_norm(grads, norm_reduce,
                                                                      n_counted)
    dev = gn.device
    scale = torch.where(gn < clip, torch.ones_like(gn), torch.full_like(gn, clip) / gn)
    c1, c2 = (torch.tensor(c, dtype=torch.float32, device=dev) for c in (c1, c2))
    omb1 = float(np.float32(1.0) - np.float32(b1))
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(grads, mu, nu, params):
        g = g * scale.to(g.dtype)
        m = b1 * m.float() + omb1 * g.float()
        v = B2 * v.float() + (1.0 - B2) * g.float().square()
        update = (m / c1) / (torch.sqrt(v / c2) + eps)
        # Moments and params keep their storage dtype; the arithmetic is f32.
        new_p.append(p - (lr * update).to(p.dtype))
        new_m.append(m.to(p.dtype))
        new_v.append(v.to(p.dtype))
    return new_p, new_m, new_v


def leaf_phases(mu: Tensors, nu: Tensors, params: Tensors) -> np.ndarray:
    """Each leaf's byte offset modulo 16 that its moments and param share,
    or -1 where they do not: the step moves a leaf's elements as 16-byte
    vectors where its gradient shares the offset too (csrc/fused_adam.cu)."""
    ptrs = np.array([[t.data_ptr() for t in ts] for ts in (mu, nu, params)], np.int64) % 16
    return np.where((ptrs == ptrs[0]).all(axis=0), ptrs[0], -1).astype(np.int64)


def one_pass(nbytes: int) -> bool:
    """Whether a step over gradients of ``nbytes`` bytes takes the one-launch
    kernel (they fit in L2 beside the update's streams)."""
    return nbytes <= ONE_PASS_BYTES


class AdamTable:
    """The device table of one set of (mu, nu, param) tensors
    (csrc/fused_adam.cu's layout), its f64 partials and its grid barrier.
    It holds the tensors, so their addresses stay valid while it lives.
    ``phases`` is each leaf's alignment (:func:`leaf_phases`); ``one_pass``
    whether a step is one launch. Built from CPU tensors it stays on the
    CPU (its host side, for inspection)."""

    def __init__(self, mu: Tensors, nu: Tensors, params: Tensors):
        self.dtype, device = params[0].dtype, params[0].device
        _build.dtype_suffix(params[0])
        for t in (*mu, *nu, *params):
            if t.dtype != self.dtype or t.device != device or not t.is_contiguous():
                raise ValueError("fused_adam: moments and params must be contiguous and "
                                 f"share one dtype and device; got {t.dtype} on {t.device}, "
                                 f"want {self.dtype} on {device}")
        n = len(params)
        if not (len(mu) == len(nu) == n):
            raise ValueError("fused_adam: one mu and nu for every param")
        self.tensors = (tuple(mu), tuple(nu), tuple(params))
        self.shapes = [p.shape for p in params]
        self.device_index = device.index
        numel = np.array([p.numel() for p in params], np.int64)
        chunks = -(-numel // CHUNK)
        starts = np.concatenate([[0], np.cumsum(chunks)]).astype(np.int64)
        self.starts = starts
        self.n, self.n_chunks = n, int(starts[-1])
        self.phases = leaf_phases(mu, nu, params)
        leaf_of = np.repeat(np.arange(n, dtype=np.int32), chunks)
        words = np.zeros(7 * n + 2 + -(-self.n_chunks // 2), np.int64)
        words[n + 2:2 * n + 2] = [t.data_ptr() for t in mu]
        words[2 * n + 2:3 * n + 2] = [t.data_ptr() for t in nu]
        words[3 * n + 2:4 * n + 2] = [t.data_ptr() for t in params]
        words[4 * n + 2:5 * n + 2] = numel
        words[5 * n + 2:6 * n + 2] = starts[:-1]
        words[6 * n + 2:7 * n + 2] = self.phases
        words[7 * n + 2:].view(np.int32)[:self.n_chunks] = leaf_of
        self.words = torch.from_numpy(words)
        if device.type == "cuda":
            self.words = self.words.pin_memory().to(device, non_blocking=True)
        self.one_pass = one_pass(int(numel.sum()) * self.dtype.itemsize)
        self.n_sum = min(self.n_chunks, SUM_BLOCKS)
        self.n_update = min(self.n_chunks, UPDATE_BLOCKS)
        self.partials = torch.empty(max(self.n_sum, self.n_update), dtype=torch.float64,
                                    device=device)
        self.barrier = torch.zeros(2, dtype=torch.int32, device=device)
        self.total = torch.zeros(1, dtype=torch.float64, device=device)

    def holds(self, mu: Tensors, nu: Tensors, params: Tensors) -> bool:
        """Whether the table was built for exactly these tensors, in order."""
        return all(len(ts) == self.n and all(a is b for a, b in zip(ts, mine))
                   for ts, mine in zip((mu, nu, params), self.tensors))


@torch.no_grad()
def fused_adam(grads: Tensors, mu: Tensors, nu: Tensors, params: Tensors,
               lr: float, b1: float, c1: float, c2: float, clip: float = 1.0,
               eps: float = 1e-8, table: AdamTable = None, norm_reduce=None,
               n_counted: Optional[int] = None) -> Tuple[List[torch.Tensor], ...]:
    """One clip + Adam step of every leaf: -> (params, mu, nu).

    Kernel B13 on CUDA tensors (one launch or two, the update in place:
    the returned tensors are the ones given); :func:`adam_reference` on CPU
    tensors and inside ``_build.plain_versions()`` (new tensors). The four
    step scalars are f32 values. ``table`` is an :class:`AdamTable` that
    holds ``mu``, ``nu`` and ``params`` (its caller checks
    :meth:`AdamTable.holds`), kept across steps; without one the call
    builds its own. ``norm_reduce`` and ``n_counted``: the sharded step (the
    module's docstring); the norm counts the first ``n_counted`` leaves."""
    if not params:
        return [], [], []
    if not _build.use_kernel(params[0]):
        return adam_reference(grads, mu, nu, params, lr, b1, c1, c2, clip, eps, norm_reduce,
                              n_counted)
    if table is None:
        table = AdamTable(mu, nu, params)
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    if len(grads) != table.n or any(
            g.shape != s or g.dtype is not table.dtype or g.get_device() != table.device_index
            for g, s in zip(grads, table.shapes)):
        raise ValueError(f"fused_adam: the {len(grads)} grads do not match the shapes, "
                         f"dtype {table.dtype} and device cuda:{table.device_index} of the "
                         f"{table.n} params")
    n = table.n
    step = np.empty(n + 2, np.int64)
    step[:n] = [g.data_ptr() for g in grads]
    step[n:] = np.array([lr, b1, c1, c2], np.float32).view(np.int64)
    table.words[:n + 2].copy_(torch.from_numpy(step).pin_memory(), non_blocking=True)
    if norm_reduce is None:
        launch_table(table, params[0], clip, eps)
    else:
        launch_sharded(table, params[0], clip, eps, norm_reduce,
                       table.n if n_counted is None else n_counted)
    return list(params), list(mu), list(nu)


def launch_table(table: AdamTable, like: torch.Tensor, clip: float, eps: float) -> None:
    """Launch B13 on ``table`` as it stands (the step's grad pointers and
    scalars already copied in), on ``like``'s stream: one kernel where
    ``table.one_pass``, else the sum of squares and the update."""
    dtype = _build.dtype_suffix(like)
    _build.launch("fused_adam", f"gaviko_fused_adam_{dtype}", _ARGTYPES,
                  table.words.data_ptr(), table.n, table.n_chunks, table.partials.data_ptr(),
                  table.barrier.data_ptr(), table.n_sum, table.n_update, int(table.one_pass),
                  float(clip), float(np.float32(B2)), float(np.float32(1.0 - B2)), float(eps),
                  _build.stream_of(like))
    fused_adam.launches += 1


def launch_sharded(table: AdamTable, like: torch.Tensor, clip: float, eps: float,
                   norm_reduce, n_counted: int) -> None:
    """The sharded step on ``table``: the norm launch over its first
    ``n_counted`` leaves into ``table.total``, ``norm_reduce(table.total)``
    (the sum over the ranks), then the update launch."""
    dtype = _build.dtype_suffix(like)
    if not 0 <= n_counted <= table.n:
        raise ValueError(f"fused_adam: n_counted {n_counted} outside [0, {table.n}]")
    counted = int(table.starts[n_counted])
    stream = _build.stream_of(like)
    _build.launch("fused_adam", f"gaviko_fused_adam_sumsq_{dtype}", _SUMSQ_ARGTYPES,
                  table.words.data_ptr(), table.n, counted, table.partials.data_ptr(),
                  min(counted, SUM_BLOCKS), table.total.data_ptr(), stream)
    norm_reduce(table.total)
    _build.launch("fused_adam", f"gaviko_fused_adam_apply_{dtype}", _APPLY_ARGTYPES,
                  table.words.data_ptr(), table.n, table.n_chunks, table.total.data_ptr(),
                  table.n_update, float(clip), float(np.float32(B2)),
                  float(np.float32(1.0 - B2)), float(eps), stream)
    fused_adam.launches += 1


fused_adam.launches = 0  # B13 steps launched (one kernel, two, or a sharded step's two)
