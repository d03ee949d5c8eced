"""Training augmentation on the card: affine + flip + rescale of raw volumes.

Port of ``gaviko_tpu/ops/augment.py`` (``train.device_augment: true``). The
reference runs torchio augmentations in DataLoader workers
(src/train.py:38-54); here the loader hands the step RAW volumes and each
train step augments its batch on the device before the forward:

- per-sample rotation (+-15 deg per axis) and scale ([0.9, 1.1]) about the
  volume centre with probability 0.5, zero fill outside the volume;
- the D-axis flip with probability 0.5 (tio.RandomFlip(axes=0));
- the per-volume min-max rescale to [0, 1].

JAX's version is XLA einsums and gathers, not a Pallas kernel; so is this
one (``torch.einsum`` and ``torch.gather``). Two warps, as in JAX:
``method="shear"`` factors the affine map into 3 scale passes and 9 Paeth
shears, each a 1-D linear resample along one axis written as an einsum of
the volume with a 2-banded tent tensor; ``method="gather"`` is the direct
trilinear pull-back (``map_coordinates(order=1, mode="constant")``).

Drawing is apart from applying. :func:`draw_augment_params` draws each
sample's 3 angles (radians), 3 scales and the apply and flip flags on a CPU
``torch.Generator``; :func:`train_augment` applies them. So a test can feed
the port the JAX package's own draws, and the warp's small matrices and
shear factors are computed on the CPU whatever the batch's device: the card
and the CPU then start every pass from the same numbers. The warps run in
float32 with TF32 off, whatever the step's compute dtype; the cast to it
comes after the rescale (the step's ``_forward``).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import NamedTuple

import torch


class AugmentParams(NamedTuple):
    """One batch's draws, on the CPU: ``angles`` (B, 3) radians about the
    (D, H, W) axes as ``rotation_matrix`` takes them, ``scales`` (B, 3),
    ``apply`` (B,) bool (warp this sample), ``flip`` (B,) bool."""
    angles: torch.Tensor
    scales: torch.Tensor
    apply: torch.Tensor
    flip: torch.Tensor


def draw_augment_params(gen: torch.Generator, batch: int, degrees: float = 15.0,
                        scales: float = 0.1, p_affine: float = 0.5,
                        p_flip: float = 0.5) -> AugmentParams:
    """Each sample's draws from ``gen`` (a CPU generator): angles uniform in
    +-``degrees``, scales in [1 - ``scales``, 1 + ``scales``], the warp with
    probability ``p_affine`` and the flip with ``p_flip``."""
    u = torch.rand(batch, 8, generator=gen, dtype=torch.float32)
    angles = torch.deg2rad(-degrees + 2.0 * degrees * u[:, 1:4])
    return AugmentParams(angles=angles, scales=(1.0 - scales) + 2.0 * scales * u[:, 4:7],
                         apply=u[:, 0] < p_affine, flip=u[:, 7] < p_flip)


def rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) angles -> (..., 3, 3) ``rx @ ry @ rz`` in float32; ``ry``
    carries +sin at [0, 2] (JAX ``_rotation_matrix``)."""
    a = angles.float()
    cd, ch, cw = torch.cos(a).unbind(-1)
    sd, sh, sw = torch.sin(a).unbind(-1)
    one, zero = torch.ones_like(cd), torch.zeros_like(cd)
    rx = torch.stack([one, zero, zero, zero, cd, -sd, zero, sd, cd], -1)
    ry = torch.stack([ch, zero, sh, zero, one, zero, -sh, zero, ch], -1)
    rz = torch.stack([cw, -sw, zero, sw, cw, zero, zero, zero, one], -1)
    shape = a.shape[:-1] + (3, 3)
    return rx.reshape(shape) @ ry.reshape(shape) @ rz.reshape(shape)


@contextlib.contextmanager
def _f32_products():
    """The warps' einsums in full float32: TF32 off for their duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _centers(shape) -> torch.Tensor:
    return (torch.tensor(shape, dtype=torch.float32) - 1.0) / 2.0


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small CPU tensor on ``device``. To a card it goes through pinned
    memory without blocking: a plain copy from pageable memory would wait for
    every launch queued before it, a stall at each pass."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# The gather warp: trilinear pull-back about the centre
# ---------------------------------------------------------------------------

def affine_gather(vols: torch.Tensor, angles: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """vols (n, C, D, H, W) float32, angles and scales (n, 3) on the CPU ->
    each volume sampled at ``inv(R * s) @ (x - c) + c`` with
    ``map_coordinates(order=1, mode="constant", cval=0)`` semantics: the 8
    corners of each point, a corner outside the volume contributing 0 (JAX
    ``_affine_one``)."""
    n, C, D, H, W = vols.shape
    dev = vols.device
    inv = torch.linalg.inv(rotation_matrix(angles) * scales.float()[:, None, :])
    centers = _centers((D, H, W))
    axes = [(torch.arange(s, dtype=torch.float32, device=dev) - c).reshape(
        [-1 if i == k else 1 for i in range(3)]) for k, (s, c) in enumerate(
            zip((D, H, W), centers.tolist()))]
    inv_d = _on(inv, dev)
    src = []  # per axis: (n, D, H, W) source coordinate
    for i in range(3):
        m = [inv_d[:, i, j].reshape(n, 1, 1, 1) for j in range(3)]
        src.append(m[0] * axes[0] + m[1] * axes[1] + m[2] * axes[2] + centers[i].item())
    nodes = []  # per axis: [(index, weight)] of the lower and the upper corner
    for coord, size in zip(src, (D, H, W)):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        nodes.append([(index + k, w) for k, w in ((0, 1.0 - upper_w), (1, upper_w))])
    flat = vols.reshape(n, C, D * H * W)
    out = None
    for (i_d, w_d), (i_h, w_h), (i_w, w_w) in itertools.product(*nodes):
        valid = ((i_d >= 0) & (i_d < D) & (i_h >= 0) & (i_h < H)
                 & (i_w >= 0) & (i_w < W))
        lin = ((i_d.clamp(0, D - 1) * H + i_h.clamp(0, H - 1)) * W
               + i_w.clamp(0, W - 1)).reshape(n, 1, -1).expand(n, C, -1)
        got = torch.gather(flat, 2, lin).reshape(n, C, D, H, W)
        term = (w_d * w_h * w_w)[:, None] * torch.where(valid[:, None], got,
                                                        torch.zeros((), device=dev))
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# The shear-factored warp (JAX's fast path)
# ---------------------------------------------------------------------------
#
#   pull-back map  M = diag(1/s) . Rz(-g) . Ry(-b) . Rx(-a)
#   each axis rotation R(theta) = Shear1(-tan(theta/2)) . Shear2(sin theta)
#                                 . Shear1(-tan(theta/2))     (Paeth)
#   each shear / scale = a 1-D linear resample along ONE axis whose source
#   coordinate is affine in the output coordinate (+ one orthogonal one).
#
# 12 passes a volume, each an einsum against a 2-banded (U, N_out, N_in)
# tent tensor; tent rows vanish outside [0, N-1] (mode="constant").

_LETTERS = "dhw"


def tent_weights(size: int, a: torch.Tensor, b_per_u: torch.Tensor) -> torch.Tensor:
    """(n, U, N_out, N_in) linear-interpolation weights for ``src = a *
    w_out + b[u]``: a (n,), b_per_u (n, U), on the volume's device."""
    w = torch.arange(size, dtype=torch.float32, device=b_per_u.device)
    src = a[:, None, None] * w[None, None, :] + b_per_u[:, :, None]      # (n, U, No)
    return (1.0 - (src[..., None] - w).abs()).clamp(0.0, 1.0)


def resample_axis(vols: torch.Tensor, axis: int, u_axis: int, a: torch.Tensor,
                  b_per_u: torch.Tensor) -> torch.Tensor:
    """Resample spatial ``axis`` (0, 1, 2 of (D, H, W)) of vols (n, C, D, H, W):
    ``src = a * x_axis + b(x_{u_axis})``; the renamed axis stays in place."""
    T = tent_weights(vols.shape[2 + axis], a, b_per_u)
    x = _LETTERS[axis]
    spec = f"nc{_LETTERS},n{_LETTERS[u_axis]}{x.upper()}{x}->nc{_LETTERS.replace(x, x.upper())}"
    return torch.einsum(spec, vols, T)


def shear_pass(vols, axis: int, u_axis: int, alpha: torch.Tensor, centers):
    """``src_axis = x_axis + alpha * (x_u - c_u)``: the axis centre stays."""
    u = torch.arange(vols.shape[2 + u_axis], dtype=torch.float32) - centers[u_axis]
    b = _on(alpha[:, None] * u[None, :], vols.device)
    return resample_axis(vols, axis, u_axis, _on(torch.ones_like(alpha), vols.device), b)


def rot_passes(vols, plane, theta: torch.Tensor, centers):
    """Rotation by theta (n,) in the (i, j) ``plane`` as three shears (2-D
    Paeth: ``Sx(-tan(t/2)) Sy(sin t) Sx(-tan(t/2))``, the first-applied pass
    the leftmost factor of the source map)."""
    i, j = plane
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    vols = shear_pass(vols, i, j, a, centers)
    vols = shear_pass(vols, j, i, b, centers)
    return shear_pass(vols, i, j, a, centers)


def affine_shear(vols: torch.Tensor, angles: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """The shear-factored equivalent of :func:`affine_gather` (JAX
    ``_affine_shear_one``): 3 scale passes, then the transposed rotation
    factors of ``inv(R)`` in composition order."""
    n, C, D, H, W = vols.shape
    centers = _centers((D, H, W))
    angles, scales = angles.float(), scales.float()
    for ax in range(3):
        # src = c + (x - c) / s
        a = 1.0 / scales[:, ax]
        b0 = centers[ax] * (1.0 - a)
        u = (ax + 1) % 3
        vols = resample_axis(vols, ax, u, _on(a, vols.device),
                             _on(b0[:, None].expand(n, vols.shape[2 + u]).contiguous(),
                                 vols.device))
    # Rz^T in the (d, h) plane, Ry^T in (d, w), Rx^T in (h, w). rotation_matrix's
    # ry carries +sin at [0, 2] (the other handedness of rx and rz), so its
    # inverse is +angle while rz and rx invert with -angle.
    vols = rot_passes(vols, (0, 1), -angles[:, 2], centers)
    vols = rot_passes(vols, (0, 2), angles[:, 1], centers)
    return rot_passes(vols, (1, 2), -angles[:, 0], centers)


# ---------------------------------------------------------------------------
# Flip, rescale, the batch entry points
# ---------------------------------------------------------------------------

def flip(vols: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    """Flip the D axis of vols (B, C, D, H, W) where ``which`` (B,) is set."""
    rows = torch.nonzero(which).flatten()
    if not len(rows):
        return vols
    rows = _on(rows, vols.device)
    out = vols.clone()
    out[rows] = vols[rows].flip(2)
    return out


def rescale_minmax(vols: torch.Tensor) -> torch.Tensor:
    """Per-volume min-max rescale of (B, ...) float32 to [0, 1]; a constant
    volume becomes 0 (JAX ``rescale_minmax``)."""
    dims = tuple(range(1, vols.ndim))
    lo = vols.amin(dim=dims, keepdim=True)
    hi = vols.amax(dim=dims, keepdim=True)
    return torch.where(hi > lo, (vols - lo) / (hi - lo).clamp_min(1e-30),
                       torch.zeros((), device=vols.device))


def train_augment(batch: torch.Tensor, params: AugmentParams,
                  method: str = "shear") -> torch.Tensor:
    """batch (B, C, D, H, W) raw volumes -> warped where ``params.apply``,
    flipped where ``params.flip``, each rescaled to [0, 1], in the batch's
    dtype. ``method``: "shear" (banded-matmul passes) or "gather" (the
    direct trilinear pull-back, the reference's semantics)."""
    if method not in ("shear", "gather"):
        raise ValueError(f"Unknown augment method: {method!r} (shear | gather)")
    vols = batch.float()
    rows = torch.nonzero(params.apply).flatten()
    if len(rows):
        warp = affine_shear if method == "shear" else affine_gather
        on_dev = _on(rows, vols.device)
        with _f32_products():
            warped = warp(vols[on_dev], params.angles[rows], params.scales[rows])
        vols = vols.clone()
        vols[on_dev] = warped
    return rescale_minmax(flip(vols, params.flip)).to(batch.dtype)


def eval_rescale(batch: torch.Tensor) -> torch.Tensor:
    """The eval and predict path: per-volume min-max rescale on the device."""
    return rescale_minmax(batch.float()).to(batch.dtype)

