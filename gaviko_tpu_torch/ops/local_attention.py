"""3D-neighbourhood local attention for GAViKO's local stream.

Port of ``gaviko_tpu/ops/local_attention.py``. Query token p at grid cell
(d, h, w) may attend key q at (d2, h2, w2) iff, per axis with window k,

    (q_coord - p_coord) in [-(k // 2), k - 1 - k // 2]

(asymmetric for even k, e.g. k=6 gives [-3, +2]). ``local_mask_additive`` is
that predicate as an (N, N) additive mask for the plain version; the kernel
evaluates it per key instead.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def local_mask_additive_np(DHW: Tuple[int, int, int],
                           local_k: Tuple[int, int, int]) -> np.ndarray:
    """(N, N) float32 additive mask: 0 where attendable, -inf elsewhere."""
    D, H, W = DHW
    coords = np.stack(
        np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    delta = coords[None, :, :] - coords[:, None, :]  # [N, N, 3] = q - p
    ks = np.asarray(local_k)
    lo = -(ks // 2)
    hi = ks - 1 - ks // 2
    allowed = np.all((delta >= lo) & (delta <= hi), axis=-1)
    return np.where(allowed, 0.0, -np.inf).astype(np.float32)


def local_mask_additive(DHW: Tuple[int, int, int], local_k: Tuple[int, int, int],
                        device="cpu") -> torch.Tensor:
    mask = local_mask_additive_np(tuple(int(x) for x in DHW),
                                  tuple(int(x) for x in local_k))
    return torch.from_numpy(mask.copy()).to(device)


def masked_local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           scale: float, DHW: Tuple[int, int, int],
                           local_k: Tuple[int, int, int],
                           seed: Optional[int] = None,
                           dropout_rate: float = 0.0) -> torch.Tensor:
    """Single-head local attention over the [B, N, dl] latent stream, N ==
    prod(DHW), differentiable. ``scale`` is the caller's (GAViKO scales by
    the full model dim ** -0.5). Dropout on the probabilities (the
    reference's attn_drop) takes hash bits from the int32 ``seed``, so the
    kernel, its plain version and the JAX package drop the same elements.
    The kernels on CUDA, their plain versions on the CPU."""
    from gaviko_tpu_torch.ops.flash_attention import flash_local_attention

    return flash_local_attention(q, k, v, scale, DHW, local_k, dropout_rate, seed)
