"""Host-side volume transforms mirroring the reference's torchio pipeline.

Port of ``gaviko_tpu/data/transforms.py``. Reference transform stacks
(src/train.py:38-62):

- train: RandomAffine(degrees=15, p=.5) + RandomFlip(axes=0, p=.5), then
  RescaleIntensity((0, 1));
- val / test / inference: RescaleIntensity((0, 1)) only (deterministic).

torchio RandomAffine(degrees=15) keeps its default scales=0.1 (random
scaling in [0.9, 1.1]), reproduced. The augmentations draw from a numpy
``RandomState`` in the JAX package's order, so the same per-sample state
gives the same volume in both packages. The rescale is the arithmetic of
the JAX package's C++ loader core (``(x - lo) * scale + out_min``, ``scale``
a float32) in numpy, so the two agree to the bit. They run on host numpy in
the loader's workers.

With ``train.device_augment`` the loader hands the step raw volumes
(:func:`raw_volume`) and the augmentation runs on the card
(``ops/augment.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def rescale_intensity(x: np.ndarray, out_min: float = 0.0, out_max: float = 1.0) -> np.ndarray:
    """Min-max rescale to [out_min, out_max] (torchio RescaleIntensity); a
    constant volume becomes ``out_min``. Rounds as the JAX package's C++
    core does: one float32 ``scale``, then a subtract, a multiply and an
    add, each rounded to float32."""
    x = np.asarray(x, dtype=np.float32)
    lo, hi = x.min(), x.max()
    if hi == lo:
        return np.full_like(x, out_min)
    out = x - lo
    out *= np.float32((out_max - out_min) / (float(hi) - float(lo)))
    out += np.float32(out_min)
    return out


def raw_volume(x: np.ndarray, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """The identity transform of ``train.device_augment`` (train and eval):
    the raw float32 volume, augmented and rescaled on the card. A module-level
    function, so that the loader's process workers can pickle it."""
    return np.ascontiguousarray(x, dtype=np.float32)


def random_flip(x: np.ndarray, rng: np.random.RandomState, p: float = 0.5) -> np.ndarray:
    """Flip along spatial axis 0 (D) with probability p (tio.RandomFlip(axes=0))."""
    if rng.rand() < p:
        return x[:, ::-1].copy()
    return x


def _rotation_matrix(rng: np.random.RandomState, degrees: float) -> np.ndarray:
    angles = np.deg2rad(rng.uniform(-degrees, degrees, size=3))
    cd, ch, cw = np.cos(angles)
    sd, sh, sw = np.sin(angles)
    rx = np.array([[1, 0, 0], [0, cd, -sd], [0, sd, cd]])
    ry = np.array([[ch, 0, sh], [0, 1, 0], [-sh, 0, ch]])
    rz = np.array([[cw, -sw, 0], [sw, cw, 0], [0, 0, 1]])
    return rx @ ry @ rz


def random_affine(x: np.ndarray, rng: np.random.RandomState, degrees: float = 15.0,
                  scales: float = 0.1, p: float = 0.5) -> np.ndarray:
    """Random rotation (+-degrees per axis) and scale ([1-s, 1+s]) about the
    volume center, linear interpolation, zero padding. x: (C, D, H, W)."""
    if rng.rand() >= p:
        return x
    from scipy import ndimage

    rot = _rotation_matrix(rng, degrees)
    scale = rng.uniform(1.0 - scales, 1.0 + scales, size=3)
    mat = rot * scale[None, :]
    center = (np.asarray(x.shape[1:]) - 1) / 2.0
    # Pull-back map: out coord -> in coord around the center.
    inv = np.linalg.inv(mat)
    offset = center - inv @ center
    out = np.empty_like(x)
    for c in range(x.shape[0]):
        out[c] = ndimage.affine_transform(x[c], inv, offset=offset, order=1,
                                          mode="constant", cval=0.0)
    return out


def random_noise(x: np.ndarray, rng: np.random.RandomState,
                 std_range=(0.0, 0.25), p: float = 0.25) -> np.ndarray:
    """Additive gaussian noise (tio.RandomNoise analog; the reference defines
    its intensity augs but leaves them commented out, train.py:43-48)."""
    if rng.rand() >= p:
        return x
    std = rng.uniform(*std_range) * float(x.std())
    return x + rng.normal(0.0, max(std, 1e-8), size=x.shape).astype(x.dtype)


def random_blur(x: np.ndarray, rng: np.random.RandomState,
                std_range=(0.0, 1.5), p: float = 0.25) -> np.ndarray:
    """Gaussian blur (tio.RandomBlur analog, off by default like the
    reference's commented-out intensity stack)."""
    if rng.rand() >= p:
        return x
    from scipy import ndimage

    sigma = rng.uniform(*std_range, size=3)
    out = np.empty_like(x)
    for c in range(x.shape[0]):
        out[c] = ndimage.gaussian_filter(x[c], sigma=sigma)
    return out


def train_transform(x: np.ndarray, rng: np.random.RandomState,
                    intensity_augs: bool = False) -> np.ndarray:
    x = random_affine(x, rng)
    x = random_flip(x, rng)
    if intensity_augs:  # off by default, mirroring train.py:50-54
        x = random_noise(x, rng)
        x = random_blur(x, rng)
    return rescale_intensity(x)


def eval_transform(x: np.ndarray) -> np.ndarray:
    return rescale_intensity(x)
