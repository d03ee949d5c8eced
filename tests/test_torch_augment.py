"""PyTorch port: on-device augmentation (``ops/augment.py``) against the JAX
package's on the CPU.

Every function of ``gaviko_tpu/ops/augment.py`` against its port on small
volumes, the port fed JAX's own draws (``keys = split(rng, 2B)``;
``split(keys[b], 3)`` -> apply / rotation / scale; ``keys[B + b]`` ->
flip): the rotation matrix and the tent weights within 1e-6, each resample
pass and both warps within 1e-5, the flip, ``rescale_minmax`` and
``eval_rescale`` exact, ``train_augment`` of both methods within 1e-5, and
the identity and flip-only cases exact, as ``tests/test_device_augment.py``
checks JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.ops import augment as jaug
from gaviko_tpu_torch.ops import augment as taug

SHAPES = [(2, 1, 6, 8, 10), (3, 2, 5, 7, 9)]
# JAX's functions jitted, as its train step runs them.
J_TRAIN_AUGMENT = jax.jit(jaug.train_augment, static_argnames=("method", "p_affine", "p_flip"))
J_WARP = {"shear": jax.jit(jax.vmap(jaug._affine_shear_one, (0, 0, None, None, None)),
                           static_argnums=(2, 3, 4)),
          "gather": jax.jit(jax.vmap(jaug._affine_one, (0, 0, None, None, None)),
                            static_argnums=(2, 3, 4))}
J_EVAL_RESCALE = jax.jit(jaug.eval_rescale)


def _vols(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) * 90 - 20


def jax_draws(rng, batch, degrees=15.0, scales=0.1, p_affine=0.5, p_flip=0.5):
    """JAX ``train_augment``'s draws of each sample, as the port's params."""
    keys = jax.random.split(rng, 2 * batch)
    angles, scale, apply, flip = [], [], [], []
    for b in range(batch):
        k_apply, k_rot, k_scale = jax.random.split(keys[b], 3)
        angles.append(np.asarray(jnp.deg2rad(jax.random.uniform(
            k_rot, (3,), minval=-degrees, maxval=degrees))))
        scale.append(np.asarray(jax.random.uniform(
            k_scale, (3,), minval=1.0 - scales, maxval=1.0 + scales)))
        apply.append(bool(jax.random.uniform(k_apply) < p_affine))
        flip.append(bool(jax.random.uniform(keys[batch + b]) < p_flip))
    return taug.AugmentParams(angles=torch.from_numpy(np.stack(angles)),
                              scales=torch.from_numpy(np.stack(scale)),
                              apply=torch.tensor(apply), flip=torch.tensor(flip))


def test_rotation_matrix_matches_jax():
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jaug._rotation_matrix(key, 15.0))
        angles = jnp.deg2rad(jax.random.uniform(key, (3,), minval=-15.0, maxval=15.0))
        got = taug.rotation_matrix(torch.from_numpy(np.array(angles))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_tent_weights_match_jax():
    a, b = np.float32(0.93), np.linspace(-2.5, 3.0, 7).astype(np.float32)
    want = np.asarray(jaug._tent_weights(9, a, jnp.asarray(b)))
    got = taug.tent_weights(9, torch.tensor([a]), torch.from_numpy(b)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("axis,u_axis", [(0, 1), (1, 2), (2, 0)])
def test_resample_and_shear_passes_match_jax(axis, u_axis):
    vol = _vols((6, 8, 10), 1)
    centers = (np.asarray(vol.shape, np.float32) - 1) / 2
    n_u = vol.shape[u_axis]
    a, b = np.float32(1.07), np.linspace(-1.3, 2.2, n_u).astype(np.float32)
    want = np.asarray(jaug._resample_axis(jnp.asarray(vol), axis, u_axis, a, jnp.asarray(b)))
    got = taug.resample_axis(torch.from_numpy(vol)[None, None], axis, u_axis,
                             torch.tensor([a]), torch.from_numpy(b)[None])[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    alpha = np.float32(-0.21)
    want = np.asarray(jaug._shear_pass(jnp.asarray(vol), axis, u_axis, alpha,
                                       jnp.asarray(centers)))
    got = taug.shear_pass(torch.from_numpy(vol)[None, None], axis, u_axis,
                          torch.tensor([alpha]), torch.from_numpy(centers))[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want = np.asarray(jaug._rot_passes(jnp.asarray(vol), (min(axis, u_axis), max(axis, u_axis)),
                                       jnp.float32(0.2), jnp.asarray(centers)))
    got = taug.rot_passes(torch.from_numpy(vol)[None, None], (min(axis, u_axis),
                          max(axis, u_axis)), torch.tensor([0.2]),
                          torch.from_numpy(centers))[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["shear", "gather"])
@pytest.mark.parametrize("shape", SHAPES)
def test_warps_match_jax_with_its_draws(method, shape):
    """Each sample warped (p = 1) by JAX's ``_affine_shear_one`` /
    ``_affine_one`` and by the port with the same draws."""
    x = _vols(shape, 2)
    tfn = taug.affine_shear if method == "shear" else taug.affine_gather
    rng = jax.random.PRNGKey(11)
    params = jax_draws(rng, shape[0], p_affine=1.0)
    keys = jax.random.split(rng, 2 * shape[0])[:shape[0]]
    got = tfn(torch.from_numpy(x), params.angles, params.scales).numpy()
    want = np.asarray(J_WARP[method](jnp.asarray(x), keys, 15.0, 0.1, 1.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("method", ["shear", "gather"])
@pytest.mark.parametrize("seed", [0, 3])
def test_train_augment_matches_jax(method, seed):
    x = _vols((4, 1, 6, 8, 10), seed)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(J_TRAIN_AUGMENT(jnp.asarray(x), rng, method=method))
    params = jax_draws(rng, 4)
    got = taug.train_augment(torch.from_numpy(x), params, method=method)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert params.apply.any() or params.flip.any()


def test_identity_flip_and_rescale_are_exact():
    x = _vols((3, 1, 6, 8, 8), 4)
    x[1] = 7.0  # a constant volume rescales to 0
    want = np.asarray(J_EVAL_RESCALE(jnp.asarray(x)))
    np.testing.assert_array_equal(taug.eval_rescale(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(taug.rescale_minmax(torch.from_numpy(x)).numpy(),
                                  np.stack([np.asarray(jaug.rescale_minmax(jnp.asarray(v)))
                                            for v in x]))
    for p_flip in (0.0, 1.0):
        rng = jax.random.PRNGKey(5)
        want = np.asarray(J_TRAIN_AUGMENT(jnp.asarray(x), rng, p_affine=0.0, p_flip=p_flip))
        params = jax_draws(rng, 3, p_affine=0.0, p_flip=p_flip)
        got = taug.train_augment(torch.from_numpy(x), params).numpy()
        np.testing.assert_array_equal(got, want)
    flipped = taug.flip(torch.from_numpy(x), torch.tensor([True, False, True])).numpy()
    np.testing.assert_array_equal(flipped[0], x[0, :, ::-1])
    np.testing.assert_array_equal(flipped[1], x[1])


def test_draws_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    p = taug.draw_augment_params(gen, 64)
    assert p.angles.shape == p.scales.shape == (64, 3)
    assert float(p.angles.abs().max()) <= np.deg2rad(15.0) + 1e-6
    assert 0.9 <= float(p.scales.min()) and float(p.scales.max()) <= 1.1
    assert 10 < int(p.apply.sum()) < 54 and 10 < int(p.flip.sum()) < 54
    again = taug.draw_augment_params(torch.Generator().manual_seed(0), 64)
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    x = torch.from_numpy(_vols((2, 1, 6, 8, 8))).bfloat16()
    out = taug.train_augment(x, taug.draw_augment_params(gen, 2, p_affine=1.0))
    assert out.dtype == torch.bfloat16 and float(out.min()) >= 0 and float(out.max()) <= 1
    with pytest.raises(ValueError, match="shear | gather"):
        taug.train_augment(x, p, method="nearest")
