"""PyTorch port: hash dropout, bit for bit against the JAX package.

Every dropout site of both packages draws its bits from the coordinate hash
of ``ops/hash_dropout.py``, so the port's masks must equal the JAX
package's exactly: ``keep_mask`` over shapes, seeds of both signs, salts and
offsets; ``apply_dropout``; ``layers.dropout`` with the seeds of JAX's
``RngStream``; the ViT MLP branch in training; and the local attention with
dropout, forward and backward, against JAX's ``local_reference`` and its VJP
(the JAX backward of ``flash_local_attention``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.config import make_spec as jax_make_spec
from gaviko_tpu.core import layers as jlayers
from gaviko_tpu.core import vit as jvit
from gaviko_tpu.ops import flash_attention as jfa
from gaviko_tpu.ops import hash_dropout as jhd
from gaviko_tpu_torch.config import make_spec
from gaviko_tpu_torch.core import layers as tlayers
from gaviko_tpu_torch.core import vit as tvit
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops import hash_dropout as thd
from gaviko_tpu_torch.weights.from_jax import from_jax

MASK_CASES = [
    # shape, seed, rate, salt, row_offset, col_offset
    ((7, 33), 123, 0.2, 0, 0, 0),
    ((3, 5, 17), -987654321, 0.1, 2, 5, 3),
    ((64, 64), 2 ** 31 - 1, 0.5, 7, 1000, 0),
    ((2, 1000, 1000), -(2 ** 31), 0.2, 0, 0, 0),
    ((16, 4096), 5, 0.9, 3, 123456, 77),
    ((9, 11), 0, 0.0, 0, 0, 0),
    ((9, 11), 42, 1.0 - 1e-9, 1, 0, 0),
]


@pytest.mark.parametrize("shape,seed,rate,salt,ro,co", MASK_CASES)
def test_keep_mask_is_bit_exact(shape, seed, rate, salt, ro, co):
    want = np.asarray(jhd.keep_mask(shape, jnp.int32(seed), rate, salt=salt,
                                    row_offset=ro, col_offset=co))
    got = thd.keep_mask(shape, seed, rate, salt=salt, row_offset=ro, col_offset=co)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_mask_takes_a_salt_per_plane():
    salt = np.arange(3, dtype=np.int32).reshape(3, 1, 1) * 5 - 4
    want = np.asarray(jhd.keep_mask((3, 20, 30), jnp.int32(-77), 0.3,
                                    salt=jnp.asarray(salt)))
    got = thd.keep_mask((3, 20, 30), -77, 0.3, salt=torch.from_numpy(salt))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate", [0.0, 0.2, 0.5])
def test_threshold_matches_jax(rate):
    assert thd._threshold(rate) == int(jhd._threshold(rate))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.2])
def test_apply_dropout_matches_jax(rate):
    x = np.random.RandomState(0).randn(40, 70).astype(np.float32)
    want = np.asarray(jhd.apply_dropout(jnp.asarray(x), jnp.int32(-31), rate,
                                        salt=3, row_offset=8))
    got = thd.apply_dropout(torch.from_numpy(x), -31, rate, salt=3, row_offset=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)


def _jax_seeds(n, key=0):
    rs = jlayers.RngStream(jax.random.PRNGKey(key))
    return [int(rs.next_seed()) for _ in range(n)]


@pytest.mark.parametrize("shape", [(2, 13, 24), (50, 7), (2, 3, 4, 5)])
def test_layers_dropout_matches_jax(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    rs = jlayers.RngStream(jax.random.PRNGKey(3))
    want = [np.asarray(jlayers.dropout(jnp.asarray(x), 0.2, True, rs)) for _ in range(2)]
    seeds = tlayers.SeedStream(_jax_seeds(2, key=3))
    got = [tlayers.dropout(torch.from_numpy(x), 0.2, True, seeds).numpy() for _ in range(2)]
    assert seeds.count == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g == 0, w == 0)


def test_layers_dropout_consumes_no_seed_when_off():
    seeds = tlayers.SeedStream([1, 2])
    x = torch.ones(4, 5)
    assert tlayers.dropout(x, 0.2, False, seeds) is x
    assert tlayers.dropout(x, 0.0, True, seeds) is x
    assert seeds.count == 0
    tlayers.dropout(x, 0.2, True, seeds)
    assert seeds.count == 1


def test_seed_stream_sources():
    with pytest.raises(ValueError, match="not both"):
        tlayers.SeedStream()
    s = tlayers.SeedStream([5])
    assert s.next_seed() == 5
    with pytest.raises(ValueError, match="no seed"):
        s.next_seed()
    g1 = tlayers.SeedStream(generator=torch.Generator().manual_seed(0))
    g2 = tlayers.SeedStream(generator=torch.Generator().manual_seed(0))
    a = [g1.next_seed() for _ in range(4)]
    assert a == [g2.next_seed() for _ in range(4)]
    assert all(-(2 ** 31) <= x < 2 ** 31 for x in a) and len(set(a)) == 4


def test_feedforward_block_training_dropout_matches_jax():
    cfg = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-t16",
               method="fft", dropout=0.1)
    jspec, tspec = jax_make_spec(cfg), make_spec(cfg)
    rng = np.random.RandomState(4)
    dim, mlp = jspec.dim, jspec.mlp_dim
    p = {"m.net.0.weight": 1 + 0.1 * rng.randn(dim), "m.net.0.bias": 0.1 * rng.randn(dim),
         "m.net.1.weight": rng.randn(mlp, dim) * dim ** -0.5, "m.net.1.bias": rng.randn(mlp) * 0.1,
         "m.net.4.weight": rng.randn(dim, mlp) * mlp ** -0.5, "m.net.4.bias": rng.randn(dim) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(2, 9, dim).astype(np.float32)
    want = jvit.feedforward_block(p, "m", jnp.asarray(x), jspec, train=True,
                                  rngs=jlayers.RngStream(jax.random.PRNGKey(5)))
    seeds = tlayers.SeedStream(_jax_seeds(2, key=5))
    got = tvit.feedforward_block(from_jax(p), "m", torch.from_numpy(x), tspec,
                                 train=True, seeds=seeds)
    assert seeds.count == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# The last case is a latent wider than kernels C and D took before ROADMAP
# Queue C item 8 was repaired.
LOCAL_CASES = [((4, 4, 4), (6, 6, 6), 20), ((2, 3, 5), (2, 2, 3), 8), ((4, 4, 4), (6, 6, 6), 40)]


def _local_inputs(DHW, dl, B=2, seed=6):
    rng = np.random.RandomState(seed)
    n = int(np.prod(DHW))
    return [rng.randn(B, n, dl).astype(np.float32) * 3.0 for _ in range(3)]


@pytest.mark.parametrize("DHW,local_k,dl", LOCAL_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_local_attention_with_dropout_matches_jax(DHW, local_k, dl, rate):
    """Forward and VJP of the port's local attention (plain versions of
    kernels C and D on the CPU) against JAX's local_reference, atol 1e-5."""
    q, k, v = _local_inputs(DHW, dl)
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    scale, seed = 384 ** -0.5, -12345
    jseed = jnp.asarray([seed], jnp.int32)
    want, vjp = jax.vjp(
        lambda a, b, c: jfa.local_reference(a, b, c, jseed, scale, DHW, local_k, rate),
        *(jnp.asarray(t) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    got = tfa.flash_local_attention(tq, tk, tv, scale, DHW, local_k, rate, seed)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5)


def test_local_attention_dropout_matches_jax_kernel():
    """The plain version against the JAX Pallas kernel (interpret mode)
    with dropout on: the same elements are dropped."""
    DHW, local_k, dl = (4, 4, 4), (3, 6, 6), 20
    q, k, v = _local_inputs(DHW, dl, seed=8)
    want = jfa.flash_local_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                     jnp.asarray([99], jnp.int32), 0.05, DHW,
                                     local_k, 0.2)
    got = tfa.local_reference(*(torch.from_numpy(t) for t in (q, k, v)), 0.05, DHW,
                              local_k, dropout_rate=0.2, seed=99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_local_lse_is_the_log_normaliser():
    DHW, local_k, dl = (2, 3, 5), (2, 2, 3), 8
    q, k, v = (torch.from_numpy(t) for t in _local_inputs(DHW, dl, seed=9))
    out, lse = tfa.local_reference(q, k, v, 0.1, DHW, local_k, with_lse=True)
    s = tfa._local_scores(q, k, 0.1, DHW, local_k)
    torch.testing.assert_close(torch.exp(s - lse[..., None]).sum(-1),
                               torch.ones_like(lse), rtol=0, atol=1e-6)
    torch.testing.assert_close(out, tfa.local_reference(q, k, v, 0.1, DHW, local_k))
