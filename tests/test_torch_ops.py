"""PyTorch port: the plain versions of the ported kernels against the JAX
package's Pallas kernels (interpret mode on the CPU) and XLA references.

On a CPU tensor every kernel wrapper runs its plain version, so the wrappers
are checked here too; the kernels themselves are checked against the same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaviko_tpu.config import make_spec
from gaviko_tpu.ops import flash_attention as jfa
from gaviko_tpu.ops import local_attention as jla
from gaviko_tpu.ops import patchify as jpatch
from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops import attention as tattn
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops import local_attention as tla
from gaviko_tpu_torch.ops import patchify as tpatch

PATCH_SPEC = make_spec(dict(
    image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
    num_classes=5, channels=1, pool="cls", backbone="vit-t16", method="fft",
))


def _patch_inputs(dim=64, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(2, 1, 24, 32, 32).astype(np.float32)
    w = (rng.randn(dim, 1, 12, 16, 16) * 0.02).astype(np.float32)
    b = rng.randn(dim).astype(np.float32)
    pos = rng.randn(PATCH_SPEC.num_patches, dim).astype(np.float32)
    return img, w, b, pos


@pytest.mark.parametrize("jax_fn", ["patchify_pallas", "_patchify_reference"])
def test_patchify_reference_matches_jax(jax_fn):
    img, w, b, pos = _patch_inputs()
    want = getattr(jpatch, jax_fn)(jnp.asarray(img), jnp.asarray(w), jnp.asarray(b),
                                   jnp.asarray(pos), PATCH_SPEC)
    got = tpatch.patchify_reference(*(torch.from_numpy(a) for a in (img, w, b, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_patchify_wrapper_on_cpu_is_the_plain_version():
    img, w, b, pos = (torch.from_numpy(a) for a in _patch_inputs(seed=1))
    before = tpatch.patchify_fused.launches
    for p in (pos, None):
        torch.testing.assert_close(tpatch.patchify_fused(img, w, b, p),
                                   tpatch.patchify_reference(img, w, b, p),
                                   rtol=0, atol=0)
    assert tpatch.patchify_fused.launches == before  # no kernel ran


def test_patchify_rejects_indivisible_volume():
    img, w, b, _ = (torch.from_numpy(a) for a in _patch_inputs())
    with pytest.raises(ValueError, match="not divisible"):
        tpatch.patchify_reference(img[:, :, :20], w, b)


def _qkv(B=2, H=4, D=64, n_pad=48, seed=0):
    return np.random.RandomState(seed).randn(B, n_pad, 3 * H * D).astype(np.float32)


def test_mhsa_reference_matches_jax_fused_mhsa():
    B, H, D, n_pad, n_true = 2, 4, 64, 48, 41
    qkv = _qkv(B, H, D, n_pad)
    want = jfa.fused_mhsa(jnp.asarray(qkv), jnp.zeros((1,), jnp.int32), H, D,
                          D ** -0.5, n_true)
    got = tfa.mhsa_reference(torch.from_numpy(qkv), H, D, D ** -0.5, n_true)
    np.testing.assert_allclose(got.numpy()[:, :n_true], np.asarray(want)[:, :n_true],
                               atol=2e-5)


def test_self_attention_dispatch_on_cpu():
    """Odd heads fail the fused gate: as in the JAX package the rows are
    sliced to n_true, attention runs on [B, H, n_true, D] (the flash
    attention kernel's plain version on the CPU) and the output is padded
    back with zero rows. fused_mhsa on the CPU is its plain version."""
    B, H, D, n_pad, n_true = 2, 3, 64, 40, 37  # odd heads: the kernel's gate refuses
    qkv = torch.from_numpy(_qkv(B, H, D, n_pad, seed=1))
    assert not tfa.fused_mhsa_supported(H, D, n_pad)
    q, k, v = (t[:, :, :n_true] for t in tfa._split_heads(qkv, H, D))
    rows = tfa.flash_attention_reference(q, k, v, 0.125).transpose(1, 2)
    got = tattn.self_attention(qkv, H, D, 0.125, n_true)
    torch.testing.assert_close(got[:, :n_true], rows.reshape(B, n_true, H * D),
                               rtol=0, atol=0)
    assert torch.all(got[:, n_true:] == 0)
    want = tfa.mhsa_reference(qkv, H, D, 0.125, n_true)
    torch.testing.assert_close(got[:, :n_true], want[:, :n_true], rtol=0, atol=1e-6)
    torch.testing.assert_close(tfa.fused_mhsa(qkv, H, D, 0.125, n_true), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("heads,dim_head,n,ok", [
    (16, 64, 1040, True), (6, 64, 1040, True), (3, 64, 1040, False),
    (4, 32, 64, False), (4, 64, 4096, False), (12, 128, 1008, True),
])
def test_fused_mhsa_supported(heads, dim_head, n, ok):
    """The port's gate is the JAX package's, head dim 128 included."""
    assert tfa.fused_mhsa_supported(heads, dim_head, n) is ok
    assert jfa.fused_mhsa_supported(heads, dim_head, n) is ok


# dl 48: a latent wider than kernels C and D took before ROADMAP Queue C
# item 8 was repaired (the JAX kernel has no width gate).
@pytest.mark.parametrize("local_k,dl", [
    pytest.param((6, 6, 6), 20, id="local_k0"), pytest.param((3, 6, 6), 20, id="local_k1"),
    pytest.param((6, 6, 6), 48, id="dl48"),
])
def test_local_reference_matches_jax_flash_local(local_k, dl):
    B, DHW = 2, (4, 4, 4)
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(B, 64, dl).astype(np.float32) * 3.0 for _ in range(3))
    scale = 384 ** -0.5
    want = jfa.flash_local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.zeros((1,), jnp.int32), scale, DHW, local_k)
    got = tfa.local_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale, DHW, local_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_masked_local_attention_takes_strided_views():
    B, DHW, dl = 2, (4, 4, 4), 20
    qkv = torch.from_numpy(np.random.RandomState(3).randn(B, 64, 3 * dl).astype(np.float32))
    q, k, v = qkv.chunk(3, dim=-1)
    got = tla.masked_local_attention(q, k, v, scale=0.05, DHW=DHW, local_k=(6, 6, 6))
    want = tfa.local_reference(q.contiguous(), k.contiguous(), v.contiguous(), 0.05,
                               DHW, (6, 6, 6))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("DHW,local_k", [
    ((4, 4, 4), (6, 6, 6)), ((4, 4, 4), (3, 6, 6)), ((2, 3, 5), (2, 2, 3)),
    ((10, 10, 10), (6, 6, 6)),
])
def test_local_mask_matches_jax(DHW, local_k):
    np.testing.assert_array_equal(tla.local_mask_additive(DHW, local_k).numpy(),
                                  jla.local_mask_additive_np(DHW, local_k))


def test_dropout_is_not_ported():
    """Dropout is ported in every attention kernel: on the CPU the MHSA and
    local wrappers are their plain versions with the mask of the seed, and
    a rate without a seed, or outside [0, 1), is refused. (Named when MHSA
    dropout was still refused.)"""
    qkv = torch.randn(2, 8, 3 * 2 * 64, generator=torch.Generator().manual_seed(1))
    got = tfa.fused_mhsa(qkv, 2, 64, 0.125, 7, dropout_rate=0.3, seed=11)
    torch.testing.assert_close(got, tfa.mhsa_reference(qkv, 2, 64, 0.125, 7, 0.3, seed=11),
                               rtol=0, atol=0)
    assert not torch.equal(got, tfa.fused_mhsa(qkv, 2, 64, 0.125, 7))
    with pytest.raises(ValueError, match="seed"):
        tfa.mhsa_qkv_proj(torch.zeros(1, 8, 16), torch.zeros(3 * 2 * 64, 16), 2, 64,
                          0.125, 8, dropout_rate=0.1)
    with pytest.raises(ValueError, match="outside"):
        tfa.fused_mhsa(qkv, 2, 64, 0.125, 7, dropout_rate=1.0, seed=1)
    q = torch.randn(1, 8, 4, generator=torch.Generator().manual_seed(0))
    out = tfa.flash_local_attention(q, q, q, 1.0, (2, 2, 2), (2, 2, 2),
                                    dropout_rate=0.5, seed=3)
    torch.testing.assert_close(out, tfa.local_reference(
        q, q, q, 1.0, (2, 2, 2), (2, 2, 2), dropout_rate=0.5, seed=3), rtol=0, atol=0)
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_local_attention(q, q, q, 1.0, (2, 2, 2), (2, 2, 2), dropout_rate=0.1)


def test_no_kernel_for_other_devices():
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        _build.use_kernel(torch.empty(1, device="meta"))


def test_plain_versions_is_thread_local():
    import threading

    seen = {}

    def other():
        seen["other"] = getattr(_build._plain, "on", False)

    with _build.plain_versions():
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert _build._plain.on
    assert not t.is_alive()
    assert seen["other"] is False
    assert not _build._plain.on
