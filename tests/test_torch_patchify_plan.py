"""PyTorch port: the plan of patchify (``csrc/patchify.cu``: a rows pass,
then one product on the port's Hopper GEMM) and its rows pass's plain
version, on the CPU.

- ``patchify_plan`` at GAViKO's and vit-b16's patch (12, 16, 16) of the
  120 x 160 x 160 volume, B8 and B4, bf16 and f32, and at a patch whose
  K is no whole number of 16-byte vectors ((3, 5, 7), three channels): the
  GEMM's tiles (the policy's and each compiled tile, ``ops/_blocks.py``)
  cover every output once within a CTA's shared memory, the patch matrix's width kp is K
  rounded up to whole 16-byte rows (TMA's strides), the rows pass moves 16
  bytes a thread where the patch and volume widths allow it, and the
  scratch holds the matrix unless ``save_rows`` returns it;
- the rows pass's plain version equals ``patch_rows`` with zero columns
  to kp, and the JAX package's gathered rows (``patchify_pallas(...,
  save_rows=True)`` in interpret mode, its stripe layout undone);
- on a faked card one call is one launch with the plan's kp, vector
  width and tile, the weight padded with zero columns to kp, and ``save_rows``
  returns the first K columns of the [B * N, kp] matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaviko_tpu.config import make_spec
from gaviko_tpu.ops import patchify as jpatch
from gaviko_tpu_torch.ops import _blocks, _build
from gaviko_tpu_torch.ops import patchify as tpatch
from gaviko_tpu_torch.ops.gemm_plan import (
    SMEM_LIMIT, _SCRATCH_ALIGN, gemm_smem, launch_tile, patchify_plan)

VOLUME = (120, 160, 160)
CASES = [  # (B, C, volume, patch, dim): GAViKO vit-l16, vit-b16, K no whole vector
    (8, 1, VOLUME, (12, 16, 16), 1024), (4, 1, VOLUME, (12, 16, 16), 1024),
    (8, 1, VOLUME, (12, 16, 16), 768), (4, 1, VOLUME, (12, 16, 16), 768),
    (2, 3, (6, 10, 14), (3, 5, 7), 40),
]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("B,C,vol,patch,dim", CASES)
def test_patchify_plan(dtype, B, C, vol, patch, dim):
    size = dtype.itemsize
    n_tok = (vol[0] // patch[0]) * (vol[1] // patch[1]) * (vol[2] // patch[2])
    k = C * patch[0] * patch[1] * patch[2]
    blocks = [None] + [bm for bm, _ in _blocks.TILES[dtype]]  # the policy's, then each tile
    for save_rows, block in ((s, b) for s in (False, True) for b in blocks):
        plan = patchify_plan(B, C, vol, patch, dim, dtype, save_rows, block)
        assert (plan.rows, plan.k, plan.dim, plan.launches) == (B * n_tok, k, dim, 2)
        # kp: the fewest columns of whole 16-byte rows, so the patch matrix's
        # and the weight's row strides are TMA's
        assert plan.kp >= k and plan.kp * size % 16 == 0 and (plan.kp - k) * size < 16
        whole = patch[2] * size % 16 == 0 and vol[2] * size % 16 == 0
        assert plan.vector == (16 // size if whole else 1)
        if plan.vector > 1:
            assert plan.kp == k  # a 16-byte run never leaves a patch row
        (product,), = plan.products
        bm, bn = product.tile_shape
        assert product.tile_shape in _blocks.TILES[dtype] and (block is None or bm == block)
        assert plan.smem == gemm_smem(dtype, product.tile_shape) <= SMEM_LIMIT
        assert (product.m, product.n, product.k) == (plan.rows, dim, plan.kp)
        covered = np.zeros((-(-plan.rows // bm), -(-dim // bn)), np.int64)
        for cta in range(product.blocks):
            _, r0, c0 = launch_tile(plan.products[0], cta)
            covered[r0 // bm, c0 // bn] += 1
        assert (covered == 1).all()
        if save_rows:
            assert plan.scratch == () and plan.scratch_bytes == 0
        else:
            (name, shape, dt, off), = plan.scratch
            assert (name, shape, dt, off) == ("rows", (plan.rows, plan.kp), dtype, 0)
            nbytes = plan.rows * plan.kp * size
            assert plan.scratch_bytes == -(-nbytes // _SCRATCH_ALIGN) * _SCRATCH_ALIGN


def test_patchify_plan_raises_on_what_the_kernels_cannot_take():
    with pytest.raises(NotImplementedError, match="float16"):
        patchify_plan(1, 1, (12, 16, 16), (12, 16, 16), 8, torch.float16)
    with pytest.raises(ValueError, match="patchify"):
        patchify_plan(1, 1, (12, 16, 20), (12, 16, 16), 8)
    with pytest.raises(NotImplementedError, match="2\\*\\*31"):
        patchify_plan(1024, 1, VOLUME, (12, 16, 16), 8)


@pytest.mark.parametrize("C,vol,patch", [(1, (24, 32, 48), (12, 16, 16)),
                                         (3, (6, 10, 14), (3, 5, 7))])
def test_rows_reference_is_the_padded_patch_matrix(C, vol, patch):
    img = torch.from_numpy(np.random.RandomState(3).rand(2, C, *vol).astype(np.float32))
    plan = patchify_plan(2, C, vol, patch, 8, torch.bfloat16)
    rows = tpatch.rows_reference(img, patch, plan.kp)
    assert rows.shape == (plan.rows, plan.kp)
    torch.testing.assert_close(rows[:, :plan.k],
                               tpatch.patch_rows(img, patch).reshape(plan.rows, plan.k),
                               rtol=0, atol=0)
    assert not rows[:, plan.k:].any()


def test_rows_reference_matches_jax_gathered_rows():
    """JAX's kernel emits the rows as (B, gd, gh * gw, pw * kpad): each of
    the pw lane phases owns a kpad-wide stripe of its (pd, ph) columns.
    Undone, they are the port's rows, bit for bit."""
    spec = make_spec(dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
                          num_classes=5, channels=1, pool="cls", backbone="vit-t16",
                          method="fft"))
    rng = np.random.RandomState(4)
    img = rng.rand(2, 1, 24, 32, 32).astype(np.float32)
    w = (rng.randn(16, 1, 12, 16, 16) * 0.02).astype(np.float32)
    b, pos = rng.randn(16).astype(np.float32), rng.randn(spec.num_patches, 16).astype(np.float32)
    _, jrows = jpatch.patchify_pallas(*(jnp.asarray(a) for a in (img, w, b, pos)), spec,
                                      save_rows=True)
    B, gd, ghw, width = jrows.shape
    pd, (ph, pw) = spec.frame_patch_size, spec.image_patch_size
    kdim = pd * ph
    undone = np.asarray(jrows).reshape(B, gd, ghw, pw, width // pw)[..., :kdim]
    undone = undone.transpose(0, 1, 2, 4, 3).reshape(B * gd * ghw, kdim * pw)
    plan = patchify_plan(2, 1, (24, 32, 32), (pd, ph, pw), 16, torch.float32)
    got = tpatch.rows_reference(torch.from_numpy(img), (pd, ph, pw), plan.kp)
    np.testing.assert_array_equal(got.numpy(), undone)


@pytest.mark.parametrize("save_rows", [False, True])
@pytest.mark.parametrize("C,vol,patch,dtype", [
    (1, (24, 32, 48), (12, 16, 16), torch.bfloat16), (3, (6, 10, 14), (3, 5, 7), torch.float32)])
def test_patchify_is_one_launch_on_a_faked_card(monkeypatch, C, vol, patch, dtype, save_rows):
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "check_cuda", lambda name, *t: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, argtypes, *args: calls.append((symbol, args)))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    dim, B = 24, 2
    img = torch.zeros(B, C, *vol, dtype=dtype)
    w = torch.ones(dim, C, *patch, dtype=dtype)
    plan = patchify_plan(B, C, vol, patch, dim, dtype, save_rows)
    before = tpatch.patchify_fused.launches
    res = tpatch.patchify_kernel(img, w, torch.zeros(dim, dtype=dtype), None, save_rows)
    assert tpatch.patchify_fused.launches == before + 1
    (symbol, args), = calls
    assert symbol == f"gaviko_patchify_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
    assert args[6:19] == (B, C, *vol, *patch, dim, plan.kp, plan.vector,
                          *plan.products[0][0].tile_shape)
    if save_rows:
        out, rows = res
        assert rows.shape == (plan.rows, plan.k) and rows.stride() == (plan.kp, 1)
        assert rows.data_ptr() == args[5]
    else:
        out = res
    assert out.shape == (B, plan.rows // B, dim)
