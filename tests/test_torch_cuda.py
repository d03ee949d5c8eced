"""PyTorch port: each CUDA kernel against its plain version on the card.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip without
one. The card's machine has no JAX, so this file imports none, and runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Shapes are small and deliberately ragged (tiles cut by every edge). Budgets:
fp32 with TF32 off to 1e-4 relative MAE (the sums only reorder), bf16 to
1e-2 (the kernels round P to bf16 at another point than the plain versions).
Dropout is bit-exact, so the rate-0.2 cases keep the rate-0 budgets.
"""

import dataclasses
import io
import json
import math
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.cls_attention import cls_attention, cls_attention_reference
from gaviko_tpu_torch.ops.flash_attention import (
    _local_forward, _split_heads, flash_attention, flash_attention_reference,
    flash_local_attention, fused_mhsa, fused_mhsa_bwd, local_attention_bwd, local_bwd_reference,
    local_plan, local_reference, mhsa_bwd_reference, mhsa_qkv_proj, mhsa_reference)
from gaviko_tpu_torch.ops.fused_mlp import (
    fused_mlp, fused_mlp_bwd, fused_mlp_forward, mlp_bwd_reference, mlp_reference)
from gaviko_tpu_torch.ops.ln_linear import (
    fused_ln_linear, ln_linear_bwd, ln_linear_bwd_reference, ln_linear_reference)
from gaviko_tpu_torch.ops.patchify import (
    patch_rows, patchify_fused, patchify_kernel, patchify_reference)

pytestmark = pytest.mark.cuda
BUDGET = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_mae(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().mean() / want.abs().mean())


def _randn(gen, *shape, dtype, std=1.0):
    return (torch.randn(*shape, generator=gen, device=gen.device) * std).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,dim,with_pos,vol,patch", [
    (1, 200, True, (24, 32, 48), (12, 16, 16)),
    (1, 64, False, (24, 32, 48), (12, 16, 16)),
    (2, 130, True, (24, 32, 48), (12, 16, 16)),
    (1, 72, True, (4, 8, 12), (2, 4, 4)),  # runs too short for 16-byte loads in bf16
    (3, 40, False, (3, 6, 10), (1, 3, 5)),  # odd widths: element loads in both dtypes
    (3, 36, True, (6, 10, 14), (3, 5, 7)),  # K = 315: rows padded to whole 16 bytes
])
def test_patchify_kernel(dev, dtype, C, dim, with_pos, vol, patch):
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand(3, C, *vol, generator=gen, device=dev).to(dtype)
    w = _randn(gen, dim, C, *patch, dtype=dtype, std=0.02)
    b = _randn(gen, dim, dtype=dtype)
    n_tok = (vol[0] // patch[0]) * (vol[1] // patch[1]) * (vol[2] // patch[2])
    pos = _randn(gen, n_tok, dim, dtype=dtype) if with_pos else None
    before = patchify_fused.launches
    got = patchify_fused(img, w, b, pos)
    assert patchify_fused.launches == before + 1
    assert _rel_mae(got, patchify_reference(img, w, b, pos)) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("save_rows", [False, True])
@pytest.mark.parametrize("B,C,dim,vol,patch", [
    (8, 1, 1024, (24, 160, 160), (12, 16, 16)),  # GAViKO's patch and width, 2 slabs
    (2, 3, 36, (6, 10, 14), (3, 5, 7)),  # K = 315: rows padded to whole 16 bytes
])
def test_patchify_kernel_reruns_bit_equal(dev, dtype, save_rows, B, C, dim, vol, patch):
    """The rows pass and the GEMM (no atomics): two calls give the same
    bits, the patch rows too; one wrapper launch a call."""
    gen = torch.Generator(device=dev).manual_seed(13)
    img = torch.rand(B, C, *vol, generator=gen, device=dev).to(dtype)
    n_tok = (vol[0] // patch[0]) * (vol[1] // patch[1]) * (vol[2] // patch[2])
    args = (_randn(gen, dim, C, *patch, dtype=dtype, std=0.02), _randn(gen, dim, dtype=dtype),
            _randn(gen, n_tok, dim, dtype=dtype))
    before = patchify_fused.launches
    with torch.no_grad():
        runs = [patchify_kernel(img, *args, save_rows=save_rows) for _ in range(2)]
    assert patchify_fused.launches == before + 2
    first, second = ((r,) if not save_rows else r for r in runs)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert _rel_mae(first[0], patchify_reference(img, *args)) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,n_pad,n_true", [(2, 4, 136, 130), (1, 2, 64, 64), (3, 2, 40, 1)])
def test_fused_mhsa_kernel(dev, dtype, B, H, n_pad, n_true):
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = _randn(gen, B, n_pad, 3 * H * 64, dtype=dtype)
    before = fused_mhsa.launches
    got = fused_mhsa(qkv, H, 64, 0.125, n_true)
    assert fused_mhsa.launches == before + 1
    want = mhsa_reference(qkv, H, 64, 0.125, n_true)
    assert torch.isfinite(got).all()
    assert _rel_mae(got[:, :n_true], want[:, :n_true]) <= BUDGET[dtype]


# Kernels C and D: GAViKO-like shapes, then (ROADMAP Queue C item 8) latents
# wider than 32 and GAViKO's patch grid at image_size 224 (10 x 14 x 14),
# which the kernels refused before their key tiles streamed; an odd latent
# (21: rows off 4-byte words in bf16, copied element-wise) and one above a
# slice (136: several column slices).
LOCAL_WIDE = [((4, 5, 6), (6, 6, 6), 40), ((3, 5, 7), (6, 6, 6), 64),
              ((4, 4, 6), (3, 6, 6), 128), ((10, 14, 14), (6, 6, 6), 20),
              ((3, 4, 5), (6, 6, 6), 21), ((3, 4, 5), (2, 3, 1), 136)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("DHW,local_k,dl", [
    ((4, 5, 6), (6, 6, 6), 20), ((4, 5, 6), (3, 6, 6), 8), ((10, 10, 10), (2, 3, 1), 20),
    ((3, 2, 30), (6, 6, 6), 32), *LOCAL_WIDE,
])
def test_local_attention_kernel(dev, dtype, DHW, local_k, dl):
    gen = torch.Generator(device=dev).manual_seed(2)
    n = DHW[0] * DHW[1] * DHW[2]
    q, k, v = _randn(gen, 2, n, 3 * dl, dtype=dtype, std=3.0).chunk(3, dim=-1)
    before = flash_local_attention.launches
    got = flash_local_attention(q, k, v, 0.05, DHW, local_k)
    assert flash_local_attention.launches == before + 1
    want = local_reference(q, k, v, 0.05, DHW, local_k)
    assert _rel_mae(got, want) <= BUDGET[dtype]


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """Strided qkv, float16 and a head dim below 1 raise. (Any head dim >= 1
    reaches kernel A since ROADMAP Queue C item 4 was repaired: dim_head 32
    raised here before it runs the general instance. A latent wider than 32
    raised here too until Queue C item 8 was repaired: it now launches
    kernel C once, within budget.)"""
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mhsa(torch.zeros(1, 16, 3 * 2 * 64, device=dev)[:, ::2], 2, 64, 0.125, 8)
    with pytest.raises(NotImplementedError, match="float16"):
        fused_mhsa(qkv.half(), 2, 64, 0.125, 8)
    with pytest.raises(ValueError, match="dim_head"):
        fused_mhsa(torch.zeros(1, 8, 0, device=dev), 2, 0, 0.125, 8)
    q = _randn(torch.Generator(device=dev).manual_seed(9), 1, 8, 40, dtype=torch.float32)
    before = flash_local_attention.launches
    got = flash_local_attention(q, q, q, 0.2, (2, 2, 2), (2, 2, 2))
    assert flash_local_attention.launches == before + 1
    assert _rel_mae(got, local_reference(q, q, q, 0.2, (2, 2, 2), (2, 2, 2))) <= 1e-4


def test_gaviko_forward_runs_the_kernels(dev):
    cfg = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-s16",
               method="gaviko", num_prompts=4, prompt_latent_dim=8, local_dim=8,
               local_k=(2, 2, 2))
    model = build_model(cfg)
    params = {k: v.to(dev) for k, v in
              model.init(torch.Generator().manual_seed(0), model.spec).items()}
    x = torch.rand(2, 1, 24, 32, 32, generator=torch.Generator().manual_seed(1)).to(dev)
    wrappers = (patchify_fused, fused_mhsa, flash_local_attention)
    for w in wrappers:
        w.launches = 0
    with torch.inference_mode():
        got = model.apply(params, x, model.spec)
        counts = [w.launches for w in wrappers]
        with _build.plain_versions():
            want = model.apply(params, x, model.spec)
    assert counts == [1, model.spec.depth, model.spec.depth]
    assert [w.launches for w in wrappers] == counts  # the plain run launched nothing
    assert _rel_mae(got, want) <= 1e-4


def _lse_as_kernel_a(qkv, H, scale, n_true):
    """Kernel A's lse in log2 units [B, H, N_pad], computed as the kernel
    does: q scaled by scale * log2(e) and rounded to qkv's dtype, f32
    scores, keys >= n_true left out."""
    B, n_pad, _ = qkv.shape
    q, k, _ = qkv.float().view(B, n_pad, 3, H, 64).unbind(2)
    q = (q * (scale * math.log2(math.e))).to(qkv.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, :n_true])
    return torch.logsumexp(s * math.log(2), dim=-1) / math.log(2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,n_pad,n_true", [(2, 4, 136, 130), (1, 2, 64, 64), (3, 2, 40, 1)])
def test_fused_mhsa_lse_and_backward_kernels(dev, dtype, B, H, n_pad, n_true):
    """Kernel A's lse to 1e-3 absolute (log2 units) against the sum from q
    rounded as the kernel rounds it, and kernel B's packed dqkv against its
    plain version; pad keys get dK = dV = 0 and a zero cotangent on pad rows
    gives dq = 0 there."""
    gen = torch.Generator(device=dev).manual_seed(3)
    qkv = _randn(gen, B, n_pad, 3 * H * 64, dtype=dtype)
    dout = _randn(gen, B, n_pad, H * 64, dtype=dtype)
    dout[:, n_true:] = 0
    before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
    out, lse = fused_mhsa(qkv, H, 64, 0.125, n_true, with_lse=True)
    dqkv = fused_mhsa_bwd(qkv, out, lse, dout, H, 64, 0.125, n_true)
    assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = mhsa_bwd_reference(qkv, out, lse, dout, H, 64, 0.125, n_true)
    assert float((lse - _lse_as_kernel_a(qkv, H, 0.125, n_true)).abs().max()) <= 1e-3
    assert torch.isfinite(dqkv).all()
    inner = H * 64
    assert torch.all(dqkv[:, n_true:, inner:] == 0)
    assert torch.all(dqkv[:, n_true:, :inner] == 0)
    assert _rel_mae(dqkv, want) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mhsa_qkv_proj_runs_kernels_a_and_b(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(4)
    h = _randn(gen, 2, 48, 96, dtype=dtype, std=0.5).requires_grad_(True)
    w = _randn(gen, 3 * 2 * 64, 96, dtype=dtype, std=0.1).requires_grad_(True)
    g = _randn(gen, 2, 48, 2 * 64, dtype=dtype)
    before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
    mhsa_qkv_proj(h, w, 2, 64, 0.125, 45).backward(g)
    assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    got = (h.grad.clone(), w.grad.clone())
    h.grad = w.grad = None
    with _build.plain_versions():
        mhsa_qkv_proj(h, w, 2, 64, 0.125, 45).backward(g)
    for a, b in zip(got, (h.grad, w.grad)):
        assert _rel_mae(a, b) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("DHW,local_k,dl", [
    ((4, 5, 6), (6, 6, 6), 20), ((4, 5, 6), (3, 6, 6), 8), ((10, 10, 10), (2, 3, 1), 20),
    *LOCAL_WIDE,
])
def test_local_attention_dropout_and_backward_kernels(dev, dtype, rate, DHW, local_k, dl):
    """Kernels C and D against their plain versions, dropout on and off."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = DHW[0] * DHW[1] * DHW[2]
    q, k, v = _randn(gen, 2, n, 3 * dl, dtype=dtype, std=3.0).chunk(3, dim=-1)
    dout = _randn(gen, 2, n, dl, dtype=dtype)
    seed = -123456789
    before = (flash_local_attention.launches, local_attention_bwd.launches)
    got = flash_local_attention(q, k, v, 0.05, DHW, local_k, rate, seed)
    want, lse = local_reference(q, k, v, 0.05, DHW, local_k, rate, seed, with_lse=True)
    assert _rel_mae(got, want) <= BUDGET[dtype]
    dqkv = local_attention_bwd(q, k, v, got, lse, dout, 0.05, DHW, local_k, rate, seed)
    assert (flash_local_attention.launches, local_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    dwant = local_bwd_reference(q, k, v, got, lse, dout, 0.05, DHW, local_k, rate, seed)
    assert torch.isfinite(dqkv).all()
    assert _rel_mae(dqkv, dwant) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("DHW,dl,B", [((10, 10, 10), 20, 4), ((10, 14, 14), 20, 2),
                                      ((4, 5, 6), 64, 3)])
def test_local_attention_kernels_rerun_bit_equal(dev, dtype, DHW, dl, B):
    """C's out and lse and D's dqkv are bit-equal from one call to the next,
    dropout on: the split warps' partials combine in warp order and D's two
    passes use no atomics."""
    gen = torch.Generator(device=dev).manual_seed(10)
    n = DHW[0] * DHW[1] * DHW[2]
    q, k, v = _randn(gen, B, n, 3 * dl, dtype=dtype, std=3.0).chunk(3, dim=-1)
    dout = _randn(gen, B, n, dl, dtype=dtype)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            out, lse = _local_forward(q, k, v, 0.05, DHW, (6, 6, 6), 0.2, 77)
            dqkv = local_attention_bwd(q, k, v, out, lse, dout, 0.05, DHW, (6, 6, 6), 0.2, 77)
        runs.append((out, lse, dqkv))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ROADMAP Queue C 12: latents whose staged rows of S's whole depth leave no
# tile in shared memory, which the plan refused before: GAViKO's grid at B4
# (dl 640 in f32: D's passes chunked; 1,168 in bf16: D's dk/dv pass
# chunked), and on a small grid latents wide enough to chunk C too.
LOCAL_C12 = [(torch.float32, (10, 10, 10), 4, 640), (torch.bfloat16, (10, 10, 10), 4, 1168),
             (torch.float32, (3, 4, 5), 2, 1300), (torch.bfloat16, (3, 4, 5), 2, 2400)]


@pytest.mark.parametrize("dtype,DHW,B,dl", LOCAL_C12)
def test_local_attention_kernels_at_wide_latents(dev, dtype, DHW, B, dl):
    """C and D at Queue C 12's widths, dropout 0.2, against their plain
    versions at the usual budgets, and reruns bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(14)
    n = DHW[0] * DHW[1] * DHW[2]
    q, k, v = _randn(gen, B, n, 3 * dl, dtype=dtype).chunk(3, dim=-1)
    dout = _randn(gen, B, n, dl, dtype=dtype)
    scale = dl ** -0.5
    plan = local_plan(DHW, (6, 6, 6), dl, dtype, B, 3 * dl, True)
    assert any(p.width < dl for p in plan)  # a chunked pass runs
    runs = []
    for _ in range(2):
        with torch.no_grad():
            out, lse = _local_forward(q, k, v, scale, DHW, (6, 6, 6), 0.2, 77)
            dqkv = local_attention_bwd(q, k, v, out, lse, dout, scale, DHW, (6, 6, 6), 0.2, 77)
        runs.append((out, lse, dqkv))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    want, wlse = local_reference(q, k, v, scale, DHW, (6, 6, 6), 0.2, 77, with_lse=True)
    assert _rel_mae(out, want) <= BUDGET[dtype]
    dwant = local_bwd_reference(q, k, v, out, lse, dout, scale, DHW, (6, 6, 6), 0.2, 77)
    assert torch.isfinite(dqkv).all()
    assert _rel_mae(dqkv, dwant) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_attention_kernels_take_q_k_v_from_separate_tensors(dev, dtype):
    """q, k and v as three tensors (K and V then take a stripe each) and as
    views with a row stride wider than the packed projection's: C and D
    against their plain versions, dropout on."""
    gen = torch.Generator(device=dev).manual_seed(11)
    DHW, n, dl = (4, 5, 6), 120, 24
    wide = _randn(gen, 2, n, 5 * dl, dtype=dtype, std=3.0)
    cases = [[_randn(gen, 2, n, dl, dtype=dtype, std=3.0) for _ in range(3)],
             [wide[..., :dl], wide[..., 2 * dl:3 * dl], wide[..., 4 * dl:]]]
    dout = _randn(gen, 2, n, dl, dtype=dtype)
    for q, k, v in cases:
        got = flash_local_attention(q, k, v, 0.05, DHW, (6, 6, 6), 0.2, 3)
        want, lse = local_reference(q, k, v, 0.05, DHW, (6, 6, 6), 0.2, 3, with_lse=True)
        assert _rel_mae(got, want) <= BUDGET[dtype]
        dqkv = local_attention_bwd(q, k, v, got, lse, dout, 0.05, DHW, (6, 6, 6), 0.2, 3)
        dwant = local_bwd_reference(q, k, v, got, lse, dout, 0.05, DHW, (6, 6, 6), 0.2, 3)
        assert _rel_mae(dqkv, dwant) <= BUDGET[dtype]


def test_wrappers_without_a_backward_kernel_refuse_a_gradient(dev):
    """The forward kernel wrappers whose outputs have no backward refuse a
    gradient; their differentiable entry points take one. ``fused_mhsa`` on
    a packed qkv that needs a gradient launches kernel A and its backward
    runs kernel B (the name dates from when it refused)."""
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=dev, requires_grad=True)
    before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
    fused_mhsa(qkv, 2, 64, 0.125, 8).sum().backward()
    assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()
    w = torch.zeros(8, 1, 2, 4, 4, device=dev, requires_grad=True)
    img = torch.zeros(1, 1, 4, 8, 8, device=dev)
    with pytest.raises(NotImplementedError, match="through patchify_fused"):
        patchify_kernel(img, w, torch.zeros(8, device=dev))
    patchify_fused(img, w, torch.zeros(8, device=dev)).sum().backward()
    assert w.grad is not None


def test_gaviko_train_gradients_run_the_kernels(dev):
    cfg = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-s16",
               method="gaviko", num_prompts=4, prompt_latent_dim=8, local_dim=8,
               local_k=(2, 2, 2), freeze_vit=True)
    model = build_model(cfg)
    params = {k: v.to(dev) for k, v in
              model.init(torch.Generator().manual_seed(0), model.spec).items()}
    x = torch.rand(2, 1, 24, 32, 32, generator=torch.Generator().manual_seed(1)).to(dev)
    seeds = [int(s) for s in torch.randint(-2 ** 31, 2 ** 31, (2 * model.spec.depth,),
                                           generator=torch.Generator().manual_seed(2))]

    def trainable_grads():
        p = {k: v.clone().requires_grad_(True) if model.trainable(k) else v
             for k, v in params.items()}
        names = model.trainable_names(p)
        out = model.apply(p, x, model.spec, train=True, seeds=SeedStream(seeds))
        grads = torch.autograd.grad(out.square().sum(), [p[k] for k in names],
                                    allow_unused=True)
        return torch.cat([torch.zeros_like(p[k]).flatten() if g is None else g.flatten()
                          for k, g in zip(names, grads)])

    # The frozen global layers run train=False under a gradient: at vit-s16
    # fp32 the qkv is B9, whose backward is B12.
    wrappers = (fused_mhsa, fused_mhsa_bwd, flash_local_attention, local_attention_bwd,
                fused_ln_linear, ln_linear_bwd)
    for w in wrappers:
        w.launches = 0
    got = trainable_grads()
    counts = [w.launches for w in wrappers]
    with _build.plain_versions():
        want = trainable_grads()
    assert counts == [model.spec.depth] * 6
    assert [w.launches for w in wrappers] == counts
    assert _rel_mae(got, want) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gaviko_step_at_image_size_224_runs_c_and_d(dev, dtype):
    """GAViKO at ``image_size: 224`` (patch grid 10 x 14 x 14, 1960 rows,
    which kernel D refused before ROADMAP Queue C item 8 was repaired), built
    in memory at depth 2 with vit-s16 widths: the train step's gradients
    launch C and D once a layer and agree with the plain versions."""
    cfg = dict(image_size=224, image_patch_size=16, frames=120, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-s16",
               method="gaviko", num_prompts=4, prompt_latent_dim=8, local_dim=20,
               local_k=(6, 6, 6), freeze_vit=True)
    model = build_model(cfg)
    spec = dataclasses.replace(model.spec, depth=2)
    assert spec.DHW == (10, 14, 14)
    params = {k: v.to(dev, dtype) for k, v in
              model.init(torch.Generator().manual_seed(0), spec).items()}
    x = torch.rand(2, 1, 120, 224, 224, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    seeds = [int(s) for s in torch.randint(-2 ** 31, 2 ** 31, (2 * spec.depth,),
                                           generator=torch.Generator().manual_seed(2))]

    def trainable_grads():
        p = {k: v.clone().requires_grad_(True) if model.trainable(k) else v
             for k, v in params.items()}
        names = model.trainable_names(p)
        out = model.apply(p, x, spec, train=True, seeds=SeedStream(seeds))
        grads = torch.autograd.grad(out.float().square().sum(), [p[k] for k in names],
                                    allow_unused=True)
        return torch.cat([torch.zeros_like(p[k]).flatten() if g is None else g.flatten()
                          for k, g in zip(names, grads)])

    wrappers = (flash_local_attention, local_attention_bwd)
    for w in wrappers:
        w.launches = 0
    got = trainable_grads()
    counts = [w.launches for w in wrappers]
    with _build.plain_versions():
        want = trainable_grads()
    assert counts == [spec.depth, spec.depth]
    assert [w.launches for w in wrappers] == counts
    assert torch.isfinite(got).all()
    assert _rel_mae(got, want) <= (1e-4 if dtype == torch.float32 else 5e-2)


def _ln_params(gen, dim, dtype):
    gamma = (1.0 + 0.1 * torch.randn(dim, generator=gen, device=gen.device)).to(dtype)
    return gamma, _randn(gen, dim, dtype=dtype, std=0.1)


# (B, N, dim, out): the vit-b16 B8 qkv and kv projections, then ragged rows
# (tiles cut by the row edge) and an out width that is no multiple of 128;
# vit-s16's qkv at B8 and vit-l16's qkv and kv at GAViKO B4 widths; and the
# widths above 1,024 that JAX's gates admit (Queue C 11).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,dim,out", [
    (8, 1008, 768, 2304), (8, 1008, 768, 1536), (3, 37, 384, 1152), (2, 5, 128, 136),
    (8, 1008, 384, 1152), (4, 1040, 1024, 3072), (4, 1040, 1024, 2048),
    (2, 300, 1152, 1152), (1, 70, 2048, 768), (2, 100, 1152, 768), (1, 130, 1280, 768),
])
def test_ln_linear_kernel(dev, dtype, B, N, dim, out):
    """B9 against its plain version; a second call bit-equal (no atomics)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x = _randn(gen, B, N, dim, dtype=dtype, std=2.0) + 0.5
    gamma, beta = _ln_params(gen, dim, dtype)
    w = _randn(gen, out, dim, dtype=dtype, std=dim ** -0.5)
    before = fused_ln_linear.launches
    got = fused_ln_linear(x, gamma, beta, w)
    assert fused_ln_linear.launches == before + 1
    assert got.shape == (B, N, out) and torch.isfinite(got).all()
    assert _rel_mae(got, ln_linear_reference(x, gamma, beta, w)) <= BUDGET[dtype]
    assert torch.equal(fused_ln_linear(x, gamma, beta, w), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,dim,mlp,gelu,residual", [
    (8, 1008, 768, 3072, "exact", True), (8, 1008, 768, 3072, "tanh", True),
    (8, 1008, 768, 3072, "erf_fast", True), (3, 37, 384, 1536, "exact", False),
    (2, 5, 128, 256, "tanh", True), (1, 70, 1024, 512, "erf_fast", False),
])
def test_fused_mlp_kernel(dev, dtype, B, N, dim, mlp, gelu, residual):
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _randn(gen, B, N, dim, dtype=dtype)
    gamma, beta = _ln_params(gen, dim, dtype)
    w1 = _randn(gen, mlp, dim, dtype=dtype, std=dim ** -0.5)
    b1 = _randn(gen, mlp, dtype=dtype, std=0.1)
    w2 = _randn(gen, dim, mlp, dtype=dtype, std=mlp ** -0.5)
    b2 = _randn(gen, dim, dtype=dtype, std=0.1)
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-5, gelu)
    before = fused_mlp.launches
    got = fused_mlp(*args, residual=residual)
    assert fused_mlp.launches == before + 1
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _rel_mae(got, mlp_reference(*args, residual=residual)) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,n_true", [
    (8, 1008, 12, 1001), (2, 128, 4, 128), (1, 64, 8, 57), (4, 16, 2, 11), (3, 40, 2, 1),
])
def test_cls_attention_kernel(dev, dtype, B, N, H, n_true):
    gen = torch.Generator(device=dev).manual_seed(8)
    kv = _randn(gen, B, N, 2 * H * 64, dtype=dtype)
    q0 = _randn(gen, B, H * 64, dtype=dtype)
    before = cls_attention.launches
    got = cls_attention(kv, q0, H, 64, 0.125, n_true)
    assert cls_attention.launches == before + 1
    assert torch.isfinite(got).all()
    assert _rel_mae(got, cls_attention_reference(kv, q0, H, 64, 0.125, n_true)) <= BUDGET[dtype]


def test_new_wrappers_refuse_a_gradient_and_mlp_dropout(dev):
    """The inference-only CLS attention kernel and the raw fused MLP
    forward refuse a gradient; ``fused_ln_linear`` takes one (B9, then B12
    as its backward), and ``fused_mlp`` takes dropout and a gradient (B6
    then B7)."""
    x = torch.zeros(1, 8, 128, device=dev, requires_grad=True)
    g, b = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    w = torch.zeros(256, 128, device=dev)
    before = (fused_ln_linear.launches, ln_linear_bwd.launches)
    fused_ln_linear(x, g, b, w).sum().backward()
    assert (fused_ln_linear.launches, ln_linear_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(x.grad, torch.zeros_like(x))  # zero weights
    x.grad = None
    w1, b1 = torch.zeros(256, 128, device=dev), torch.zeros(256, device=dev)
    w2 = torch.zeros(128, 256, device=dev)
    with pytest.raises(NotImplementedError, match="through fused_mlp"):
        fused_mlp_forward(x, g, b, w1, b1, w2, b, residual=True)
    before = (fused_mlp.launches, fused_mlp_bwd.launches)
    fused_mlp(x, g, b, w1, b1, w2, b, dropout_rate=0.1, residual=True, seed=3).sum().backward()
    assert (fused_mlp.launches, fused_mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(x.grad, torch.ones_like(x))  # zero weights: the residual
    kv = torch.zeros(1, 8, 2 * 2 * 64, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference only"):
        cls_attention(kv, torch.zeros(1, 2 * 64, device=dev), 2, 64, 0.125, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_forward_runs_the_kernels(dev, dtype):
    """The plain ViT's serving forward at vit-s16 width: patchify, LN+qkv,
    MHSA and the fused MLP in every full layer, LN+kv and the CLS attention
    in the last one, against the plain versions."""
    cfg = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-s16", method="fft")
    model = build_model(cfg)
    params = {k: v.to(dev, dtype) for k, v in
              model.init(torch.Generator().manual_seed(0), model.spec).items()}
    x = torch.rand(3, 1, 24, 32, 32, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    wrappers = (patchify_fused, fused_ln_linear, fused_mhsa, fused_mlp, cls_attention)
    for w in wrappers:
        w.launches = 0
    with torch.inference_mode():
        got = model.apply(params, x, model.spec)
        counts = [w.launches for w in wrappers]
        with _build.plain_versions():
            want = model.apply(params, x, model.spec)
    d = model.spec.depth
    assert counts == [1, d, d - 1, d - 1, 1]
    assert [w.launches for w in wrappers] == counts
    assert _rel_mae(got, want) <= {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]


def test_cli_serves_vit_b16(dev, tmp_path):
    """``python -m gaviko_tpu_torch.cli.serve --config vit.yaml --method fft``
    builds the vit-b16 Predictor on the card (random init: no pretrained
    file) and answers /predict over HTTP."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gaviko_tpu_torch.cli.serve", "--config",
         "gaviko_tpu_torch/configs/vit.yaml", "--method", "fft", "--port", str(port)],
        cwd=repo, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 600
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()
            try:
                with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                    if json.load(r)["status"] == "ok":
                        break
            except OSError:
                assert time.monotonic() < deadline, "the server did not come up"
                time.sleep(1)
        buf = io.BytesIO()
        np.savez(buf, data=np.random.RandomState(0).rand(120, 160, 160).astype(np.float32))
        req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            answer = json.load(r)
        assert len(answer["logits"]) == 5 and np.isfinite(answer["logits"]).all()
        assert answer["class"] == int(np.argmax(answer["logits"]))
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.close()


# ------------------------------------------- the vit-b16 train path kernels ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,n_pad,n_true", [(2, 4, 136, 130), (2, 12, 64, 57), (3, 2, 40, 1)])
def test_fused_mhsa_dropout_kernels(dev, dtype, B, H, n_pad, n_true):
    """Kernels A and B with dropout 0.1 against their plain versions: the
    bits are the same, so the budgets of rate 0 hold; lse is unchanged by
    dropout."""
    gen = torch.Generator(device=dev).manual_seed(9)
    qkv = _randn(gen, B, n_pad, 3 * H * 64, dtype=dtype)
    dout = _randn(gen, B, n_pad, H * 64, dtype=dtype)
    dout[:, n_true:] = 0
    seed = -20260
    before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
    out, lse = fused_mhsa(qkv, H, 64, 0.125, n_true, 0.1, with_lse=True, seed=seed)
    dqkv = fused_mhsa_bwd(qkv, out, lse, dout, H, 64, 0.125, n_true, 0.1, seed)
    assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    want, want_lse = mhsa_reference(qkv, H, 64, 0.125, n_true, 0.1, with_lse=True, seed=seed)
    assert _rel_mae(out[:, :n_true], want[:, :n_true]) <= BUDGET[dtype]
    assert float((lse - _lse_as_kernel_a(qkv, H, 0.125, n_true)).abs().max()) <= 1e-3
    dwant = mhsa_bwd_reference(qkv, out, lse, dout, H, 64, 0.125, n_true, 0.1, seed)
    assert torch.isfinite(dqkv).all()
    assert _rel_mae(dqkv, dwant) <= BUDGET[dtype]
    nodrop = fused_mhsa(qkv, H, 64, 0.125, n_true)
    assert _rel_mae(out[:, :n_true], nodrop[:, :n_true]) > 10 * BUDGET[dtype]


def _mlp_args(gen, B, N, dim, mlp, dtype):
    x = _randn(gen, B, N, dim, dtype=dtype)
    gamma, beta = _ln_params(gen, dim, dtype)
    return (x, gamma, beta, _randn(gen, mlp, dim, dtype=dtype, std=dim ** -0.5),
            _randn(gen, mlp, dtype=dtype, std=0.1), _randn(gen, dim, mlp, dtype=dtype,
                                                           std=mlp ** -0.5),
            _randn(gen, dim, dtype=dtype, std=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,dim,mlp,gelu,residual", [
    (2, 1008, 768, 3072, "exact", True), (3, 37, 384, 1536, "erf_fast", False),
    (2, 5, 128, 256, "tanh", True),
])
def test_fused_mlp_dropout_and_save_a_kernel(dev, dtype, B, N, dim, mlp, gelu, residual):
    """Kernel B6 with dropout 0.1 and save_a: the output and the saved
    pre-GELU hidden against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(10)
    args = _mlp_args(gen, B, N, dim, mlp, dtype)
    before = fused_mlp.launches
    out, a = fused_mlp_forward(*args, 1e-5, gelu, 0.1, residual, seed=77, save_a=True)
    assert fused_mlp.launches == before + 1
    want, want_a = mlp_reference(*args, 1e-5, gelu, 0.1, residual, 77, save_a=True)
    assert out.shape == args[0].shape and a.shape == (B * N, mlp)
    assert torch.isfinite(out).all() and torch.isfinite(a).all()
    assert _rel_mae(out, want) <= BUDGET[dtype]
    assert _rel_mae(a, want_a) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,dim,mlp,gelu,residual,rate", [
    (2, 1008, 768, 3072, "exact", True, 0.1), (3, 37, 384, 1536, "erf_fast", False, 0.1),
    (2, 5, 128, 256, "tanh", True, 0.0), (1, 200, 256, 512, "exact", False, 0.0),
])
def test_fused_mlp_bwd_kernel(dev, dtype, B, N, dim, mlp, gelu, residual, rate):
    """Kernel B7 against its plain version: dx, dgamma, dbeta, dW1, db1, dW2
    and db2 from the saved pre-GELU hidden, the masks replayed."""
    gen = torch.Generator(device=dev).manual_seed(11)
    args = _mlp_args(gen, B, N, dim, mlp, dtype)
    dy = _randn(gen, B, N, dim, dtype=dtype)
    _, a = mlp_reference(*args, 1e-5, gelu, rate, residual, 5, save_a=True)
    before = fused_mlp_bwd.launches
    got = fused_mlp_bwd(*args, dy, a, 1e-5, gelu, rate, residual, 5)
    assert fused_mlp_bwd.launches == before + 1
    want = mlp_bwd_reference(*args, dy, a, 1e-5, gelu, rate, residual, 5)
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel_mae(g, w) <= BUDGET[dtype], (name, _rel_mae(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,dim,vol,patch", [
    (1, 200, (24, 32, 48), (12, 16, 16)), (3, 40, (3, 6, 10), (1, 3, 5)),
    (3, 36, (6, 10, 14), (3, 5, 7)),
])
def test_patchify_save_rows_and_backward(dev, dtype, C, dim, vol, patch):
    """The patch rows the kernel saves are the patch matrix exactly, and the
    gradients of weight, bias and pos (dW = rows^T dy) match autograd
    through the plain version."""
    gen = torch.Generator(device=dev).manual_seed(12)
    img = torch.rand(3, C, *vol, generator=gen, device=dev).to(dtype)
    n_tok = (vol[0] // patch[0]) * (vol[1] // patch[1]) * (vol[2] // patch[2])
    leaves = [_randn(gen, dim, C, *patch, dtype=dtype, std=0.02), _randn(gen, dim, dtype=dtype),
              _randn(gen, n_tok, dim, dtype=dtype)]
    dy = _randn(gen, 3, n_tok, dim, dtype=dtype)
    before = patchify_fused.launches
    out, rows = patchify_kernel(img, *leaves, save_rows=True)
    assert patchify_fused.launches == before + 1
    assert torch.equal(rows, patch_rows(img, patch).reshape(3 * n_tok, -1))
    assert _rel_mae(out, patchify_reference(img, *leaves)) <= BUDGET[dtype]
    got = torch.autograd.grad(patchify_fused(img, *(t.requires_grad_(True) for t in leaves)),
                              leaves, dy)
    assert patchify_fused.launches == before + 2
    want = torch.autograd.grad(patchify_reference(img, *leaves), leaves, dy)
    for g, w in zip(got, want):
        assert _rel_mae(g, w) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_b16_train_step_runs_the_backward_kernels(dev, dtype):
    """The vit-b16 train forward and its gradients (method fft, full
    120x160x160 geometry, depth cut to 3, B2, dropout 0.1) launch patchify
    with its rows once, kernels A and B in each full layer and, where the
    fused MLP gate holds (bf16), B6 and B7 there; the gradients of every
    tensor match the plain versions' (1e-4 / 5e-2 relative MAE)."""
    import dataclasses

    cfg = dict(image_size=160, image_patch_size=16, frames=120, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-b16", method="fft",
               dropout=0.1, emb_dropout=0.1)
    model = build_model(cfg)
    spec = dataclasses.replace(model.spec, depth=3)
    params = {k: v.to(dev, dtype) for k, v in
              model.init(torch.Generator().manual_seed(0), spec).items()}
    x = torch.rand(2, 1, 120, 160, 160, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    n = 1 + 3 * 2 + 4 if dtype == torch.bfloat16 else 1 + 4 * 2 + 4
    seeds = [int(s) for s in torch.randint(-2 ** 31, 2 ** 31, (n,),
                                           generator=torch.Generator().manual_seed(2))]

    def grads():
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        stream = SeedStream(seeds)
        out = model.apply(p, x, spec, train=True, seeds=stream)
        assert stream.count == n
        g = torch.autograd.grad(out.float().square().sum(), list(p.values()))
        return torch.cat([t.float().flatten() for t in g])

    wrappers = (patchify_fused, fused_mhsa, fused_mhsa_bwd, fused_mlp, fused_mlp_bwd)
    for w in wrappers:
        w.launches = 0
    got = grads()
    counts = [w.launches for w in wrappers]
    with _build.plain_versions():
        want = grads()
    fused = 2 if dtype == torch.bfloat16 else 0
    assert counts == [1, 2, 2, fused, fused]
    assert [w.launches for w in wrappers] == counts
    assert torch.isfinite(got).all()
    assert _rel_mae(got, want) <= {torch.float32: 1e-4, torch.bfloat16: 5e-2}[dtype]


# ------------------------------------------------ LN + linear backward (B12) ----

# (rows, dim, out): the vit-b16 B8 hybrid train step's qkv (8 x 1,008 rows),
# GAViKO vit-l16 B4's (4 x 1,040), ragged rows with a small out, vit-s16's
# qkv at B2 (GAViKO's frozen layers there), and the widths above 1,024 that
# JAX's hybrid gate admits (Queue C 11).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim,out", [(8064, 768, 2304), (4160, 1024, 3072), (74, 256, 136),
                                          (2066, 384, 1152), (300, 1152, 1152),
                                          (200, 2048, 768), (37, 1280, 768)])
@pytest.mark.parametrize("need_dw", [True, False])
def test_ln_linear_bwd_kernel(dev, dtype, rows, dim, out, need_dw):
    """B12 against its plain version, every output; a second call bit-equal
    (no atomics)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    x = _randn(gen, rows, dim, dtype=dtype, std=2.0) + 0.5
    gamma, beta = _ln_params(gen, dim, dtype)
    w = _randn(gen, out, dim, dtype=dtype, std=dim ** -0.5)
    dy = _randn(gen, rows, out, dtype=dtype, std=out ** -0.5)
    before = ln_linear_bwd.launches
    got = ln_linear_bwd(x, gamma, beta, w, dy, 1e-5, need_dw)
    assert ln_linear_bwd.launches == before + 1
    want = ln_linear_bwd_reference(x, gamma, beta, w, dy, 1e-5, need_dw)
    assert (got[3] is None) is (not need_dw)
    for name, g, wt in zip(("dx", "dgamma", "dbeta", "dw"), got, want):
        if wt is None:
            continue
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        assert _rel_mae(g, wt) <= BUDGET[dtype], name
    again = ln_linear_bwd(x, gamma, beta, w, dy, 1e-5, need_dw)
    for g, a in zip(got, again):
        if g is not None:
            assert torch.equal(g, a)


def test_fused_mlp_bwd_bit_equal_to_before_the_move(dev):
    """B7's outputs on fixed inputs are bit-equal to the redesigned kernel's
    digests, two calls agreeing (``chip_smoke.b7_digests`` and B7_DIGESTS),
    and B12's to the digests of B12 on the same GEMM
    (``chip_smoke.b12_digests`` and B12_DIGESTS), both at the 128 x 128
    tile; at the GEMM's other compiled tiles, to B7_TILE_DIGESTS and
    B12_TILE_DIGESTS."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.b7_digests() == smoke.B7_DIGESTS
    assert smoke.b12_digests() == smoke.B12_DIGESTS
    for block in smoke.TILE_DIGEST_BLOCKS:
        assert smoke.b7_digests(block) == smoke.B7_TILE_DIGESTS[block]
        assert smoke.b12_digests(block) == smoke.B12_TILE_DIGESTS[block]


# B6 and B7 at the widths of vit-s16 (384, 1,536) and vit-b16 (768, 3,072)
# and ragged row counts (GAViKO-like 37, 2,002 and vit-b16 B8's 8,064), each
# GELU mode with and without dropout, the residual on and off.
MLP_WIDTHS = [(384, 1536), (768, 3072)]
MLP_ROWS = [37, 2002, 8064]
MLP_MODES = [("exact", 0.1, True), ("exact", 0.0, False), ("tanh", 0.1, False),
             ("tanh", 0.0, True), ("erf_fast", 0.1, True), ("erf_fast", 0.0, False)]


def _check_mlp(dev, dtype, rows, dim, mlp, gelu, rate, residual, seed=21):
    """B6 (out and the saved a) and B7 (all seven outputs) against their
    plain versions within budget; a second call of each bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    args = _mlp_args(gen, 1, rows, dim, mlp, dtype)
    dy = _randn(gen, 1, rows, dim, dtype=dtype)
    before = (fused_mlp.launches, fused_mlp_bwd.launches)
    out, a = fused_mlp_forward(*args, 1e-5, gelu, rate, residual, 13, save_a=True)
    want, want_a = mlp_reference(*args, 1e-5, gelu, rate, residual, 13, save_a=True)
    got = fused_mlp_bwd(*args, dy, a, 1e-5, gelu, rate, residual, 13)
    assert (fused_mlp.launches, fused_mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
    wants = mlp_bwd_reference(*args, dy, a, 1e-5, gelu, rate, residual, 13)
    for name, g, w in (("out", out, want), ("a", a, want_a),
                       *zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), got, wants)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel_mae(g, w) <= BUDGET[dtype], (name, _rel_mae(g, w))
    again = fused_mlp_forward(*args, 1e-5, gelu, rate, residual, 13, save_a=True)
    assert torch.equal(again[0], out) and torch.equal(again[1], a)
    for g, g2 in zip(got, fused_mlp_bwd(*args, dy, a, 1e-5, gelu, rate, residual, 13)):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,mlp", MLP_WIDTHS)
@pytest.mark.parametrize("rows", MLP_ROWS)
@pytest.mark.parametrize("gelu,rate,residual", MLP_MODES)
def test_fused_mlp_kernels_at_backbone_widths(dev, dtype, dim, mlp, rows, gelu, rate, residual):
    """B6 and B7 on csrc/gemm_sm90.cuh against their plain versions at the
    vit-s16 and vit-b16 widths (vit-t16's 192 is no multiple of 128: JAX's
    gate and the plan refuse it), reruns bit-equal."""
    _check_mlp(dev, dtype, rows, dim, mlp, gelu, rate, residual)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_kernels_take_dims_above_1024(dev, dtype):
    """Queue C 9: dim 1,152 with mlp 256 (JAX's gate admits it) runs B6 and
    B7 within budget; the forward refused dims above 1,024 before. vit-t16's
    192 is refused by the plan, as by JAX's gate."""
    _check_mlp(dev, dtype, 300, 1152, 256, "exact", 0.1, True)
    args = _mlp_args(torch.Generator(device=dev).manual_seed(3), 1, 8, 192, 768, dtype)
    with pytest.raises(NotImplementedError, match="multiples of 128"):
        fused_mlp_forward(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_backward_runs_b7_on_autograd_thread(dev, dtype):
    """``fused_mlp`` under ``.backward()`` (autograd's thread, where B7
    encodes its tensor maps) at vit-b16 widths: every gradient within budget
    of the plain path's."""
    gen = torch.Generator(device=dev).manual_seed(4)
    args = _mlp_args(gen, 2, 1008, 768, 3072, dtype)
    dy = _randn(gen, 2, 1008, 768, dtype=dtype)

    def grads():
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        fused_mlp(*leaves, 1e-5, "exact", 0.1, True, seed=9).backward(dy)
        return [t.grad for t in leaves]

    before = fused_mlp_bwd.launches
    got = grads()
    assert fused_mlp_bwd.launches == before + 1
    with _build.plain_versions():
        want = grads()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel_mae(g, w) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hybrid", [False, True])
def test_ln_linear_backward_runs_b12_on_autograd_thread(dev, dtype, hybrid):
    """``fused_ln_linear`` and ``ln_linear_hybrid`` under ``.backward()``
    (autograd's thread, where B12 encodes its tensor maps) at vit-b16 B2
    widths: B12 once, every gradient within budget of the plain path's."""
    from gaviko_tpu_torch.ops.ln_linear import ln_linear_hybrid

    gen = torch.Generator(device=dev).manual_seed(14)
    x = _randn(gen, 2, 1008, 768, dtype=dtype, std=2.0) + 0.5
    gamma, beta = _ln_params(gen, 768, dtype)
    w = _randn(gen, 2304, 768, dtype=dtype, std=768 ** -0.5)
    dy = _randn(gen, 2, 1008, 2304, dtype=dtype, std=2304 ** -0.5)
    fn = ln_linear_hybrid if hybrid else fused_ln_linear

    def grads():
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, gamma, beta, w)]
        fn(*leaves).backward(dy)
        return [t.grad for t in leaves]

    before = ln_linear_bwd.launches
    got = grads()
    assert ln_linear_bwd.launches == before + 1
    with _build.plain_versions():
        want = grads()
    for g, wt in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel_mae(g, wt) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hybrid_vit_s16_fft_step_runs_b12(dev, dtype, monkeypatch):
    """With GAVIKO_LNQKV_HYBRID=1 the vit-s16 fft train step (depth 3, B2,
    dropout 0.1) takes the hybrid qkv in each full layer: B12 once a full
    layer, A and B on the packed qkv; the gradients of every tensor match
    the plain versions' (1e-4 / 5e-2 relative MAE)."""
    import dataclasses

    monkeypatch.setenv("GAVIKO_LNQKV_HYBRID", "1")
    cfg = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-s16", method="fft",
               dropout=0.1, emb_dropout=0.1)
    model = build_model(cfg)
    spec = dataclasses.replace(model.spec, depth=3)
    params = {k: v.to(dev, dtype) for k, v in
              model.init(torch.Generator().manual_seed(0), spec).items()}
    x = torch.rand(2, 1, 24, 32, 32, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    n = 1 + 3 * 2 + 4  # the fused MLP's gate holds at vit-s16 in both dtypes
    seeds = [int(s) for s in torch.randint(-2 ** 31, 2 ** 31, (n,),
                                           generator=torch.Generator().manual_seed(2))]

    def grads():
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        stream = SeedStream(seeds)
        out = model.apply(p, x, spec, train=True, seeds=stream)
        assert stream.count == n
        g = torch.autograd.grad(out.float().square().sum(), list(p.values()))
        return torch.cat([t.float().flatten() for t in g])

    wrappers = (ln_linear_bwd, fused_ln_linear, fused_mhsa, fused_mhsa_bwd)
    for w in wrappers:
        w.launches = 0
    got = grads()
    counts = [w.launches for w in wrappers]
    with _build.plain_versions():
        want = grads()
    assert counts == [2, 0, 2, 2]
    assert [w.launches for w in wrappers] == counts
    assert torch.isfinite(got).all()
    assert _rel_mae(got, want) <= {torch.float32: 1e-4, torch.bfloat16: 5e-2}[dtype]


# ----------------------- flash attention (B10) and head dim 128 (A, B, B8) ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,N,D", [
    (8, 3, 1001, 64), (1, 1, 2353, 32), (2, 2, 130, 128), (3, 1, 1, 64), (2, 3, 77, 32),
])
def test_flash_attention_kernel(dev, dtype, B, H, N, D):
    """B10 against its plain version: vit-t16's serving shape, a stream
    longer than 2048, head dims 32 and 128, one row, tiles cut by N."""
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (_randn(gen, B, H, N, D, dtype=dtype) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, D ** -0.5)
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert _rel_mae(got, flash_attention_reference(q, k, v, D ** -0.5)) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_packed_heads_and_takes_a_gradient(dev, dtype):
    """B10 on the head views of a packed qkv sliced to n_true rows (no
    copy), and its gradient: the rematerialised plain version's VJP."""
    gen = torch.Generator(device=dev).manual_seed(14)
    B, n_pad, n_true, H, D = 2, 48, 45, 3, 64
    qkv = _randn(gen, B, n_pad, 3 * H * D, dtype=dtype).requires_grad_(True)
    g = _randn(gen, B, H, n_true, D, dtype=dtype)

    def grads():
        q, k, v = (t[:, :, :n_true] for t in _split_heads(qkv, H, D))
        out = flash_attention(q, k, v, 0.125)
        (dqkv,) = torch.autograd.grad(out, qkv, g)
        return out, dqkv

    before = flash_attention.launches
    out, dqkv = grads()
    assert flash_attention.launches == before + 1
    with _build.plain_versions():
        want, want_d = grads()
    assert _rel_mae(out, want) <= BUDGET[dtype]
    assert _rel_mae(dqkv, want_d) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,n_pad,n_true,rate", [
    (2, 12, 136, 130, 0.0), (1, 2, 64, 64, 0.1), (3, 2, 40, 1, 0.0), (2, 4, 72, 65, 0.1),
])
def test_fused_mhsa_kernels_at_head_dim_128(dev, dtype, B, H, n_pad, n_true, rate):
    """Kernels A (output and lse) and B at head dim 128 against their plain
    versions, dropout on and off."""
    D, seed = 128, 4242
    gen = torch.Generator(device=dev).manual_seed(15)
    qkv = _randn(gen, B, n_pad, 3 * H * D, dtype=dtype)
    dout = _randn(gen, B, n_pad, H * D, dtype=dtype)
    dout[:, n_true:] = 0
    before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
    out, lse = fused_mhsa(qkv, H, D, D ** -0.5, n_true, rate, with_lse=True, seed=seed)
    dqkv = fused_mhsa_bwd(qkv, out, lse, dout, H, D, D ** -0.5, n_true, rate, seed)
    assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    want, want_lse = mhsa_reference(qkv, H, D, D ** -0.5, n_true, rate, with_lse=True,
                                    seed=seed)
    assert _rel_mae(out[:, :n_true], want[:, :n_true]) <= BUDGET[dtype]
    assert float((lse - want_lse).abs().max()) <= (1e-4 if dtype == torch.float32 else 0.1)
    dwant = mhsa_bwd_reference(qkv, out, lse, dout, H, D, D ** -0.5, n_true, rate, seed)
    assert torch.isfinite(dqkv).all()
    assert torch.all(dqkv[:, n_true:] == 0)
    assert _rel_mae(dqkv, dwant) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,n_true", [(8, 1008, 12, 1001), (3, 40, 2, 1), (2, 64, 4, 57)])
def test_cls_attention_kernel_at_head_dim_128(dev, dtype, B, N, H, n_true):
    gen = torch.Generator(device=dev).manual_seed(16)
    kv = _randn(gen, B, N, 2 * H * 128, dtype=dtype)
    q0 = _randn(gen, B, H * 128, dtype=dtype)
    before = cls_attention.launches
    got = cls_attention(kv, q0, H, 128, 128 ** -0.5, n_true)
    assert cls_attention.launches == before + 1
    want = cls_attention_reference(kv, q0, H, 128, 128 ** -0.5, n_true)
    assert torch.isfinite(got).all() and _rel_mae(got, want) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_pad", [40, 37])
def test_fused_mhsa_packed_qkv_vjp_runs_kernels_a_and_b(dev, dtype, n_pad):
    """The gradient of fused_mhsa on a packed qkv (head dims 64 and 128,
    dropout 0.1; 37 rows is the length a training stream pads from) is
    kernel B's, against the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(17)
    for D in (64, 128):
        qkv = _randn(gen, 2, n_pad, 3 * 2 * D, dtype=dtype).requires_grad_(True)
        g = _randn(gen, 2, n_pad, 2 * D, dtype=dtype)
        before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
        (got,) = torch.autograd.grad(fused_mhsa(qkv, 2, D, D ** -0.5, 35, 0.1, seed=8), qkv, g)
        assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == \
            (before[0] + 1, before[1] + 1)
        with _build.plain_versions():
            (want,) = torch.autograd.grad(fused_mhsa(qkv, 2, D, D ** -0.5, 35, 0.1, seed=8),
                                          qkv, g)
        assert _rel_mae(got, want) <= BUDGET[dtype]


@pytest.mark.parametrize("backbone,dim_head,heads", [("vit-t16", 64, 3), ("vit-s16", 128, 2)])
def test_vit_t16_and_dim_head_128_forward_and_step_run_the_kernels(dev, backbone, dim_head,
                                                                    heads):
    """vit-t16 (3 heads: B10 in every full layer) and a dim_head-128 ViT (A
    and B at 128, B8 at 128 in the last layer) in bf16: the serving
    forward's launches and logits, and one train step's gradients with
    dropout 0.1, against the plain versions."""
    import dataclasses

    cfg = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone=backbone, method="fft",
               dim_head=dim_head, dropout=0.1, emb_dropout=0.1)
    model = build_model(cfg)
    spec = dataclasses.replace(model.spec, heads=heads, depth=3)
    params = {k: v.to(dev, torch.bfloat16) for k, v in
              model.init(torch.Generator().manual_seed(0), spec).items()}
    x = torch.rand(2, 1, 24, 32, 32, generator=torch.Generator().manual_seed(1)).to(
        dev, torch.bfloat16)
    wrappers = (flash_attention, fused_mhsa, fused_mhsa_bwd, cls_attention)
    for w in wrappers:
        w.launches = 0
    with torch.inference_mode():
        got = model.apply(params, x, spec)
        counts = [w.launches for w in wrappers]
        with _build.plain_versions():
            want = model.apply(params, x, spec)
    t16 = backbone == "vit-t16"
    assert counts == ([2, 0, 0, 0] if t16 else [0, 2, 0, 1])
    assert _rel_mae(got, want) <= 2e-2

    def grads():
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = model.apply(p, x, spec, train=True, seeds=SeedStream(range(1, 64)))
        return torch.cat([g.float().flatten() for g in
                          torch.autograd.grad(out.float().square().sum(), list(p.values()))])

    for w in wrappers:
        w.launches = 0
    got = grads()
    counts = [w.launches for w in wrappers]
    with _build.plain_versions():
        want = grads()
    assert counts == ([0, 0, 0, 0] if t16 else [0, 2, 2, 0])  # vit-t16: dropout's route
    assert torch.isfinite(got).all()
    assert torch.nn.functional.cosine_similarity(got, want, dim=0) >= 0.99


# ------------------------------------- head dims 192 and 256 (A, B, B8, B10) ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("B,H,n_pad,n_true,rate", [
    (2, 4, 136, 130, 0.0), (1, 2, 64, 64, 0.1), (3, 2, 40, 1, 0.0), (2, 2, 72, 65, 0.1),
])
def test_fused_mhsa_kernels_at_head_dims_192_and_256(dev, dtype, D, B, H, n_pad, n_true, rate):
    """Kernels A (output and lse) and B at head dims 192 and 256 against
    their plain versions, dropout on and off."""
    seed = 4243
    gen = torch.Generator(device=dev).manual_seed(18)
    qkv = _randn(gen, B, n_pad, 3 * H * D, dtype=dtype)
    dout = _randn(gen, B, n_pad, H * D, dtype=dtype)
    dout[:, n_true:] = 0
    before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
    out, lse = fused_mhsa(qkv, H, D, D ** -0.5, n_true, rate, with_lse=True, seed=seed)
    dqkv = fused_mhsa_bwd(qkv, out, lse, dout, H, D, D ** -0.5, n_true, rate, seed)
    assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    want, want_lse = mhsa_reference(qkv, H, D, D ** -0.5, n_true, rate, with_lse=True,
                                    seed=seed)
    assert _rel_mae(out[:, :n_true], want[:, :n_true]) <= BUDGET[dtype]
    assert float((lse - want_lse).abs().max()) <= (1e-4 if dtype == torch.float32 else 0.1)
    dwant = mhsa_bwd_reference(qkv, out, lse, dout, H, D, D ** -0.5, n_true, rate, seed)
    assert torch.isfinite(dqkv).all()
    assert torch.all(dqkv[:, n_true:] == 0)
    assert _rel_mae(dqkv, dwant) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("B,N,H,n_true", [(8, 1008, 12, 1001), (3, 40, 2, 1), (2, 64, 4, 57)])
def test_cls_attention_kernel_at_head_dims_192_and_256(dev, dtype, D, B, N, H, n_true):
    gen = torch.Generator(device=dev).manual_seed(19)
    kv = _randn(gen, B, N, 2 * H * D, dtype=dtype)
    q0 = _randn(gen, B, H * D, dtype=dtype)
    before = cls_attention.launches
    got = cls_attention(kv, q0, H, D, D ** -0.5, n_true)
    assert cls_attention.launches == before + 1
    want = cls_attention_reference(kv, q0, H, D, D ** -0.5, n_true)
    assert torch.isfinite(got).all() and _rel_mae(got, want) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [192, 256, 48, 96, 200])
def test_flash_attention_kernel_at_any_head_dim_up_to_256(dev, dtype, D):
    """B10 at its new instances (192, 256) and at head dims it is not
    compiled for, zero-padded to the next one (48 -> 64, 96 -> 128, 200 ->
    256), forward and gradient against the plain version; and at 264, the
    general instance."""
    gen = torch.Generator(device=dev).manual_seed(20)
    q, k, v = (_randn(gen, 2, 3, 77, D, dtype=dtype).requires_grad_(True) for _ in range(3))
    g = _randn(gen, 2, 3, 77, D, dtype=dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, D ** -0.5)
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    dgot = torch.autograd.grad(got, (q, k, v), g)
    with _build.plain_versions():
        want = flash_attention(q, k, v, D ** -0.5)
        dwant = torch.autograd.grad(want, (q, k, v), g)
    assert _rel_mae(got, want) <= BUDGET[dtype]
    for a, b in zip(dgot, dwant):
        assert _rel_mae(a, b) <= BUDGET[dtype]
    # Above 256 the general instance runs (it raised here before ROADMAP
    # Queue C item 4 was repaired).
    wide = [t.detach()[..., :1].expand(2, 3, 77, 264).contiguous() for t in (q, k, v)]
    got = flash_attention(*wide, 0.1)
    assert _rel_mae(got, flash_attention_reference(*wide, 0.1)) <= BUDGET[dtype]


# ----------------------------- head dims of the general instances ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [320, 512])
@pytest.mark.parametrize("B,H,n_pad,n_true,rate", [
    (2, 2, 136, 130, 0.0), (1, 2, 64, 64, 0.1), (3, 2, 40, 1, 0.0), (2, 4, 72, 65, 0.1),
])
def test_fused_mhsa_kernels_at_general_head_dims(dev, dtype, D, B, H, n_pad, n_true, rate):
    """Kernels A (output and lse) and B at head dims 320 and 512, which
    JAX's fused gate admits and only the general instances take, against
    their plain versions, dropout on and off."""
    seed = 5353
    gen = torch.Generator(device=dev).manual_seed(22)
    qkv = _randn(gen, B, n_pad, 3 * H * D, dtype=dtype)
    dout = _randn(gen, B, n_pad, H * D, dtype=dtype)
    dout[:, n_true:] = 0
    before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
    out, lse = fused_mhsa(qkv, H, D, D ** -0.5, n_true, rate, with_lse=True, seed=seed)
    dqkv = fused_mhsa_bwd(qkv, out, lse, dout, H, D, D ** -0.5, n_true, rate, seed)
    assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    want, want_lse = mhsa_reference(qkv, H, D, D ** -0.5, n_true, rate, with_lse=True,
                                    seed=seed)
    assert _rel_mae(out[:, :n_true], want[:, :n_true]) <= BUDGET[dtype]
    assert float((lse - want_lse).abs().max()) <= (1e-4 if dtype == torch.float32 else 0.1)
    dwant = mhsa_bwd_reference(qkv, out, lse, dout, H, D, D ** -0.5, n_true, rate, seed)
    assert torch.isfinite(dqkv).all()
    assert torch.all(dqkv[:, n_true:] == 0)
    assert _rel_mae(dqkv, dwant) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H", [(96, 4), (320, 2), (160, 4)])
@pytest.mark.parametrize("B,N,n_true", [(8, 1008, 1001), (3, 40, 1)])
def test_cls_attention_kernel_at_general_head_dims(dev, dtype, D, H, B, N, n_true):
    """B8's general instance at head dims its gate admits (heads * dim_head
    a multiple of 128) and no specialization takes."""
    gen = torch.Generator(device=dev).manual_seed(23)
    kv = _randn(gen, B, N, 2 * H * D, dtype=dtype)
    q0 = _randn(gen, B, H * D, dtype=dtype)
    before = cls_attention.launches
    got = cls_attention(kv, q0, H, D, D ** -0.5, n_true)
    assert cls_attention.launches == before + 1
    want = cls_attention_reference(kv, q0, H, D, D ** -0.5, n_true)
    assert torch.isfinite(got).all() and _rel_mae(got, want) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [320, 512])
def test_flash_attention_kernel_at_general_head_dims(dev, dtype, D):
    """B10's general instance on the head views of a packed projection
    (strided, in place), forward and gradient against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(24)
    qkv = _randn(gen, 2, 77, 3 * 3 * D, dtype=dtype).requires_grad_(True)
    q, k, v = _split_heads(qkv, 3, D)
    g = _randn(gen, 2, 3, 77, D, dtype=dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, D ** -0.5)
    assert flash_attention.launches == before + 1
    (dgot,) = torch.autograd.grad(got, qkv, g)
    with _build.plain_versions():
        want = flash_attention(q, k, v, D ** -0.5)
        (dwant,) = torch.autograd.grad(want, qkv, g)
    assert torch.isfinite(got).all() and _rel_mae(got, want) <= BUDGET[dtype]
    assert _rel_mae(dgot, dwant) <= BUDGET[dtype]


# ------------------------------------------------------ int8 (B11) ----

def _int8_linear_case(dev, dtype, rows, din, dout, seed=25):
    from gaviko_tpu_torch.ops.int8_linear import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(gen, rows, din, dtype=dtype)
    w_i8, scale = quantize_weight(_randn(gen, dout, din, dtype=dtype, std=din ** -0.5))
    bias = _randn(gen, dout, dtype=dtype, std=0.1)
    gamma = (1.0 + _randn(gen, din, dtype=torch.float32, std=0.1)).to(dtype)
    beta = _randn(gen, din, dtype=dtype, std=0.1)
    return x, w_i8, scale, bias, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,din,dout", [
    (8320, 1024, 3072),  # GAViKO vit-l16 B8 qkv
    (8320, 1024, 1024),  # its out-projection
    (1033, 1024, 3072), (264, 1024, 1024),  # one volume; the last layer's rows
    (8064, 768, 2304),  # vit-b16 B8 qkv
    (37, 192, 576), (5, 48, 10),  # ragged tiles
])
def test_int8_linear_kernel(dev, dtype, rows, din, dout):
    """B11's int8_linear against its plain version: bit-equal without LN
    (bias or none), and with LN within the budget (its sums reorder)."""
    from gaviko_tpu_torch.ops.int8_linear import int8_linear

    x, w_i8, scale, bias, gamma, beta = _int8_linear_case(dev, dtype, rows, din, dout)
    with torch.no_grad():
        for kw in ({}, {"bias": bias}, {"gamma": gamma, "beta": beta}):
            before = int8_linear.launches
            got = int8_linear(x, w_i8, scale, **kw)
            assert int8_linear.launches == before + 1
            with _build.plain_versions():
                want = int8_linear(x, w_i8, scale, **kw)
            assert got.shape == (rows, dout) and torch.isfinite(got).all()
            if "gamma" in kw:
                assert _rel_mae(got, want) <= BUDGET[dtype]
            else:
                assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim,mlp,gelu,residual", [
    (8320, 1024, 4096, "exact", False),  # GAViKO vit-l16 B8
    (264, 1024, 4096, "exact", False),  # its last layer's pooled rows
    (1033, 1024, 4096, "tanh", False),
    (8064, 768, 3072, "exact", True),  # vit-b16 B8, residual fused
    (37, 64, 256, "erf_fast", True), (5, 48, 80, "tanh", False),  # ragged tiles
])
def test_int8_mlp_kernel(dev, dtype, rows, dim, mlp, gelu, residual):
    from gaviko_tpu_torch.ops.int8_linear import int8_mlp, quantize_weight

    gen = torch.Generator(device=dev).manual_seed(26)
    x = _randn(gen, rows, dim, dtype=dtype)
    gamma = (1.0 + _randn(gen, dim, dtype=torch.float32, std=0.1)).to(dtype)
    beta = _randn(gen, dim, dtype=dtype, std=0.1)
    w1, s1 = quantize_weight(_randn(gen, mlp, dim, dtype=dtype, std=dim ** -0.5))
    w2, s2 = quantize_weight(_randn(gen, dim, mlp, dtype=dtype, std=mlp ** -0.5))
    b1, b2 = _randn(gen, mlp, dtype=dtype, std=0.1), _randn(gen, dim, dtype=dtype, std=0.1)
    args = (x, gamma, beta, w1, s1, b1, w2, s2, b2, 1e-5, gelu, residual)
    with torch.no_grad():
        before = int8_mlp.launches
        got = int8_mlp(*args)
        assert int8_mlp.launches == before + 1
        with _build.plain_versions():
            want = int8_mlp(*args)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _rel_mae(got, want) <= BUDGET[dtype]


def _int8_mlp_case(dev, dtype, rows, dim, mlp, seed=26):
    from gaviko_tpu_torch.ops.int8_linear import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(gen, rows, dim, dtype=dtype)
    gamma = (1.0 + _randn(gen, dim, dtype=torch.float32, std=0.1)).to(dtype)
    beta = _randn(gen, dim, dtype=dtype, std=0.1)
    w1, s1 = quantize_weight(_randn(gen, mlp, dim, dtype=dtype, std=dim ** -0.5))
    w2, s2 = quantize_weight(_randn(gen, dim, mlp, dtype=dtype, std=mlp ** -0.5))
    b1, b2 = _randn(gen, mlp, dtype=dtype, std=0.1), _randn(gen, dim, dtype=dtype, std=0.1)
    return x, gamma, beta, w1, s1, b1, w2, s2, b2


def _int8_against_plain(dtype, fn, *args, bit_equal=False, **kw):
    """One call of B11's wrapper ``fn`` against its plain version: finite,
    a rerun bit-equal to the first run, and bit-equal to the plain version
    (no LN) or within the budget."""
    with torch.no_grad():
        before = fn.launches
        got = fn(*args, **kw)
        again = fn(*args, **kw)
        assert fn.launches == before + 2
        with _build.plain_versions():
            want = fn(*args, **kw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    if bit_equal:
        assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    else:
        assert _rel_mae(got, want) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,din,dout", [
    (1040, 2304, 768),  # vit-b16 at dim_head 192: the out-projection
    (1040, 3072, 768),  # vit-b16 at dim_head 256
    (1040, 3072, 1024),  # vit-l16 at dim_head 192
    (264, 4096, 1024),  # vit-l16 at dim_head 256, the last layer's rows
])
def test_int8_linear_takes_out_projections_above_2048(dev, dtype, rows, din, dout):
    """Queue C 10: out-projections whose in-width passes 2,048, which JAX's
    int8_linear serves and the row-in-registers prologue refused: with the
    bias bit-equal to the plain version, with LN within the budget, reruns
    bit-equal."""
    from gaviko_tpu_torch.ops.int8_linear import int8_linear

    x, w_i8, scale, bias, gamma, beta = _int8_linear_case(dev, dtype, rows, din, dout)
    _int8_against_plain(dtype, int8_linear, x, w_i8, scale, bias=bias, bit_equal=True)
    _int8_against_plain(dtype, int8_linear, x, w_i8, scale, gamma=gamma, beta=beta)


INT8_BACKBONES = {"vit-s16": (384, 1536), "vit-b16": (768, 3072), "vit-l16": (1024, 4096)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backbone", list(INT8_BACKBONES))
@pytest.mark.parametrize("rows", [264, 1033, 8320])  # the last layer's rows, a volume, B8
def test_int8_kernels_at_backbone_widths(dev, dtype, backbone, rows):
    """B11 at a backbone's widths: the qkv projection with its LN, the
    out-projection with its bias (bit-equal) and without, and the MLP in
    every GELU mode with the residual and without, each against its plain
    version with reruns bit-equal."""
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp

    dim, mlp = INT8_BACKBONES[backbone]
    x, w_qkv, s_qkv, _, gamma, beta = _int8_linear_case(dev, dtype, rows, dim, 3 * dim)
    _int8_against_plain(dtype, int8_linear, x, w_qkv, s_qkv, gamma=gamma, beta=beta)
    x, w_out, s_out, bias, _, _ = _int8_linear_case(dev, dtype, rows, dim, dim, seed=27)
    _int8_against_plain(dtype, int8_linear, x, w_out, s_out, bias=bias, bit_equal=True)
    _int8_against_plain(dtype, int8_linear, x, w_out, s_out, bit_equal=True)
    args = _int8_mlp_case(dev, dtype, rows, dim, mlp)
    for gelu in ("exact", "tanh", "erf_fast"):
        for residual in (False, True):
            _int8_against_plain(dtype, int8_mlp, *args, 1e-5, gelu, residual)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim,inner,mlp", [
    (37, 60, 60, 100),  # 3 heads x 20, an MLP of 100
    (130, 200, 60, 520),
    (5, 7, 21, 9),  # widths under one vector
])
def test_int8_kernels_take_widths_not_multiples_of_16(dev, dtype, rows, dim, inner, mlp):
    """Widths that are no multiple of 16, as JAX takes them: the row pass
    pads the codes, the sidecars take one zero-padded copy each (made once,
    then reused), the last column tile is masked. The qkv projection (dim
    -> 3 inner) with LN, the out-projection (inner -> dim) with its bias
    bit-equal, and the MLP, against the plain versions."""
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp, int8_plan, padded_codes

    x, w_qkv, s_qkv, _, gamma, beta = _int8_linear_case(dev, dtype, rows, dim, 3 * inner)
    _int8_against_plain(dtype, int8_linear, x, w_qkv, s_qkv, gamma=gamma, beta=beta)
    o, w_out, s_out, bias, _, _ = _int8_linear_case(dev, dtype, rows, inner, dim, seed=27)
    _int8_against_plain(dtype, int8_linear, o, w_out, s_out, bias=bias, bit_equal=True)
    k_pad = int8_plan("linear", rows, inner, dim, dtype).k_pad
    assert padded_codes(w_out, k_pad) is padded_codes(w_out, k_pad)
    args = _int8_mlp_case(dev, dtype, rows, dim, mlp)
    for residual in (False, True):
        _int8_against_plain(dtype, int8_mlp, *args, 1e-5, "exact", residual)


def test_int8_predictor_serves_vit_b16_at_dim_head_192(dev):
    """Queue C 10 end to end: vit-b16 with ``model.dim_head: 192`` (its
    out-projections 2,304 -> 768) served by ``Predictor(quantize="int8")``
    at bf16: every layer runs B11 (2 int8_linear and 1 int8_mlp), and the
    logits agree with the plain versions' within 2e-2 (the vit-b16 int8
    serving budget)."""
    from gaviko_tpu_torch.config import apply_method_override, load_config
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp
    from gaviko_tpu_torch.serving import Predictor

    config = apply_method_override(load_config("gaviko_tpu_torch/configs/vit.yaml"), "fft")
    config["model"]["dim_head"] = 192
    predictor = Predictor(config, batch_size=2, dtype="bfloat16", pretrained_dir=None,
                          quantize="int8", device="cuda")
    rng = np.random.RandomState(0)
    vols = [rng.rand(120, 160, 160).astype(np.float32) for _ in range(2)]
    before = (int8_linear.launches, int8_mlp.launches)
    got = predictor.predict_logits(vols)
    depth = predictor.spec.depth
    assert (int8_linear.launches - before[0], int8_mlp.launches - before[1]) == (2 * depth, depth)
    with _build.plain_versions():
        want = predictor.predict_logits(vols)
    assert got.shape == (2, 5) and np.isfinite(got).all()
    assert float(np.abs(got - want).mean() / np.abs(want).mean()) <= 2e-2


def test_int8_wrappers_refuse_a_gradient_on_the_card(dev):
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp, quantize_weight

    x, w_i8, scale, bias, gamma, beta = _int8_linear_case(dev, torch.float32, 8, 64, 32)
    w2, s2 = quantize_weight(torch.randn(64, 32, device=dev))
    for leaf in (x, bias, gamma):
        t = leaf.detach().requires_grad_(True)
        args = {"x": x, "bias": bias, "gamma": gamma, "beta": beta}
        args["x" if leaf is x else "bias" if leaf is bias else "gamma"] = t
        with pytest.raises(NotImplementedError, match="serving-only"):
            int8_linear(args["x"], w_i8, scale, bias=args["bias"], gamma=args["gamma"],
                        beta=args["beta"])
    with pytest.raises(NotImplementedError, match="serving-only"):
        int8_mlp(x.detach().requires_grad_(True), torch.ones(64, device=dev),
                 torch.zeros(64, device=dev), w_i8, scale, torch.zeros(32, device=dev), w2, s2,
                 torch.zeros(64, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["gaviko", "fft"])
def test_int8_forward_runs_the_int8_kernels(dev, method, dtype):
    """A quantized model's forward on the card: every layer's qkv,
    out-projection and MLP launch B11 (3 launches a layer; the plain ViT's
    CLS-fast last layer defers to them), and the logits agree with the
    plain versions' within JAX's own int8 budget of 5e-2 relative MAE. An
    activation that differs in its last places (sums in other orders; in
    bf16 the fp kernels and their plain versions also round at other
    points) moves a code where it sits on a rounding boundary, and this
    tiny random-init GAViKO carries that through every later layer: on an
    H100 its forward read 1.2e-2 in fp32 and 3.4e-2 in bf16."""
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp, quantize_backbone

    cfg = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-s16", method=method,
               freeze_vit=True, num_prompts=4, prompt_latent_dim=8, local_dim=8,
               local_k=[2, 2, 2])
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), model.spec)
    params = quantize_backbone({k: v.to(dtype) if v.is_floating_point() else v
                                for k, v in params.items()})
    x = torch.rand(2, 1, 24, 32, 32, device=dev).to(dtype)
    before = (int8_linear.launches, int8_mlp.launches)
    with torch.no_grad():
        got = model.apply(params, x, model.spec)
        depth = model.spec.depth
        assert (int8_linear.launches - before[0], int8_mlp.launches - before[1]) == \
            (2 * depth, depth)
        with _build.plain_versions():
            want = model.apply(params, x, model.spec)
    assert torch.isfinite(got).all() and _rel_mae(got, want) <= 5e-2


# --------------------------------------------------- fused Adam (B13) ----

ADAM_SIZES = (1, 0, 4096, 4097, 3 * 4096, 37, 1000, 8192 + 5)  # one, empty, whole and cut chunks


def _adam_leaves(dev, dtype, sizes, grad_std, seed=21):
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = [_randn(gen, n, dtype=dtype, std=grad_std) for n in sizes]
    mu = [_randn(gen, n, dtype=dtype, std=0.01) for n in sizes]
    nu = [(_randn(gen, n, dtype=torch.float32, std=0.01) ** 2).to(dtype) for n in sizes]
    params = [_randn(gen, n, dtype=dtype) for n in sizes]
    return grads, mu, nu, params


def _ulps(got, want, mag=None):
    """|got - want| in units in the last place, in want's dtype (24
    significant bits in f32, 8 in bf16), of ``mag``: the largest term of the
    sum that made want (want itself by default), since m' = b1 m + (1 - b1)
    g and p' = p - lr u can cancel."""
    if not want.numel():
        return 0.0
    bits = 24 if want.dtype == torch.float32 else 8
    ref = want.double().abs() if mag is None else torch.maximum(want.double().abs(), mag)
    _, exp = torch.frexp(ref)
    gap = torch.pow(2.0, (exp - bits).double())
    return float(((got.double() - want.double()).abs() / gap).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_std", [1e-4, 1.0])  # clip off (gn < 1), clip on
def test_fused_adam_kernel(dev, dtype, grad_std):
    """B13 against its plain version: every output within 2 ULP of f32 (1
    ULP of bf16 under bf16 storage), two runs bit-equal, one B13 launch (one
    kernel here, or its norm and update kernels) a step, and no host sync in
    the step."""
    from gaviko_tpu_torch.ops.fused_adam import adam_reference, fused_adam, global_norm

    grads, mu, nu, params = _adam_leaves(dev, dtype, ADAM_SIZES, grad_std)
    assert (float(global_norm(grads)) < 1.0) == (grad_std < 1e-2)
    scalars = (3e-4, 0.93, 0.1351, 0.00299)
    want = adam_reference(grads, mu, nu, params, *scalars, clip=1.0, eps=1e-8)
    runs = []
    for _ in range(2):
        state = [[t.clone() for t in ts] for ts in (mu, nu, params)]
        before = fused_adam.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got_p, got_m, got_v = fused_adam(grads, *state, *scalars, clip=1.0, eps=1e-8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert fused_adam.launches == before + 1
        assert all(a is b for a, b in zip(got_p, state[2]))  # in place
        runs.append((got_p, got_m, got_v))
    ulp_budget = 2 if dtype == torch.float32 else 1
    b1 = scalars[1]
    for i in range(len(ADAM_SIZES)):
        mags = ((params[i].double() - want[0][i].double()).abs().maximum(params[i].double().abs()),
                (b1 * mu[i].double()).abs().maximum(((1 - b1) * grads[i].double()).abs()),
                None)
        for got, ref, mag in zip(runs[0], want, mags):
            assert _ulps(got[i], ref[i], mag) <= ulp_budget
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _same_phase_copy(t):
    skip = (t.data_ptr() % 16) // t.element_size()
    out = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)[skip:skip + t.numel()]
    return out.view(t.shape).copy_(t)


def _offset_leaves(dev, dtype, sizes, layout, grad_std, seed=23):
    """(grads, mu, nu, params) as views of one buffer each: "aligned" at
    16-byte offsets, "unaligned" every leaf's four at one odd element offset
    (16-byte vectors after a scalar head), "mixed" every other leaf's grad
    one element off its moments and param (element by element)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    starts = [0]
    for n in sizes[:-1]:  # each leaf at a multiple of 16 elements, one spare between
        starts.append(-(-(starts[-1] + n + 1) // 16) * 16)
    out = []
    for which, std in enumerate((grad_std, 0.01, 0.01, 1.0)):
        buf = _randn(gen, starts[-1] + sizes[-1] + 16, dtype=dtype, std=std)
        if which == 2:
            buf = (buf.float() ** 2).to(dtype)
        leaves = []
        for i, (at, n) in enumerate(zip(starts, sizes)):
            shift = {"aligned": 0, "unaligned": 1,
                     "mixed": int(which == 0 and i % 2 == 1)}[layout]
            leaves.append(buf[at + shift:at + shift + n])
        out.append(leaves)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["aligned", "unaligned", "mixed"])
@pytest.mark.parametrize("one_pass", [True, False])
def test_fused_adam_kernel_bit_equal_on_any_alignment(dev, monkeypatch, dtype, layout, one_pass):
    """B13's vector and element paths, in one launch and in two (the
    threshold moved to force the second), against its plain version bit
    for bit (0 ULP), clipping on, and reruns bit-equal."""
    from gaviko_tpu_torch.ops import fused_adam as fa

    monkeypatch.setattr(fa, "ONE_PASS_BYTES", fa.ONE_PASS_BYTES if one_pass else 0)
    grads, mu, nu, params = _offset_leaves(dev, dtype, ADAM_SIZES, layout, 1.0)
    table = fa.AdamTable(mu, nu, params)
    assert table.one_pass == one_pass
    # moments and params share a phase: 0, or one element in ("unaligned")
    held = [i for i, n in enumerate(ADAM_SIZES) if n]  # an empty leaf has no phase of note
    assert (table.phases[held] == (mu[0].element_size() if layout == "unaligned" else 0)).all()
    scalars = (3e-4, 0.93, 0.1351, 0.00299)
    want = fa.adam_reference(grads, mu, nu, params, *scalars, clip=1.0, eps=1e-8)
    runs = []
    for _ in range(2):
        # copies at the leaves' offsets (a clone would start aligned)
        state = [[_same_phase_copy(t) for t in ts] for ts in (mu, nu, params)]
        assert (fa.leaf_phases(*state)[held] == table.phases[held]).all()
        got = fa.fused_adam(grads, *state, *scalars, clip=1.0, eps=1e-8)
        runs.append(got)
    for got, ref in zip(runs[0], want):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_fused_optim_step_runs_b13_and_matches_the_plain_step(dev):
    """fused_optim.step on CUDA tensors launches B13 (no per-leaf chain),
    builds the kernel's table of leaves at the first step only, and agrees
    with the plain step from a carried state, at a cycled b1."""
    from gaviko_tpu_torch.ops.fused_adam import fused_adam
    from gaviko_tpu_torch.train import fused_optim, schedule

    gen = torch.Generator(device=dev).manual_seed(22)
    shapes = {"w": (33, 17), "b": (17,), "one": (1,), "big": (3, 4096)}
    params = {k: _randn(gen, *s, dtype=torch.float32) for k, s in shapes.items()}
    sched, b1 = schedule.onecycle_cos(3e-4, 10), schedule.onecycle_beta1(10)
    state = fused_optim.init(params)
    plain_p, plain_state = {k: v.clone() for k, v in params.items()}, fused_optim.init(params)
    tables = []
    for _ in range(3):
        grads = {k: _randn(gen, *s, dtype=torch.float32) for k, s in shapes.items()}
        before = fused_adam.launches
        params, state = fused_optim.step(grads, state, params, sched, b1=b1)
        assert fused_adam.launches == before + 1
        tables.append(state.mu.table)
        with _build.plain_versions():
            plain_p, plain_state = fused_optim.step(grads, plain_state, plain_p, sched, b1=b1)
    assert state.count == plain_state.count == 3
    assert tables[0] is not None and all(t is tables[0] for t in tables)
    for k in shapes:
        torch.testing.assert_close(params[k], plain_p[k], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(state.mu[k], plain_state.mu[k], rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(state.nu[k], plain_state.nu[k], rtol=1e-6, atol=1e-12)


# ------------------ the forward tile of A and B10 (csrc/attention_fwd.cuh) ----

TILE_DIMS = [64, 128, 192, 256, 320, 384, 512, 1024]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [36, 96] + TILE_DIMS)
@pytest.mark.parametrize("n_pad,n_true", [(1008, 1001), (1040, 1033), (8, 7)])
def test_fused_mhsa_forward_tile_at_every_instance(dev, dtype, D, n_pad, n_true):
    """Kernel A at every instance of the shared forward tile (64 to 256
    compiled, above that the general one; 96 on the 128-column tile, its
    missing columns read as zeros; 36, whose head columns are not whole 16
    bytes, on a copy padded to 40), ragged n_true, dropout 0.1:
    output and lse against the plain version (whose mask is the hash's, so a
    wrong bit shows), a rerun bit-equal, one launch a call, and kernel B's
    packed dqkv, which replays the mask from the seed and reads A's lse,
    against its plain version."""
    H, seed, scale = 2, 31, D ** -0.5
    gen = torch.Generator(device=dev).manual_seed(26)
    qkv = _randn(gen, 1, n_pad, 3 * H * D, dtype=dtype)
    dout = _randn(gen, 1, n_pad, H * D, dtype=dtype)
    dout[:, n_true:] = 0
    before = fused_mhsa.launches
    out, lse = fused_mhsa(qkv, H, D, scale, n_true, 0.1, with_lse=True, seed=seed)
    again = fused_mhsa(qkv, H, D, scale, n_true, 0.1, with_lse=True, seed=seed)
    assert fused_mhsa.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    want, want_lse = mhsa_reference(qkv, H, D, scale, n_true, 0.1, with_lse=True, seed=seed)
    assert torch.isfinite(out[:, :n_true]).all()
    assert _rel_mae(out[:, :n_true], want[:, :n_true]) <= BUDGET[dtype]
    lse_err = float((lse[..., :n_true] - want_lse[..., :n_true]).abs().max())
    assert lse_err <= (1e-4 if dtype == torch.float32 else 0.1)
    dqkv = fused_mhsa_bwd(qkv, out, lse, dout, H, D, scale, n_true, 0.1, seed)
    dwant = mhsa_bwd_reference(qkv, out, lse, dout, H, D, scale, n_true, 0.1, seed)
    assert torch.isfinite(dqkv).all() and _rel_mae(dqkv, dwant) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 96, 263] + TILE_DIMS)
@pytest.mark.parametrize("n_pad,n_true", [(1008, 1001), (8, 7)])
def test_flash_attention_forward_tile_at_every_instance(dev, dtype, D, n_pad, n_true):
    """Kernel B10 at every instance of the shared forward tile and at head
    dims between them (32 and 96 on the tiles of 64 and 128, their missing
    columns read as zeros; 263, whose rows are not whole 16 bytes, padded
    to 264), on the head views of a packed projection sliced to the real
    rows (strided, read in place): against the plain version, a rerun
    bit-equal, one launch a call."""
    H = 3
    gen = torch.Generator(device=dev).manual_seed(27)
    qkv = _randn(gen, 2, n_pad, 3 * H * D, dtype=dtype)
    q, k, v = (t[:, :, :n_true] for t in _split_heads(qkv, H, D))
    before = flash_attention.launches
    got = flash_attention(q, k, v, D ** -0.5)
    again = flash_attention(q, k, v, D ** -0.5)
    assert flash_attention.launches == before + 2
    assert got.shape == q.shape and torch.isfinite(got).all() and torch.equal(got, again)
    assert _rel_mae(got, flash_attention_reference(q, k, v, D ** -0.5)) <= BUDGET[dtype]


# ---------------- head dims above 1280 (Q streamed), B's and B8's redesign ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_tile_streams_q_at_head_dim_1344(dev, dtype):
    """A at 16 heads of 1344 (JAX's fused gate admits it; Q's chunks do not
    fit beside the ring, so they stream through it) with dropout 0.1, and
    B10 at 1352, against their plain versions; B at 1344 replaying the
    mask against its plain version."""
    H, D, n_pad, n_true, seed = 16, 1344, 40, 33, 41
    gen = torch.Generator(device=dev).manual_seed(31)
    qkv = _randn(gen, 1, n_pad, 3 * H * D, dtype=dtype)
    dout = _randn(gen, 1, n_pad, H * D, dtype=dtype)
    dout[:, n_true:] = 0
    out, lse = fused_mhsa(qkv, H, D, D ** -0.5, n_true, 0.1, with_lse=True, seed=seed)
    want, want_lse = mhsa_reference(qkv, H, D, D ** -0.5, n_true, 0.1, with_lse=True, seed=seed)
    assert _rel_mae(out[:, :n_true], want[:, :n_true]) <= BUDGET[dtype]
    assert float((lse - want_lse).abs().max()) <= (1e-4 if dtype == torch.float32 else 0.1)
    dqkv = fused_mhsa_bwd(qkv, out, lse, dout, H, D, D ** -0.5, n_true, 0.1, seed)
    dwant = mhsa_bwd_reference(qkv, out, lse, dout, H, D, D ** -0.5, n_true, 0.1, seed)
    assert torch.isfinite(dqkv).all() and _rel_mae(dqkv, dwant) <= BUDGET[dtype]
    q, k, v = (_randn(gen, 1, 3, 77, 1352, dtype=dtype) for _ in range(3))
    got = flash_attention(q, k, v, 1352 ** -0.5)
    assert _rel_mae(got, flash_attention_reference(q, k, v, 1352 ** -0.5)) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_mhsa_bwd_reruns_bit_equal_at_gaviko_b4(dev, dtype, rate):
    """B at GAViKO vit-l16 train B4 (16 heads of 64, 1,033 rows padded to
    1,040): one launch a call, within budget of its plain version, pad keys
    getting dK = dV = 0, and a rerun bit-equal (no atomics: every sum in a
    fixed order)."""
    H, D, n_pad, n_true, seed = 16, 64, 1040, 1033, 17
    gen = torch.Generator(device=dev).manual_seed(32)
    qkv = _randn(gen, 4, n_pad, 3 * H * D, dtype=dtype)
    dout = _randn(gen, 4, n_pad, H * D, dtype=dtype)
    dout[:, n_true:] = 0
    out, lse = fused_mhsa(qkv, H, D, 0.125, n_true, rate, with_lse=True, seed=seed)
    before = fused_mhsa_bwd.launches
    dqkv = fused_mhsa_bwd(qkv, out, lse, dout, H, D, 0.125, n_true, rate, seed)
    again = fused_mhsa_bwd(qkv, out, lse, dout, H, D, 0.125, n_true, rate, seed)
    assert fused_mhsa_bwd.launches == before + 2 and torch.equal(dqkv, again)
    want = mhsa_bwd_reference(qkv, out, lse, dout, H, D, 0.125, n_true, rate, seed)
    assert torch.all(dqkv[:, n_true:, H * D:] == 0)
    assert _rel_mae(dqkv, want) <= BUDGET[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,n_true", [
    (1, 1008, 2, 64, 1001), (2, 1008, 4, 96, 999), (1, 2048, 1, 320, 2041), (3, 96, 2, 36, 95),
])
def test_cls_attention_splits_the_keys(dev, dtype, B, N, H, D, n_true):
    """B8 with several runs of keys (n_true not a multiple of the run), the
    last CTA of each (batch, head) combining them: one launch a call,
    within budget of the plain version, a rerun bit-equal (the tickets are
    zero again after each call); 36 columns take the scalar loads."""
    from gaviko_tpu_torch.ops.cls_attention import cls_plan

    splits, chunk, _ = cls_plan(B, H, n_true, D, dtype)
    assert splits > 1 and n_true % chunk
    gen = torch.Generator(device=dev).manual_seed(33)
    kv = _randn(gen, B, N, 2 * H * D, dtype=dtype)
    q0 = _randn(gen, B, H * D, dtype=dtype)
    before = cls_attention.launches
    got = cls_attention(kv, q0, H, D, D ** -0.5, n_true)
    again = cls_attention(kv, q0, H, D, D ** -0.5, n_true)
    assert cls_attention.launches == before + 2 and torch.equal(got, again)
    want = cls_attention_reference(kv, q0, H, D, D ** -0.5, n_true)
    assert torch.isfinite(got).all() and _rel_mae(got, want) <= BUDGET[dtype]


def test_kernels_launch_from_a_fresh_thread(dev):
    """A, B10 and B launch from a thread that has made no CUDA runtime call
    yet (their tensor-map encode is a driver call that needs a current
    context; ROADMAP Queue C item 7), and give there what they give on the
    main thread, bit for bit."""
    import threading

    gen = torch.Generator(device=dev).manual_seed(34)
    qkv = _randn(gen, 2, 40, 3 * 2 * 64, dtype=torch.bfloat16)
    dout = _randn(gen, 2, 40, 2 * 64, dtype=torch.bfloat16)
    q, k, v = (t[:, :, :37] for t in _split_heads(qkv, 2, 64))

    def calls():
        out, lse = fused_mhsa(qkv, 2, 64, 0.125, 37, with_lse=True)
        return (out, lse, flash_attention(q, k, v, 0.125),
                fused_mhsa_bwd(qkv, out, lse, dout, 2, 64, 0.125, 37))

    on_main = calls()
    got, errors = [], []

    def run():
        try:
            got.append(calls())
            torch.cuda.synchronize()
        except Exception as e:  # the assert below reports it
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert errors == [] and len(got) == 1
    assert all(torch.equal(a, b) for a, b in zip(got[0], on_main))


# ---- tensor-parallel shards: A and B's head offset, B6 / B7's hidden columns,
# ---- B13's norm apart from its update (parallel/mesh.py)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,heads,head0,D", [(16, 8, 8, 64), (12, 6, 6, 64), (4, 2, 2, 128)])
def test_fused_mhsa_kernels_on_a_head_shard(dev, dtype, H, heads, head0, D):
    """Kernels A and B on heads [head0, head0 + heads) of a layer of H, with
    dropout: against their plain versions, and bit-equal to the whole
    layer's kernels on those heads (every (batch, head) plane is its own)."""
    gen = torch.Generator(device=dev).manual_seed(31)
    B, n_pad, n_true = 2, 136, 130
    qkv = _randn(gen, B, n_pad, 3 * H * D, dtype=dtype)
    dout = _randn(gen, B, n_pad, H * D, dtype=dtype)
    dout[:, n_true:] = 0
    cols = torch.cat([torch.arange(head0 * D, (head0 + heads) * D, device=dev) + j * H * D
                      for j in range(3)])
    part, o = qkv[..., cols].contiguous(), slice(head0 * D, (head0 + heads) * D)
    pdout = dout[..., o].contiguous()
    kw = dict(heads_total=H, head0=head0)
    before = (fused_mhsa.launches, fused_mhsa_bwd.launches)
    out, lse = fused_mhsa(part, heads, D, D ** -0.5, n_true, 0.1, True, -515, **kw)
    dqkv = fused_mhsa_bwd(part, out, lse, pdout, heads, D, D ** -0.5, n_true, 0.1, -515, **kw)
    assert (fused_mhsa.launches, fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    want, _ = mhsa_reference(part, heads, D, D ** -0.5, n_true, 0.1, True, -515, **kw)
    assert _rel_mae(out[:, :n_true], want[:, :n_true]) <= BUDGET[dtype]
    dwant = mhsa_bwd_reference(part, out, lse, pdout, heads, D, D ** -0.5, n_true, 0.1, -515,
                               **kw)
    assert _rel_mae(dqkv, dwant) <= BUDGET[dtype]
    whole, wlse = fused_mhsa(qkv, H, D, D ** -0.5, n_true, 0.1, True, -515)
    wd = fused_mhsa_bwd(qkv, whole, wlse, dout, H, D, D ** -0.5, n_true, 0.1, -515)
    assert torch.equal(out, whole[..., o]) and torch.equal(lse, wlse[:, head0:head0 + heads])
    assert torch.equal(dqkv, wd[..., cols])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,mlp,col0", [(768, 1536, 1536), (1024, 2048, 2048)])
def test_fused_mlp_kernels_on_a_hidden_slice(dev, dtype, dim, mlp, col0):
    """B6 and B7 on hidden columns [col0, col0 + mlp) of a wider layer, with
    dropout and without the residual (a model rank > 0's call), against
    their plain versions with the same column offset."""
    gen = torch.Generator(device=dev).manual_seed(32)
    args = _mlp_args(gen, 2, 37, dim, mlp, dtype)
    dy = _randn(gen, 2, 37, dim, dtype=dtype)
    out, a = fused_mlp_forward(*args, 1e-5, "exact", 0.1, False, 9, save_a=True,
                               hidden_col0=col0)
    want, want_a = mlp_reference(*args, 1e-5, "exact", 0.1, False, 9, save_a=True,
                                 hidden_col0=col0)
    assert _rel_mae(out, want) <= BUDGET[dtype] and _rel_mae(a, want_a) <= BUDGET[dtype]
    at0 = mlp_reference(*args, 1e-5, "exact", 0.1, False, 9)
    assert _rel_mae(out, at0) > 10 * BUDGET[dtype]  # the offset moves the hidden's bits
    got = fused_mlp_bwd(*args, dy, a, 1e-5, "exact", 0.1, False, 9, col0)
    wants = mlp_bwd_reference(*args, dy, a, 1e-5, "exact", 0.1, False, 9, col0)
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), got, wants):
        assert _rel_mae(g, w) <= BUDGET[dtype], (name, _rel_mae(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("one_pass", [True, False])
def test_fused_adam_sharded_norm_bit_equal_to_one_launch(dev, monkeypatch, dtype, one_pass):
    """B13's sharded step (the norm kernel into a device scalar, a reduce
    over the ranks, then the update kernel), on one rank: bit-equal to the
    one-launch and two-launch steps (0 ULP), reruns bit-equal; the norm of a
    prefix of the leaves plus the rest's sum of squares, reduced in, within
    the budgets of a one-ULP move of the clip scale."""
    from gaviko_tpu_torch.ops import fused_adam as fa

    monkeypatch.setattr(fa, "ONE_PASS_BYTES", fa.ONE_PASS_BYTES if one_pass else 0)
    grads, mu, nu, params = _adam_leaves(dev, dtype, ADAM_SIZES, 1.0)
    scalars = (3e-4, 0.93, 0.1351, 0.00299)
    runs = []
    for reduce in (None, lambda t: None, lambda t: None):
        state = [[t.clone() for t in ts] for ts in (mu, nu, params)]
        before = fa.fused_adam.launches
        runs.append(fa.fused_adam(grads, *state, *scalars, clip=1.0, eps=1e-8,
                                  norm_reduce=reduce))
        assert fa.fused_adam.launches == before + 1
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    k = len(ADAM_SIZES) // 2
    rest = sum(g.double().square().sum() for g in grads[k:])
    state = [[t.clone() for t in ts] for ts in (mu, nu, params)]
    split = fa.fused_adam(grads, *state, *scalars, clip=1.0, eps=1e-8, n_counted=k,
                          norm_reduce=lambda t: t.add_(rest))
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-6)
    for got, ref in zip(split, runs[0]):
        for i in range(len(ADAM_SIZES)):
            torch.testing.assert_close(got[i], ref[i], **tol)


# ------------------------------------------- the GEMM's tiles (ops/_blocks.py) ----

def _tile_params():
    """(operand dtype, tile rows) of every tile compiled for bf16 and fp32."""
    from gaviko_tpu_torch.ops import _blocks

    return [(dt, bm) for dt in (torch.float32, torch.bfloat16) for bm, _ in _blocks.TILES[dt]]


def _int8_tile_rows():
    from gaviko_tpu_torch.ops import _blocks

    return [bm for bm, _ in _blocks.TILES[torch.int8]]


# Ragged rows (1,001: no multiple of any tile's rows; 70: under one 128-row
# tile) at widths whose N is no multiple of 128 where the kernel takes it.
@pytest.mark.parametrize("dtype,block", _tile_params())
@pytest.mark.parametrize("rows", [1001, 70])
def test_mlp_kernels_at_every_tile(dev, monkeypatch, dtype, block, rows):
    """B6 (dropout, save_a, the residual) and B7 (its dg launch and its
    launch of dW2, dW1 and dh) with GAVIKO_MLP_BLOCK set to each compiled
    tile: every output against the plain version, the plan's launches on
    that tile, a rerun bit-equal."""
    from gaviko_tpu_torch.ops import _blocks
    from gaviko_tpu_torch.ops.fused_mlp import mlp_plan

    monkeypatch.setenv(_blocks.MLP_ENV, str(block))
    dim, mlp = 384, 1536
    plan = mlp_plan(rows, dim, mlp, dtype)
    assert {p.tile_shape for launch in plan.forward + plan.backward for p in launch} == {
        (block, 128)}
    gen = torch.Generator(device=dev).manual_seed(40)
    args = _mlp_args(gen, 1, rows, dim, mlp, dtype)
    dy = _randn(gen, 1, rows, dim, dtype=dtype)
    out, a = fused_mlp_forward(*args, 1e-5, "exact", 0.1, True, 21, save_a=True)
    want, want_a = mlp_reference(*args, 1e-5, "exact", 0.1, True, 21, save_a=True)
    assert _rel_mae(out, want) <= BUDGET[dtype] and _rel_mae(a, want_a) <= BUDGET[dtype]
    again = fused_mlp_forward(*args, 1e-5, "exact", 0.1, True, 21, save_a=True)
    assert torch.equal(out, again[0]) and torch.equal(a, again[1])
    got = fused_mlp_bwd(*args, dy, a, 1e-5, "exact", 0.1, True, 21)
    wants = mlp_bwd_reference(*args, dy, a, 1e-5, "exact", 0.1, True, 21)
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), got, wants):
        assert torch.isfinite(g).all(), name
        assert _rel_mae(g, w) <= BUDGET[dtype], (name, _rel_mae(g, w))
    again = fused_mlp_bwd(*args, dy, a, 1e-5, "exact", 0.1, True, 21)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("dtype,block", _tile_params())
@pytest.mark.parametrize("rows,dim,out", [(1001, 768, 2304), (70, 256, 200)])
def test_ln_linear_kernels_at_every_tile(dev, monkeypatch, dtype, block, rows, dim, out):
    """B9 and B12 (with dW: its launch of dW and dh; and without) with
    GAVIKO_LNL_BLOCK set to each compiled tile, out 200 no multiple of 128:
    against their plain versions, reruns bit-equal."""
    from gaviko_tpu_torch.ops import _blocks
    from gaviko_tpu_torch.ops.ln_linear import ln_linear_plan

    monkeypatch.setenv(_blocks.LNL_ENV, str(block))
    for kind in ("forward", "backward", "backward_dh"):
        plan = ln_linear_plan(kind, rows, dim, out, dtype)
        assert {p.tile_shape for launch in plan.products for p in launch} == {(block, 128)}
    gen = torch.Generator(device=dev).manual_seed(41)
    x = _randn(gen, rows, dim, dtype=dtype, std=2.0) + 0.5
    gamma, beta = _ln_params(gen, dim, dtype)
    w = _randn(gen, out, dim, dtype=dtype, std=dim ** -0.5)
    dy = _randn(gen, rows, out, dtype=dtype, std=out ** -0.5)
    got = fused_ln_linear(x, gamma, beta, w)
    assert _rel_mae(got, ln_linear_reference(x, gamma, beta, w)) <= BUDGET[dtype]
    assert torch.equal(fused_ln_linear(x, gamma, beta, w), got)
    for need_dw in (True, False):
        got = ln_linear_bwd(x, gamma, beta, w, dy, 1e-5, need_dw)
        want = ln_linear_bwd_reference(x, gamma, beta, w, dy, 1e-5, need_dw)
        for name, g, wt in zip(("dx", "dgamma", "dbeta", "dw"), got, want):
            if wt is not None:
                assert _rel_mae(g, wt) <= BUDGET[dtype], (name, need_dw)
        again = ln_linear_bwd(x, gamma, beta, w, dy, 1e-5, need_dw)
        assert all(g is None or torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("dtype,block", _tile_params())
def test_patchify_at_every_tile(dev, dtype, block):
    """Patchify's GEMM on each compiled tile (its ``block`` argument), dim
    130 and K 315 ragged: against its plain version, a rerun bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(42)
    img = torch.rand(3, 3, 6, 10, 14, generator=gen, device=dev).to(dtype)
    w = _randn(gen, 130, 3, 3, 5, 7, dtype=dtype, std=0.02)
    b, pos = _randn(gen, 130, dtype=dtype), _randn(gen, 8, 130, dtype=dtype)
    got = patchify_kernel(img, w, b, pos, block=block)
    assert _rel_mae(got, patchify_reference(img, w, b, pos)) <= BUDGET[dtype]
    assert torch.equal(patchify_kernel(img, w, b, pos, block=block), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", _int8_tile_rows())
@pytest.mark.parametrize("rows,dim,mlp", [(1033, 1024, 4096), (264, 1024, 4096), (37, 200, 300)])
def test_int8_kernels_at_every_tile(dev, dtype, block, rows, dim, mlp):
    """B11 on each compiled int8 tile (the ``block`` argument): int8_linear
    without LN bit-equal to its plain version and with LN within the
    budget, int8_mlp within the budget, reruns bit-equal."""
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp, int8_plan, quantize_weight

    for kind, n in (("linear", mlp), ("mlp", mlp)):
        plan = int8_plan(kind, rows, dim, n, dtype, block)
        assert {p.tile_shape for launch in plan.products for p in launch} == {(block, 128)}
    x, w_i8, scale, bias, gamma, beta = _int8_linear_case(dev, dtype, rows, dim, mlp, seed=43)
    gen = torch.Generator(device=dev).manual_seed(44)
    w2, s2 = quantize_weight(_randn(gen, dim, mlp, dtype=dtype, std=mlp ** -0.5))
    b2 = _randn(gen, dim, dtype=dtype, std=0.1)
    margs = (x, gamma, beta, w_i8, scale, bias, w2, s2, b2, 1e-5, "exact", True)
    with torch.no_grad():
        for kw in ({"bias": bias}, {"gamma": gamma, "beta": beta}):
            got = int8_linear(x, w_i8, scale, **kw, block=block)
            with _build.plain_versions():
                want = int8_linear(x, w_i8, scale, **kw)
            if "gamma" in kw:
                assert _rel_mae(got, want) <= BUDGET[dtype]
            else:
                assert torch.equal(got, want)
            assert torch.equal(int8_linear(x, w_i8, scale, **kw, block=block), got)
        got = int8_mlp(*margs, block=block)
        with _build.plain_versions():
            want = int8_mlp(*margs)
        assert _rel_mae(got, want) <= BUDGET[dtype]
        assert torch.equal(int8_mlp(*margs, block=block), got)


def test_gemm_tiles_not_compiled_raise(dev, monkeypatch):
    """A tile no instance has for the dtype raises before any launch: 256
    rows (in no type) through GAVIKO_MLP_BLOCK, and 96 rows anywhere."""
    from gaviko_tpu_torch.ops import _blocks

    gen = torch.Generator(device=dev).manual_seed(45)
    monkeypatch.setenv(_blocks.MLP_ENV, "256")
    for dtype in (torch.float32, torch.bfloat16):
        args = _mlp_args(gen, 1, 70, 256, 512, dtype)
        before = fused_mlp.launches
        with pytest.raises(ValueError, match="no 256-row tile"):
            fused_mlp(*args)
        assert fused_mlp.launches == before
    img = torch.rand(1, 1, 4, 8, 12, generator=gen, device=dev)
    with pytest.raises(ValueError, match="no 96-row tile"):
        patchify_kernel(img, _randn(gen, 72, 1, 2, 4, 4, dtype=torch.float32),
                        _randn(gen, 72, dtype=torch.float32), block=96)
