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
    flash_local_attention, fused_mhsa, fused_mhsa_bwd, local_attention_bwd,
    local_bwd_reference, local_reference, mhsa_bwd_reference, mhsa_qkv_proj,
    mhsa_reference)
from gaviko_tpu_torch.ops.fused_mlp import fused_mlp, mlp_reference
from gaviko_tpu_torch.ops.ln_linear import fused_ln_linear, ln_linear_reference
from gaviko_tpu_torch.ops.patchify import patchify_fused, patchify_reference

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("DHW,local_k,dl", [
    ((4, 5, 6), (6, 6, 6), 20), ((4, 5, 6), (3, 6, 6), 8), ((10, 10, 10), (2, 3, 1), 20),
    ((3, 2, 30), (6, 6, 6), 32),
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
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mhsa(torch.zeros(1, 16, 3 * 2 * 64, device=dev)[:, ::2], 2, 64, 0.125, 8)
    with pytest.raises(NotImplementedError, match="float16"):
        fused_mhsa(qkv.half(), 2, 64, 0.125, 8)
    with pytest.raises(NotImplementedError, match="dim_head"):
        fused_mhsa(torch.zeros(1, 8, 3 * 2 * 32, device=dev), 2, 32, 0.125, 8)
    q = torch.zeros(1, 8, 40, device=dev)
    with pytest.raises(NotImplementedError, match="dl <= 32"):
        flash_local_attention(q, q, q, 1.0, (2, 2, 2), (2, 2, 2))


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


def test_wrappers_without_a_backward_kernel_refuse_a_gradient(dev):
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_mhsa(qkv, 2, 64, 0.125, 8)
    w = torch.zeros(8, 1, 2, 4, 4, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        patchify_fused(torch.zeros(1, 1, 4, 8, 8, device=dev), w, torch.zeros(8, device=dev))


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

    wrappers = (fused_mhsa, fused_mhsa_bwd, flash_local_attention, local_attention_bwd)
    for w in wrappers:
        w.launches = 0
    got = trainable_grads()
    counts = [w.launches for w in wrappers]
    with _build.plain_versions():
        want = trainable_grads()
    assert counts == [model.spec.depth] * 4
    assert [w.launches for w in wrappers] == counts
    assert _rel_mae(got, want) <= 1e-4


def _ln_params(gen, dim, dtype):
    gamma = (1.0 + 0.1 * torch.randn(dim, generator=gen, device=gen.device)).to(dtype)
    return gamma, _randn(gen, dim, dtype=dtype, std=0.1)


# (B, N, dim, out): the vit-b16 B8 qkv and kv projections, then ragged rows
# (tiles cut by the row edge) and an out width that is no multiple of 128.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,dim,out", [
    (8, 1008, 768, 2304), (8, 1008, 768, 1536), (3, 37, 384, 1152), (2, 5, 128, 136),
])
def test_ln_linear_kernel(dev, dtype, B, N, dim, out):
    gen = torch.Generator(device=dev).manual_seed(6)
    x = _randn(gen, B, N, dim, dtype=dtype, std=2.0) + 0.5
    gamma, beta = _ln_params(gen, dim, dtype)
    w = _randn(gen, out, dim, dtype=dtype, std=dim ** -0.5)
    before = fused_ln_linear.launches
    got = fused_ln_linear(x, gamma, beta, w)
    assert fused_ln_linear.launches == before + 1
    assert got.shape == (B, N, out) and torch.isfinite(got).all()
    assert _rel_mae(got, ln_linear_reference(x, gamma, beta, w)) <= BUDGET[dtype]


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
    x = torch.zeros(1, 8, 128, device=dev, requires_grad=True)
    g, b = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    w = torch.zeros(256, 128, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_ln_linear(x, g, b, w)
    w1, b1 = torch.zeros(256, 128, device=dev), torch.zeros(256, device=dev)
    w2 = torch.zeros(128, 256, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_mlp(x, g, b, w1, b1, w2, b, residual=True)
    with pytest.raises(NotImplementedError, match="dropout.*ROADMAP"):
        fused_mlp(x.detach(), g, b, w1, b1, w2, b, dropout_rate=0.1)
    kv = torch.zeros(1, 8, 2 * 2 * 64, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="train slice"):
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
         "gaviko_tpu/configs/vit.yaml", "--method", "fft", "--port", str(port)],
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
