"""PyTorch port: the unfused attention routes and the packed-qkv VJP against
the JAX package on the CPU (fp32).

- B10's plain version ``flash_attention_reference`` and its gradient (the
  rematerialised VJP) against JAX's ``flash_attention`` (the Pallas kernels
  in interpret mode, whole-K at N = 40 and streaming at N = 2049) and
  ``jax.vjp`` of it: MAE < 1e-5;
- ``_xla_attention`` with dropout 0.1 against JAX's, mask for mask, fed the
  same ``next_seed()``: outputs and gradients atol 1e-6;
- ``fused_mhsa`` differentiable on a given packed qkv (head dims 64 and
  128, dropout 0.1) against ``jax.vjp`` of JAX's custom VJP: atol 2e-5;
- the gates and the head dims each kernel takes, the wrappers' routes on
  a faked CUDA tensor (``use_kernel`` says yes, ``launch`` records).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.core.layers import RngStream
from gaviko_tpu.ops import attention as jattn
from gaviko_tpu.ops import cls_attention as jcls
from gaviko_tpu.ops import flash_attention as jfa
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops import attention as tattn
from gaviko_tpu_torch.ops import cls_attention as tcls
from gaviko_tpu_torch.ops import flash_attention as tfa

RATE = 0.1


def _mae(a, b) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _qkv4(B, H, N, D, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, H, N, D) * s).astype(np.float32) for s in (1.0, 1.0, 1.0)]


# (B, H, N, D): JAX's whole-K kernel (N <= 2048) and its streaming kernel.
@pytest.mark.parametrize("B,H,N,D", [(2, 3, 40, 64), (1, 1, 2049, 32)],
                         ids=["whole_k", "streaming"])
def test_flash_reference_and_gradient_match_jax_kernel(B, H, N, D):
    q, k, v = _qkv4(B, H, N, D, seed=N)
    g = np.random.RandomState(1).randn(B, H, N, D).astype(np.float32)
    scale = D ** -0.5
    want, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale),
                        *(jnp.asarray(t) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, scale)
    out.backward(torch.from_numpy(g))
    assert _mae(out.detach().numpy(), want) < 1e-5
    for name, t, w in zip("qkv", leaves, want_grads):
        assert _mae(t.grad.numpy(), w) < 1e-5, name
    plain = tfa.flash_attention_reference(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)


def test_xla_attention_dropout_matches_jax_mask_for_mask():
    """The probabilities are dropped by ``layers.dropout`` over the
    flattened [B * H * N, N] rows with the stream's next seed."""
    B, H, N, D = 2, 3, 24, 16
    q, k, v = _qkv4(B, H, N, D, seed=3)
    g = np.random.RandomState(4).randn(B, H, N, D).astype(np.float32)
    key = jax.random.PRNGKey(7)
    seed = int(RngStream(key).next_seed())

    def jfn(a, b, c):
        return jattn._xla_attention(a, b, c, scale=0.25, dropout_rate=RATE,
                                    dropout_enabled=True, rngs=RngStream(key))

    want, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    seeds = SeedStream([seed])
    out = tattn.multi_head_attention(*leaves, scale=0.25, dropout_rate=RATE,
                                     dropout_enabled=True, seeds=seeds)
    out.backward(torch.from_numpy(g))
    assert seeds.count == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-6)
    for name, t, w in zip("qkv", leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6, err_msg=name)
    no_drop = tattn.multi_head_attention(*(t.detach() for t in leaves), scale=0.25)
    assert float((out.detach() - no_drop).abs().max()) > 1e-3  # something was dropped


def test_multi_head_attention_routes(monkeypatch):
    """Dropout off (or disabled): the flash attention kernel; on: plain
    attention, which launches nothing."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention", lambda *a: calls.append("flash") or a[0])
    q = torch.zeros(1, 3, 8, 32)
    tattn.multi_head_attention(q, q, q, scale=1.0)
    tattn.multi_head_attention(q, q, q, scale=1.0, dropout_rate=RATE, dropout_enabled=False)
    assert calls == ["flash", "flash"]
    tattn.multi_head_attention(q, q, q, scale=1.0, dropout_rate=RATE, dropout_enabled=True,
                               seeds=SeedStream([5]))
    assert calls == ["flash", "flash"]


@pytest.mark.parametrize("H,D", [(4, 64), (2, 128)])
def test_fused_mhsa_packed_qkv_vjp_matches_jax(H, D):
    """``fused_mhsa`` on a packed qkv that needs a gradient: forward and
    dqkv with dropout against ``jax.vjp`` of JAX's ``fused_mhsa``."""
    B, n_pad, n_true, seed = 2, 40, 35, -99
    rng = np.random.RandomState(5)
    qkv = (rng.randn(B, n_pad, 3 * H * D) * 0.5).astype(np.float32)
    g = rng.randn(B, n_pad, H * D).astype(np.float32)
    g[:, n_true:] = 0.0
    jseed = jnp.asarray([seed], jnp.int32)
    want, vjp = jax.vjp(lambda t: jfa.fused_mhsa(t, jseed, H, D, D ** -0.5, n_true, RATE),
                        jnp.asarray(qkv))
    (dqkv_want,) = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qkv).requires_grad_(True)
    out = tfa.fused_mhsa(tq, H, D, D ** -0.5, n_true, RATE, seed=seed)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy()[:, :n_true],
                               np.asarray(want)[:, :n_true], atol=2e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(dqkv_want), atol=2e-5)


@pytest.mark.parametrize("heads,dim_head,n", [
    (2, 64, 1008), (2, 128, 1008), (12, 128, 1008), (3, 64, 1008), (3, 128, 1008),
    (2, 32, 64), (2, 192, 64), (4, 256, 64), (2, 64, 2353),
])
def test_fused_gate_is_the_jax_gate(heads, dim_head, n):
    assert tfa.fused_mhsa_supported(heads, dim_head, n) == \
        jfa.fused_mhsa_supported(heads, dim_head, n)


def _fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "launch", lambda name, symbol, *a: calls.append(symbol))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return calls


def test_kernels_take_the_head_dims_they_are_compiled_for(monkeypatch):
    """A, B and B8 launch at head dims 64, 128, 192 and 256, and B10 at any
    head dim that is a multiple of 8, in place (32 and 96 run on the tiles
    of 64 and 128, which read the missing columns as zeros: no padding
    copy). Every other head dim JAX's gates admit (A and B above 256, B8 at
    e.g. 96, B10 above 256) launches the same entry point, which runs A and
    B10's general instance, B's plan of slices (two of the dq pass and
    three of the dk/dv pass at 320 and 384 in bf16) and B8's one design;
    B10 pads a head dim that is not a multiple of 8 (263
    to 264, the view there having no 16-byte rows) and checks the strides
    of what it launches on. (Head dims above 256 raised here before ROADMAP
    Queue C item 4 was repaired; the test's name dates from then.)"""
    calls = _fake_card(monkeypatch)
    for dh in (64, 128, 192, 256):
        qkv = torch.zeros(1, 8, 3 * 2 * dh)
        out, lse = tfa.fused_mhsa(qkv, 2, dh, 0.1, 8, with_lse=True)
        tfa.fused_mhsa_bwd(qkv, out, lse, out, 2, dh, 0.1, 8)
        tcls.cls_attention(torch.zeros(1, 8, 2 * 2 * dh), torch.zeros(1, 2 * dh), 2, dh, 0.1, 8)
    widths = []
    monkeypatch.setattr(tfa, "_flash_strides", lambda name, t: widths.append(t.shape[-1])
                        or t.stride()[:3])
    for d in (32, 64, 128, 192, 256, 96):
        q = torch.zeros(1, 3, 8, d)
        assert tfa.flash_attention(q, q, q, 0.1).shape == q.shape
    assert calls == ["gaviko_fused_mhsa_f32", "gaviko_fused_mhsa_bwd_f32",
                     "gaviko_cls_attention_f32"] * 4 + ["gaviko_flash_attention_f32"] * 6
    assert widths[::3] == [32, 64, 128, 192, 256, 96]
    del calls[:]
    for dh in (320, 384):
        assert tfa.fused_mhsa_supported(2, dh, 64)
        assert len(tfa.mhsa_bwd_plan(dh).dq) == 2 and len(tfa.mhsa_bwd_plan(dh).dkdv) == 3
        qkv = torch.zeros(1, 8, 3 * 2 * dh)
        out, lse = tfa.fused_mhsa(qkv, 2, dh, 0.1, 8, with_lse=True)
        assert out.shape == (1, 8, 2 * dh)
        tfa.fused_mhsa_bwd(qkv, out, lse, out, 2, dh, 0.1, 8)
        tcls.cls_attention(torch.zeros(1, 8, 2 * 2 * dh), torch.zeros(1, 2 * dh), 2, dh,
                           0.1, 8)
    assert tcls.cls_attention_supported(4, 96, 8, torch.float32)
    tcls.cls_attention(torch.zeros(1, 8, 2 * 4 * 96), torch.zeros(1, 4 * 96), 4, 96, 0.1, 8)
    q = torch.zeros(1, 3, 8, 264)[..., 1:]  # 263 wide: no 16-byte rows
    plan = tfa.attention_plan(264)
    assert (plan.instance, plan.width) == ("general", 264)
    assert tfa.flash_attention(q, q, q, 0.1).shape == q.shape
    assert calls == ["gaviko_fused_mhsa_f32", "gaviko_fused_mhsa_bwd_f32",
                     "gaviko_cls_attention_f32"] * 2 + ["gaviko_cls_attention_f32",
                                                        "gaviko_flash_attention_f32"]
    assert widths[::3] == [32, 64, 128, 192, 256, 96, 264]  # 263 padded, then checked


def test_every_head_dim_the_jax_gates_admit_has_an_instance():
    """Each head dim in 8..2048 that JAX's fused gate or CLS gate admits (at
    2, 4 and 12 heads, N 1008, bf16) has a plan of A and B in both dtypes,
    or of B8 (a split of the keys), without raising, as does every head dim
    of B10 (which JAX takes at any width); the compiled forward tiles keep
    their own head dims. (The range stopped at 1024 while A and B10 refused
    head dims above 1280, ROADMAP Queue C item 6.)"""
    admitted = {"mhsa": set(), "cls": set()}
    for d in range(8, 2049):
        for heads in (2, 4, 12):
            if jfa.fused_mhsa_supported(heads, d, 1008):
                admitted["mhsa"].add(d)
                for dtype in (torch.bfloat16, torch.float32):
                    assert tfa.attention_plan(d, dtype).smem <= tfa.SMEM_LIMIT
                    assert tfa.mhsa_bwd_plan(d, dtype).smem <= tfa.SMEM_LIMIT
            if jcls.cls_attention_supported(heads, d, 1008, jnp.bfloat16):
                admitted["cls"].add(d)
                for dtype in (torch.bfloat16, torch.float32):
                    splits, chunk, _ = tcls.cls_plan(8, heads, 1001, d, dtype)
                    assert (splits - 1) * chunk < 1001 <= splits * chunk
        wide = d + (-d) % 8  # B10 pads a head dim to whole 16-byte rows
        plan = tfa.attention_plan(wide)
        kind, width = plan.instance, plan.width
        assert width >= d and (kind == "general") == (d > 256)
        assert (kind == "specialized") == (wide in tfa.MHSA_DIM_HEADS)
    assert {320, 512, 1024, 1344, 2048} <= admitted["mhsa"]
    assert {96, 160, 320} <= admitted["cls"]


def test_flash_attention_on_the_card_reads_head_views_in_place(monkeypatch):
    """On a (faked) CUDA tensor the kernel takes the strided head views of
    a packed projection and returns o as a [B, H, N, D] view of [B, N, H, D]
    memory; a layout it cannot read raises."""
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(list(a[-3])))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    B, N, H, D = 2, 13, 3, 64
    qkv = torch.zeros(B, 16, 3 * H * D)
    q, k, v = (t[:, :, :N] for t in tfa._split_heads(qkv, H, D))
    o = tfa.flash_attention(q, k, v, 0.125)
    assert o.shape == (B, H, N, D) and o.transpose(1, 2).is_contiguous()
    row = 3 * H * D
    assert calls == [[16 * row, D, row] * 3 + [N * H * D, D, H * D]]
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attention(torch.zeros(1, 1, 8, 36)[..., :32], q[:1, :1, :8, :32],
                            q[:1, :1, :8, :32], 0.1)


def test_self_attention_train_pads_a_fused_stream_to_a_multiple_of_8(monkeypatch):
    """A fused-route stream of 13 rows: the packed qkv is padded to 16 rows,
    fused_mhsa runs on it (differentiable) and the output is sliced back."""
    shapes = []
    real = tattn.fused_mhsa
    monkeypatch.setattr(tattn, "fused_mhsa",
                        lambda qkv, *a, **kw: shapes.append(tuple(qkv.shape)) or real(qkv, *a, **kw))
    h = torch.randn(2, 13, 32, requires_grad=True)
    w = torch.randn(3 * 2 * 64, 32, requires_grad=True)
    out = tattn.self_attention_train(h, w, 2, 64, 0.125, 11, RATE, SeedStream([3]))
    out.sum().backward()
    assert shapes == [(2, 16, 3 * 2 * 64)] and out.shape == (2, 13, 128)
    assert h.grad is not None and w.grad is not None
