"""PyTorch port: the vit-b16 serving kernels' plain versions and gates
against the JAX package (fp32 on the CPU).

Each plain version is held against the JAX Pallas kernel it replaces, run
in interpret mode on the CPU, at MAE <= 1e-5; the port's dispatch predicates
must equal the JAX package's, so one configuration takes the same route in
both packages. On a CPU tensor every wrapper runs its plain version; the
kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaviko_tpu.ops import cls_attention as jcls
from gaviko_tpu.ops import fused_mlp as jmlp
from gaviko_tpu.ops import ln_linear as jln
from gaviko_tpu_torch.ops import cls_attention as tcls
from gaviko_tpu_torch.ops import fused_mlp as tmlp
from gaviko_tpu_torch.ops import ln_linear as tln

MAE = 1e-5
WIDTHS = {"vit-t16": (192, 3), "vit-s16": (384, 6), "vit-b16": (768, 12),
          "vit-l16": (1024, 16)}
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _mae(got: torch.Tensor, want) -> float:
    return float(np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64)).mean())


def _ln_inputs(B, N, dim, out, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, dim) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(dim)).astype(np.float32)
    beta = (0.1 * rng.randn(dim)).astype(np.float32)
    w = (rng.randn(out, dim) * dim ** -0.5).astype(np.float32)
    return x, gamma, beta, w


@pytest.mark.parametrize("B,N,dim,out", [(2, 70, 128, 256), (1, 16, 384, 1152)])
def test_ln_linear_reference_matches_jax_kernel(B, N, dim, out):
    args = _ln_inputs(B, N, dim, out, seed=0)
    want = jln.fused_ln_linear(*(jnp.asarray(a) for a in args))
    got = tln.ln_linear_reference(*(torch.from_numpy(a) for a in args))
    assert got.shape == (B, N, out)
    assert _mae(got, want) <= MAE


def test_ln_linear_wrapper_on_cpu_is_the_plain_version():
    args = [torch.from_numpy(a) for a in _ln_inputs(2, 9, 128, 128, seed=1)]
    before = tln.fused_ln_linear.launches
    torch.testing.assert_close(tln.fused_ln_linear(*args), tln.ln_linear_reference(*args),
                               rtol=0, atol=0)
    assert tln.fused_ln_linear.launches == before


def _mlp_inputs(dim=128, mlp=256, rows=70, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, rows, dim).astype(np.float32)
    gamma = (rng.randn(dim) * 0.1 + 1).astype(np.float32)
    beta = (rng.randn(dim) * 0.1).astype(np.float32)
    w1 = (rng.randn(mlp, dim) * 0.05).astype(np.float32)
    b1 = (rng.randn(mlp) * 0.1).astype(np.float32)
    w2 = (rng.randn(dim, mlp) * 0.05).astype(np.float32)
    b2 = (rng.randn(dim) * 0.1).astype(np.float32)
    return x, gamma, beta, w1, b1, w2, b2


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("gelu", ["exact", "tanh", "erf_fast"])
def test_mlp_reference_matches_jax_kernel(gelu, residual):
    args = _mlp_inputs()
    want = jmlp.fused_mlp(*(jnp.asarray(a) for a in args), jnp.zeros((1,), jnp.int32),
                          1e-5, gelu, 0.0, residual)
    got = tmlp.mlp_reference(*(torch.from_numpy(a) for a in args), 1e-5, gelu,
                             residual=residual)
    assert _mae(got, want) <= MAE


@pytest.mark.parametrize("gelu", ["exact", "tanh", "erf_fast", True, False, None])
def test_gelu_modes_match_jax(gelu):
    x = np.linspace(-6.0, 6.0, 2001, dtype=np.float32)
    assert tmlp.gelu_mode(gelu) == jmlp.gelu_mode(gelu)
    np.testing.assert_allclose(tmlp.gelu_by_mode(torch.from_numpy(x), gelu).numpy(),
                               np.asarray(jmlp.gelu_by_mode(jnp.asarray(x), gelu)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tmlp.erf_f32(torch.from_numpy(x)).numpy(),
                               np.asarray(jmlp.erf_f32(jnp.asarray(x))), atol=1e-6, rtol=0)


def test_mlp_wrapper_on_cpu_is_the_plain_version_and_refuses_dropout():
    """On the CPU the wrapper is the plain version, dropout included; a
    dropout rate without a seed is refused (the refusal the name means;
    a rate with a seed is taken)."""
    args = [torch.from_numpy(a) for a in _mlp_inputs(rows=5, seed=1)]
    before = tmlp.fused_mlp.launches
    torch.testing.assert_close(tmlp.fused_mlp(*args, residual=True),
                               tmlp.mlp_reference(*args, residual=True), rtol=0, atol=0)
    torch.testing.assert_close(
        tmlp.fused_mlp(*args, dropout_rate=0.1, residual=True, seed=-3),
        tmlp.mlp_reference(*args, residual=True, dropout_rate=0.1, seed=-3), rtol=0, atol=0)
    assert tmlp.fused_mlp.launches == before
    with pytest.raises(ValueError, match="seed"):
        tmlp.fused_mlp(*args, dropout_rate=0.1)


# The geometries of tests/test_cls_attention.py: the vit-b16 padded stream,
# no padding, a ragged tail, tiny.
@pytest.mark.parametrize("B,N,H,n_true", [
    (3, 1008, 12, 1001), (2, 128, 4, 128), (1, 64, 8, 57), (4, 16, 2, 11),
])
def test_cls_attention_reference_matches_jax_kernel(B, N, H, n_true):
    rng = np.random.RandomState(2)
    inner = H * 64
    kv = rng.randn(B, N, 2 * inner).astype(np.float32)
    q0 = rng.randn(B, inner).astype(np.float32)
    want = jcls.cls_attention(jnp.asarray(kv), jnp.asarray(q0), H, 64, 0.125, n_true)
    got = tcls.cls_attention_reference(torch.from_numpy(kv), torch.from_numpy(q0), H, 64,
                                       0.125, n_true)
    assert got.shape == (B, inner)
    assert _mae(got, want) <= MAE
    before = tcls.cls_attention.launches
    torch.testing.assert_close(
        tcls.cls_attention(torch.from_numpy(kv), torch.from_numpy(q0), H, 64, 0.125, n_true),
        got, rtol=0, atol=0)
    assert tcls.cls_attention.launches == before


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("backbone", sorted(WIDTHS))
def test_gates_equal_the_jax_package(backbone, dtypes):
    tdt, jdt = dtypes
    dim, heads = WIDTHS[backbone]
    inner = heads * 64
    for out in (3 * inner, 2 * inner, 4 * dim):  # qkv, kv, MLP hidden
        assert tln.ln_linear_supported(dim, out, tdt) is jln.ln_linear_supported(dim, out, jdt)
        assert tmlp._chunk_plan(dim, out, tdt.itemsize) == \
            jmlp._chunk_plan(dim, out, jnp.dtype(jdt).itemsize)
        assert tmlp.fused_mlp_supported(dim, out, tdt) is \
            jmlp.fused_mlp_supported(dim, out, jdt)
    for n in (16, 1001, 1008, 1040):
        assert tcls.cls_attention_supported(heads, 64, n, tdt) is \
            jcls.cls_attention_supported(heads, 64, n, jdt)


def test_vit_b16_bf16_takes_the_fused_routes_and_vit_l16_does_not():
    """The slice's path: vit-b16 in bf16 fuses LN+qkv, the last layer's kv
    projection and the MLP; in fp32 only the CLS attention stays on, and
    GAViKO's vit-l16 keeps its plain GEMMs."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tln.ln_linear_supported(768, 2304, bf16) and tln.ln_linear_supported(768, 1536, bf16)
    assert tmlp.fused_mlp_supported(768, 3072, bf16)
    assert not tln.ln_linear_supported(768, 2304, f32)
    assert not tmlp.fused_mlp_supported(768, 3072, f32)
    assert tcls.cls_attention_supported(12, 64, 1008, f32)
    assert not tln.ln_linear_supported(1024, 3072, bf16)
    assert not tmlp.fused_mlp_supported(1024, 4096, bf16)
