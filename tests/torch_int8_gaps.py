"""Print the int8 gaps that tests/test_torch_int8.py budgets, on the CPU:

    JAX_PLATFORMS=cpu python -m tests.torch_int8_gaps

- the MLP of test_int8_mlp_matches_jax (exact GELU, no residual) against
  JAX's, with the biases added after a rounded product (``a * s + b`` in
  two roundings) and fused as one multiply-add (``fma_f32``, the port's);
- the fp32 logits of the GAViKO configuration of test_int8_logits_match_jax
  and of the Predictor of test_predictor_int8_matches_jax, fp and int8,
  against JAX's: MAE and relative MAE; and the Predictor's int8 gap with
  JAX's own int8 functions put into the port's model.

Not collected by pytest (no ``test_`` prefix): it only reports.
"""

import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.ops import int8_linear as jq
from gaviko_tpu.serving import Predictor as JaxPredictor
from gaviko_tpu_torch.ops import int8_linear as tq
from gaviko_tpu_torch.ops.fused_mlp import gelu_by_mode
from gaviko_tpu_torch.serving import Predictor
from tests.test_torch_int8 import CONFIG, GAVIKO, SHAPE, _logits_case, _rel


def _gap(got, want) -> str:
    return f"MAE {np.abs(got - want).mean():.3g}, relative {_rel(got, want):.3g}"


def mlp_bias_rounding() -> None:
    rng = np.random.RandomState(3)
    dim, mlp = 128, 512
    x = rng.randn(2, 24, dim).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(dim)).astype(np.float32)
    be = (0.1 * rng.randn(dim)).astype(np.float32)
    w1 = (rng.randn(mlp, dim) * dim ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.randn(mlp)).astype(np.float32)
    w2 = (rng.randn(dim, mlp) * mlp ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.randn(dim)).astype(np.float32)
    (w1_i8, s1), (w2_i8, s2) = jq.quantize_weight(jnp.asarray(w1)), jq.quantize_weight(
        jnp.asarray(w2))
    want = np.asarray(jq.int8_mlp(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), w1_i8, s1,
                                  jnp.asarray(b1), w2_i8, s2, jnp.asarray(b2), 1e-5, "exact"))

    def t(a):
        return torch.from_numpy(np.array(a))

    xf = t(x)
    for name, add in (("rounded product + bias", lambda a, m, b: a * m + b),
                      ("one multiply-add", tq.fma_f32)):
        codes, sh = tq._quant_rows(tq._ln_f32(xf, t(g), t(be), 1e-5))
        a = add(tq._int8_matmul(codes, t(w1_i8)), sh * t(s1).reshape(-1), t(b1))
        gcodes, sg = tq._quant_rows(gelu_by_mode(a, "exact"))
        out = add(tq._int8_matmul(gcodes, t(w2_i8)), sg * t(s2).reshape(-1), t(b2))
        print(f"int8_mlp, bias as {name}: relative MAE vs JAX {_rel(out.numpy(), want):.3g}")


def gaviko_logits() -> None:
    jm = jax_build_model(GAVIKO)
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}
    jp_int8 = {k: np.asarray(v) for k, v in jq.quantize_backbone(
        {k: jnp.asarray(v) for k, v in jp.items()}).items()}
    x = np.random.RandomState(4).rand(*SHAPE).astype(np.float32)
    want, got, fp, _ = _logits_case(GAVIKO, None, jp_int8, x)
    want_fp = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jp, jnp.asarray(x)))
    print(f"GAViKO logits, fp32: {_gap(fp, want_fp)}; int8: {_gap(got, want)}")


def predictor_logits() -> None:
    jm = jax_build_model(CONFIG["model"])
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3), jm.spec).items()}
    rng = np.random.RandomState(0)
    vols = [rng.rand(24, 32, 32).astype(np.float32) for _ in range(3)]
    with tempfile.TemporaryDirectory() as root:
        ckpt = f"{root}/full.npz"
        np.savez(ckpt, **params)
        kw = dict(checkpoint=ckpt, batch_size=2, dtype="float32", pretrained_dir=None)
        for quantize in (None, "int8"):
            got = Predictor(CONFIG, device="cpu", quantize=quantize, **kw).predict_logits(vols)
            want = JaxPredictor(CONFIG, quantize=quantize, **kw).predict_logits(vols)
            print(f"Predictor logits, quantize={quantize}: {_gap(got, want)}")
        port = Predictor(CONFIG, device="cpu", quantize="int8", **kw)
        with pytest.MonkeyPatch.context() as mp:
            from gaviko_tpu_torch.core import vit as tvit

            def jx(t):
                return None if t is None else jnp.asarray(t.numpy())

            def linear(x, w, s, bias=None, gamma=None, beta=None, eps=1e-5):
                out = jq.int8_linear(jx(x.reshape(1, -1, x.shape[-1])), jx(w), jx(s),
                                     bias=jx(bias), gamma=jx(gamma), beta=jx(beta), eps=eps)
                return torch.from_numpy(np.array(out)).reshape(*x.shape[:-1], -1)

            def mlp(x, g, b, w1, s1, b1, w2, s2, b2, eps, approximate, residual):
                out = jq.int8_mlp(jx(x.reshape(1, -1, x.shape[-1])), jx(g), jx(b), jx(w1),
                                  jx(s1), jx(b1), jx(w2), jx(s2), jx(b2), eps, approximate,
                                  residual=residual)
                return torch.from_numpy(np.array(out)).reshape(x.shape)

            mp.setattr(tvit, "int8_linear", linear)
            mp.setattr(tvit, "int8_mlp", mlp)
            got = port.predict_logits(vols)
        print(f"Predictor logits, int8 with JAX's int8 functions in the port's model: "
              f"{_gap(got, want)}")


if __name__ == "__main__":
    mlp_bias_rounding()
    gaviko_logits()
    predictor_logits()
