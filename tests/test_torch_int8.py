"""PyTorch port: int8 (w8a8) serving against the JAX package on the CPU.

The same inputs, made from a numpy seed, go through the JAX package's
``ops/int8_linear.py`` (its Pallas kernels in interpret mode off the TPU)
and the port's (the plain versions of ``csrc/int8_linear.cu``):

- ``quantize_weight`` / ``quantize_backbone`` bit-exact on f32 and bf16
  weights: key set, codes and scales, GAViKO's ``attns``/``mlps`` sites,
  the ``.local_attns.`` exclusion and the SSF refusal;
- ``int8_linear`` without LN equal to JAX (bit for bit without a bias,
  within 1 ULP of the largest term with one), also at an out-projection
  wider than 2,048 (2,304 -> 64); with LN, and
  ``int8_mlp`` (residual both ways, GELU ``tanh`` and ``exact``), within
  1e-5 relative MAE (the LN's sums run in another order);
- fp32 logits of GAViKO (JAX's own ``tests/test_int8.py`` config) and of
  vit-t16 / vit-b16 ``fft`` (depth 2) with int8 sidecars, every GEMM site
  through the int8 functions: within 1e-2 relative MAE of JAX's int8
  logits (see below), argmax equal, and within JAX's own 5e-2 of the
  port's fp logits; a train forward with sidecars bit-equal to one
  without;
- ``Predictor(quantize="int8")`` against JAX's the same way, and
  ``evaluate --quantize int8`` writing JAX's CSV.

Why 1e-2 end to end, where fp32 logits agree to 1e-4: the activations
entering an int8 site differ from JAX's in the last f32 places (sums in
other orders: an LN's mean and variance, attention), so a row's amax, and
its scale, can differ by one ULP, and where a value sits on a rounding
boundary its code moves by 1, which a random-init model carries through
every later layer. ``python -m tests.torch_int8_gaps`` prints the gaps:
1.2e-4 MAE on the GAViKO logits here (one code of layer 0's MLP) and
6.4e-3 (3.3e-3 relative) on the Predictor's vit-s16 GAViKO, against
3e-7 and 6e-7 in fp32; with JAX's own int8 functions put in the port's
model the Predictor's gap is still 3.3e-3 MAE, so it is not the port's
int8 functions, which agree with JAX's on identical inputs as stated
above.
"""

import copy
import dataclasses
import logging
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from gaviko_tpu.cli import evaluate as jcli_eval
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.ops import int8_linear as jq
from gaviko_tpu.serving import Predictor as JaxPredictor
from gaviko_tpu_torch.cli import evaluate as tcli_eval
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.ops import int8_linear as tq
from gaviko_tpu_torch.serving import Predictor
from gaviko_tpu_torch.weights.from_jax import from_jax
from tests.test_end_to_end import make_synth_dataset, tiny_config

# JAX's tests/test_int8.py GAViKO configuration (vit-t16 widths, 2x2x2 grid).
GAVIKO = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
              num_classes=5, channels=1, pool="cls", backbone="vit-t16", method="gaviko",
              num_prompts=8, prompt_latent_dim=12, local_dim=12, local_k=[2, 2, 2],
              DHW=[2, 2, 2], attn_drop=0.2, proj_drop=0.2, share_factor=1, dropout=0.1,
              emb_dropout=0.1)
TINY_VIT = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
                num_classes=5, channels=1, pool="cls", method="fft", dropout=0.1,
                emb_dropout=0.1)
SHAPE = (2, 1, 24, 32, 32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ulps(got: np.ndarray, want: np.ndarray, dtype, mag: np.ndarray) -> float:
    """Largest |got - want| in units of the last place, in ``dtype``, of
    ``mag`` (the largest term that was summed into each output)."""
    ulp = np.spacing(np.abs(mag).astype(np.float32)) * (2.0 ** 16 if dtype == "bf16" else 1.0)
    return float((np.abs(got.astype(np.float32) - want.astype(np.float32)) / ulp).max())


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.fixture(scope="module")
def gaviko_params():
    jm = jax_build_model(GAVIKO)
    return jm, {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_backbone_is_jax_bit_for_bit(gaviko_params, dtype):
    _, jp = gaviko_params
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jparams = {k: jnp.asarray(v).astype(jdt) if v.dtype == np.float32 else jnp.asarray(v)
               for k, v in jp.items()}
    want = {k: np.asarray(v) for k, v in jq.quantize_backbone(jparams, 12).items()}
    got = tq.quantize_backbone(from_jax(jparams), 12)
    assert set(got) == set(want)
    sites = [k for k in want if k.endswith(tq.INT8_SUFFIX)]
    assert any(k.startswith("transformer.attns.") for k in sites)
    assert any(k.startswith("transformer.mlps.") for k in sites)
    assert not any(".local_attns." in k for k in sites) and len(sites) == 4 * 12
    for k in sites:
        scale = k[:-len(tq.INT8_SUFFIX)] + tq.SCALE_SUFFIX
        assert got[k].dtype == torch.int8 and got[scale].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        np.testing.assert_array_equal(got[scale].numpy().view(np.uint32),
                                      want[scale].view(np.uint32))
    w_i8, scale = tq.quantize_weight(from_jax(jparams)["transformer.attns.0.to_qkv.weight"])
    assert tuple(scale.shape) == (1, w_i8.shape[0])


def test_quantize_backbone_refuses_ssf(caplog):
    params = {"transformer.layers.0.0.to_qkv.weight": torch.ones(24, 8),
              "transformer.layers.0.0.ssf_scale_1": torch.ones(8)}
    with caplog.at_level(logging.WARNING):
        out = tq.quantize_backbone(params, 1)
    assert set(out) == set(params) and out is not params
    assert "not supported for SSF" in caplog.text
    jout = jq.quantize_backbone({k: jnp.asarray(v.numpy()) for k, v in params.items()}, 1)
    assert set(jout) == set(out)


def test_from_jax_carries_jax_codes_unchanged(gaviko_params):
    _, jp = gaviko_params
    jparams = jq.quantize_backbone({k: jnp.asarray(v) for k, v in jp.items()})
    k = "transformer.mlps.1.net.4.weight"
    t = from_jax(jparams, dtype=torch.bfloat16)
    assert t[k + tq.INT8_SUFFIX].dtype == torch.int8
    np.testing.assert_array_equal(t[k + tq.INT8_SUFFIX].numpy(),
                                  np.asarray(jparams[k + tq.INT8_SUFFIX]))


def _linear_case(rng, dtype, din=256, dout=384, rows=(2, 40)):
    x = rng.randn(*rows, din).astype(np.float32)
    w = (rng.randn(dout, din) * 0.05).astype(np.float32)
    b = (rng.randn(dout) * 0.01).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(din)).astype(np.float32)
    be = (0.1 * rng.randn(din)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jx, jb, jg, jbe = (jnp.asarray(a).astype(jdt) for a in (x, b, g, be))
    w_i8, scale = jq.quantize_weight(jnp.asarray(w))
    tw, ts = torch.from_numpy(np.array(w_i8)), torch.from_numpy(np.array(scale))
    tx, tb, tg, tbe = (from_jax({"a": a})["a"] for a in (jx, jb, jg, jbe))
    return (jx, w_i8, scale, jb, jg, jbe), (tx, tw, ts, tb, tg, tbe)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_without_ln_is_jax_to_one_ulp(dtype, bias):
    """Same codes, same int32 sums, same scales, and the bias fused into
    the dequantizing product as one multiply-add in both (XLA contracts
    JAX's ``acc * (sx * ws) + bias`` into an FMA; the port's ``fma_f32``
    rounds once too): equal to JAX bit for bit without a bias, and within
    1 ULP (of the output, or of the larger of the product and the bias if
    that is larger) with one."""
    (jx, w_i8, scale, jb, _, _), (tx, tw, ts, tb, _, _) = _linear_case(
        np.random.RandomState(1), dtype)
    want = np.asarray(jq.int8_linear(jx, w_i8, scale, bias=jb if bias else None)
                      .astype(jnp.float32))
    got = _np(tq.int8_linear(tx, tw, ts, bias=tb if bias else None))
    assert got.shape == want.shape
    if not bias:
        np.testing.assert_array_equal(got, want)
        return
    codes, sx = tq._quant_rows(tx.float())
    prod = (tq._int8_matmul(codes, tw) * (sx * ts.reshape(-1))).numpy()
    mag = np.maximum(np.maximum(np.abs(prod), np.abs(_np(tb))), np.abs(want))
    assert _ulps(got, want, dtype, mag) <= 1.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_linear_with_ln_matches_jax(dtype):
    (jx, w_i8, scale, _, jg, jbe), (tx, tw, ts, _, tg, tbe) = _linear_case(
        np.random.RandomState(2), dtype)
    want = np.asarray(jq.int8_linear(jx, w_i8, scale, gamma=jg, beta=jbe)
                      .astype(jnp.float32))
    got = _np(tq.int8_linear(tx, tw, ts, gamma=tg, beta=tbe))
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_linear_above_2048_matches_jax(dtype):
    """An out-projection wider than 2,048 (vit-b16's 2,304 at ``dim_head``
    192), which JAX's int8_linear serves: the port's plain version, what
    the redesigned kernels compute, against JAX's interpret-mode kernel,
    with the bias as in the narrow case (1 ULP) and with LN (1e-5)."""
    (jx, w_i8, scale, jb, jg, jbe), (tx, tw, ts, tb, tg, tbe) = _linear_case(
        np.random.RandomState(4), dtype, din=2304, dout=64, rows=(1, 5))
    want = np.asarray(jq.int8_linear(jx, w_i8, scale, bias=jb).astype(jnp.float32))
    got = _np(tq.int8_linear(tx, tw, ts, bias=tb))
    assert got.shape == want.shape == (1, 5, 64)
    codes, sx = tq._quant_rows(tx.float())
    prod = (tq._int8_matmul(codes, tw) * (sx * ts.reshape(-1))).numpy()
    mag = np.maximum(np.maximum(np.abs(prod), np.abs(_np(tb))), np.abs(want))
    assert _ulps(got, want, dtype, mag) <= 1.0
    want = np.asarray(jq.int8_linear(jx, w_i8, scale, gamma=jg, beta=jbe).astype(jnp.float32))
    assert _rel(_np(tq.int8_linear(tx, tw, ts, gamma=tg, beta=tbe)), want) <= 1e-5


@pytest.mark.parametrize("gelu", ["tanh", "exact"])
@pytest.mark.parametrize("residual", [False, True])
def test_int8_mlp_matches_jax(gelu, residual):
    rng = np.random.RandomState(3)
    dim, mlp = 128, 512
    x = rng.randn(2, 24, dim).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(dim)).astype(np.float32)
    be = (0.1 * rng.randn(dim)).astype(np.float32)
    w1 = (rng.randn(mlp, dim) * dim ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.randn(mlp)).astype(np.float32)
    w2 = (rng.randn(dim, mlp) * mlp ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.randn(dim)).astype(np.float32)
    w1_i8, s1 = jq.quantize_weight(jnp.asarray(w1))
    w2_i8, s2 = jq.quantize_weight(jnp.asarray(w2))
    want = np.asarray(jq.int8_mlp(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), w1_i8, s1,
                                  jnp.asarray(b1), w2_i8, s2, jnp.asarray(b2), 1e-5, gelu,
                                  residual=residual))
    def t(a):
        return torch.from_numpy(np.array(a))

    got = tq.int8_mlp(t(x), t(g), t(be), t(w1_i8), t(s1), t(b1), t(w2_i8), t(s2), t(b2),
                      1e-5, gelu, residual=residual).numpy()
    assert _rel(got, want) <= 1e-5


def test_int8_wrappers_refuse_a_gradient():
    x = torch.randn(1, 4, 32, requires_grad=True)
    w_i8, scale = tq.quantize_weight(torch.randn(16, 32))
    with pytest.raises(NotImplementedError, match="serving-only"):
        tq.int8_linear(x, w_i8, scale)
    ones, zeros = torch.ones(32), torch.zeros(32)
    with pytest.raises(NotImplementedError, match="serving-only"):
        tq.int8_mlp(x, ones, zeros, w_i8, scale, torch.zeros(16), *tq.quantize_weight(
            torch.randn(32, 16)), zeros)
    with torch.no_grad():
        assert tq.int8_linear(x, w_i8, scale).shape == (1, 4, 16)


@pytest.fixture
def int8_calls(monkeypatch):
    """Counts the port model's calls of each int8 function."""
    from gaviko_tpu_torch.core import vit as tvit

    calls = {"int8_linear": 0, "int8_mlp": 0}
    for name in calls:
        fn = getattr(tvit, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tvit, name, counted)
    return calls


def _logits_case(cfg, depth, jp_int8, x):
    """(JAX int8 logits, port int8 logits, port fp logits, depth) at fp32."""
    jm, tm = jax_build_model(cfg), build_model(cfg)
    jspec, tspec = jm.spec, tm.spec
    if depth is not None:
        jspec = dataclasses.replace(jspec, depth=depth)
        tspec = dataclasses.replace(tspec, depth=depth)
    want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jspec))(jp_int8, jnp.asarray(x)))
    params = from_jax({k: v for k, v in jp_int8.items() if "::" not in k})
    qparams = tq.quantize_backbone(params, tspec.depth)
    with torch.no_grad():
        got = tm.apply(qparams, torch.from_numpy(x), tspec).numpy()
        fp = tm.apply(params, torch.from_numpy(x), tspec).numpy()
    return want, got, fp, tspec.depth


@pytest.mark.parametrize("model", ["gaviko", "vit-t16", "vit-b16"])
def test_int8_logits_match_jax(gaviko_params, int8_calls, model):
    x = np.random.RandomState(4).rand(*SHAPE).astype(np.float32)
    if model == "gaviko":
        cfg, depth, (jm, jp) = GAVIKO, None, gaviko_params
    else:
        cfg, depth = {**TINY_VIT, "backbone": model}, 2
        jm = jax_build_model(cfg)
        jspec = dataclasses.replace(jm.spec, depth=depth)
        jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jspec).items()}
    jp_int8 = {k: np.asarray(v) for k, v in jq.quantize_backbone(
        {k: jnp.asarray(v) for k, v in jp.items()}).items()}
    want, got, fp, depth = _logits_case(cfg, depth, jp_int8, x)
    # Every layer's qkv, out-projection and MLP ran int8 (the plain ViT's
    # CLS-fast last layer deferring to them); the fp forward ran none.
    assert int8_calls == {"int8_linear": 2 * depth, "int8_mlp": depth}
    assert got.shape == want.shape == (2, 5)
    assert _rel(got, want) <= 1e-2
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert _rel(got, fp) < 5e-2


def test_train_forward_ignores_the_sidecars():
    cfg = {**TINY_VIT, "backbone": "vit-t16"}
    tm = build_model(cfg)
    spec = dataclasses.replace(tm.spec, depth=2)
    params = tm.init(torch.Generator().manual_seed(0), spec)
    qparams = tq.quantize_backbone(params)
    x = torch.from_numpy(np.random.RandomState(5).rand(*SHAPE).astype(np.float32))
    runs = [tm.apply(p, x, spec, train=True,
                     seeds=SeedStream(generator=torch.Generator().manual_seed(7)))
            for p in (params, qparams)]
    assert torch.equal(runs[0], runs[1])


CONFIG = {"model": dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
                        num_classes=5, channels=1, pool="cls", backbone="vit-s16",
                        method="gaviko", freeze_vit=True, num_prompts=4,
                        prompt_latent_dim=8, local_dim=8, local_k=[2, 2, 2])}


def test_predictor_int8_matches_jax(tmp_path):
    jm = jax_build_model(CONFIG["model"])
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3), jm.spec).items()}
    ckpt = str(tmp_path / "full.npz")
    np.savez(ckpt, **params)
    kw = dict(checkpoint=ckpt, batch_size=2, dtype="float32", pretrained_dir=None,
              quantize="int8")
    port, jpred = Predictor(CONFIG, device="cpu", **kw), JaxPredictor(CONFIG, **kw)
    rng = np.random.RandomState(0)
    vols = [rng.rand(24, 32, 32).astype(np.float32) for _ in range(3)]
    got, want = port.predict_logits(vols), jpred.predict_logits(vols)
    assert _rel(got, want) <= 1e-2 and (got.argmax(-1) == want.argmax(-1)).all()
    port.reload_checkpoint(ckpt)  # quantizes anew
    assert any(k.endswith(tq.INT8_SUFFIX) for k in port.params)
    np.testing.assert_array_equal(port.predict_logits(vols), got)


def test_evaluate_quantized_writes_jax_csv(tmp_path):
    root = str(tmp_path)
    csv_path, volumes = make_synth_dataset(root, n_train=1, n_val=4)
    config = tiny_config(root, csv_path, volumes, method="fft")
    config["model"]["backbone"] = "vit-s16"
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    jm = jax_build_model(config["model"])
    ckpt = os.path.join(root, "full.npz")
    np.savez(ckpt, **{k: np.asarray(v) for k, v in
                      jm.init(jax.random.PRNGKey(1), jm.spec).items()})
    port_out, jax_out = os.path.join(root, "port_out"), os.path.join(root, "jax_out")
    got = tcli_eval.main(["--config", path, "--method", "fft", "--checkpoint", ckpt,
                          "--results_dir", port_out, "--quantize", "int8", "--device", "cpu"])
    jcfg = copy.deepcopy(config)
    jcfg["utils"].update(checkpoint=ckpt, results_dir=jax_out, quantize="int8")
    want = jcli_eval.evaluate(jcfg)
    assert os.path.basename(got["csv"]) == os.path.basename(want["csv"])
    for key in ("accuracy", "kappa", "auc"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
    with open(got["csv"]) as a, open(want["csv"]) as b:
        assert a.read() == b.read()
