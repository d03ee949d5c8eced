"""PyTorch port: the plain 3D ViT (methods fft / linear / bitfit) against
the JAX package (fp32 eval on the CPU).

Weights cross from the JAX package through ``weights/from_jax.py``. Against
JAX's XLA route (its default on the CPU) logits must agree with MAE < 1e-4,
the JAX package's parity budget: at the tiny geometry with vit-s16 (6
heads: vit-t16's 3 would need the unported flash_attention kernel), and at
vit-b16 width on the full 120x160x160 geometry with the depth cut to 2 on
both sides. Against JAX's kernel route (``set_default_impl("flash")``, the
Pallas kernels in interpret mode) the tiny model goes through fused
LN+linear, fused MHSA, the fused MLP and CLS attention in both packages,
and logits must agree with MAE <= 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.ops import attention as jattn
from gaviko_tpu.serving import Predictor as JaxPredictor
from gaviko_tpu_torch.core import vit as tvit
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.serving import Predictor
from gaviko_tpu_torch.weights.from_jax import from_jax

METHODS = ["fft", "linear", "bitfit"]
TINY = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
            num_classes=5, channels=1, pool="cls", backbone="vit-s16")
FULL = dict(TINY, image_size=160, frames=120, backbone="vit-b16")
GEOMETRIES = {"tiny": (TINY, None, (2, 1, 24, 32, 32)),
              "full_depth2": (FULL, 2, (1, 1, 120, 160, 160))}


def _models(cfg, method, depth=None):
    jm, tm = jax_build_model({**cfg, "method": method}), build_model({**cfg, "method": method})
    spec = tm.spec if depth is None else dataclasses.replace(tm.spec, depth=depth)
    jspec = jm.spec if depth is None else dataclasses.replace(jm.spec, depth=depth)
    return jm, jspec, tm, spec


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def jax_run(request):
    """JAX params and XLA-route logits of one geometry (shared by the methods)."""
    cfg, depth, shape = GEOMETRIES[request.param]
    jm, jspec, _, _ = _models(cfg, "fft", depth)
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jspec).items()}
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    logits = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jspec))(jp, jnp.asarray(x)))
    return cfg, depth, jp, x, logits


@pytest.mark.parametrize("method", METHODS)
def test_logits_match_jax_xla_route(jax_run, method):
    cfg, depth, jp, x, want = jax_run
    _, _, tm, spec = _models(cfg, method, depth)
    got = tm.apply(from_jax(jp), torch.from_numpy(x), spec).numpy()
    assert got.shape == want.shape == (x.shape[0], 5)
    assert np.abs(got - want).mean() < 1e-4, np.abs(got - want).mean()


@pytest.mark.parametrize("method", METHODS)
def test_trainable_mask_and_init_match_jax(jax_run, method):
    cfg, depth, jp, _, _ = jax_run
    jm, _, tm, spec = _models(cfg, method, depth)
    assert tm.trainable_mask(jp) == jm.trainable_mask(jp)
    tp = tm.init(torch.Generator().manual_seed(0), spec)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    assert torch.all(tp["transformer.layers.0.0.norm.weight"] == 1)
    assert torch.all(tp["transformer.norm.bias"] == 0)


def test_mask_semantics():
    _, _, tm, _ = _models(TINY, "linear")
    names = list(tm.init(torch.Generator().manual_seed(0), tm.spec))
    masks = {m: set(_models(TINY, m)[2].trainable_names(dict.fromkeys(names))) for m in METHODS}
    assert masks["fft"] == set(names)
    assert masks["linear"] == {"mlp_head.weight", "mlp_head.bias"}
    assert masks["bitfit"] == {n for n in names if n.endswith("bias") or "head" in n}


def _counting(monkeypatch, names):
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tvit, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tvit, name, counted)
    return counts


def test_logits_match_jax_kernel_route(monkeypatch):
    """Both packages through their fused routes: JAX's Pallas kernels in
    interpret mode, the port's wrappers (their plain versions on the CPU),
    each wrapper called as often as on the card."""
    jm, jspec, tm, spec = _models(TINY, "fft")
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(1), jspec).items()}
    x = np.random.RandomState(1).rand(2, 1, 24, 32, 32).astype(np.float32)
    jattn.set_default_impl("flash")
    try:
        want = np.asarray(jm.apply(jp, jnp.asarray(x), jspec))
    finally:
        jattn.set_default_impl("xla")
    counts = _counting(monkeypatch, ["patchify_fused", "fused_ln_linear", "self_attention",
                                     "fused_mlp", "cls_attention"])
    got = tm.apply(from_jax(jp), torch.from_numpy(x), spec).numpy()
    assert np.abs(got - want).mean() <= 1e-5, np.abs(got - want).mean()
    d = spec.depth
    assert counts == {"patchify_fused": 1, "fused_ln_linear": d, "self_attention": d - 1,
                      "fused_mlp": d - 1, "cls_attention": 1}


@pytest.mark.parametrize("pool,fast", [("mean", "1"), ("cls", "0")])
def test_other_last_layers_match_jax(monkeypatch, pool, fast):
    """pool='mean' and the CLS-fast path switched off run every layer in
    full, as in the JAX package."""
    monkeypatch.setenv("GAVIKO_CLS_FAST", fast)
    jm, jspec, tm, spec = _models({**TINY, "pool": pool}, "fft")
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(2), jspec).items()}
    x = np.random.RandomState(2).rand(2, 1, 24, 32, 32).astype(np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(x), jspec))
    counts = _counting(monkeypatch, ["cls_attention", "fused_mlp"])
    got = tm.apply(from_jax(jp), torch.from_numpy(x), spec).numpy()
    assert np.abs(got - want).mean() < 1e-4
    assert counts == {"cls_attention": 0, "fused_mlp": spec.depth}


def test_gradient_needed_keeps_the_plain_routes(monkeypatch):
    """A forward that needs a gradient takes the JAX package's routes: the
    fused MLP (its backward is kernel B7), and, as the layers run with
    ``train=False``, the fused LN+linear (its backward is B12) for the qkv
    of every full layer and the last layer's kv, the packed qkv through
    ``self_attention`` (kernel B), patchify with its weight gradient; never
    the inference-only CLS attention kernel, which has no backward."""
    _, _, tm, spec = _models(TINY, "fft")
    params = {k: v.requires_grad_(True) for k, v in
              tm.init(torch.Generator().manual_seed(0), spec).items()}
    x = torch.rand(2, 1, 24, 32, 32, generator=torch.Generator().manual_seed(3))
    counts = _counting(monkeypatch, ["fused_ln_linear", "fused_mlp", "self_attention",
                                     "self_attention_train", "cls_attention",
                                     "patchify_fused"])
    tm.apply(params, x, spec).sum().backward()
    d = spec.depth
    assert counts == {"fused_ln_linear": d, "fused_mlp": d - 1, "self_attention": d - 1,
                      "self_attention_train": 0, "cls_attention": 0, "patchify_fused": 1}
    assert all(params[k].grad is not None for k in ("conv_proj.0.weight", "mlp_head.bias",
                                                   "transformer.layers.0.0.to_qkv.weight",
                                                   "transformer.layers.0.1.net.1.weight"))


def test_add_cls_and_pos_and_pool_match_jax():
    from gaviko_tpu.core import vit as jvit

    jm, jspec, tm, spec = _models({**TINY, "pool": "mean"}, "fft")
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(5), jspec).items()}
    tokens = np.random.RandomState(5).randn(2, spec.num_patches, spec.dim).astype(np.float32)
    want = jvit.add_cls_and_pos(jp, jnp.asarray(tokens))
    got = tvit.add_cls_and_pos(from_jax(jp), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tvit.pool_and_head(from_jax(jp), got, spec).numpy(),
                               np.asarray(jvit.pool_and_head(jp, want, jspec)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", METHODS)
def test_training_is_not_ported(method):
    """``vit_apply(train=True)`` is ported for every ViT method: each
    dropout site draws one seed (the embedding, three a full layer, four in
    the CLS-fast last layer), dropout changes the logits, and a seed stream
    is required. (Named when ViT training was still refused.)"""
    _, _, tm, spec = _models({**TINY, "dropout": 0.1, "emb_dropout": 0.1}, method)
    params = tm.init(torch.Generator().manual_seed(0), spec)
    x = torch.rand(2, 1, 24, 32, 32, generator=torch.Generator().manual_seed(6))
    seeds = SeedStream(generator=torch.Generator().manual_seed(7))
    train = tm.apply(params, x, spec, train=True, seeds=seeds)
    assert seeds.count == 1 + 3 * (spec.depth - 1) + 4
    eval_ = tm.apply(params, x, spec)
    assert train.shape == eval_.shape == (2, 5) and torch.isfinite(train).all()
    assert not torch.equal(train, eval_)
    with pytest.raises(ValueError, match="no seed stream"):
        tm.apply(params, x, spec, train=True)


def test_predictor_serves_fft_like_the_jax_predictor(tmp_path):
    config = {"model": {**TINY, "method": "fft"}}
    jm = jax_build_model(config["model"])
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(4), jm.spec).items()}
    ckpt = str(tmp_path / "vit.npz")
    np.savez(ckpt, **params)
    kw = dict(checkpoint=ckpt, batch_size=2, dtype="float32", pretrained_dir=None)
    vols = [np.random.RandomState(i).rand(24, 32, 32).astype(np.float32) for i in range(3)]
    got = Predictor(config, device="cpu", **kw).predict_logits(vols)
    want = JaxPredictor(config, **kw).predict_logits(vols)
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, atol=1e-4)
