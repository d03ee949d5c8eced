"""PyTorch port: the GAViKO slice against the JAX package (fp32 eval).

Weights cross from the JAX package through ``weights/from_jax.py``; the JAX
side runs its XLA reference paths on the CPU, the port its plain versions.
Logits must agree with MAE < 1e-4 (the JAX package's own parity budget).
vit-s16 keeps 6 heads (the fused MHSA gate's even head count); its depth
comes from the backbone table.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu_torch.models import gaviko as tgaviko
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.weights.from_jax import from_jax

BASE = dict(num_classes=5, channels=1, pool="cls", backbone="vit-s16",
            method="gaviko", freeze_vit=True)
GEOMETRIES = {
    "tiny": (dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
                  num_prompts=4, prompt_latent_dim=8, local_dim=8, local_k=(2, 2, 2)),
             (2, 1, 24, 32, 32)),
    "full": (dict(image_size=160, image_patch_size=16, frames=120, frame_patch_size=12,
                  num_prompts=32, prompt_latent_dim=20, local_dim=20, local_k=(6, 6, 6)),
             (1, 1, 120, 160, 160)),
}


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def pair(request):
    geom, shape = GEOMETRIES[request.param]
    cfg = {**BASE, **geom}
    jm, tm = jax_build_model(cfg), build_model(cfg)
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}
    return jm, tm, jp, shape


def test_logits_match_jax(pair):
    jm, tm, jp, shape = pair
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jp, jnp.asarray(x)))
    got = tm.apply(from_jax(jp), torch.from_numpy(x), tm.spec).numpy()
    assert got.shape == want.shape == (shape[0], 5)
    assert np.abs(got - want).mean() < 1e-4, np.abs(got - want).mean()


def test_trainable_mask_matches_jax(pair):
    jm, tm, jp, _ = pair
    assert tm.trainable_mask(jp) == jm.trainable_mask(jp)


def test_init_matches_jax_names_shapes(pair):
    jm, tm, jp, _ = pair
    tp = tm.init(torch.Generator().manual_seed(0), tm.spec)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    # The reference's fixed values: LN ones, balancer bias 0.5, zeroed biases.
    assert torch.all(tp["transformer.attns.0.norm.weight"] == 1)
    assert torch.all(tp["transformer.prompt_projs.0.gl_balancer.gl_balancer_.1.bias"] == 0.5)
    assert torch.all(tp["transformer.local_attns.0.proj_down.bias"] == 0)
    w = tp["transformer.prompt_projs.0.global_attention.query_proj.weight"]
    torch.testing.assert_close(w @ w.t(), torch.eye(w.shape[0]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("source", ["init", "from_jax"])
def test_aliases_are_separate_copies(pair, source):
    _, tm, jp, _ = pair
    p = (tm.init(torch.Generator().manual_seed(0), tm.spec) if source == "init"
         else from_jax(jp))
    for alias, canon in tgaviko.aliases(tm.spec).items():
        torch.testing.assert_close(p[alias], p[canon], rtol=0, atol=0)
        assert p[alias].untyped_storage().data_ptr() != \
            p[canon].untyped_storage().data_ptr()


def test_from_jax_copies_and_casts():
    src = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
           "b": np.arange(3, dtype=np.int32),
           "c": jnp.asarray([1.5, -2.25], jnp.bfloat16)}
    out = from_jax(src, dtype=torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == torch.int32
    assert out["c"].dtype == torch.bfloat16
    assert out["c"].float().tolist() == [1.5, -2.25]
    src["a"][0, 0] = 100.0
    assert float(out["a"][0, 0]) == 0.0


def test_training_is_not_ported():
    """Training with a trainable backbone (freeze_vit: false) is ported: the
    backbone's dropout sites draw seeds too (two embedding sites, then per
    layer two local, two attention and one fused-MLP site), and every
    backbone tensor gets a gradient. The 3-step oracle against the JAX
    package is tests/test_torch_gaviko_train.py. (Named when a trainable
    backbone was still refused.)"""
    from gaviko_tpu_torch.core.layers import SeedStream

    geom, shape = GEOMETRIES["tiny"]
    tm = build_model({**BASE, **geom, "freeze_vit": False, "dropout": 0.1,
                      "emb_dropout": 0.1})
    params = {k: v.requires_grad_(True) for k, v in
              tm.init(torch.Generator().manual_seed(0), tm.spec).items()}
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    seeds = SeedStream(generator=torch.Generator().manual_seed(2))
    tm.apply(params, x, tm.spec, train=True, seeds=seeds).square().sum().backward()
    assert seeds.count == 2 + 5 * tm.spec.depth
    for k in ("conv_proj.0.weight", "cls_token", "transformer.attns.0.to_qkv.weight",
              "transformer.mlps.0.net.1.weight", "transformer.mlps.0.net.0.bias"):
        assert params[k].grad is not None and float(params[k].grad.abs().max()) > 0, k


def test_frozen_backbone_training_forward_consumes_two_seeds_a_layer():
    from gaviko_tpu_torch.core.layers import SeedStream

    geom, shape = GEOMETRIES["tiny"]
    tm = build_model({**BASE, **geom})
    params = tm.init(torch.Generator().manual_seed(0), tm.spec)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    seeds = SeedStream(generator=torch.Generator().manual_seed(2))
    train = tm.apply(params, x, tm.spec, train=True, seeds=seeds)
    assert seeds.count == 2 * tm.spec.depth
    eval_ = tm.apply(params, x, tm.spec)
    assert train.shape == eval_.shape and torch.isfinite(train).all()
    assert not torch.equal(train, eval_)  # the local branch dropped something
