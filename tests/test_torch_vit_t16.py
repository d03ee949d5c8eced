"""PyTorch port: vit-t16 and a dim_head-128 ViT against the JAX package on
the CPU (fp32, tiny 24x32x32 geometry, depth 3, B2).

vit-t16's 3 heads fail the fused MHSA gate, so both packages slice the
stream to its real rows and run ``multi_head_attention``: the flash
attention kernel at eval and in dropout-free training (JAX's Pallas kernels
in interpret mode, the port's plain version), plain attention with
``layers.dropout`` on the probabilities when dropout is on. The dim_head-128
ViT (vit-s16 widths, 2 heads of 128) takes the fused route at head dim 128:
fused MHSA forward and backward, and the CLS attention at 128 in the last
layer. Both packages run their kernel route (``set_default_impl("flash")``
on the JAX side):

- logits of fft / linear / bitfit within 1e-4 (MAE), and the flash
  attention wrapper called in every full layer at eval;
- three fft train steps with dropout and emb_dropout 0.1 and with 0, fed
  the JAX step's own dropout seeds: per-step loss atol 1e-5, params 2e-4,
  step-1 gradients 1e-5, equal seed counts;
- three steps of a lone attention block on a 13-row stream (no multiple of
  8), which pads around ``fused_mhsa`` and differentiates it on the packed
  qkv (its VJP is kernel B), with dropout 0.1: loss 1e-5, params 2e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.config import make_spec as jax_make_spec
from gaviko_tpu.core import vit as jvit
from gaviko_tpu.core.layers import RngStream
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.ops import attention as jattn
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import losses as jlosses
from gaviko_tpu_torch.config import make_spec
from gaviko_tpu_torch.core import vit as tvit
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.ops import attention as tattn
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops.fused_mlp import fused_mlp_supported
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from gaviko_tpu_torch.weights.from_jax import from_jax

SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "accumulation_steps": 1,
             "precision": "fp32", "scheduler": SCHED}
TINY = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
            num_classes=5, channels=1, pool="cls")
# name -> (config, spec overrides)
MODELS = {"vit_t16": (dict(TINY, backbone="vit-t16"), {}),
          "dh128": (dict(TINY, backbone="vit-s16", dim_head=128), {"heads": 2})}
DEPTH = 3


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _models(name, method, rate=0.0):
    cfg, over = MODELS[name]
    cfg = {**cfg, "method": method, "dropout": rate, "emb_dropout": rate}
    jm, tm = jax_build_model(cfg), build_model(cfg)
    over = {**over, "depth": DEPTH}
    jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, **over))
    tm = dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, **over))
    return jm, tm


def _jax_params(jm, seed=0):
    return {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(seed), jm.spec).items()}


@pytest.fixture
def flash_route():
    jattn.set_default_impl("flash")
    yield
    jattn.set_default_impl("xla")


@pytest.mark.parametrize("method", ["fft", "linear", "bitfit"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_match_jax_kernel_route(monkeypatch, flash_route, name, method):
    jm, tm = _models(name, method)
    assert tfa.fused_mhsa_supported(tm.spec.heads, tm.spec.dim_head, 16) == (name == "dh128")
    jp = _jax_params(jm, seed=1)
    x = np.random.RandomState(1).rand(2, 1, 24, 32, 32).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jp, jnp.asarray(x)))
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention", lambda *a: calls.append(1) or real(*a))
    got = tm.apply(from_jax(jp), torch.from_numpy(x), tm.spec).numpy()
    assert got.shape == want.shape == (2, 5)
    assert np.abs(got - want).mean() < 1e-4, np.abs(got - want).mean()
    assert len(calls) == (DEPTH - 1 if name == "vit_t16" else 0)


def n_seeds(tm, rate) -> int:
    """Dropout sites of one train forward: the embedding, per full layer the
    attention, the out-projection and the MLP (one site on the fused MLP
    route, two on the plain one), four in the CLS-fast last layer."""
    if rate == 0.0:
        return 0
    mlp = 1 if fused_mlp_supported(tm.spec.dim, tm.spec.mlp_dim, torch.float32) else 2
    return 1 + (2 + mlp) * (DEPTH - 1) + 4


def _step_seeds(step: int, n: int):
    rs = RngStream(jax.random.fold_in(jax.random.PRNGKey(0), step))
    return [int(rs.next_seed()) for _ in range(n)]


@pytest.fixture(scope="module", params=[("vit_t16", 0.1), ("vit_t16", 0.0),
                                        ("dh128", 0.1), ("dh128", 0.0)],
                ids=lambda p: f"{p[0]}-rate{p[1]}")
def train_run(request):
    """Three fft train steps of both packages (JAX on its kernel route) from
    the same params, batches and dropout seeds; the step-1 gradients."""
    name, rate = request.param
    jm, tm = _models(name, "fft", rate)
    jp = _jax_params(jm)
    total, n_steps, B = 10, 3, 2
    rng = np.random.RandomState(0)
    batches = [(rng.rand(B, 1, 24, 32, 32).astype(np.float32),
                rng.randint(0, 5, B).astype(np.int32)) for _ in range(n_steps)]
    n = n_seeds(tm, rate)

    jattn.set_default_impl("flash")
    try:
        crit_j = jlosses.make_criterion(TRAIN_CFG)
        tx, _, fused_j = jloop.make_optimizer(TRAIN_CFG, total)
        jstep, _, _ = jloop.make_steps(jm, crit_j, tx, jnp.float32, fused=fused_j)
        jtr, jfr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in jp.items()})

        def loss_fn(tr, x, y, key):
            logits = jm.apply({**jfr, **tr}, x, jm.spec, train=True, rng=key)
            return crit_j(logits.astype(jnp.float32), y)

        _, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
            jtr, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]),
            jax.random.fold_in(jax.random.PRNGKey(0), 0))
        jgrads = {k: np.asarray(v) for k, v in jgrads.items()}
        jopt_state = jloop.init_opt_state(tx, fused_j, jtr)
        jlosses_ = []
        for i, (x, y) in enumerate(batches):
            jtr, jopt_state, loss, _ = jstep(jtr, jopt_state, jfr, jnp.asarray(x),
                                             jnp.asarray(y),
                                             jax.random.fold_in(jax.random.PRNGKey(0), i))
            jlosses_.append(float(loss))
        jfinal = {k: np.asarray(v) for k, v in jtr.items()}
    finally:
        jattn.set_default_impl("xla")

    crit_t = tlosses.make_criterion(TRAIN_CFG)
    tstep, _, _ = tloop.make_steps(tm, crit_t, tloop.make_optimizer(TRAIN_CFG, total))
    ttr, tfr = tloop.split_params(tm, from_jax(jp))
    x0, y0 = (torch.from_numpy(a) for a in batches[0])
    _, _, tgrads = tloop.make_loss_and_grads(tm, crit_t)(ttr, tfr, x0, y0.long(),
                                                         _step_seeds(0, n))
    opt_state = tloop.init_opt_state(ttr)
    tlosses_, seed_counts = [], []
    for i, (x, y) in enumerate(batches):
        seeds = SeedStream(_step_seeds(i, n))
        ttr, opt_state, loss, _ = tstep(ttr, opt_state, tfr, torch.from_numpy(x),
                                        torch.from_numpy(y).long(), seeds)
        tlosses_.append(float(loss))
        seed_counts.append(seeds.count)
    return dict(jlosses=jlosses_, tlosses=tlosses_, jfinal=jfinal, tfinal=ttr,
                jgrads=jgrads, tgrads=tgrads, seed_counts=seed_counts, n=n)


def test_train_steps_match_jax_losses(train_run):
    np.testing.assert_allclose(train_run["tlosses"], train_run["jlosses"], atol=1e-5)
    assert train_run["seed_counts"] == [train_run["n"]] * 3


def test_train_steps_match_jax_params(train_run):
    jf, tf = train_run["jfinal"], train_run["tfinal"]
    assert set(jf) == set(tf)
    worst = max(_max_abs(tf[k], jf[k]) for k in jf)
    assert worst <= 2e-4, worst


def test_step_one_gradients_match_jax(train_run):
    jg, tg = train_run["jgrads"], train_run["tgrads"]
    assert set(jg) == set(tg)
    for k in jg:
        assert _max_abs(tg[k], jg[k]) <= 1e-5, k
    assert float(np.abs(jg["transformer.layers.0.0.to_qkv.weight"]).max()) > 0


def test_ragged_stream_attention_block_steps_match_jax(flash_route):
    """Three SGD steps of one attention block (2 heads of 64, dropout 0.1)
    on a 13-row stream with 11 real rows: both packages pad the packed qkv
    to 16 rows around fused_mhsa and differentiate it on the packed qkv."""
    rate, N, n_true, lr = 0.1, 13, 11, 0.5
    cfg = dict(TINY, backbone="vit-t16", method="fft", dropout=rate)
    jspec = dataclasses.replace(jax_make_spec(cfg), heads=2)
    tspec = dataclasses.replace(make_spec(cfg), heads=2)
    dim, inner = jspec.dim, 2 * 64
    rng = np.random.RandomState(9)
    p = {"a.norm.weight": 1 + 0.1 * rng.randn(dim), "a.norm.bias": 0.1 * rng.randn(dim),
         "a.to_qkv.weight": rng.randn(3 * inner, dim) * dim ** -0.5,
         "a.to_out.0.weight": rng.randn(dim, inner) * inner ** -0.5,
         "a.to_out.0.bias": 0.1 * rng.randn(dim)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    xs = [rng.randn(2, N, dim).astype(np.float32) for _ in range(3)]
    target = rng.randn(2, N, dim).astype(np.float32)

    def jloss(params, x, key):
        out = jvit.attention_block_res(params, "a", x, jspec, train=True,
                                       rngs=RngStream(key), n_true=n_true)
        return jnp.mean((out[:, :n_true] - target[:, :n_true]) ** 2)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jl = []
    for i, x in enumerate(xs):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        loss, g = jax.value_and_grad(jloss)(jp, jnp.asarray(x), key)
        jl.append(float(loss))
        jp = {k: jp[k] - lr * g[k] for k in jp}

    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tl = []
    for i, x in enumerate(xs):
        seeds = SeedStream(_step_seeds_for(jax.random.fold_in(jax.random.PRNGKey(3), i)))
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        out = tvit.attention_block_res(leaves, "a", torch.from_numpy(x), tspec, train=True,
                                       seeds=seeds, n_true=n_true)
        loss = ((out[:, :n_true] - torch.from_numpy(target)[:, :n_true]) ** 2).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        tl.append(float(loss.detach()))
        assert seeds.count == 2
        tp = {k: (v - lr * g).detach() for (k, v), g in zip(leaves.items(), grads)}
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert max(_max_abs(tp[k].numpy(), jp[k]) for k in tp) <= 2e-4


def _step_seeds_for(key, n=2):
    rs = RngStream(key)
    return [int(rs.next_seed()) for _ in range(n)]
