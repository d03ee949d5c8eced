"""PyTorch port: head dims 192 and 256 on the fused route, and an odd head
dim on the unfused one, against the JAX package on the CPU (fp32).

ViTs of vit-b16 widths (dim 768, MLP 3072) cut to 2 layers and 2 heads, at
the tiny 24x32x32 geometry, B2:

- ``dim_head`` 192 and 256 pass JAX's fused MHSA gate, so both packages run
  the fused MHSA forward and backward there (JAX's Pallas kernels in
  interpret mode on its kernel route, the plain versions of kernels A and B
  here) and the CLS attention (B8) in the last layer;
- ``dim_head`` 48 fails the gate ((2 * 48) % 128 != 0): the unfused route,
  flash attention (B10, which the card reaches zero-padded to 64) at eval
  and plain attention with dropout in training.

For each: fft / bitfit logits within 1e-4 (MAE) of JAX's, and three fft
train steps with dropout and emb_dropout 0.1, fed the JAX step's own dropout
seeds: per-step loss atol 1e-5, params 2e-4 (the JAX package's budgets).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.core.layers import RngStream
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.ops import attention as jattn
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import losses as jlosses
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
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
            num_classes=5, channels=1, pool="cls", backbone="vit-b16")
DEPTH, HEADS = 2, 2
DIM_HEADS = (192, 256, 48)


@pytest.fixture(autouse=True)
def kernel_route():
    """JAX on its kernel route (Pallas in interpret mode where it has one)."""
    jattn.set_default_impl("flash")
    yield
    jattn.set_default_impl("xla")


def _models(dim_head, method, rate=0.0):
    cfg = {**TINY, "dim_head": dim_head, "method": method, "dropout": rate,
           "emb_dropout": rate}
    over = {"depth": DEPTH, "heads": HEADS}
    jm, tm = jax_build_model(cfg), build_model(cfg)
    jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, **over))
    tm = dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, **over))
    return jm, tm


def _jax_params(jm):
    return {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}


@pytest.mark.parametrize("method", ["fft", "bitfit"])
@pytest.mark.parametrize("dim_head", DIM_HEADS)
def test_logits_match_jax(dim_head, method):
    jm, tm = _models(dim_head, method)
    assert tfa.fused_mhsa_supported(HEADS, dim_head, 16) == (dim_head != 48)
    jp = _jax_params(jm)
    x = np.random.RandomState(1).rand(2, 1, 24, 32, 32).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jp, jnp.asarray(x)))
    got = tm.apply(from_jax(jp), torch.from_numpy(x), tm.spec).numpy()
    assert got.shape == want.shape == (2, 5)
    assert np.abs(got - want).mean() < 1e-4, np.abs(got - want).mean()


def _n_seeds(tm) -> int:
    """Dropout sites of one train forward at rate > 0: the embedding, per
    full layer the attention, the out-projection and the MLP (one site on
    the fused MLP route, two on the plain one), four in the last layer."""
    mlp = 1 if fused_mlp_supported(tm.spec.dim, tm.spec.mlp_dim, torch.float32) else 2
    return 1 + (2 + mlp) * (DEPTH - 1) + 4


def _step_seeds(step: int, n: int):
    rs = RngStream(jax.random.fold_in(jax.random.PRNGKey(0), step))
    return [int(rs.next_seed()) for _ in range(n)]


@pytest.fixture(scope="module", params=DIM_HEADS, ids=lambda d: f"dh{d}")
def train_run(request):
    """Three fft train steps of both packages at dropout 0.1 from the same
    params, batches and seeds."""
    jattn.set_default_impl("flash")
    try:
        jm, tm = _models(request.param, "fft", 0.1)
        jp = _jax_params(jm)
        rng = np.random.RandomState(0)
        batches = [(rng.rand(2, 1, 24, 32, 32).astype(np.float32),
                    rng.randint(0, 5, 2).astype(np.int32)) for _ in range(3)]
        n = _n_seeds(tm)
        crit_j = jlosses.make_criterion(TRAIN_CFG)
        tx, _, fused_j = jloop.make_optimizer(TRAIN_CFG, 10)
        jstep, _, _ = jloop.make_steps(jm, crit_j, tx, jnp.float32, fused=fused_j)
        jtr, jfr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in jp.items()})
        jstate = jloop.init_opt_state(tx, fused_j, jtr)
        jl = []
        for i, (x, y) in enumerate(batches):
            jtr, jstate, loss, _ = jstep(jtr, jstate, jfr, jnp.asarray(x), jnp.asarray(y),
                                         jax.random.fold_in(jax.random.PRNGKey(0), i))
            jl.append(float(loss))
    finally:
        jattn.set_default_impl("xla")
    tstep, _, _ = tloop.make_steps(tm, tlosses.make_criterion(TRAIN_CFG),
                                   tloop.make_optimizer(TRAIN_CFG, 10))
    ttr, tfr = tloop.split_params(tm, from_jax(jp))
    tstate = tloop.init_opt_state(ttr)
    tl, counts = [], []
    for i, (x, y) in enumerate(batches):
        seeds = SeedStream(_step_seeds(i, n))
        ttr, tstate, loss, _ = tstep(ttr, tstate, tfr, torch.from_numpy(x),
                                     torch.from_numpy(y).long(), seeds)
        tl.append(float(loss))
        counts.append(seeds.count)
    return dict(jl=jl, tl=tl, jfinal={k: np.asarray(v) for k, v in jtr.items()}, tfinal=ttr,
                counts=counts, n=n)


def test_three_train_steps_match_jax(train_run):
    np.testing.assert_allclose(train_run["tl"], train_run["jl"], atol=1e-5)
    assert train_run["counts"] == [train_run["n"]] * 3
    jf, tf = train_run["jfinal"], train_run["tfinal"]
    assert set(jf) == set(tf)
    worst = max(float(np.max(np.abs(tf[k].numpy() - jf[k]))) for k in jf)
    assert worst <= 2e-4, worst
