"""PyTorch port: GAViKO with a trainable backbone (``freeze_vit: false``),
three train steps against the JAX package on the CPU.

The JAX package runs its TPU route (``set_default_impl("flash")``: its
Pallas kernels in interpret mode, the route the port takes everywhere), the
port its plain versions; fp32, tiny geometry (vit-s16, 24x32x32, B2), depth
cut to 3, dropout and emb_dropout 0.1 in the backbone and attn_drop and
proj_drop 0.2 in the local branch, fed the JAX step's own dropout seeds.
Budgets as for the frozen-backbone step (tests/test_torch_train.py): per-step
loss atol 1e-5, params 2e-4, step-1 gradients 1e-5, equal seed counts.
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
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from gaviko_tpu_torch.weights.from_jax import from_jax

SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "accumulation_steps": 1,
             "precision": "fp32", "scheduler": SCHED}
CFG = dict(num_classes=5, channels=1, pool="cls", backbone="vit-s16", method="gaviko",
           freeze_vit=False, attn_drop=0.2, proj_drop=0.2, dropout=0.1, emb_dropout=0.1,
           image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
           num_prompts=4, prompt_latent_dim=8, local_dim=8, local_k=(2, 2, 2))
DEPTH = 3
# Two embedding sites, then per layer: local attention and proj_drop, the
# MHSA kernel and the out-projection, the fused MLP kernel.
N_SEEDS = 2 + 5 * DEPTH


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _step_seeds(step: int):
    rs = RngStream(jax.random.fold_in(jax.random.PRNGKey(0), step))
    return [int(rs.next_seed()) for _ in range(N_SEEDS)]


@pytest.fixture(scope="module")
def run():
    jm, tm = jax_build_model(CFG), build_model(CFG)
    jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=DEPTH))
    tm = dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, depth=DEPTH))
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}
    total, n_steps, B = 10, 3, 2
    rng = np.random.RandomState(0)
    batches = [(rng.rand(B, 1, 24, 32, 32).astype(np.float32),
                rng.randint(0, 5, B).astype(np.int32)) for _ in range(n_steps)]

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
                                                         _step_seeds(0))
    opt_state = tloop.init_opt_state(ttr)
    tlosses_, seed_counts = [], []
    for i, (x, y) in enumerate(batches):
        seeds = SeedStream(_step_seeds(i))
        ttr, opt_state, loss, _ = tstep(ttr, opt_state, tfr, torch.from_numpy(x),
                                        torch.from_numpy(y).long(), seeds)
        tlosses_.append(float(loss))
        seed_counts.append(seeds.count)
    return dict(jlosses=jlosses_, tlosses=tlosses_, jfinal=jfinal, tfinal=ttr,
                jgrads=jgrads, tgrads=tgrads, seed_counts=seed_counts)


def test_trainable_backbone_steps_match_jax_losses(run):
    np.testing.assert_allclose(run["tlosses"], run["jlosses"], atol=1e-5)
    assert run["seed_counts"] == [N_SEEDS] * 3


def test_trainable_backbone_steps_match_jax_params(run):
    jf, tf = run["jfinal"], run["tfinal"]
    assert set(jf) == set(tf)
    worst = max(_max_abs(tf[k], jf[k]) for k in jf)
    assert worst <= 2e-4, worst


def test_trainable_backbone_step_one_gradients_match_jax(run):
    jg, tg = run["jgrads"], run["tgrads"]
    assert set(jg) == set(tg)
    for k in jg:
        assert _max_abs(tg[k], jg[k]) <= 1e-5, k
    assert float(np.abs(jg["conv_proj.0.weight"]).max()) > 0
    assert float(np.abs(jg["transformer.mlps.0.net.1.weight"]).max()) > 0
