"""PyTorch port: the sharded train step and forward on a data=2 x model=2
mesh of four spawned gloo ranks (``tests/torch_parallel_ranks.py``),
against the JAX package on the CPU.

The oracles are the JAX package's ``make_parallel_train_step`` on its own
data=2 x model=2 mesh (the conftest's virtual devices) and its
single-device ``make_steps``, both on its TPU route (``flash``: the Pallas
kernels in interpret mode, whose dropout the port replays). GAViKO (frozen
vit-s16 backbone: the global layers split by heads and hidden columns, the
gradient reaching the prompts through them) and fft (every weight trained,
split), both at depth 2 with dropout on (0.1 in the backbone, 0.2 in the
local branch), three steps of a global batch of 4 fed the JAX step's own
seeds. Budgets: per-step loss atol 1e-5 and parameters 2e-4 after three
steps (the JAX package's train budgets), and the sharded forward's logits
within MAE 1e-4 of the JAX single-device forward (its XLA route: no
dropout at inference). The ranks run while JAX compiles.
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
from gaviko_tpu.parallel.mesh import make_mesh, make_parallel_train_step
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import losses as jlosses
from gaviko_tpu_torch.models.factory import build_model
from tests import torch_parallel_ranks as ranks

SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "accumulation_steps": 1,
             "precision": "fp32", "scheduler": SCHED}
BASE = dict(num_classes=5, channels=1, pool="cls", backbone="vit-s16", attn_drop=0.2,
            proj_drop=0.2, dropout=0.1, emb_dropout=0.1, image_size=32, image_patch_size=16,
            frames=24, frame_patch_size=12, num_prompts=4, prompt_latent_dim=8, local_dim=8,
            local_k=(2, 2, 2))
RUNS = {"gaviko": dict(method="gaviko", freeze_vit=True), "fft": dict(method="fft")}
DEPTH, STEPS, B, TOTAL, N_SEEDS = 2, 3, 4, 10, 16


def _key(step):
    return jax.random.fold_in(jax.random.PRNGKey(0), step)


def _seeds(step):
    rs = RngStream(_key(step))
    return [int(rs.next_seed()) for _ in range(N_SEEDS)]


def _copy(tree):
    return {k: jnp.array(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.RandomState(0)
    batches = [(rng.rand(B, 1, 24, 32, 32).astype(np.float32),
                rng.randint(0, 5, B).astype(np.int32)) for _ in range(STEPS)]
    infer_x = rng.rand(B, 1, 24, 32, 32).astype(np.float32)
    seeds = [_seeds(i) for i in range(STEPS)]
    params = {}
    for name, over in RUNS.items():  # the port's init: both packages take any params
        tm = build_model({**BASE, **over})
        params[name] = {k: v.numpy() for k, v in tm.init(
            torch.Generator().manual_seed(0),
            dataclasses.replace(tm.spec, depth=DEPTH)).items()}
    # The ranks run while the JAX package compiles its oracles.
    handle = ranks.start(ranks.train_rank, 4, str(tmp_path_factory.mktemp("ranks")),
                         [({**BASE, **over}, DEPTH, params[name], seeds, batches)
                          for name, over in RUNS.items()], 2, TRAIN_CFG, TOTAL, infer_x)
    jax_out = {}
    jattn.set_default_impl("flash")
    try:
        for name, over in RUNS.items():
            cfg = {**BASE, **over}
            jm = jax_build_model(cfg)
            jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=DEPTH))
            jp = params[name]
            crit = jlosses.make_criterion(TRAIN_CFG)
            tx, _, fused = jloop.make_optimizer(TRAIN_CFG, TOTAL)
            tr, fr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in jp.items()})
            # The forward has no dropout: JAX's XLA route computes it.
            jattn.set_default_impl("xla")
            res = {"logits": np.asarray(jax.jit(lambda p, x: jm.apply(p, x, jm.spec))(
                {**fr, **tr}, jnp.asarray(infer_x)))}
            jattn.set_default_impl("flash")
            single, _, _ = jloop.make_steps(jm, crit, tx, jnp.float32, fused=fused)
            mesh = make_mesh(data=2, model=2)
            pstep, _, (pt, pf, po) = make_parallel_train_step(
                jm, crit, tx, mesh, _copy(tr), fr, jloop.init_opt_state(tx, fused, tr),
                tp=True, zero=True, fused=fused)
            st, so = _copy(tr), jloop.init_opt_state(tx, fused, tr)
            res["single"], res["mesh"] = [], []
            for i, (x, y) in enumerate(batches):
                st, so, loss, _ = single(st, so, fr, jnp.asarray(x), jnp.asarray(y), _key(i))
                res["single"].append(float(loss))
                pt, po, loss, _ = pstep(pt, po, pf, jnp.asarray(x), jnp.asarray(y), _key(i))
                res["mesh"].append(float(loss))
            res["single_params"] = {k: np.asarray(v) for k, v in st.items()}
            res["mesh_params"] = {k: np.asarray(v) for k, v in pt.items()}
            jax_out[name] = res
    finally:
        jattn.set_default_impl("xla")
    port = ranks.join(handle)
    return jax_out, dict(zip(RUNS, port[0])), port


@pytest.mark.parametrize("name", sorted(RUNS))
def test_dp2_tp2_losses_match_jax(run, name):
    jax_out, port, _ = run
    np.testing.assert_allclose(port[name]["losses"], jax_out[name]["single"], atol=1e-5)
    np.testing.assert_allclose(port[name]["losses"], jax_out[name]["mesh"], atol=1e-5)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_dp2_tp2_params_match_jax(run, name):
    jax_out, port, every = run
    got = port[name]["trainable"]
    for ref in ("single_params", "mesh_params"):
        want = jax_out[name][ref]
        assert set(got) == set(want)
        worst = max(float(np.max(np.abs(got[k].astype(np.float64) - want[k]))) for k in want)
        assert worst <= 2e-4, (ref, worst)
    # Every rank holds the same whole state after the gather.
    i = list(RUNS).index(name)
    for r in every[1:]:
        assert all(np.array_equal(r[i]["trainable"][k], got[k]) for k in got)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_dp2_tp2_forward_matches_jax_single_device(run, name):
    jax_out, port, _ = run
    mae = float(np.mean(np.abs(port[name]["logits"] - jax_out[name]["logits"])))
    assert mae < 1e-4, mae
