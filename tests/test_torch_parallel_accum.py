"""PyTorch port: ``accumulation_steps: 2`` under ``train.parallel``, on
spawned gloo ranks (``tests/torch_parallel_ranks.py``), against the JAX
package on the CPU.

fft at vit-s16 widths, depth 2, dropout 0.1, a global batch of 4: four
micro-steps, so two updates, fed the JAX steps' own dropout seeds. The
port runs data=2 with ZeRO (2 ranks) and data=2 x model=2 (4 ranks): each
micro-step reduce-scatters the gradients into the rank's ZeRO slices of
optax ``MultiSteps``' running mean, and every second one runs the sharded
B13 update on it. The oracles are the JAX package's
``make_parallel_train_step`` with ``optax.MultiSteps`` on its data=2 x
model=2 mesh (the conftest's virtual devices) and its single-device
``make_steps``, both on its kernel route (``flash``: the Pallas kernels in
interpret mode, whose dropout the port replays). Budgets are the parallel
step's (``tests/test_torch_parallel_train.py``): per-step loss atol 1e-5,
parameters 2e-4.

Resume files: the state the data=2 mesh gathers after micro-step 3 (mid
cycle: the running mean holds one gradient) loads in one process, and the
one-process state of that step loads on the mesh; either runs on to the
same parameters as the uninterrupted one-process run (atol 1e-6), and the
mesh's file holds the one-process state's leaves (``MultiStepsState``'s
layout, within 1e-6).
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
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.train import fused_optim
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from gaviko_tpu_torch.utils.checkpoint import load_train_state, opt_leaves, save_train_state
from tests import torch_parallel_ranks as ranks

SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "accumulation_steps": 2,
             "precision": "fp32", "scheduler": SCHED}
CFG = dict(num_classes=5, channels=1, pool="cls", backbone="vit-s16", dropout=0.1,
           emb_dropout=0.1, image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
           method="fft")
DEPTH, STEPS, B, TOTAL, N_SEEDS = 2, 4, 4, 8, 16


def _key(step):
    return jax.random.fold_in(jax.random.PRNGKey(0), step)


def _seeds(step):
    rs = RngStream(_key(step))
    return [int(rs.next_seed()) for _ in range(N_SEEDS)]


def _port_model():
    tm = build_model(CFG)
    return dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, depth=DEPTH))


def _one_process(params, batches, seeds, start=0, state=None):
    """The port's one-process run from ``start`` (a fresh state, or the
    (trainable, opt_state) ``state``) -> (losses, trainable, opt_state, the
    state after micro-step 3)."""
    tm = _port_model()
    fused = tloop.make_optimizer(TRAIN_CFG, TOTAL)
    step, _, _ = tloop.make_steps(tm, tlosses.make_criterion(TRAIN_CFG), fused)
    tr, fr = tloop.split_params(tm, {k: torch.from_numpy(v.copy()) for k, v in params.items()})
    opt = tloop.init_opt_state(tr, fused)
    if state is not None:
        tr, opt = state
    losses, after3 = [], None
    for i in range(start, STEPS):
        x, y = batches[i]
        tr, opt, loss, _ = step(tr, opt, fr, torch.from_numpy(x), torch.from_numpy(y).long(),
                                SeedStream(seeds[i]))
        losses.append(float(loss))
        if i == 2:  # CPU steps return new tensors: no copy needed
            after3 = (tr, opt)
    return losses, tr, opt, after3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.RandomState(0)
    batches = [(rng.rand(B, 1, 24, 32, 32).astype(np.float32),
                rng.randint(0, 5, B).astype(np.int32)) for _ in range(STEPS)]
    seeds = [_seeds(i) for i in range(STEPS)]
    tm = _port_model()
    params = {k: v.numpy() for k, v in tm.init(torch.Generator().manual_seed(0), tm.spec).items()}
    losses, final, final_opt, (tr3, opt3) = _one_process(params, batches, seeds)
    root = tmp_path_factory.mktemp("accum")
    one_file = str(root / "one_step3.npz")
    save_train_state(one_file, tr3, opt3, {"global_step": 3})
    common = (CFG, DEPTH, params, seeds, batches)
    # The ranks run while the JAX package compiles its oracles.
    handles = {name: ranks.start(ranks.accum_rank, world, str(root / name), *common, 2,
                                 TRAIN_CFG, TOTAL, str(root / name), resume)
               for name, world, resume in (("dp2", 2, None), ("dp2_tp2", 4, None),
                                           ("dp2_resumed", 2, one_file))}
    jattn.set_default_impl("flash")
    try:
        jm = jax_build_model(CFG)
        jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=DEPTH))
        crit = jlosses.make_criterion(TRAIN_CFG)
        tx, _, fused = jloop.make_optimizer(TRAIN_CFG, TOTAL)
        assert fused is None  # MultiSteps around the optax chain
        tr, fr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in params.items()})
        single, _, _ = jloop.make_steps(jm, crit, tx, jnp.float32, fused=None)
        pstep, _, (pt, pf, po) = make_parallel_train_step(
            jm, crit, tx, make_mesh(data=2, model=2), {k: jnp.array(v) for k, v in tr.items()},
            fr, tx.init(tr), tp=True, zero=True, fused=None)
        st, so = {k: jnp.array(v) for k, v in tr.items()}, tx.init(tr)
        jax_out = {"single": [], "mesh": []}
        for i, (x, y) in enumerate(batches):
            st, so, loss, _ = single(st, so, fr, jnp.asarray(x), jnp.asarray(y), _key(i))
            jax_out["single"].append(float(loss))
            pt, po, loss, _ = pstep(pt, po, pf, jnp.asarray(x), jnp.asarray(y), _key(i))
            jax_out["mesh"].append(float(loss))
        jax_out["single_params"] = {k: np.asarray(v) for k, v in st.items()}
        jax_out["mesh_params"] = {k: np.asarray(v) for k, v in pt.items()}
    finally:
        jattn.set_default_impl("xla")
    port = {name: ranks.join(h, timeout=300) for name, h in handles.items()}
    return dict(jax=jax_out, port=port, params=params, batches=batches, seeds=seeds,
                one=(losses, final, final_opt), one_file=one_file,
                mesh_file=str(root / "dp2" / "mesh_step3.npz"))


@pytest.mark.parametrize("mesh", ["dp2", "dp2_tp2"])
def test_accumulation_on_a_mesh_matches_jax_losses(run, mesh):
    got = run["port"][mesh][0]["losses"]
    np.testing.assert_allclose(got, run["jax"]["single"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, run["jax"]["mesh"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, run["one"][0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("mesh", ["dp2", "dp2_tp2"])
def test_accumulation_on_a_mesh_matches_jax_params(run, mesh):
    got = run["port"][mesh][0]["trainable"]
    for ref in ("single_params", "mesh_params"):
        want = run["jax"][ref]
        assert set(got) == set(want)
        worst = max(float(np.max(np.abs(got[k] - want[k]))) for k in want)
        assert worst <= 2e-4, (ref, worst)
    moved = max(float(np.max(np.abs(run["jax"]["single_params"][k] - run["params"][k])))
                for k in got)
    assert moved > 1e-4  # two updates applied
    for r in run["port"][mesh][1:]:  # every rank holds the same whole tensors
        assert all(np.array_equal(r["trainable"][k], got[k]) for k in got)


def test_one_process_resume_file_runs_on_a_mesh(run):
    """The one-process state of micro-step 3 loads on the data=2 mesh,
    which runs step 4 (the second update) to the uninterrupted run's
    parameters."""
    got = run["port"]["dp2_resumed"][0]
    np.testing.assert_allclose(got["losses"], run["one"][0][3:], rtol=0, atol=1e-5)
    final = run["one"][1]
    worst = max(float(np.max(np.abs(got["trainable"][k] - final[k].numpy()))) for k in final)
    assert worst <= 1e-6, worst


def test_mesh_resume_file_runs_in_one_process(run):
    """The data=2 mesh's gathered state of micro-step 3 holds the
    one-process state's leaves, and loads in one process, which runs step
    4 to the uninterrupted run's parameters."""
    tm = _port_model()
    fused = tloop.make_optimizer(TRAIN_CFG, TOTAL)
    tr, _ = tloop.split_params(tm, {k: torch.from_numpy(v.copy())
                                    for k, v in run["params"].items()})
    tr, opt, meta = load_train_state(run["mesh_file"], tr, tloop.opt_template(tr, fused))
    assert isinstance(opt, fused_optim.MultiStepState) and meta["global_step"] == 3
    assert (opt.mini_step, opt.gradient_step, opt.inner.count) == (1, 1, 1)
    assert max(float(a.abs().max()) for a in opt.acc.values()) > 0  # one gradient held
    with np.load(run["mesh_file"]) as z, np.load(run["one_file"]) as w:
        assert sorted(z.files) == sorted(w.files)
        assert sum(k.startswith("opt::") for k in z.files) == len(opt_leaves(opt))
        for k in w.files:
            if k != "meta::json":
                assert z[k].shape == w[k].shape and z[k].dtype == w[k].dtype, k
                assert np.max(np.abs(z[k].astype(np.float64) - w[k]), initial=0) <= 1e-6, k
    losses, final, _, _ = _one_process(run["params"], run["batches"], run["seeds"], start=3,
                                       state=(tr, opt))
    np.testing.assert_allclose(losses, run["one"][0][3:], rtol=0, atol=1e-5)
    want = run["one"][1]
    worst = max(float(np.max(np.abs(final[k].numpy() - want[k].numpy()))) for k in final)
    assert worst <= 1e-6, worst
