"""PyTorch port: three train steps of each PEFT method against the JAX
package's ``make_steps`` on the CPU.

The configurations of ``tests/test_torch_peft.py`` (vit-s16, 24x32x32,
fp32, B2, depth 3, ``freeze_vit: true``, dropout, embedding and prompt
dropout 0.1), the switched-off branches filled with random values. JAX runs
its kernel route (``set_default_impl("flash")``: the Pallas kernels in
interpret mode), the route the port takes everywhere; the port is fed the
JAX step's own dropout seeds. With the backbone frozen only the prompts'
dropout draws seeds (deep VPT one a layer, shallow VPT one); MeLO trains
its whole backbone in train mode (the embedding, three a full layer, four
in the CLS-fast last one); the others draw none. For each method:

- per-step losses within 1e-5 of JAX's and equal seed counts;
- the trainable params after three steps within 2e-4 of JAX's;
- one step's kernel-wrapper calls (the plain versions on the CPU, as
  often as the kernels launch on the card) equal
  ``chip_smoke.zoo_launches`` of the step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.core.layers import RngStream
from gaviko_tpu.ops import attention as jattn
from gaviko_tpu.ops import cls_attention as jcls
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import losses as jlosses
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from gaviko_tpu_torch.weights.from_jax import from_jax
from tests.test_torch_peft import (
    DEPTH, SHAPE, ZOO, cfg_of, count_launches, expected_launches, models, zoo_params)

SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "accumulation_steps": 1,
             "precision": "fp32", "scheduler": SCHED}
STEPS, TOTAL = 3, 10


def n_seeds(spec) -> int:
    """Dropout sites of one train forward: the prompts' with the backbone
    frozen; MeLO's backbone on the fused route (vit-s16 fp32: the fused
    MLP's gate holds)."""
    if spec.method == "deep_vpt":
        return spec.depth
    if spec.method == "shallow_vpt":
        return 1
    if spec.method == "melo":
        return 1 + 3 * (spec.depth - 1) + 4
    return 0


def _step_seeds(step: int, n: int):
    rs = RngStream(jax.random.fold_in(jax.random.PRNGKey(0), step))
    return [int(rs.next_seed()) for _ in range(n)]


def _jax_steps(jm, jp, batches):
    tx, _, fused_j = jloop.make_optimizer(TRAIN_CFG, TOTAL)
    jstep, _, _ = jloop.make_steps(jm, jlosses.make_criterion(TRAIN_CFG), tx, jnp.float32,
                                   fused=fused_j)
    jtr, jfr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in jp.items()})
    jopt = jloop.init_opt_state(tx, fused_j, jtr)
    losses = []
    for i, (x, y) in enumerate(batches):
        jtr, jopt, loss, _ = jstep(jtr, jopt, jfr, jnp.asarray(x), jnp.asarray(y),
                                   jax.random.fold_in(jax.random.PRNGKey(0), i))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in jtr.items()}


@pytest.fixture(scope="module", params=ZOO)
def zoo_run(request):
    """Three train steps of both packages from the same params, batches and
    dropout seeds."""
    jm, tm = models(cfg_of(request.param))
    jp = zoo_params(request.param)
    rng = np.random.RandomState(0)
    batches = [(rng.rand(*SHAPE).astype(np.float32), rng.randint(0, 5, SHAPE[0]).astype(np.int32))
               for _ in range(STEPS)]
    n = n_seeds(tm.spec)

    jattn.set_default_impl("flash")
    try:
        with pytest.MonkeyPatch.context() as mp:
            # JAX's kernel route cannot differentiate AdaptFormer's and SSF's
            # CLS-fast last layer with the backbone frozen: it calls the
            # inference-only CLS attention kernel, which has no VJP, under a
            # gradient ("Linearization failed"). The port takes that
            # kernel's plain twin there, as JAX's XLA route does; so does
            # the oracle, with the kernel's gate off.
            mp.setattr(jcls, "cls_attention_supported", lambda *a: False)
            jlosses_, jfinal = _jax_steps(jm, jp, batches)
    finally:
        jattn.set_default_impl("xla")

    tstep, _, _ = tloop.make_steps(tm, tlosses.make_criterion(TRAIN_CFG),
                                   tloop.make_optimizer(TRAIN_CFG, TOTAL))
    ttr, tfr = tloop.split_params(tm, from_jax(jp))
    opt = tloop.init_opt_state(ttr)
    tlosses_, counts = [], []
    for i, (x, y) in enumerate(batches):
        seeds = SeedStream(_step_seeds(i, n))
        ttr, opt, loss, _ = tstep(ttr, opt, tfr, torch.from_numpy(x),
                                  torch.from_numpy(y).long(), seeds)
        tlosses_.append(float(loss))
        counts.append(seeds.count)
    return dict(tm=tm, jp=jp, n=n, jlosses=jlosses_, tlosses=tlosses_, jfinal=jfinal,
                tfinal=ttr, seed_counts=counts)


def test_train_steps_match_jax_losses(zoo_run):
    np.testing.assert_allclose(zoo_run["tlosses"], zoo_run["jlosses"], rtol=0, atol=1e-5)
    assert zoo_run["seed_counts"] == [zoo_run["n"]] * STEPS


def test_train_steps_match_jax_params(zoo_run):
    jf, tf = zoo_run["jfinal"], zoo_run["tfinal"]
    assert set(jf) == set(tf) and jf
    worst = max(float(np.max(np.abs(tf[k].numpy() - jf[k]))) for k in jf)
    assert worst <= 2e-4, worst
    moved = max(float(np.max(np.abs(jf[k] - zoo_run["jp"][k]))) for k in jf)
    assert moved > 10 * worst  # the steps moved the params


def test_train_step_launches(zoo_run, monkeypatch):
    """One step's kernel-wrapper calls, as on the card: patchify (EVP
    twice), the frozen layers' B9 with B12 and A with B where a gradient
    reaches them, B6 with B7, and one B13 update."""
    tm = zoo_run["tm"]
    counts = count_launches(monkeypatch)
    step, _, _ = tloop.make_steps(tm, tlosses.make_criterion(TRAIN_CFG),
                                  tloop.make_optimizer(TRAIN_CFG, TOTAL))
    trainable, frozen = tloop.split_params(tm, from_jax(zoo_run["jp"]))
    x = torch.rand(*SHAPE, generator=torch.Generator().manual_seed(1))
    step(trainable, tloop.init_opt_state(trainable), frozen, x, torch.tensor([1, 3]),
         SeedStream(_step_seeds(0, zoo_run["n"])))
    want = expected_launches(tm.spec, torch.float32, True)
    assert counts == want
    assert want["fused_mhsa_bwd"] >= DEPTH - 2 and want["fused_adam"] == 1


@pytest.mark.parametrize("method", ZOO)
def test_bf16_train_step_launches(method, monkeypatch):
    """A bf16 step (f32 masters cast inside it) calls each kernel wrapper as
    ``zoo_launches`` says the card launches them: EVP's stream stays f32
    on bf16 weights, so its layers take neither B9 nor B6."""
    _, tm = models(cfg_of(method))
    cfg = {**TRAIN_CFG, "precision": "bf16"}
    step, _, _ = tloop.make_steps(tm, tlosses.make_criterion(cfg),
                                  tloop.make_optimizer(cfg, TOTAL), torch.bfloat16)
    trainable, frozen = tloop.split_params(tm, tm.init(torch.Generator().manual_seed(0),
                                                       tm.spec))
    counts = count_launches(monkeypatch)
    seeds = SeedStream(_step_seeds(0, n_seeds(tm.spec)))
    _, _, loss, _ = step(trainable, tloop.init_opt_state(trainable), frozen,
                         torch.rand(*SHAPE, generator=torch.Generator().manual_seed(2)),
                         torch.tensor([0, 4]), seeds)
    assert counts == expected_launches(tm.spec, torch.bfloat16, True)
    assert seeds.count == n_seeds(tm.spec) and np.isfinite(float(loss))
