"""PyTorch port: tensor parallelism for the rest of the PEFT zoo on two
spawned gloo ranks (``tests/torch_parallel_ranks.py``, model=2), on the CPU.

Each of deep and shallow VPT, AdaptFormer, SSF, MeLO, DVPT and EVP in the
configurations of ``tests/test_torch_peft.py`` (vit-s16: 6 heads, 3 a
rank; depth 3; ``freeze_vit: true``; dropout 0.1 where the method keeps
it live), its zero-initialised branches filled: the blocks the shard rules
cover split by heads and hidden columns, SSF's ``ssf_1`` with their rows,
everything else (prompts, adapters, the generators, MeLO's LoRA-merged
layers, the head) whole on both ranks; also MeLO with LoRA on layer 0
only, whose later layers (the CLS-fast last one included) split. Against
the port's one-process forward and train step, which
``tests/test_torch_peft*.py`` hold to JAX:

- the sharded forward's logits within MAE 1e-4;
- one train step, fed the JAX step's own dropout seeds: the loss within
  1e-5 and the gathered trainable params within 2e-4 (the budgets of
  ``tests/test_torch_parallel_train.py``), and Adam's gathered moments,
  which hold the step's gradient (the first step's update is about lr
  times its sign), within ``MOMENTS_BUDGET`` of the largest value of
  their leaf.

MeLO (dropout live in its backbone) and SSF (``ssf_1`` split) are also held
to the JAX package's ``make_parallel_train_step`` on its model=2 mesh
(its kernel route, the CLS attention kernel's gate off as in
``tests/test_torch_peft_train.py``), with the same budgets, moments
included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.ops import attention as jattn
from gaviko_tpu.ops import cls_attention as jcls
from gaviko_tpu.parallel.mesh import make_mesh, make_parallel_train_step
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import losses as jlosses
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.parallel import mesh as pmesh
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from gaviko_tpu_torch.weights.from_jax import from_jax
from tests import torch_parallel_ranks as ranks
from tests.test_torch_peft import DEPTH, SHAPE, ZOO, cfg_of, models, zoo_params
from tests.test_torch_peft_train import TRAIN_CFG, _step_seeds, n_seeds

TOTAL = 10
# Adam's moments after the step, each leaf's max error over its largest
# value (read: at most 2.3e-6 for mu and 4.2e-6 for nu against the
# one-process step, 2.5e-6 and 3.8e-6 against JAX's; with the gradient
# into a split block left unsummed over model, 0.2 to 2.0, with SSF's
# ssf_0 gradients unsummed 0.94 for SSF, while the params stayed within
# 6e-5 in both).
MOMENTS_BUDGET = 2e-5
JAX_HELD = ("melo", "ssf")
# MeLO with LoRA on layer 0 only: its later layers, the CLS-fast last one
# included, split by heads.
CASES = {**{m: cfg_of(m) for m in ZOO}, "melo_lora0": cfg_of("melo", lora_layers=[0])}


def _params(name):
    if name in ZOO:
        return zoo_params(name)
    _, tm = models(CASES[name])
    gen = torch.Generator().manual_seed(1)
    return {k: (v + 0.05 * torch.randn(v.shape, generator=gen)).numpy()
            for k, v in tm.init(torch.Generator().manual_seed(0), tm.spec).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.RandomState(0)
    x = rng.rand(*SHAPE).astype(np.float32)
    y = rng.randint(0, 5, SHAPE[0]).astype(np.int32)
    runs = {}
    for name, cfg in CASES.items():
        _, tm = models(cfg)
        runs[name] = (cfg, DEPTH, _params(name), [_step_seeds(0, max(n_seeds(tm.spec), 1))],
                      [(x, y)])
    handle = ranks.start(ranks.train_rank, 2, str(tmp_path_factory.mktemp("zoo")),
                         list(runs.values()), 1, TRAIN_CFG, TOTAL, x)
    one = {}
    for method, (cfg, _, params, seeds, _) in runs.items():
        _, tm = models(cfg)
        whole = from_jax(params)
        step, _, _ = tloop.make_steps(tm, tlosses.make_criterion(TRAIN_CFG),
                                      tloop.make_optimizer(TRAIN_CFG, TOTAL))
        tr, fr = tloop.split_params(tm, whole)
        tr, opt, loss, _ = step(tr, tloop.init_opt_state(tr), fr, torch.from_numpy(x),
                                torch.from_numpy(y).long(), SeedStream(seeds[0]))
        with torch.no_grad():
            logits = tm.apply(whole, torch.from_numpy(x), tm.spec).numpy()
        one[method] = dict(logits=logits, loss=float(loss),
                           trainable={k: v.numpy() for k, v in tr.items()},
                           mu={k: v.numpy() for k, v in opt.mu.items()},
                           nu={k: v.numpy() for k, v in opt.nu.items()})
    jax_out = {}
    jattn.set_default_impl("flash")
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcls, "cls_attention_supported", lambda *a: False)
            for method in JAX_HELD:
                jm, _ = models(CASES[method])
                crit = jlosses.make_criterion(TRAIN_CFG)
                tx, _, fused = jloop.make_optimizer(TRAIN_CFG, TOTAL)
                tr, fr = jloop.split_params(jm, {k: jnp.asarray(v)
                                                 for k, v in runs[method][2].items()})
                pstep, _, (pt, pf, po) = make_parallel_train_step(
                    jm, crit, tx, make_mesh(data=1, model=2),
                    {k: jnp.array(v) for k, v in tr.items()}, fr,
                    jloop.init_opt_state(tx, fused, tr), tp=True, zero=True, fused=fused)
                pt, po, loss, _ = pstep(pt, po, pf, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.fold_in(jax.random.PRNGKey(0), 0))
                jax_out[method] = dict(loss=float(loss),
                                       trainable={k: np.asarray(v) for k, v in pt.items()},
                                       mu={k: np.asarray(v) for k, v in po.mu.items()},
                                       nu={k: np.asarray(v) for k, v in po.nu.items()})
    finally:
        jattn.set_default_impl("xla")
    port = ranks.join(handle, timeout=300)
    return dict(runs=runs, one=one, jax=jax_out, port=[dict(zip(runs, r)) for r in port])


def _moments(got, want):
    """Adam's moments after the step (mu = 0.1 g, nu = 0.001 g^2 of the
    clipped gradient g): the worst leaf's max error over its largest
    value, per moment."""
    out = {}
    for m in ("mu", "nu"):
        assert set(got[m]) == set(want[m])
        out[m] = max(float(np.max(np.abs(got[m][k] - want[m][k])))
                     / max(float(np.max(np.abs(want[m][k]))), 1e-30) for k in want[m])
    return out


def _worst(got, want):
    assert set(got) == set(want) and want
    return max(float(np.max(np.abs(got[k] - want[k]))) for k in want)


@pytest.mark.parametrize("method", sorted(CASES))
def test_zoo_shard_plan_splits_the_covered_blocks(method):
    """Every block's qkv and MLP split, except MeLO's LoRA-merged qkv; the
    method's own weights stay whole."""
    _, tm = models(CASES[method])
    params = _params(method)
    plan = pmesh.tp_plan(params, tm.spec.heads, 2)
    qkv = [k for k in params if k.endswith("to_qkv.weight")]
    lora = {"melo": DEPTH, "melo_lora0": 1}.get(method, 0)
    assert sum(plan.get(k) == "qkv" for k in qkv) == DEPTH - lora
    assert sum(k.endswith(".net.1.weight") for k in plan) == DEPTH
    extra = {"ssf": "ssf_scale_1", "melo": "linear_", "melo_lora0": "linear_",
             "adaptformer": "adapter",
             "dvpt": "prompt", "evp": "prompt_generator", "deep_vpt": "prompt",
             "shallow_vpt": "prompt"}[method]
    split_extra = [k for k in plan if extra in k]
    assert bool(split_extra) == (method == "ssf"), split_extra


@pytest.mark.parametrize("method", sorted(CASES))
def test_zoo_tp2_forward_matches_one_process(run, method):
    for r in run["port"]:
        mae = float(np.mean(np.abs(r[method]["logits"] - run["one"][method]["logits"])))
        assert mae < 1e-4, mae


@pytest.mark.parametrize("method", sorted(CASES))
def test_zoo_tp2_step_matches_one_process(run, method):
    got, want = run["port"][0][method], run["one"][method]
    assert abs(got["losses"][0] - want["loss"]) <= 1e-5
    assert _worst(got["trainable"], want["trainable"]) <= 2e-4
    # The step moved the trainable params.
    init = run["runs"][method][2]
    assert max(float(np.max(np.abs(want["trainable"][k] - init[k])))
               for k in want["trainable"]) > 1e-5
    # The gradient itself, through Adam's moments (one Adam step at lr 3e-5
    # moves each element by about lr whatever the gradient's size).
    assert max(_moments(got, want).values()) <= MOMENTS_BUDGET
    # Both ranks hold the same params.
    other = run["port"][1][method]["trainable"]
    assert all(np.array_equal(other[k], got["trainable"][k]) for k in other)


@pytest.mark.parametrize("method", JAX_HELD)
def test_zoo_tp2_step_matches_jax_parallel_step(run, method):
    got, want = run["port"][0][method], run["jax"][method]
    assert abs(got["losses"][0] - want["loss"]) <= 1e-5
    assert _worst(got["trainable"], want["trainable"]) <= 2e-4
    assert max(_moments(got, want).values()) <= MOMENTS_BUDGET
