"""PyTorch port: the GAViKO train step against the JAX package on the CPU.

The port's kernels run their plain versions on CPU tensors, so these hold
the algebra of every piece of the train step against the JAX package (its
Pallas kernels in interpret mode where the JAX function reaches one, its
XLA paths otherwise), in fp32:

- the MHSA forward's lse statistic and ``mhsa_qkv_proj``'s forward and
  backward (dh, dW) with padded rows, atol 2e-5;
- focal loss (both modes), CE, the OneCycle lr and beta1 schedules over 50
  steps, and one clip + Adam step from a carried mid-schedule state, 1e-6;
- three GAViKO train steps with dropout on, fed the JAX step's own dropout
  seeds: per-step loss atol 1e-5, params 2e-4 (the JAX package's budgets,
  tests/test_train_step_parity.py), step-1 gradients 1e-5;
- one step's gradients at the full 120x160x160 geometry (depth 2, B1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.core.layers import RngStream
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.ops import flash_attention as jfa
from gaviko_tpu.train import fused_optim as jopt
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import losses as jlosses
from gaviko_tpu.train import schedule as jsched
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops import fused_mlp as tmlp
from gaviko_tpu_torch.ops import patchify as tpatch
from gaviko_tpu_torch.train import fused_optim as topt
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from gaviko_tpu_torch.train import metrics as tmetrics
from gaviko_tpu_torch.train import schedule as tsched
from gaviko_tpu_torch.weights.from_jax import from_jax, opt_state_from_jax

SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "accumulation_steps": 1,
             "precision": "fp32", "scheduler": SCHED}
BASE = dict(num_classes=5, channels=1, pool="cls", backbone="vit-s16",
            method="gaviko", freeze_vit=True, attn_drop=0.2, proj_drop=0.2,
            dropout=0.1, emb_dropout=0.1)
TINY = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
            num_prompts=4, prompt_latent_dim=8, local_dim=8, local_k=(2, 2, 2))
FULL = dict(image_size=160, image_patch_size=16, frames=120, frame_patch_size=12,
            num_prompts=32, prompt_latent_dim=20, local_dim=20, local_k=(6, 6, 6))


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---------------------------------------------------------------- MHSA ----

def test_mhsa_lse_matches_jax_emitted_ml():
    """JAX's m is the max over all columns (pad keys too) and the port's
    excludes them, so only lse = m + log2(l) is compared."""
    B, H, D, n_pad, n_true = 2, 4, 64, 48, 41
    qkv = np.random.RandomState(0).randn(B, n_pad, 3 * H * D).astype(np.float32)
    out_j, ml = jfa._fused_mhsa_forward(jnp.asarray(qkv), jnp.zeros((1,), jnp.int32),
                                        H, D, D ** -0.5, n_true, 0.0, emit_ml=True)
    ml = np.asarray(ml)
    want = ml[..., 0] + np.log2(ml[..., 1])
    out, lse = tfa.mhsa_reference(torch.from_numpy(qkv), H, D, D ** -0.5, n_true,
                                  with_lse=True)
    assert lse.shape == (B, H, n_pad) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(out.numpy()[:, :n_true], np.asarray(out_j)[:, :n_true],
                               atol=2e-5)
    got_out, got_lse = tfa.fused_mhsa(torch.from_numpy(qkv), H, D, D ** -0.5, n_true,
                                      with_lse=True)
    torch.testing.assert_close(got_lse, lse, rtol=0, atol=0)


@pytest.mark.parametrize("pad_cotangent", ["random", "zero"])
def test_mhsa_qkv_proj_matches_jax_vjp(pad_cotangent):
    """Forward, dh and dW of the port's mhsa_qkv_proj (the plain versions of
    kernels A and B on the CPU) against jax.vjp of JAX's mhsa_qkv_proj
    (Pallas interpret mode), with padded rows (n_true < N_pad)."""
    B, H, N, D, dim, n_true = 2, 4, 48, 64, 128, 41
    rng = np.random.RandomState(3)
    h = (rng.randn(B, N, dim) * 0.3).astype(np.float32)
    w = (rng.randn(3 * H * D, dim) * 0.05).astype(np.float32)
    g = rng.randn(B, N, H * D).astype(np.float32)
    if pad_cotangent == "zero":
        g[:, n_true:] = 0.0
    seed = jnp.zeros((1,), jnp.int32)
    want, vjp = jax.vjp(lambda a, b: jfa.mhsa_qkv_proj(a, b, seed, H, D, D ** -0.5,
                                                        n_true, 0.0),
                        jnp.asarray(h), jnp.asarray(w))
    dh_want, dw_want = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tfa.mhsa_qkv_proj(th, tw, H, D, D ** -0.5, n_true)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy()[:, :n_true],
                               np.asarray(want)[:, :n_true], atol=2e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_want), atol=2e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_want), atol=2e-5)


def test_mhsa_bwd_reference_is_the_autograd_gradient():
    """The kernel-B algebra (from the saved lse) equals torch autograd
    through the forward's plain version, and pad keys get dK = dV = 0."""
    B, H, D, n_pad, n_true = 1, 2, 64, 24, 19
    qkv = torch.from_numpy(np.random.RandomState(1).randn(B, n_pad, 3 * H * D)
                           .astype(np.float64)).float().requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(2).randn(B, n_pad, H * D).astype(np.float32))
    out, lse = tfa.mhsa_reference(qkv, H, D, 0.125, n_true, with_lse=True)
    out.backward(g)
    dqkv = tfa.mhsa_bwd_reference(qkv.detach(), out.detach(), lse.detach(), g, H, D,
                                  0.125, n_true)
    torch.testing.assert_close(dqkv, qkv.grad, rtol=0, atol=1e-5)
    inner = H * D
    assert torch.all(dqkv[:, n_true:, inner:] == 0)


def test_mhsa_qkv_proj_skips_dw_when_w_is_frozen():
    B, H, N, D, dim = 1, 2, 16, 64, 32
    h = torch.randn(B, N, dim, requires_grad=True)
    w = torch.randn(3 * H * D, dim)
    tfa.mhsa_qkv_proj(h, w, H, D, 0.125, 13).sum().backward()
    assert h.grad is not None and w.grad is None


def test_kernel_wrappers_refuse_a_gradient_on_the_card(monkeypatch):
    """A forward kernel wrapper whose output has no backward raises, saying
    where the gradient goes, when a CUDA tensor needs a gradient (faked
    here: use_kernel says yes); it raises before touching the device. The
    differentiable entry points (``fused_mhsa``, ``mhsa_qkv_proj``,
    ``patchify_fused``, ``fused_mlp``) take a gradient: ``fused_mhsa`` on a
    packed qkv launches kernel A and its backward reaches kernel B
    (``fused_mhsa_bwd``). The name dates from when ``fused_mhsa`` refused."""
    monkeypatch.setattr(_build, "use_kernel", lambda t: True)
    qkv = torch.zeros(1, 8, 3 * 2 * 64, requires_grad=True)
    img = torch.zeros(1, 1, 4, 8, 8)
    w = torch.zeros(8, 1, 2, 4, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="through patchify_fused"):
        tpatch.patchify_kernel(img, w, torch.zeros(8))
    x = torch.zeros(1, 8, 128, requires_grad=True)
    with pytest.raises(NotImplementedError, match="through fused_mlp"):
        tmlp.fused_mlp_forward(x, torch.ones(128), torch.zeros(128), torch.zeros(256, 128),
                               torch.zeros(256), torch.zeros(128, 256), torch.zeros(128))
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, symbol, *a: calls.append(symbol))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    tfa.fused_mhsa(qkv, 2, 64, 0.125, 8).sum().backward()
    assert calls == ["gaviko_fused_mhsa_f32", "gaviko_fused_mhsa_bwd_f32"]
    assert qkv.grad is not None and qkv.grad.shape == qkv.shape
    with torch.no_grad():
        tfa.fused_mhsa(qkv, 2, 64, 0.125, 8)  # no gradient asked: kernel A alone
    assert calls[2:] == ["gaviko_fused_mhsa_f32"]


# ------------------------------------------------- losses and optimizer ----

def _logits_labels(seed=0, B=8, C=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, C).astype(np.float32) * 2.0
    labels = rng.randint(0, C, B).astype(np.int32)
    labels[1] = -100  # an ignored row
    return logits, labels


@pytest.mark.parametrize("name", ["focal_parity", "focal_corrected", "ce"])
def test_losses_and_their_gradients_match_jax(name):
    logits, labels = _logits_labels()
    fns = {
        "focal_parity": (lambda x, y: jlosses.focal_loss(x, y, 1.2, parity=True),
                         lambda x, y: tlosses.focal_loss(x, y, 1.2, parity=True)),
        "focal_corrected": (lambda x, y: jlosses.focal_loss(x, y, 1.2, parity=False),
                            lambda x, y: tlosses.focal_loss(x, y, 1.2, parity=False)),
        "ce": (jlosses.cross_entropy_loss, tlosses.cross_entropy_loss),
    }
    jfn, tfn = fns[name]
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tfn(x, torch.from_numpy(labels).long())
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-6)


def test_make_criterion_picks_focal_with_gamma_1_2():
    logits, labels = _logits_labels(1)
    crit = tlosses.make_criterion({"loss_fn": "focal_loss"})
    want = jlosses.make_criterion({"loss_fn": "focal_loss"})(jnp.asarray(logits),
                                                            jnp.asarray(labels))
    got = crit(torch.from_numpy(logits), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    assert tlosses.make_criterion({"loss_fn": "ce"}) is tlosses.cross_entropy_loss


@pytest.mark.parametrize("total", [50, 7])
def test_schedules_match_jax(total):
    sch = {**SCHED, "cycle_momentum": True}
    jlr, tlr = jsched.from_config(sch, total), tsched.from_config(sch, total)
    jb1, tb1 = jsched.beta1_from_config(sch, total), tsched.beta1_from_config(sch, total)
    for c in range(total + 3):
        assert abs(tlr(c) - float(jlr(c))) <= 1e-6 * SCHED["max_lr"]
        assert abs(tb1(c) - float(jb1(c))) <= 1e-6
    assert tsched.beta1_from_config({**sch, "cycle_momentum": False}, total) is None


def test_fused_optim_step_from_a_carried_state_matches_jax():
    rng = np.random.RandomState(5)
    shapes = {"a": (7, 5), "b": (5,), "c": (1, 3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 0.7).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    total = 10
    lr_j, b1_j = jsched.from_config(SCHED, total), jsched.beta1_from_config(SCHED, total)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    for g in grads[:3]:  # carry the JAX state to mid-schedule
        jp, state = jopt.step({k: jnp.asarray(v) for k, v in g.items()}, state, jp,
                              lr_j, clip=1.0, b1=b1_j)
    tp, tstate = from_jax(jp), opt_state_from_jax(state)
    assert tstate.count == 3
    jp2, state2 = jopt.step({k: jnp.asarray(v) for k, v in grads[3].items()}, state,
                            jp, lr_j, clip=1.0, b1=b1_j)
    tp2, tstate2 = topt.step(from_jax(grads[3]), tstate, tp,
                             tsched.from_config(SCHED, total), clip=1.0,
                             b1=tsched.beta1_from_config(SCHED, total))
    assert tstate2.count == int(state2.count) == 4
    for k in shapes:
        assert _max_abs(tp2[k], jp2[k]) <= 1e-6, k
        assert _max_abs(tstate2.mu[k], state2.mu[k]) <= 1e-6, k
        assert _max_abs(tstate2.nu[k], state2.nu[k]) <= 1e-6, k


def test_clip_scale_divides_by_the_norm():
    """The JAX convention (clip / norm), not torch's clip / (norm + 1e-6):
    at a norm of 5e-6 and clip 1e-6 the two scales are 0.2 and 0.167."""
    g = {"a": torch.tensor([3e-6, 4e-6])}
    p = {"a": torch.zeros(2)}
    _, state = topt.step(g, topt.init(p), p, 1e-3, clip=1e-6, b1=0.9)
    torch.testing.assert_close(state.mu["a"], 0.1 * 0.2 * g["a"], rtol=1e-5, atol=0)
    _, state = topt.step(g, topt.init(p), p, 1e-3, clip=1.0, b1=0.9)  # norm < clip
    torch.testing.assert_close(state.mu["a"], 0.1 * g["a"], rtol=1e-5, atol=0)


def test_make_optimizer_refuses_what_is_not_ported():
    """No train option is left unported: the optax-chain layout
    (fused_optimizer: false) and the orbax resume directory run (held to
    JAX in tests/test_torch_chain.py), as do accumulation_steps > 1 (optax
    MultiSteps semantics, schedules over the updates, whatever
    fused_optimizer says), pure_bf16, device_augment and train.parallel."""
    chain = tloop.make_optimizer({**TRAIN_CFG, "fused_optimizer": False}, 10)
    assert chain["chain"] and not tloop.make_optimizer(TRAIN_CFG, 10)["chain"]
    assert isinstance(tloop.init_opt_state({"a": torch.zeros(2)}, chain), topt.ChainState)
    fused = tloop.make_optimizer({**TRAIN_CFG, "accumulation_steps": 2}, 10)
    assert fused["accum"] == 2
    assert fused["sched"](4) == tsched.from_config(SCHED, 5)(4)
    assert isinstance(tloop.init_opt_state({"a": torch.zeros(2)}, fused),
                      topt.MultiStepState)
    multi = tloop.make_optimizer({**TRAIN_CFG, "accumulation_steps": 2,
                                  "fused_optimizer": False}, 10)
    assert not multi["chain"]  # MultiSteps wraps the chain either way
    assert not hasattr(tloop, "unported_options")
    assert tloop.compute_dtype_of({"precision": "bf16"}) == torch.bfloat16
    assert tloop.compute_dtype_of({"precision": "pure_bf16"}) == torch.bfloat16
    assert tloop.compute_dtype_of(TRAIN_CFG) == torch.float32


def test_metrics_copy_matches_jax():
    from gaviko_tpu.train import metrics as jmetrics

    rng = np.random.RandomState(2)
    y = rng.randint(0, 5, 40)
    pred = rng.randint(0, 5, 40)
    proba = rng.rand(40, 5)
    for name in ("accuracy", "cohen_kappa_quadratic"):
        assert getattr(tmetrics, name)(y, pred) == getattr(jmetrics, name)(y, pred)
    assert tmetrics.roc_auc_ovr_macro(y, proba) == jmetrics.roc_auc_ovr_macro(y, proba)


# ------------------------------------------------------ the train step ----

def _pair(geom: dict, depth=None):
    cfg = {**BASE, **geom}
    jm, tm = jax_build_model(cfg), build_model(cfg)
    if depth is not None:
        jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=depth))
        tm = dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, depth=depth))
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}
    return jm, tm, jp


def _step_seeds(step: int, n: int):
    rs = RngStream(jax.random.fold_in(jax.random.PRNGKey(0), step))
    return [int(rs.next_seed()) for _ in range(n)]


def _jax_grads(jm, crit, trainable, frozen, x, y, rng):
    def loss_fn(tr):
        logits = jm.apply({**frozen, **tr}, x, jm.spec, train=True, rng=rng)
        return crit(logits.astype(jnp.float32), y)

    return jax.jit(jax.value_and_grad(loss_fn))(trainable)


@pytest.fixture(scope="module")
def tiny_run():
    """Three train steps of both packages from the same params, batches and
    dropout seeds; the step-1 gradients of both."""
    jm, tm, jp = _pair(TINY)
    total, n_steps, B = 10, 3, 2
    rng = np.random.RandomState(0)
    batches = [(rng.rand(B, 1, 24, 32, 32).astype(np.float32),
                rng.randint(0, 5, B).astype(np.int32)) for _ in range(n_steps)]
    n_seeds = 2 * tm.spec.depth  # two local-branch sites a layer

    crit_j = jlosses.make_criterion(TRAIN_CFG)
    tx, _, fused_j = jloop.make_optimizer(TRAIN_CFG, total)
    jstep, _, _ = jloop.make_steps(jm, crit_j, tx, jnp.float32, fused=fused_j)
    jtr, jfr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in jp.items()})
    _, jgrads = _jax_grads(jm, crit_j, jtr, jfr, jnp.asarray(batches[0][0]),
                           jnp.asarray(batches[0][1]),
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

    crit_t = tlosses.make_criterion(TRAIN_CFG)
    fused_t = tloop.make_optimizer(TRAIN_CFG, total)
    tstep, teval, _ = tloop.make_steps(tm, crit_t, fused_t,
                                       tloop.compute_dtype_of(TRAIN_CFG))
    ttr, tfr = tloop.split_params(tm, from_jax(jp))
    x0, y0 = (torch.from_numpy(a) for a in batches[0])
    _, _, tgrads = tloop.make_loss_and_grads(tm, crit_t)(
        ttr, tfr, x0, y0.long(), _step_seeds(0, n_seeds))
    opt_state = tloop.init_opt_state(ttr)
    tlosses_, seed_counts = [], []
    for i, (x, y) in enumerate(batches):
        seeds = SeedStream(_step_seeds(i, n_seeds))
        ttr, opt_state, loss, correct = tstep(ttr, opt_state, tfr, torch.from_numpy(x),
                                              torch.from_numpy(y).long(), seeds)
        tlosses_.append(float(loss))
        seed_counts.append(seeds.count)
    eval_out = teval(ttr, tfr, x0, y0.long())
    return dict(jlosses=jlosses_, tlosses=tlosses_, jfinal=jfinal, tfinal=ttr,
                jgrads=jgrads, tgrads=tgrads, seed_counts=seed_counts,
                n_seeds=n_seeds, opt_state=opt_state, eval_out=eval_out, B=B)


def test_three_train_steps_match_jax_losses(tiny_run):
    np.testing.assert_allclose(tiny_run["tlosses"], tiny_run["jlosses"], atol=1e-5)
    assert tiny_run["seed_counts"] == [tiny_run["n_seeds"]] * 3
    assert tiny_run["opt_state"].count == 3


def test_three_train_steps_match_jax_params(tiny_run):
    jf, tf = tiny_run["jfinal"], tiny_run["tfinal"]
    assert set(jf) == set(tf)
    worst = max(_max_abs(tf[k], jf[k]) for k in jf)
    assert worst <= 2e-4, worst


def test_step_one_gradients_match_jax(tiny_run):
    jg, tg = tiny_run["jgrads"], tiny_run["tgrads"]
    assert set(jg) == set(tg)
    for k in jg:
        assert _max_abs(tg[k], jg[k]) <= 1e-5, k
    # the prompts are reached only through the frozen global layers
    assert float(np.abs(jg["prompt_embeddings"]).max()) > 0


def test_eval_step_after_training(tiny_run):
    loss, correct, logits = tiny_run["eval_out"]
    assert logits.shape == (tiny_run["B"], 5) and torch.isfinite(logits).all()
    assert torch.isfinite(loss) and 0 <= int(correct) <= tiny_run["B"]


def test_full_geometry_gradients_match_jax():
    """One step's loss and gradients at 120x160x160 (1033 -> 1040 global
    rows, 10^3 grid, 6^3 window), depth 2, B1, dropout on."""
    jm, tm, jp = _pair(FULL, depth=2)
    x = np.random.RandomState(1).rand(1, 1, 120, 160, 160).astype(np.float32)
    y = np.asarray([3], np.int32)
    crit_j = jlosses.make_criterion(TRAIN_CFG)
    jtr, jfr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in jp.items()})
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    jloss, jg = _jax_grads(jm, crit_j, jtr, jfr, jnp.asarray(x), jnp.asarray(y), rng)
    ttr, tfr = tloop.split_params(tm, from_jax(jp))
    tloss, _, tg = tloop.make_loss_and_grads(tm, tlosses.make_criterion(TRAIN_CFG))(
        ttr, tfr, torch.from_numpy(x), torch.from_numpy(y).long(), _step_seeds(7, 4))
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    for k in jg:
        assert _max_abs(tg[k], jg[k]) <= 1e-5, k
