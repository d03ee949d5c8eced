"""PyTorch port: the vit-b16 train path against the JAX package on the CPU.

The port's kernels run their plain versions on CPU tensors; the JAX package
runs its TPU route (``set_default_impl("flash")``: the Pallas kernels in
interpret mode), the route the port takes everywhere. fp32, tiny geometry
(vit-s16, 24x32x32), B2 so that a dropout mask off by the stream's padding
would show:

- the MHSA kernels with dropout: the port's ``mhsa_reference`` and
  ``mhsa_qkv_proj`` (forward, dh, dW) against JAX's ``fused_mhsa`` and
  ``mhsa_qkv_proj``, masks bit-exact, atol 2e-5;
- the fused MLP forward with dropout and ``save_a`` against JAX's
  ``_fused_mlp_forward(save_a=True)``, MAE <= 1e-5;
- the fused MLP backward ``mlp_bwd_reference`` against JAX's
  ``_mlp_bwd_pallas`` and against autograd through ``mlp_reference``, atol
  3e-5, for each GELU mode, residual on and off;
- patchify's weight, bias and pos gradients against ``jax.vjp`` of JAX's
  ``patchify_fused``, atol 1e-5;
- three train steps of methods fft, linear and bitfit (depth cut to 3: two
  full layers and the CLS-fast last one) against JAX's ``make_steps``, fed
  the JAX step's own dropout seeds (dropout and emb_dropout 0.1): per-step
  loss atol 1e-5, params 2e-4, step-1 gradients 1e-5, equal seed counts;
  and each method's kernel launches a step, counted on the wrappers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.config import make_spec as jax_make_spec
from gaviko_tpu.core.layers import RngStream
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.ops import attention as jattn
from gaviko_tpu.ops import flash_attention as jfa
from gaviko_tpu.ops import fused_mlp as jmlp
from gaviko_tpu.ops import hash_dropout as jhd
from gaviko_tpu.ops import patchify as jpatch
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import losses as jlosses
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops import fused_mlp as tmlp
from gaviko_tpu_torch.ops import patchify as tpatch
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from gaviko_tpu_torch.weights.from_jax import from_jax

RATE = 0.1
SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "accumulation_steps": 1,
             "precision": "fp32", "scheduler": SCHED}
TINY = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
            num_classes=5, channels=1, pool="cls", backbone="vit-s16",
            dropout=RATE, emb_dropout=RATE)
DEPTH = 3


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _mae(a, b) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---------------------------------------------------------- MHSA dropout ----

@pytest.mark.parametrize("seed", [-123456789, 77])
def test_mhsa_dropout_matches_jax_kernel(seed):
    """Kernel A's plain version with dropout against the Pallas kernel;
    the mask (query row, key, plane b * heads + head) is JAX's bit for bit."""
    B, H, D, n_pad, n_true = 2, 4, 64, 48, 41
    qkv = np.random.RandomState(0).randn(B, n_pad, 3 * H * D).astype(np.float32)
    want = jfa.fused_mhsa(jnp.asarray(qkv), jnp.asarray([seed], jnp.int32), H, D,
                          D ** -0.5, n_true, RATE)
    got = tfa.fused_mhsa(torch.from_numpy(qkv), H, D, D ** -0.5, n_true, RATE, seed=seed)
    np.testing.assert_allclose(got.numpy()[:, :n_true], np.asarray(want)[:, :n_true],
                               atol=2e-5)
    salt = np.arange(B * H, dtype=np.int32).reshape(B, H, 1, 1)
    keep = np.asarray(jhd.keep_mask((B, H, n_pad, n_pad), jnp.int32(seed), RATE,
                                    salt=jnp.asarray(salt)))
    factor = tfa._mhsa_keep_factor((B, H, n_pad, n_pad), seed, RATE, "cpu")
    np.testing.assert_array_equal(factor.numpy() > 0, keep)
    assert 0.85 < keep.mean() < 0.95


@pytest.mark.parametrize("pad_cotangent", ["random", "zero"])
def test_mhsa_qkv_proj_with_dropout_matches_jax_vjp(pad_cotangent):
    """Forward, dh and dW of the port's mhsa_qkv_proj with dropout (the
    plain versions of kernels A and B) against jax.vjp of JAX's."""
    B, H, N, D, dim, n_true, seed = 2, 4, 48, 64, 128, 41, -5
    rng = np.random.RandomState(3)
    h = (rng.randn(B, N, dim) * 0.3).astype(np.float32)
    w = (rng.randn(3 * H * D, dim) * 0.05).astype(np.float32)
    g = rng.randn(B, N, H * D).astype(np.float32)
    if pad_cotangent == "zero":
        g[:, n_true:] = 0.0
    jseed = jnp.asarray([seed], jnp.int32)
    want, vjp = jax.vjp(lambda a, b: jfa.mhsa_qkv_proj(a, b, jseed, H, D, D ** -0.5,
                                                        n_true, RATE),
                        jnp.asarray(h), jnp.asarray(w))
    dh_want, dw_want = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tfa.mhsa_qkv_proj(th, tw, H, D, D ** -0.5, n_true, RATE, seed)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy()[:, :n_true],
                               np.asarray(want)[:, :n_true], atol=2e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_want), atol=2e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_want), atol=2e-5)


def test_mhsa_bwd_reference_with_dropout_is_the_autograd_gradient():
    """Kernel B's algebra with the replayed mask equals autograd through the
    forward's plain version with the same mask."""
    B, H, D, n_pad, n_true, seed = 2, 2, 64, 24, 19, 31
    qkv = torch.from_numpy(np.random.RandomState(1).randn(B, n_pad, 3 * H * D)
                           .astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(2).randn(B, n_pad, H * D).astype(np.float32))
    out, lse = tfa.mhsa_reference(qkv, H, D, 0.125, n_true, RATE, with_lse=True, seed=seed)
    out.backward(g)
    dqkv = tfa.mhsa_bwd_reference(qkv.detach(), out.detach(), lse.detach(), g, H, D, 0.125,
                                  n_true, RATE, seed)
    torch.testing.assert_close(dqkv, qkv.grad, rtol=0, atol=1e-5)
    _, lse0 = tfa.mhsa_reference(qkv.detach(), H, D, 0.125, n_true, with_lse=True)
    torch.testing.assert_close(lse, lse0, rtol=0, atol=0)  # l is taken before dropout


# ------------------------------------------------------------- fused MLP ----

def _mlp_inputs(B=2, rows=37, dim=128, mlp=256, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, rows, dim).astype(np.float32),
            (1 + 0.1 * rng.randn(dim)).astype(np.float32),
            (0.1 * rng.randn(dim)).astype(np.float32),
            (rng.randn(mlp, dim) * dim ** -0.5).astype(np.float32),
            (0.1 * rng.randn(mlp)).astype(np.float32),
            (rng.randn(dim, mlp) * mlp ** -0.5).astype(np.float32),
            (0.1 * rng.randn(dim)).astype(np.float32))


@pytest.mark.parametrize("residual", [False, True])
def test_mlp_forward_with_dropout_and_save_a_matches_jax_kernel(residual):
    args = _mlp_inputs()
    seed = -987
    out_j, a_j = jmlp._fused_mlp_forward(*(jnp.asarray(t) for t in args),
                                         jnp.asarray([seed], jnp.int32), 1e-5, "exact",
                                         RATE, residual, save_a=True)
    out, a = tmlp.fused_mlp_forward(*(torch.from_numpy(t) for t in args), 1e-5, "exact",
                                    RATE, residual, seed, save_a=True)
    rows = out.numel() // out.shape[-1]
    assert a.shape == (rows, 256)
    assert _mae(out.numpy(), out_j) <= 1e-5
    assert _mae(a.numpy(), np.asarray(a_j)[:rows]) <= 1e-5
    plain = tmlp.fused_mlp(*(torch.from_numpy(t) for t in args), 1e-5, "exact", 0.0,
                           residual)
    assert float((out - plain).abs().max()) > 0.01  # something was dropped


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("gelu", ["exact", "tanh", "erf_fast"])
def test_mlp_bwd_reference_matches_jax_kernel_and_autograd(gelu, residual):
    args = _mlp_inputs(seed=1)
    seed = 1234
    dy = np.random.RandomState(2).randn(*args[0].shape).astype(np.float32)
    jargs = [jnp.asarray(t) for t in args]
    jseed = jnp.asarray([seed], jnp.int32)
    _, a_j = jmlp._fused_mlp_forward(*jargs, jseed, 1e-5, gelu, RATE, residual, save_a=True)
    want = jmlp._mlp_bwd_pallas(*jargs, jseed, jnp.asarray(dy), a_j, 1e-5, gelu, RATE,
                                residual)
    targs = [torch.from_numpy(t) for t in args]
    rows = dy.size // dy.shape[-1]
    _, a = tmlp.mlp_reference(*targs, 1e-5, gelu, RATE, residual, seed, save_a=True)
    got = tmlp.fused_mlp_bwd(*targs, torch.from_numpy(dy), a, 1e-5, gelu, RATE, residual,
                             seed)
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, gt, w in zip(names, got, want):
        assert _max_abs(gt.numpy(), np.asarray(w).reshape(gt.shape)) <= 3e-5, name
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j)[:rows], atol=3e-5)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    out = tmlp.mlp_reference(*leaves, 1e-5, gelu, RATE, residual, seed)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    for name, gt, w in zip(names, got, auto):
        assert _max_abs(gt.numpy(), w.numpy()) <= 3e-5, name


# The second shape is beyond the JAX package's VMEM gate for its backward
# kernel, where JAX takes its remat VJP; B7 keeps its partial sums in device
# memory and takes it all the same.
@pytest.mark.parametrize("B,rows,dim,mlp", [(2, 37, 128, 256), (1, 3, 1024, 4096)])
def test_fused_mlp_is_differentiable_through_the_backward_wrapper(monkeypatch, B, rows,
                                                                   dim, mlp):
    """Under a gradient fused_mlp saves a and its backward is fused_mlp_bwd
    (kernel B7) at every shape, equal to autograd through the plain
    version."""
    calls = []
    real = tmlp.fused_mlp_bwd
    monkeypatch.setattr(tmlp, "fused_mlp_bwd", lambda *a: calls.append(1) or real(*a))
    targs = [torch.from_numpy(t).requires_grad_(True)
             for t in _mlp_inputs(B, rows, dim, mlp, seed=3)]
    dy = torch.from_numpy(np.random.RandomState(4).randn(B, rows, dim).astype(np.float32))
    got = torch.autograd.grad(tmlp.fused_mlp(*targs, 1e-5, "exact", RATE, True, 9), targs, dy)
    want = torch.autograd.grad(tmlp.mlp_reference(*targs, 1e-5, "exact", RATE, True, 9),
                               targs, dy)
    assert calls == [1]
    assert jmlp._mlp_bwd_supported(dim, mlp, 4) == (dim < 1024)
    for gt, w in zip(got, want):
        torch.testing.assert_close(gt, w, rtol=0, atol=3e-5)


# -------------------------------------------------------------- patchify ----

def test_patchify_gradients_match_jax_vjp():
    spec = jax_make_spec({**TINY, "method": "fft"})
    rng = np.random.RandomState(5)
    img = rng.rand(2, 1, 24, 32, 32).astype(np.float32)
    w = (rng.randn(spec.dim, 1, 12, 16, 16) * 0.02).astype(np.float32)
    bias = (rng.randn(spec.dim) * 0.1).astype(np.float32)
    pos = rng.randn(spec.num_patches, spec.dim).astype(np.float32)
    g = rng.randn(2, spec.num_patches, spec.dim).astype(np.float32)
    want, vjp = jax.vjp(lambda i, a, b, c: jpatch.patchify_fused(i, a, b, c, spec),
                        *(jnp.asarray(t) for t in (img, w, bias, pos)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (img, w, bias, pos)]
    out = tpatch.patchify_fused(*leaves)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    for name, t, wg in zip(("img", "weight", "bias", "pos"), leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), atol=1e-5, err_msg=name)
    rows_out, rows = tpatch.patchify_kernel(*(t.detach() for t in leaves), save_rows=True)
    assert rows.shape == (2 * spec.num_patches, 12 * 16 * 16)
    torch.testing.assert_close(rows_out, out.detach(), rtol=0, atol=0)


# ----------------------------------------------------- the vit train step ----

def _models(method):
    cfg = {**TINY, "method": method}
    jm, tm = jax_build_model(cfg), build_model(cfg)
    jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=DEPTH))
    tm = dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, depth=DEPTH))
    return jm, tm


def n_seeds(depth: int) -> int:
    """Dropout sites of one train forward on the fused route: the embedding,
    three a full layer (MHSA kernel, out-projection, fused MLP kernel), four
    in the CLS-fast last layer."""
    return 1 + 3 * (depth - 1) + 4


def _step_seeds(step: int, n: int):
    rs = RngStream(jax.random.fold_in(jax.random.PRNGKey(0), step))
    return [int(rs.next_seed()) for _ in range(n)]


@pytest.fixture(scope="module", params=["fft", "linear", "bitfit"])
def vit_run(request):
    """Three train steps of both packages (JAX on its kernel route) from the
    same params, batches and dropout seeds; the step-1 gradients of both."""
    method = request.param
    jm, tm = _models(method)
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}
    total, n_steps, B = 10, 3, 2
    rng = np.random.RandomState(0)
    batches = [(rng.rand(B, 1, 24, 32, 32).astype(np.float32),
                rng.randint(0, 5, B).astype(np.int32)) for _ in range(n_steps)]
    n = n_seeds(DEPTH)

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
    return dict(method=method, jlosses=jlosses_, tlosses=tlosses_, jfinal=jfinal,
                tfinal=ttr, jgrads=jgrads, tgrads=tgrads, seed_counts=seed_counts, n=n)


def test_vit_train_steps_match_jax_losses(vit_run):
    np.testing.assert_allclose(vit_run["tlosses"], vit_run["jlosses"], atol=1e-5)
    assert vit_run["seed_counts"] == [vit_run["n"]] * 3


def test_vit_train_steps_match_jax_params(vit_run):
    jf, tf = vit_run["jfinal"], vit_run["tfinal"]
    assert set(jf) == set(tf)
    worst = max(_max_abs(tf[k], jf[k]) for k in jf)
    assert worst <= 2e-4, worst


def test_vit_step_one_gradients_match_jax(vit_run):
    jg, tg = vit_run["jgrads"], vit_run["tgrads"]
    assert set(jg) == set(tg)
    for k in jg:
        assert _max_abs(tg[k], jg[k]) <= 1e-5, k
    if vit_run["method"] != "linear":
        assert float(np.abs(jg["conv_proj.0.bias"]).max()) > 0


def _count(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*a, **kw):
        counts[name] += 1
        return fn(*a, **kw)

    counts[name] = 0
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("method", ["fft", "linear", "bitfit"])
def test_vit_train_step_runs_each_kernel_wrapper(monkeypatch, method):
    """One train step's calls of each kernel wrapper (the plain versions on
    the CPU, as often as the kernels launch on the card): patchify once, A
    and B6 in each full layer, and where any backbone tensor trains, B and
    B7 in each full layer; none of the inference-only kernels."""
    _, tm = _models(method)
    counts = {}
    for module, name in ((tpatch, "patchify_kernel"), (tfa, "fused_mhsa"),
                         (tfa, "fused_mhsa_bwd"), (tmlp, "fused_mlp_forward"),
                         (tmlp, "fused_mlp_bwd")):
        _count(monkeypatch, module, name, counts)
    from gaviko_tpu_torch.core import vit as tvit
    for name in ("fused_ln_linear", "cls_attention", "self_attention"):
        _count(monkeypatch, tvit, name, counts)
    params = tm.init(torch.Generator().manual_seed(0), tm.spec)
    trainable, frozen = tloop.split_params(tm, params)
    x = torch.rand(2, 1, 24, 32, 32, generator=torch.Generator().manual_seed(1))
    tloop.make_loss_and_grads(tm, tlosses.make_criterion(TRAIN_CFG))(
        trainable, frozen, x, torch.tensor([1, 3]), SeedStream(_step_seeds(0, n_seeds(DEPTH))))
    full = DEPTH - 1
    bwd = 0 if method == "linear" else full
    assert counts == {"patchify_kernel": 1, "fused_mhsa": full, "fused_mhsa_bwd": bwd,
                      "fused_mlp_forward": full, "fused_mlp_bwd": bwd, "fused_ln_linear": 0,
                      "cls_attention": 0, "self_attention": 0}
