"""PyTorch port: B12, the LN + linear backward, and the qkv dispatch that runs
it, against the JAX package on the CPU.

The port's kernels run their plain versions on CPU tensors; the JAX package
runs its Pallas kernels in interpret mode (``set_default_impl("flash")``
for its routes). Inputs are made from a numpy seed.

- ``ln_linear_bwd_reference`` against JAX's ``_ln_linear_bwd`` (the
  backward of ``ln_linear_hybrid``), ragged rows, fp32 (atol 2e-5) and bf16
  (relative MAE <= 2e-3);
- ``fused_ln_linear`` and ``ln_linear_hybrid`` gradients against JAX's,
  the backward counted on ``ln_linear_bwd`` (not taken where the hybrid
  gate is false: autograd through ``ln_linear_reference``, JAX's XLA VJP);
- ``ln_linear_hybrid_supported`` against JAX's gate;
- the qkv source of ``attention_block`` and of the CLS-fast kv against
  JAX's over train, eval under a gradient and eval, ``GAVIKO_LNQKV_HYBRID``
  on and off, dtype and width;
- three train steps with ``GAVIKO_LNQKV_HYBRID=1`` in both packages (vit-s16
  ``fft`` and GAViKO ``freeze_vit: false``, depth 3): per-step loss atol
  1e-5, params 2e-4, step-1 gradients 1e-5, and B12's calls a step;
- the frozen GAViKO step on JAX's flash route (B9 forward, B12 backward in
  every global layer), depth 2: loss and gradients 1e-5, B12's calls.
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
from gaviko_tpu.ops import cls_attention as jcls
from gaviko_tpu.ops import ln_linear as jln
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import losses as jlosses
from gaviko_tpu_torch.config import make_spec
from gaviko_tpu_torch.core import vit as tvit
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.ops import ln_linear as tln
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from gaviko_tpu_torch.weights.from_jax import from_jax

SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "accumulation_steps": 1,
             "precision": "fp32", "scheduler": SCHED}
GEOM = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
            num_classes=5, channels=1, pool="cls", backbone="vit-s16")
GAVIKO = dict(method="gaviko", attn_drop=0.2, proj_drop=0.2, num_prompts=4,
              prompt_latent_dim=8, local_dim=8, local_k=(2, 2, 2))
DEPTH = 3
BF16_REL = 2e-3
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _rel_mae(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _np(t) -> np.ndarray:
    """A torch or JAX array as float32 numpy (bf16 widened exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _inputs(B, N, dim, out, seed=0):
    """x, gamma, beta, w (torch layout) and dy as float32 numpy; each row of
    dy has about unit norm, as a loss's cotangent, so the fp32 budget
    measures the algebra at values of order 1."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, dim).astype(np.float32),
            (1.0 + 0.1 * rng.randn(dim)).astype(np.float32),
            (0.1 * rng.randn(dim)).astype(np.float32),
            (rng.randn(out, dim) * dim ** -0.5).astype(np.float32),
            (rng.randn(B, N, out) * out ** -0.5).astype(np.float32))


def _both(arrays, dtype):
    """The same values as torch tensors and JAX arrays of ``dtype``."""
    t = [torch.from_numpy(a.copy()).to(dtype) for a in arrays]
    j = [jnp.asarray(a, jnp.float32).astype(JDT[dtype]) for a in arrays]
    return t, j


def _check(got, want, dtype, names):
    for name, g, w in zip(names, got, want):
        if dtype == torch.float32:
            assert _max_abs(_np(g), _np(w)) <= 2e-5, name
        else:
            assert _rel_mae(_np(g), _np(w)) <= BF16_REL, name


# ------------------------------------------------------------- the kernel ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,out", [(128, 384), (384, 1152)])
def test_ln_linear_bwd_reference_matches_jax_kernel(dtype, dim, out):
    """B12's plain version against the Pallas kernel (interpret mode) on 2 x
    37 rows, with and without dW."""
    (x, g, b, w, dy), (jx, jg, jb, jw, jdy) = _both(_inputs(2, 37, dim, out), dtype)
    _, vjp = jax.vjp(jln.ln_linear_hybrid, jx, jg, jb, jw)
    want = vjp(jdy)
    got = tln.ln_linear_bwd_reference(x, g, b, w, dy)
    assert [t.dtype for t in got] == [dtype] * 4
    _check(got, want, dtype, ("dx", "dgamma", "dbeta", "dw"))
    no_dw = tln.ln_linear_bwd_reference(x, g, b, w, dy, need_dw=False)
    assert no_dw[3] is None
    for a, c in zip(no_dw[:3], got[:3]):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def _count(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*a, **kw):
        counts[name] += 1
        return fn(*a, **kw)

    counts[name] = 0
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("name", ["fused_ln_linear", "ln_linear_hybrid"])
@pytest.mark.parametrize("dim,out,dtype", [(128, 384, torch.float32),
                                           (128, 384, torch.bfloat16),
                                           (64, 192, torch.float32)])
def test_gradients_match_jax_through_b12(monkeypatch, dtype, name, dim, out):
    """Output and the four gradients of the port's function against jax.vjp
    of JAX's; the backward runs ``ln_linear_bwd`` once where the hybrid gate
    holds (dims multiples of 128), and autograd through the plain forward
    where it does not (JAX's XLA VJP there; held in fp32 only, as the two
    autodiff systems round a bf16 chain's cotangents at other points)."""
    counts = {}
    _count(monkeypatch, tln, "ln_linear_bwd", counts)
    (x, g, b, w, dy), (jx, jg, jb, jw, jdy) = _both(_inputs(2, 37, dim, out, seed=1), dtype)
    want, vjp = jax.vjp(getattr(jln, name), jx, jg, jb, jw)
    leaves = [t.requires_grad_(True) for t in (x, g, b, w)]
    got = getattr(tln, name)(*leaves)
    got.backward(dy)
    _check([got] + [t.grad for t in leaves], [want, *vjp(jdy)], dtype,
           ("y", "dx", "dgamma", "dbeta", "dw"))
    assert counts["ln_linear_bwd"] == int(dim % 128 == 0)


def test_frozen_weight_skips_dw():
    """With W frozen the backward forms no dW (as ``mhsa_qkv_proj``)."""
    x, g, b, w, dy = (torch.from_numpy(a) for a in _inputs(1, 9, 128, 256, seed=2))
    leaves = [t.requires_grad_(True) for t in (x, g, b)]
    tln.fused_ln_linear(*leaves, w).backward(dy)
    want = tln.ln_linear_bwd_reference(x.detach(), g.detach(), b.detach(), w, dy)
    for t, wt in zip(leaves, want):
        torch.testing.assert_close(t.grad, wt, rtol=0, atol=0)
    assert w.grad is None


def test_hybrid_gate_is_the_jax_gate():
    widths = (192, 384, 768, 1024)  # vit-t16, s16, b16, l16
    for dim in widths + (96, 1280, 2048):
        for out in (2 * dim, 3 * dim, 4 * dim, 200):
            for tdt, jdt in JDT.items():
                assert (tln.ln_linear_hybrid_supported(dim, out, tdt)
                        is jln.ln_linear_hybrid_supported(dim, out, jdt)), (dim, out, tdt)
    f32, bf16 = torch.float32, torch.bfloat16
    assert tln.ln_linear_hybrid_supported(768, 2304, f32)  # vit-b16 fp32: 14.2 MB
    assert tln.ln_linear_hybrid_supported(1024, 3072, f32)  # vit-l16 fp32: 25.2 MB
    assert not tln.ln_linear_hybrid_supported(2048, 6144, bf16)


# ------------------------------------------------------------ the dispatch ----

def _block_params(spec, dtype, seed=3):
    rng = np.random.RandomState(seed)
    dim, inner = spec.dim, spec.heads * spec.dim_head
    p = {"a.norm.weight": 1.0 + 0.1 * rng.randn(dim), "a.norm.bias": 0.1 * rng.randn(dim),
         "a.to_qkv.weight": rng.randn(3 * inner, dim) * dim ** -0.5,
         "a.to_out.0.weight": rng.randn(dim, inner) * inner ** -0.5,
         "a.to_out.0.bias": 0.1 * rng.randn(dim)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return _both(list(p.values()), dtype), list(p)


ROUTES = ("fused_ln_linear", "ln_linear_hybrid")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backbone", ["vit-t16", "vit-s16", "vit-b16", "vit-l16"])
def test_qkv_dispatch_is_the_jax_dispatch(monkeypatch, dtype, backbone):
    """attention_block's and the CLS-fast kv's qkv source (B9, the hybrid
    route, or neither) in training, at eval under a gradient and at eval,
    with the hybrid flag off and on, against JAX's on its flash route: the
    calls of each package's LN+linear functions (JAX's when traced; the
    JAX package imports them inside its functions, so the module's names
    are what it finds)."""
    cfg = {**GEOM, "backbone": backbone, "method": "fft", "dropout": 0.0}
    jspec, tspec = jax_make_spec(cfg), make_spec(cfg)
    (tp, jp), names = _block_params(tspec, dtype)
    tp, jp = dict(zip(names, tp)), dict(zip(names, jp))
    (tx,), (jx,) = _both([np.random.RandomState(4).randn(1, 16, tspec.dim)
                          .astype(np.float32)], dtype)
    jcounts, tcounts = {}, {}
    for name in ROUTES:
        _count(monkeypatch, jln, name, jcounts)
        _count(monkeypatch, tvit, name, tcounts)
    seen = set()
    jattn.set_default_impl("flash")
    try:
        for flag in ("0", "1"):
            monkeypatch.setenv("GAVIKO_LNQKV_HYBRID", flag)
            for mode in ("train", "eval_grad", "eval"):
                train = mode == "train"
                for site, fn_j, fn_t in (
                        ("qkv", lambda p, x: jvit.attention_block(p, "a", x, jspec, train=train),
                         lambda p, x: tvit.attention_block(p, "a", x, tspec, train=train)),
                        ("kv", lambda p, x: jvit.attention_cls_branch(p, "a", x, jspec,
                                                                      n_true=13, train=train),
                         lambda p, x: tvit.attention_cls_branch(p, "a", x, tspec, n_true=13,
                                                                train=train))):
                    for c in (jcounts, tcounts):
                        c.update(dict.fromkeys(ROUTES, 0))
                    if mode == "eval_grad":
                        # JAX's CLS attention kernel has no VJP: under
                        # jax.grad its XLA twin stands in (the kv route is
                        # what is compared).
                        with monkeypatch.context() as m:
                            m.setattr(jcls, "cls_attention", jcls.cls_attention_reference)
                            jax.eval_shape(jax.grad(
                                lambda x, f=fn_j: f(jp, x).astype(jnp.float32).sum()), jx)
                        fn_t(tp, tx.clone().requires_grad_(True)).sum().backward()
                    else:
                        jax.eval_shape(fn_j, jp, jx)
                        fn_t(tp, tx)
                    assert tcounts == jcounts, (flag, mode, site)
                    seen.add((site, *(k for k, v in tcounts.items() if v)))
    finally:
        jattn.set_default_impl("xla")
    dim = tspec.dim
    want = {("qkv",), ("kv",)}
    for site, out in (("qkv", 3 * dim), ("kv", 2 * dim)):
        if tln.ln_linear_supported(dim, out, dtype):
            want.add((site, "fused_ln_linear"))
    if tln.ln_linear_hybrid_supported(dim, 3 * dim, dtype):
        want.add(("qkv", "ln_linear_hybrid"))
    assert seen == want


# ------------------------------------------------------- three train steps ----

def _step_seeds(step: int, n: int):
    rs = RngStream(jax.random.fold_in(jax.random.PRNGKey(0), step))
    return [int(rs.next_seed()) for _ in range(n)]


def _jax_setup(cfg, depth):
    """JAX's and the port's models at ``depth``, the shared params (numpy)
    and three batches."""
    jm, tm = jax_build_model(cfg), build_model(cfg)
    jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=depth))
    tm = dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, depth=depth))
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}
    rng = np.random.RandomState(0)
    batches = [(rng.rand(2, 1, 24, 32, 32).astype(np.float32),
                rng.randint(0, 5, 2).astype(np.int32)) for _ in range(3)]
    return jm, tm, jp, batches


def _jax_grads(jm, jp, x, y):
    """JAX's step-1 loss and gradients of the trainable params."""
    crit = jlosses.make_criterion(TRAIN_CFG)
    jtr, jfr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in jp.items()})

    def loss_fn(tr, x, y, key):
        logits = jm.apply({**jfr, **tr}, x, jm.spec, train=True, rng=key)
        return crit(logits.astype(jnp.float32), y)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jtr, jnp.asarray(x), jnp.asarray(y), jax.random.fold_in(jax.random.PRNGKey(0), 0))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _torch_grads(tm, jp, x, y, n_seeds, mp):
    """The port's step-1 loss and gradients, and its ``ln_linear_bwd`` calls."""
    counts = {}
    _count(mp, tln, "ln_linear_bwd", counts)
    ttr, tfr = tloop.split_params(tm, from_jax(jp))
    loss, _, grads = tloop.make_loss_and_grads(tm, tlosses.make_criterion(TRAIN_CFG))(
        ttr, tfr, torch.from_numpy(x), torch.from_numpy(y).long(), _step_seeds(0, n_seeds))
    return float(loss), grads, counts["ln_linear_bwd"]


def _oracle(cfg, n_seeds, mp):
    """Three train steps of both packages with ``GAVIKO_LNQKV_HYBRID=1``
    (JAX on its flash route) from the same params, batches and seeds, the
    step-1 gradients of both and the port's ``ln_linear_bwd`` calls in one
    step."""
    jm, tm, jp, batches = _jax_setup(cfg, DEPTH)
    total = 10
    mp.setenv("GAVIKO_LNQKV_HYBRID", "1")
    jattn.set_default_impl("flash")
    try:
        _, jgrads = _jax_grads(jm, jp, *batches[0])
        crit_j = jlosses.make_criterion(TRAIN_CFG)
        tx, _, fused_j = jloop.make_optimizer(TRAIN_CFG, total)
        jstep, _, _ = jloop.make_steps(jm, crit_j, tx, jnp.float32, fused=fused_j)
        jtr, jfr = jloop.split_params(jm, {k: jnp.asarray(v) for k, v in jp.items()})
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

    _, tgrads, calls = _torch_grads(tm, jp, *batches[0], n_seeds, mp)
    crit_t = tlosses.make_criterion(TRAIN_CFG)
    tstep, _, _ = tloop.make_steps(tm, crit_t, tloop.make_optimizer(TRAIN_CFG, total))
    ttr, tfr = tloop.split_params(tm, from_jax(jp))
    opt_state = tloop.init_opt_state(ttr)
    tlosses_, seed_counts = [], []
    for i, (x, y) in enumerate(batches):
        seeds = SeedStream(_step_seeds(i, n_seeds))
        ttr, opt_state, loss, _ = tstep(ttr, opt_state, tfr, torch.from_numpy(x),
                                        torch.from_numpy(y).long(), seeds)
        tlosses_.append(float(loss))
        seed_counts.append(seeds.count)
    return dict(jlosses=jlosses_, tlosses=tlosses_, jfinal=jfinal, tfinal=ttr,
                jgrads=jgrads, tgrads=tgrads, seed_counts=seed_counts, n_seeds=n_seeds,
                b12_calls=calls)


# (config, dropout seeds a step, B12 calls a step)
ORACLES = {
    # vit-s16 fft: the embedding, three a full layer (MHSA, out-projection,
    # fused MLP), four in the CLS-fast last layer, whose kv is LN @ W_kv.
    "vit_fft_hybrid": ({**GEOM, "method": "fft", "dropout": 0.1, "emb_dropout": 0.1},
                       1 + 3 * (DEPTH - 1) + 4, DEPTH - 1),
    # GAViKO with a trainable backbone: two embedding sites, five a layer;
    # every global attention is a full layer.
    "gaviko_trainable_hybrid": ({**GEOM, **GAVIKO, "freeze_vit": False, "dropout": 0.1,
                                 "emb_dropout": 0.1}, 2 + 5 * DEPTH, DEPTH),
}


@pytest.fixture(scope="module", params=sorted(ORACLES))
def oracle(request):
    cfg, n_seeds, b12 = ORACLES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        run = _oracle(cfg, n_seeds, mp)
    run["want_b12"] = b12
    return run


def test_train_steps_match_jax_losses(oracle):
    np.testing.assert_allclose(oracle["tlosses"], oracle["jlosses"], atol=1e-5)
    assert oracle["seed_counts"] == [oracle["n_seeds"]] * 3


def test_train_steps_match_jax_params(oracle):
    jf, tf = oracle["jfinal"], oracle["tfinal"]
    assert set(jf) == set(tf)
    worst = max(_max_abs(tf[k], jf[k]) for k in jf)
    assert worst <= 2e-4, worst


def _check_grads(tg, jg):
    assert set(jg) == set(tg)
    for k in jg:
        assert _max_abs(tg[k], jg[k]) <= 1e-5, k


def test_step_one_gradients_match_jax(oracle):
    _check_grads(oracle["tgrads"], oracle["jgrads"])


def test_b12_runs_once_a_full_layer(oracle):
    assert oracle["b12_calls"] == oracle["want_b12"]


def test_frozen_gaviko_step_matches_jax_flash_route():
    """GAViKO with the backbone frozen (flag off), depth 2: the global
    layers run ``train=False`` under a gradient, so in both packages B9 is
    the qkv forward and B12 its backward in every global layer. One step's
    loss and gradients (the prompts reached only through those layers)
    against JAX's flash route, and B12 called once a layer."""
    depth = 2
    cfg = {**GEOM, **GAVIKO, "freeze_vit": True, "dropout": 0.1, "emb_dropout": 0.1}
    jm, tm, jp, batches = _jax_setup(cfg, depth)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAVIKO_LNQKV_HYBRID", "0")
        jattn.set_default_impl("flash")
        try:
            jloss, jgrads = _jax_grads(jm, jp, *batches[0])
        finally:
            jattn.set_default_impl("xla")
        tloss, tgrads, calls = _torch_grads(tm, jp, *batches[0], 2 * depth, mp)
    assert abs(tloss - jloss) <= 1e-5
    _check_grads(tgrads, jgrads)
    assert float(np.abs(jgrads["prompt_embeddings"]).max()) > 0
    assert calls == depth
