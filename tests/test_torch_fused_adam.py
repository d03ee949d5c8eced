"""PyTorch port: the optimizer kernel B13's plain version, gradient
accumulation and the resume / checkpoint files, against the JAX package on
the CPU.

- ``adam_reference`` (the plain version of ``csrc/fused_adam.cu``, one
  IEEE rounding an operation) against JAX's Pallas ``adam_leaf`` in
  interpret mode at a static b1, with the same clip scale, on leaves with
  odd row counts. ULPs are of the largest term of each output's last sum
  (a sum can cancel): m' and v' within 2 f32 ULP (measured 1: an FMA that
  XLA's CPU backend contracts), p' within 3 (measured 2.5: the update
  carries m''s and v''s ULP through two divisions and a square root); 2
  bf16 ULP at bf16 storage (measured 2 in v': jitted on the CPU, XLA keeps
  the bf16 product g * scale in f32 where the port, as PyTorch and the TPU
  do, rounds it to bf16). JAX's kernel documents the same 1-2 ULP of FMA
  difference against its own XLA leaf;
- ``fused_optim.step`` against JAX's ``fused_optim.step`` with the cycled
  beta1 from a carried mid-schedule state, clipping on and off: params
  within 1e-6, mu 1e-8, nu 1e-10 (the port's beta1 is its host schedule
  rounded once to f32, JAX's a cosine computed in f32; they differ by up
  to an ULP, which moves m' by ~4e-9 and, through a cancelled m', p' by
  ~6e-8 here);
- ``fused_optim.multi_step`` against optax ``MultiSteps`` around JAX's
  clip -> cycled Adam -> lr chain (``accumulation_steps: 2``), 1e-6;
- ``AdamTable`` (B13's table of leaves, built here on CPU tensors for its
  host side): each leaf's alignment, the byte offset modulo 16 its moments
  and param share (-1 where they do not), on leaves built as views at odd
  element offsets of one buffer, and each chunk's leaf;
- resume files in JAX's npz layout load in both packages both ways (the
  fused state and the accumulating one), and a ``.pt`` the port writes
  loads in JAX's ``load_pt`` and ``build_params``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.ops import fused_adam as jadam
from gaviko_tpu.train import fused_optim as jopt
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.train import schedule as jsched
from gaviko_tpu.utils import checkpoint as jckpt
from gaviko_tpu_torch.ops import fused_adam as tadam
from gaviko_tpu_torch.train import fused_optim as topt
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import schedule as tsched
from gaviko_tpu_torch.utils import checkpoint as tckpt
from gaviko_tpu_torch.weights import torch_io
from gaviko_tpu_torch.weights.from_jax import from_jax, opt_state_from_jax

SCHED = {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
         "final_div_factor": 1000.0, "anneal_strategy": "cos", "three_phase": False}
TRAIN_CFG = {"loss_fn": "focal_loss", "fp16": False, "precision": "fp32", "scheduler": SCHED}


def _ulps(got, want, bits, mag=None) -> float:
    """max |got - want| in units in the last place (``bits`` significant
    bits: 24 for f32, 8 for bf16) of ``mag``, the largest term of the sum
    that made ``want`` (``want`` itself by default): m' = b1 m + (1 - b1) g
    can cancel, and an FMA in one version moves the result by an ULP of its
    terms, not of itself."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    _, exp = np.frexp(np.abs(want) if mag is None else np.maximum(np.abs(want), mag))
    return float(np.max(np.abs(got - want) / np.ldexp(1.0, exp - bits)))


def _terms(p, m, g, b1, scale, p_new):
    """The largest term behind each output: p' = p - lr u, m' = b1 m + (1 -
    b1) g, v' (no cancellation: itself)."""
    g = np.asarray(g, np.float64) * scale
    p = np.asarray(p, np.float64)
    return (np.maximum(np.abs(p), np.abs(p - np.asarray(p_new, np.float64))),
            np.maximum(np.abs(b1 * np.asarray(m, np.float64)), np.abs((1 - b1) * g)), None)


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().astype(np.float64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_std", [1e-3, 1.0])  # clip off, clip on
def test_adam_reference_matches_jax_adam_leaf(dtype, grad_std):
    """b1 is dyadic (0.875) here: JAX's static-b1 kernel rounds 1 - b1 from
    a Python double, its default fused step (which the port follows, and
    which the next test holds the port to with the cycled b1) rounds it in
    f32; for 0.9 the two differ by 2 ULP of the gradient term."""
    shapes = [(37, 256), (1001, 128), (8, 384)]  # odd row counts pad in JAX's grid
    rng = np.random.RandomState(0)
    g = [(rng.randn(*s) * grad_std).astype(np.float32) for s in shapes]
    m = [(rng.randn(*s) * 0.01).astype(np.float32) for s in shapes]
    v = [(rng.randn(*s) * 0.01).astype(np.float32) ** 2 for s in shapes]
    p = [rng.randn(*s).astype(np.float32) for s in shapes]
    tdt = getattr(torch, dtype)
    tg, tm, tv, tp = ([torch.from_numpy(a).to(tdt) for a in arrs] for arrs in (g, m, v, p))
    b1, lr, count = 0.875, 3e-4, 7
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(0.999) ** np.float32(count))
    got_p, got_m, got_v = tadam.adam_reference(tg, tm, tv, tp, lr, b1, c1, c2, clip=1.0,
                                               eps=1e-8)
    gn = float(tadam.global_norm(tg))
    assert (gn < 1.0) == (grad_std < 1e-2)
    scale = np.float32(1.0) if gn < 1.0 else np.float32(1.0) / np.float32(gn)
    scalars = jnp.asarray([scale, lr, c1, c2], jnp.float32)
    bits = 24 if dtype == "float32" else 8
    budgets = (3, 2, 2) if dtype == "float32" else (2, 2, 2)  # (p', m', v')
    for i in range(len(shapes)):
        jg, jm, jv, jp = (jnp.asarray(t[i].float().numpy()).astype(dtype)
                          for t in (tg, tm, tv, tp))
        want = jadam.adam_leaf(jg, jm, jv, jp, scalars, b1=b1, b2=0.999, eps=1e-8)
        mags = _terms(_as_np(tp[i]), _as_np(tm[i]), _as_np(tg[i]), b1, float(scale),
                      np.asarray(want[0].astype(jnp.float32)))
        for got, w, mag, budget in zip((got_p[i], got_m[i], got_v[i]), want, mags, budgets):
            assert got.dtype == tdt
            assert _ulps(_as_np(got), np.asarray(w.astype(jnp.float32)), bits, mag) <= budget


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_adam_table_records_each_leaf_alignment(dtype):
    """Leaves as views of one buffer at element offsets 0, 1, 3, 8 and 16:
    a leaf whose moments and param sit at one offset modulo 16 bytes gets
    that offset (the kernel moves it as 16-byte vectors where its gradient
    sits there too), a leaf whose three differ gets -1 (element by
    element). The table's words hold the phases and every chunk's leaf
    (one lookup a chunk), and a GAViKO-sized step is one launch where
    vit-b16's is two."""
    size = torch.empty((), dtype=dtype).element_size()
    sizes, offsets = (5, 4096, 9000, 7, 4097), (0, 1, 3, 8, 16)
    bufs = [torch.zeros(40_000, dtype=dtype) for _ in range(3)]
    views = [[buf[o:o + n] for o, n in zip(offsets, sizes)] for buf in bufs]
    views[2][3] = torch.zeros(8, dtype=dtype)[1:]  # leaf 3's param: one element in
    table = tadam.AdamTable(*views)
    base = [buf.data_ptr() % 16 for buf in bufs]
    want = []
    for i, o in enumerate(offsets):
        ptrs = [v[i].data_ptr() % 16 for v in views]
        want.append(ptrs[0] if len(set(ptrs)) == 1 else -1)
    assert table.phases.tolist() == want
    assert base == [0, 0, 0]  # fresh allocations: 16-byte aligned
    assert want[0] == 0 and want[1] == (size % 16) and want[2] == (3 * size) % 16
    assert want[3] == -1 and want[4] == (16 * size) % 16 == 0
    n = len(sizes)
    words = table.words.numpy()
    assert words[6 * n + 2:7 * n + 2].tolist() == want
    chunks = [-(-s // tadam.CHUNK) for s in sizes]
    leaf_of = words[7 * n + 2:].view(np.int32)[:table.n_chunks]
    assert leaf_of.tolist() == [i for i, c in enumerate(chunks) for _ in range(c)]
    assert words[5 * n + 2:6 * n + 2].tolist() == np.cumsum([0] + chunks[:-1]).tolist()
    assert table.one_pass  # 26 K elements
    assert tadam.one_pass(2_270_000 * 4) and not tadam.one_pass(88_200_000 * 4)


@pytest.mark.parametrize("grad_std", [1e-3, 0.7])  # clip off, clip on
def test_fused_step_with_cycled_b1_from_a_carried_state_matches_jax(grad_std):
    rng = np.random.RandomState(5)
    shapes = {"a": (7, 5), "b": (5,), "c": (1, 3, 4), "one": (1,), "big": (4097,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * grad_std).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    total = 12
    lr_j, b1_j = jsched.from_config(SCHED, total), jsched.beta1_from_config(SCHED, total)
    lr_t, b1_t = tsched.from_config(SCHED, total), tsched.beta1_from_config(SCHED, total)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    for g in grads[:4]:  # carry the JAX state to mid-schedule
        jp, state = jopt.step({k: jnp.asarray(v) for k, v in g.items()}, state, jp, lr_j,
                              clip=1.0, b1=b1_j)
    tp, tstate = from_jax(jp), opt_state_from_jax(state)
    jp, state = jopt.step({k: jnp.asarray(v) for k, v in grads[4].items()}, state, jp, lr_j,
                          clip=1.0, b1=b1_j)
    tp, tstate = topt.step(from_jax(grads[4]), tstate, tp, lr_t, clip=1.0, b1=b1_t)
    assert tstate.count == int(state.count) == 5
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(state.mu[k]), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(state.nu[k]), rtol=0,
                                   atol=1e-10)


def test_multi_step_matches_optax_multisteps():
    """accumulation_steps 2: the running mean of the micro-step gradients
    and one update every second micro-step, the schedules over the updates
    (JAX: optax.MultiSteps around its clip -> cycled Adam -> lr chain)."""
    cfg = {**TRAIN_CFG, "accumulation_steps": 2}
    total = 12
    rng = np.random.RandomState(6)
    shapes = {"w": (6, 5), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 0.8).astype(np.float32) for k, s in shapes.items()}
             for _ in range(6)]
    tx, _, fused_j = jloop.make_optimizer(cfg, total)
    assert fused_j is None  # JAX takes its optax chain under accumulation
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jloop.init_opt_state(tx, None, jp)
    fused_t = tloop.make_optimizer(cfg, total)
    tp = from_jax(params)
    tstate = tloop.init_opt_state(tp, fused_t)
    for i, g in enumerate(grads):
        jp, jstate = jloop.apply_optimizer(tx, None, {k: jnp.asarray(v) for k, v in g.items()},
                                           jstate, jp)
        before = {k: v.clone() for k, v in tp.items()}
        tp, tstate = tloop.apply_optimizer(fused_t, from_jax(g), tstate, tp)
        assert tstate.mini_step == int(jstate.mini_step) == (i + 1) % 2
        assert tstate.gradient_step == int(jstate.gradient_step) == (i + 1) // 2
        if i % 2 == 0:  # an accumulating micro-step leaves the params as they are
            assert all(torch.equal(tp[k], before[k]) for k in tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(tstate.acc[k].numpy(), np.asarray(jstate.acc_grads[k]),
                                       rtol=0, atol=1e-7)


def _jax_states(accum: int):
    """A JAX trainable dict and its optimizer state after two updates (the
    fused state, or the accumulating MultiSteps one mid-cycle)."""
    rng = np.random.RandomState(7)
    shapes = {"head.weight": (5, 4), "head.bias": (5,), "blocks.0.bias": (4,)}
    jp = {k: jnp.asarray(rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}
    cfg = {**TRAIN_CFG, "accumulation_steps": accum}
    tx, _, fused = jloop.make_optimizer(cfg, 20)
    state = jloop.init_opt_state(tx, fused, jp)
    for _ in range(2 * accum + 1):
        g = {k: jnp.asarray(rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}
        jp, state = jloop.apply_optimizer(tx, fused, g, state, jp)
    return jp, state, cfg


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_state_files_load_in_both_packages(tmp_path, accum):
    jp, jstate, cfg = _jax_states(accum)
    meta = {"epoch": 3, "step_in_epoch": 1, "global_step": 9, "best_val_acc": 0.5,
            "best_epoch": 2, "epoch_since_improvement": 1}
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_train_state(jpath, jp, jstate, meta)

    fused = tloop.make_optimizer(cfg, 20)
    tp_template = {k: torch.zeros(v.shape) for k, v in jp.items()}
    template = tloop.init_opt_state(tp_template, fused)
    tp, tstate, tmeta = tckpt.load_train_state(jpath, tp_template, template)
    assert tmeta == meta
    jleaves = jax.tree.leaves(jstate)
    tleaves = tckpt.opt_leaves(tstate)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(np.asarray(tckpt.tensor_to_array(a)), np.asarray(b))
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))

    tpath = str(tmp_path / "port.npz")
    tckpt.save_train_state(tpath, tp, tstate, tmeta)
    jtemplate = jax.tree.map(jnp.zeros_like, jstate)
    jp2, jstate2, jmeta = jckpt.load_train_state(
        tpath, {k: jnp.zeros_like(v) for k, v in jp.items()}, jtemplate)
    assert jmeta == meta
    for a, b in zip(jax.tree.leaves(jstate2), jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp2[k]), np.asarray(jp[k]))


def test_port_pt_checkpoint_loads_in_jax_build_params(tmp_path):
    """PARITY #14: a trainable-only .pt written by the port (f32 and bf16
    entries) loads in JAX's load_pt, and JAX's build_params overlays it."""
    from gaviko_tpu.models.factory import build_model as jax_build_model
    from gaviko_tpu.models.pretrained import build_params as jax_build_params
    from gaviko_tpu.weights.torch_io import load_pt as jax_load_pt

    cfg = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_classes=5, channels=1, pool="cls", backbone="vit-t16", method="bitfit")
    jm = jax_build_model(cfg)
    init = jm.init(jax.random.PRNGKey(0), jm.spec)
    rng = np.random.RandomState(8)
    trainable = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
                 for k, v in init.items() if jm.trainable(k)}
    path = str(tmp_path / "best.pt")
    torch_io.save_pt(path, trainable)
    loaded = jax_load_pt(path)
    assert set(loaded) == set(trainable)
    params = jax_build_params(jm, jax.random.PRNGKey(0), pretrained_dir=str(tmp_path),
                              checkpoint_path=path)
    for k, v in trainable.items():
        np.testing.assert_array_equal(np.asarray(params[k]), v.numpy())
    key = "conv_proj.0.bias"
    bf16 = {key: trainable[key].bfloat16()}
    torch_io.save_pt(path, bf16)
    back = jax_load_pt(path)[key]
    assert back.dtype.name == "bfloat16"
    np.testing.assert_array_equal(back.astype(np.float32), bf16[key].float().numpy())
    assert torch.equal(torch_io.load_pt(path)[key], bf16[key])
