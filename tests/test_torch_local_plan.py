"""PyTorch port: the plan of kernels C and D (GAViKO's 3-D-window local
attention, forward and backward; ``csrc/local_window.cuh``) and their
launches on a faked card, on the CPU.

- ``local_plan`` over every latent width 1..512, the patch grids 10x10x10
  (GAViKO at image_size 160), 10x14x14 (224), 10x16x16 (256) and
  16x16x16, the windows (6, 6, 6), (3, 6, 6) and (2, 3, 1), both dtypes
  and batches 1, 4 and 8: it never raises, every pass fits a CTA's shared
  memory, its column slices cover dl in the fewest slices of the widths
  its accumulators hold, and its staged rows reach S's depth and every
  slice. Before ROADMAP Queue C item 8 was repaired the kernels refused
  dl > 32 and staged every row of the depth slabs a block reached, so 10 x
  16 x 16 asked for more shared memory than a CTA has;
- shared memory does not grow with the grid, and GAViKO's B4 launches
  280 CTAs on the 132 SMs (the one-thread-a-row kernels launched 32 blocks);
- on a faked CUDA tensor C and D are one launch each with their entry
  points' arguments, the plan among them, at dl 40 and on the 10x14x14
  grid;
- latents too wide for a staged row of S's whole depth (ROADMAP Queue C
  12: dl 640 and 1,152 in f32, 1,168 and 2,304 in bf16, on GAViKO's grid
  at B4): the passes that no longer fit whole stream S's depth in chunks,
  within a CTA's shared memory, and C and D take those widths on a faked
  card; the plain versions match JAX's interpret-mode kernel and its
  reference's VJP at dl 640 (atol 1e-5, as the other local tests). Before
  the repair the plan raised there.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaviko_tpu.ops import flash_attention as jfa

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops.hash_dropout import dropout_args

DTYPES = [torch.bfloat16, torch.float32]
GRIDS = [(10, 10, 10), (10, 14, 14), (10, 16, 16), (16, 16, 16)]
WINDOWS = [(6, 6, 6), (3, 6, 6), (2, 3, 1)]


def _check_pass(plan, kind, dl, dtype, rs):
    bf16 = dtype == torch.bfloat16
    widest = {"fwd": 128, "dq": 128, "dkdv": 64}[kind] // (1 if bf16 else 2)
    assert plan.smem <= tfa.SMEM_LIMIT and plan.rs in (0, rs)
    assert plan.kv == int(plan.rs > 0 and kind != "dkdv")
    assert plan.smem == tfa._local_smem(kind, plan.split, plan.stages, plan.width, plan.cols,
                                        2 if bf16 else 4, plan.rs, bool(plan.kv))
    assert plan.split in (1, 2, 4) and plan.stages in (1, 2)
    assert plan.cols % 8 == 0 and plan.cols <= widest
    assert (plan.slices - 1) * plan.cols < dl <= plan.slices * plan.cols
    assert plan.slices == -(-dl // widest)  # the fewest slices of at most `widest`
    assert plan.width >= dl and plan.width % (16 if bf16 else 8) == 0
    if kind != "fwd":  # the slices of K (dq), Q and dO (dk/dv) are read from staged rows
        assert plan.width >= plan.slices * plan.cols


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_local_plan_covers_every_latent_grid_and_window(dtype):
    """Every latent, grid, window and batch of the sweep, with the streamed
    rows read in place from the packed projection (row stride 3 dl, K and V
    in one stripe) and element-wise: a plan within a CTA's shared memory.
    At B4 on 10x10x10 the packed stripes fit every pass at dl 20, 64 and
    128."""
    for DHW, local_k, B in itertools.product(GRIDS, WINDOWS, (1, 4, 8)):
        for dl in range(1, 513):
            for rs in (3 * dl, 0):
                plan = tfa.local_plan(DHW, local_k, dl, dtype, B, rs, rs > 0)
                for kind in ("fwd", "dq", "dkdv"):
                    _check_pass(getattr(plan, kind), kind, dl, dtype, rs)
                assert plan.bwd_arg == plan.dq.arg + plan.dkdv.arg and len(plan.bwd_arg) == 14
    for dl in (20, 64, 128):
        assert all(p.rs == 3 * dl for p in tfa.local_plan((10, 10, 10), (6, 6, 6), dl, dtype, 4,
                                                          3 * dl, True))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_local_plan_smem_does_not_grow_with_the_grid(dtype):
    """At a fixed split and stage count the plan's shared memory is the
    same on every grid (the key tiles stream). GAViKO's B4 on 10x10x10
    launches 4 x 10 slabs x 7 tiles = 280 CTAs of up to 16 rows (more than
    two an SM) with 4 warps splitting the key tiles, double-buffered where
    the shared memory still holds every CTA of the grid in one wave;
    K and V share a stripe in C and the dq pass."""
    plans = {DHW: tfa.local_plan(DHW, (6, 6, 6), 20, dtype, 4, 60, True)
             for DHW in GRIDS + [(10, 32, 32)]}
    for kind in ("fwd", "dq", "dkdv"):
        by_tile = {}
        for plan in plans.values():
            p = getattr(plan, kind)
            by_tile.setdefault((p.split, p.stages), set()).add(p.smem)
        assert all(len(smem) == 1 for smem in by_tile.values())
    gaviko = plans[(10, 10, 10)]
    per_sm = -(-4 * 10 * 7 // tfa.SMS)
    assert per_sm == 3
    size = 2 if dtype == torch.bfloat16 else 4
    for kind, p in zip(("fwd", "dq", "dkdv"), gaviko):
        assert (p.split, p.slices) == (4, 1)
        two = tfa._local_smem(kind, 4, 2, p.width, p.cols, size, 60, bool(p.kv))
        assert (p.stages == 2) == (per_sm * (two + 1024) <= tfa.SM_SMEM)
    assert [p.kv for p in gaviko] == [1, 1, 0]
    if dtype == torch.bfloat16:
        assert [p.stages for p in gaviko] == [2, 2, 2]


def test_local_plan_raises_on_what_the_kernels_cannot_take():
    """A latent below 1, float16 and a grid 1024 high or wide (the kernels
    pack h and w in 10 bits each) raise. The widest latents whose dk/dv
    pass still stages S's whole depth (1152 in bf16, 576 in f32: its owned
    K and V beside one streamed tile of Q and dO) keep it; one column more
    raised here until ROADMAP Queue C 12 was repaired, and now streams the
    depth in chunks."""
    with pytest.raises(ValueError, match="local_dim"):
        tfa.local_plan((2, 2, 2), (2, 2, 2), 0)
    with pytest.raises(NotImplementedError, match="float16"):
        tfa.local_plan((2, 2, 2), (2, 2, 2), 20, torch.float16)
    with pytest.raises(ValueError, match="grid"):
        tfa.local_plan((1, 1, 1024), (2, 2, 2), 20)
    assert tfa.local_plan((1024, 2, 2), (2, 2, 2), 20).fwd.smem <= tfa.SMEM_LIMIT
    for dl, dtype in ((1152, torch.bfloat16), (576, torch.float32)):
        whole = tfa.local_plan((10, 10, 10), (6, 6, 6), dl, dtype).dkdv
        assert whole.stages == 1 and whole.width >= dl
        wider = tfa.local_plan((10, 10, 10), (6, 6, 6), dl + 1, dtype).dkdv
        assert wider.width < dl + 1 and wider.smem <= tfa.SMEM_LIMIT


def _fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, argtypes, *args: calls.append((name, symbol, args)))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return calls


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("DHW,dl", [((2, 3, 4), 40), ((10, 14, 14), 20)])
def test_local_kernels_are_one_launch_each_with_the_plan(monkeypatch, dtype, suffix, DHW, dl):
    """C reads q, k and v as strided views of the packed projection in
    place: one launch with their pointers and strides, the geometry, the
    dropout arguments, the forward's plan (its stripes at the packed row
    stride) and the end of each view's storage; D is one launch (its entry
    point runs both passes) with the fourteen ints of the backward's plan
    and the ends of q, k, v, dout, lse and delta."""
    calls = _fake_card(monkeypatch)
    B, n = 2, DHW[0] * DHW[1] * DHW[2]
    qkv = torch.zeros(B, n, 3 * dl, dtype=dtype)
    q, k, v = qkv.split(dl, dim=-1)
    before = (tfa.flash_local_attention.launches, tfa.local_attention_bwd.launches)
    out, lse = tfa._local_forward(q, k, v, 0.05, DHW, (6, 6, 6), 0.2, 9)
    dqkv = tfa.local_attention_bwd(q, k, v, out, lse, torch.zeros_like(out), 0.05, DHW,
                                   (6, 6, 6), 0.2, 9)
    assert (tfa.flash_local_attention.launches, tfa.local_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == (B, n, dl) and lse.shape == (B, n) and dqkv.shape == qkv.shape
    plan = tfa.local_plan(DHW, (6, 6, 6), dl, dtype, B, 3 * dl, True)
    assert plan.fwd.rs == plan.dq.rs == plan.dkdv.rs == 3 * dl
    assert (plan.fwd.kv, plan.dq.kv, plan.dkdv.kv) == (1, 1, 0)
    end = qkv.data_ptr() + qkv.numel() * qkv.element_size()
    (name, symbol, args), (bname, bsymbol, bargs) = calls
    assert (name, symbol) == ("local_attention", f"gaviko_local_attention_{suffix}")
    geom = (B, n, dl, *DHW, 6, 6, 6, n * 3 * dl, 3 * dl, n * 3 * dl, 3 * dl, n * 3 * dl, 3 * dl)
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse.data_ptr())
    assert args[5:20] == geom and args[20:24] == (0.05, *dropout_args(0.2, 9))
    assert tuple(args[24]) == plan.fwd.arg and tuple(args[25])[:3] == (end,) * 3
    assert args[26] == 0
    assert (bname, bsymbol) == ("local_attention_bwd", f"gaviko_local_attention_bwd_{suffix}")
    assert bargs[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert bargs[7] == dqkv.data_ptr() and bargs[8:23] == geom
    assert tuple(bargs[27]) == plan.bwd_arg and tuple(bargs[28])[:3] == (end,) * 3
    assert bargs[29] == 0


def test_local_kernels_copy_element_wise_where_words_do_not_line_up(monkeypatch):
    """An odd latent in bf16 puts the packed rows off 4-byte words: the plan
    copies the streamed rows element-wise (rs 0); in f32 the same views are
    read in place, K and V in one stripe. K and V from two tensors take a
    stripe each."""
    calls = _fake_card(monkeypatch)
    for dtype, rs in ((torch.bfloat16, 0), (torch.float32, 63)):
        q, k, v = torch.zeros(1, 24, 63, dtype=dtype).split(21, dim=-1)
        tfa._local_forward(q, k, v, 0.05, (2, 3, 4), (6, 6, 6), 0.0, 0)
        assert tuple(calls[-1][2][24]) == tfa.local_plan((2, 3, 4), (6, 6, 6), 21, dtype, 1,
                                                         rs, rs > 0).fwd.arg
        assert tuple(calls[-1][2][24])[5:] == (rs, int(rs > 0))
    q, k, v = (torch.zeros(1, 24, 20) for _ in range(3))
    tfa._local_forward(q, k, v, 0.05, (2, 3, 4), (6, 6, 6), 0.0, 0)
    assert tuple(calls[-1][2][24])[5:] == (20, 0)


# ROADMAP Queue C 12: latents whose staged rows of S's whole depth leave no
# tile in shared memory (the plan raised "no tile" at each of these).
C12 = [(640, torch.float32), (1152, torch.float32), (1168, torch.bfloat16),
       (2304, torch.bfloat16)]


@pytest.mark.parametrize("dl,dtype", C12, ids=["f32_640", "f32_1152", "bf16_1168", "bf16_2304"])
def test_local_plan_streams_the_depth_of_wide_latents(dl, dtype):
    """GAViKO's grid and window at B4, read element-wise and from the packed
    projection: a plan within a CTA's shared memory, whose passes either
    stage S's whole depth as before or stream it in chunks of 256 bytes a
    row (128 bf16 / 64 f32 columns, below dl), element-wise, one round in
    flight, with the output's B operand sliced apart (the chunked layout of
    ``_local_smem``); the slices still cover dl."""
    size = 2 if dtype == torch.bfloat16 else 4
    for rs in (0, 3 * dl):
        plan = tfa.local_plan((10, 10, 10), (6, 6, 6), dl, dtype, 4, rs, rs > 0)
        assert any(p.width < dl for p in plan[1:])  # the dq and dk/dv passes hold two rows
        for kind, p in zip(("fwd", "dq", "dkdv"), plan):
            assert p.smem <= tfa.SMEM_LIMIT
            assert (p.slices - 1) * p.cols < dl <= p.slices * p.cols
            if p.width >= dl:
                assert p.smem == tfa._local_smem(kind, p.split, p.stages, p.width, p.cols,
                                                 size, p.rs, bool(p.kv))
                continue
            assert (p.width, p.stages, p.rs, p.kv) == (256 // size, 1, 0, 0)
            assert p.smem == tfa._local_smem(kind, p.split, 1, p.width, p.cols, size,
                                             chunked=True)
            assert p.smem < tfa._local_smem(kind, p.split, 1, dl, p.cols, size)
        assert len(plan.bwd_arg) == 14


@pytest.mark.parametrize("dl,dtype,suffix", [(640, torch.float32, "f32"),
                                             (1168, torch.bfloat16, "bf16")])
def test_local_kernels_take_wide_latents_on_a_faked_card(monkeypatch, dl, dtype, suffix):
    """C and D at Queue C 12's widths on GAViKO's grid at B4: one launch
    each, with the plan of those widths (the chunked passes among it)."""
    calls = _fake_card(monkeypatch)
    DHW, B = (10, 10, 10), 4
    q, k, v = torch.zeros(B, 1000, 3 * dl, dtype=dtype).split(dl, dim=-1)
    out, lse = tfa._local_forward(q, k, v, 0.05, DHW, (6, 6, 6), 0.2, 9)
    tfa.local_attention_bwd(q, k, v, out, lse, torch.zeros_like(out), 0.05, DHW, (6, 6, 6),
                            0.2, 9)
    plan = tfa.local_plan(DHW, (6, 6, 6), dl, dtype, B, 3 * dl, True)
    (_, symbol, args), (_, bsymbol, bargs) = calls
    assert (symbol, bsymbol) == (f"gaviko_local_attention_{suffix}",
                                 f"gaviko_local_attention_bwd_{suffix}")
    assert tuple(args[24]) == plan.fwd.arg and tuple(bargs[27]) == plan.bwd_arg
    assert any(p.width < dl for p in plan)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_local_plain_versions_match_jax_at_a_wide_latent(rate):
    """At dl 640 (a chunked latent in f32) on a tiny grid: the plain
    version of C against JAX's Pallas kernel in interpret mode, and the
    forward and VJP (D's plain version) against JAX's local_reference,
    atol 1e-5, dropout off and on."""
    DHW, local_k, dl = (2, 3, 3), (3, 3, 3), 640
    rng = np.random.RandomState(13)
    q, k, v = (rng.randn(1, 18, dl).astype(np.float32) for _ in range(3))
    g = rng.randn(1, 18, dl).astype(np.float32)
    scale, seed = dl ** -0.5, 4321
    jseed = jnp.asarray([seed], jnp.int32)
    kernel = jfa.flash_local_attention(*(jnp.asarray(t) for t in (q, k, v)), jseed, scale,
                                       DHW, local_k, rate)
    want, vjp = jax.vjp(
        lambda a, b, c: jfa.local_reference(a, b, c, jseed, scale, DHW, local_k, rate),
        *(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    got = tfa.flash_local_attention(tq, tk, tv, scale, DHW, local_k, rate, seed)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(kernel), atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for t, w in zip((tq, tk, tv), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5)
