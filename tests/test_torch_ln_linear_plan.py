"""PyTorch port: the plan of kernels B9 and B12 (the LN + linear forward and
backward on the GEMM of ``csrc/gemm_sm90.cuh``), their launches on a faked
card, and Queue C 11, on the CPU.

- ``ln_linear_plan`` at every (dim, out) JAX's ``ln_linear_supported`` or
  ``ln_linear_hybrid_supported`` admits in bf16 and fp32, at the four
  backbones' qkv and kv widths and at the widths above 1,024 (Queue C 11),
  at 37 / 1,001 / 8,064 rows: shared memory within a CTA's 232,448 bytes,
  each product's tiles on the grid of its launch's tile (one of the GEMM's
  compiled tiles, ``ops/_blocks.py``) over its output, the scratch in one
  buffer without overlaps;
- at every compiled tile (``GAVIKO_LNL_BLOCK``), every CTA of each launch
  decoded as the kernel decodes its block index: each output tile of each
  product once, and B12's grouped launch taking dW's deep tiles before
  dh's;
- what the plan cannot take raises, and what the old kernels took (out 136)
  it takes;
- on a faked CUDA tensor (``use_kernel`` says yes, ``launch`` records), B9
  and B12 make one call of their C entry points with the plan's scratch; B9
  at (1,152 -> 1,152) bf16 and (1,152 -> 768) f32, which the kernel before
  the GEMM refused (Queue C 11);
- ``ln_linear_reference`` at dim 1,152 and 1,280 against JAX's Pallas kernel
  in interpret mode;
- the 3xTF32 split emulated in torch: B9's and B12's f32 outputs within
  1e-5 relative MAE of the f32 plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaviko_tpu.ops import ln_linear as jln
from gaviko_tpu_torch.ops import _blocks
from gaviko_tpu_torch.ops import gemm_plan as gp
from gaviko_tpu_torch.ops import ln_linear as tln
from tests.test_torch_mlp_plan import _fake_card, _matmul_3xtf32

DTYPES = [torch.bfloat16, torch.float32]
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
ROWS = (37, 1001, 8064)
BACKBONES = (192, 384, 768, 1024)  # vit-t16, s16, b16, l16
# The qkv and kv projections of the backbones, and Queue C 11's widths.
C11 = ((1152, 1152), (2048, 768), (1152, 768), (1280, 768))
WIDTHS = tuple((d, k * d) for d in BACKBONES for k in (3, 2)) + C11


def _admitted(dtype):
    """Every (dim, out) JAX's forward or hybrid gate admits in ``dtype``:
    both multiples of 128 with the weight within the larger budget."""
    jdt = JAX_DTYPE[dtype]
    limit = tln._HYBRID_BUDGET // ((dtype.itemsize + 4) * 128 * 128)
    pairs = [(128 * a, 128 * b) for a in range(1, limit + 1) for b in range(1, limit // a + 1)]
    return [p for p in pairs
            if jln.ln_linear_supported(*p, jdt) or jln.ln_linear_hybrid_supported(*p, jdt)]


def _check_plan(plan, kind, rows, dim, out):
    assert plan.smem <= gp.SMEM_LIMIT and plan.chunk == 128 // plan.dtype.itemsize
    want = {"linear": (rows, out, dim), "dw": (out, dim, rows), "dh": (rows, dim, out)}
    names = {"forward": ["linear"], "backward": ["dw", "dh"], "backward_dh": ["dh"]}[kind]
    assert [[p.name for p in launch] for launch in plan.products] == [names]
    assert plan.launches == (2 if kind == "forward" else 4)
    tile, = {p.tile_shape for p in plan.products[0]}  # a launch runs one tile
    assert tile in _blocks.TILES[plan.dtype] and plan.smem == gp.gemm_smem(plan.dtype, tile)
    bm, bn = tile
    for p in plan.products[0]:
        assert (p.m, p.n, p.k) == want[p.name], p.name
        assert (p.tiles_m - 1) * bm < p.m <= p.tiles_m * bm
        assert (p.tiles_n - 1) * bn < p.n <= p.tiles_n * bn
    end = 0
    for name, shape, dtype, off in plan.scratch:
        assert off % 256 == 0 and off >= end, name
        end = off + int(np.prod(shape)) * dtype.itemsize
    assert end <= plan.scratch_bytes
    got = {name for name, *_ in plan.scratch}
    assert got == ({"h"} if kind == "forward" else
                   {"h", "dh", "mean", "rstd", "part_dg", "part_db"} - (
                       {"h"} if kind == "backward_dh" else set()))
    assert plan.row_blocks == (0 if kind == "forward" else -(-rows // gp.ROW_BLOCK))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_plan_at_every_width_the_jax_gates_admit(dtype):
    """Every width JAX's two gates admit, the backbones' qkv and kv widths
    (vit-t16's 192 and vit-l16's beyond the gates, as a direct call takes
    them) and Queue C 11's have a plan of each kind at each row count."""
    admitted = _admitted(dtype)
    assert (768, 2304) in admitted and set(C11) <= set(admitted)
    for dim, out in sorted(set(admitted) | set(WIDTHS)):
        for rows in ROWS:
            for kind in tln.KINDS:
                _check_plan(tln.ln_linear_plan(kind, rows, dim, out, dtype), kind, rows, dim, out)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("dim,out", WIDTHS[::3] + C11 + ((256, 136),))
@pytest.mark.parametrize("rows", ROWS)
def test_tiles_cover_every_output_once(monkeypatch, dtype, dim, out, rows):
    """At every compiled tile (``GAVIKO_LNL_BLOCK``), each launch's CTAs,
    decoded as the kernel decodes its block index, take every output tile
    of each of its products once."""
    for bm, bn in _blocks.TILES[dtype]:
        monkeypatch.setenv(_blocks.LNL_ENV, str(bm))
        for kind in tln.KINDS:
            launch, = tln.ln_linear_plan(kind, rows, dim, out, dtype).products
            seen = set()
            for block in range(sum(p.blocks for p in launch)):
                name, m0, n0 = gp.launch_tile(launch, block)
                p = next(q for q in launch if q.name == name)
                assert p.tile_shape == (bm, bn)
                assert m0 % bm == 0 and n0 % bn == 0
                assert 0 <= m0 < p.m and 0 <= n0 < p.n
                assert (name, m0, n0) not in seen
                seen.add((name, m0, n0))
            assert len(seen) == sum(p.tiles_m * p.tiles_n for p in launch)
            with pytest.raises(IndexError):
                gp.launch_tile(launch, len(seen))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_b12_runs_dw_and_dh_in_one_launch(monkeypatch, dtype):
    """B12's GEMM launch: dW's tiles (depth: the rows) first, then dh's
    (depth: out), which fill dW's last wave; without dW, dh alone. At
    vit-b16 B8 that is 108 + 378 CTAs, at GAViKO vit-l16 B4 192 + 264 (on
    128 x 128 tiles: GAVIKO_LNL_BLOCK=128)."""
    monkeypatch.setenv(_blocks.LNL_ENV, "128")
    plan = tln.ln_linear_plan("backward", 8064, 768, 2304, dtype)
    (dw, dh), = plan.products
    assert (dw.blocks, dh.blocks) == (108, 378) and dw.k == 8064 > dh.k == 2304
    assert gp.launch_tile(plan.products[0], 107) == ("dw", 2304 - 128, 768 - 128)
    assert gp.launch_tile(plan.products[0], 108) == ("dh", 0, 0)
    (dw, dh), = tln.ln_linear_plan("backward", 4160, 1024, 3072, dtype).products
    assert (dw.blocks, dh.blocks) == (192, 264)
    (only,), = tln.ln_linear_plan("backward_dh", 8064, 768, 2304, dtype).products
    assert only == gp.GemmProduct("dh", 8064, 768, 2304) and only.blocks == 378
    assert tln.ln_linear_plan("forward", 8064, 768, 2304, dtype).products[0][0].blocks == 63 * 18


def test_plan_raises_only_where_no_kernel_runs():
    """A dtype other than bf16 / f32, no rows or columns, a K stride that is
    no multiple of 16 bytes and matrices of 2**31 elements raise; any out
    width of B9, the old kernels' shapes (out 136) and narrow f32 rows run."""
    with pytest.raises(NotImplementedError, match="float16"):
        tln.ln_linear_plan("forward", 64, 768, 2304, torch.float16)
    with pytest.raises(ValueError, match="no rows"):
        tln.ln_linear_plan("backward", 0, 768, 2304)
    with pytest.raises(ValueError, match="no rows"):
        tln.ln_linear_plan("forward", 64, 768, 0)
    with pytest.raises(ValueError, match="kind"):
        tln.ln_linear_plan("fwd", 64, 768, 2304)
    with pytest.raises(NotImplementedError, match="16-byte"):
        tln.ln_linear_plan("forward", 64, 100, 256)
    with pytest.raises(NotImplementedError, match="out 100"):
        tln.ln_linear_plan("backward", 64, 128, 100)
    with pytest.raises(NotImplementedError, match="dim 6"):
        tln.ln_linear_plan("backward_dh", 64, 6, 128, torch.float32)
    with pytest.raises(NotImplementedError, match="2\\*\\*31"):
        tln.ln_linear_plan("forward", 2 ** 21, 1024, 3072)
    assert tln.ln_linear_plan("forward", 64, 128, 100).products[0][0].tiles_n == 1
    for kind in tln.KINDS:
        _check_plan(tln.ln_linear_plan(kind, 10, 128, 136), kind, 10, 128, 136)
        _check_plan(tln.ln_linear_plan(kind, 3, 4, 4, torch.float32), kind, 3, 4, 4)


def _inputs(rows, dim, out, dtype, seed=0):
    rng = np.random.RandomState(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32)).to(dtype)

    return (t(1, rows, dim, std=2.0) + 0.5, 1.0 + t(dim, std=0.1), t(dim, std=0.1),
            t(out, dim, std=dim ** -0.5), t(1, rows, out, std=out ** -0.5))


def _check_b9_call(monkeypatch, dtype, suffix, rows, dim, out):
    calls = _fake_card(monkeypatch)
    x, gamma, beta, w, _ = _inputs(rows, dim, out, dtype)
    before = tln.fused_ln_linear.launches
    y = tln.fused_ln_linear(x, gamma, beta, w)
    assert tln.fused_ln_linear.launches == before + 1
    assert y.shape == (1, rows, out) and y.dtype == dtype
    (name, symbol, argtypes, got), = calls
    assert (name, symbol) == ("ln_linear", f"gaviko_ln_linear_{suffix}")
    assert len(argtypes) == len(got) == 13
    assert got[:5] == tuple(t.data_ptr() for t in (x, gamma, beta, w, y))
    assert got[5] % 16 == 0  # h, the plan's scratch
    tile = tln.ln_linear_plan("forward", rows, dim, out, dtype).products[0][0].tile_shape
    assert got[6:] == (rows, dim, out, 1e-5, *tile, 0)


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("dim,out", [(768, 2304), (256, 136)])
def test_fused_ln_linear_is_one_call_on_a_faked_card(monkeypatch, dtype, suffix, dim, out):
    """B9: one call of its entry point (the LN pass and the GEMM) with the
    inputs, the output, the plan's h, the rows, the widths and eps."""
    _check_b9_call(monkeypatch, dtype, suffix, 70, dim, out)


@pytest.mark.parametrize("dtype,suffix,dim,out", [(torch.bfloat16, "bf16", 1152, 1152),
                                                  (torch.float32, "f32", 1152, 768)])
def test_fused_ln_linear_takes_widths_above_1024_on_a_faked_card(monkeypatch, dtype, suffix,
                                                                 dim, out):
    """Queue C 11: B9 at widths above 1,024 that JAX's gate admits reaches
    its kernel (the kernel before the GEMM staged a whole row tile in shared
    memory and raised there)."""
    assert tln.ln_linear_supported(dim, out, dtype)
    assert jln.ln_linear_supported(dim, out, JAX_DTYPE[dtype])
    _check_b9_call(monkeypatch, dtype, suffix, 37, dim, out)


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("need_dw", [True, False])
def test_ln_linear_bwd_is_one_call_on_a_faked_card(monkeypatch, dtype, suffix, need_dw):
    """B12: one call of its entry point (its four launches) with the inputs,
    the outputs (no dW and no h without dW), the plan's scratch and its tile."""
    calls = _fake_card(monkeypatch)
    rows, dim, out = 70, 1152, 768
    x, gamma, beta, w, dy = _inputs(rows, dim, out, dtype)
    before = tln.ln_linear_bwd.launches
    outs = tln.ln_linear_bwd(x, gamma, beta, w, dy, 1e-5, need_dw)
    assert tln.ln_linear_bwd.launches == before + 1
    (name, symbol, argtypes, got), = calls
    assert (name, symbol) == ("ln_linear_bwd", f"gaviko_ln_linear_bwd_{suffix}")
    assert len(argtypes) == len(got) == 22
    assert got[:5] == tuple(t.data_ptr() for t in (x, gamma, beta, w, dy))
    assert got[5:8] == tuple(t.data_ptr() for t in outs[:3])
    assert (got[8] is None) is (outs[3] is None) is (not need_dw)
    plan = tln.ln_linear_plan("backward" if need_dw else "backward_dh", rows, dim, out, dtype)
    layout = {n: off for n, _, _, off in plan.scratch}
    base = got[10] - layout["dh"]
    assert got[9] == (base + layout["h"] if need_dw else None)
    for n, p in zip(("dh", "mean", "rstd", "part_dg", "part_db"), got[10:15]):
        assert p == base + layout[n], n
    assert got[15:] == (rows, dim, out, 1e-5, *plan.products[0][0].tile_shape, 0)


@pytest.mark.parametrize("dtype,dim,out,budget", [
    (torch.float32, 1152, 768, 1e-5), (torch.float32, 1280, 768, 1e-5),
    (torch.bfloat16, 1152, 1152, 2e-3)])
def test_reference_above_1024_matches_jax_kernel(dtype, dim, out, budget):
    """Queue C 11's widths: ``ln_linear_reference`` against JAX's
    ``fused_ln_linear`` (its Pallas kernel in interpret mode), f32 within
    1e-5 MAE, bf16 within 2e-3 relative MAE."""
    x, gamma, beta, w, _ = _inputs(16, dim, out, torch.float32, seed=3)
    jdt = JAX_DTYPE[dtype]
    want = np.asarray(jln.fused_ln_linear(*(jnp.asarray(t.numpy()).astype(jdt)
                                            for t in (x, gamma, beta, w))), np.float64)
    got = tln.ln_linear_reference(*(t.to(dtype) for t in (x, gamma, beta, w)))
    err = np.abs(got.double().numpy() - want).mean()
    if dtype == torch.bfloat16:
        err /= np.abs(want).mean()
    assert got.shape == (1, 16, out) and err <= budget


def test_3xtf32_products_of_b9_and_b12_hold_the_f32_budget(monkeypatch):
    """B9's and B12's f32 outputs with every product as the GEMM's 3xTF32
    (emulated) stay within 1e-5 relative MAE of the f32 plain version (the
    card's budget is 1e-4), at 48 rows, dim 128, out 136."""
    x, gamma, beta, w, dy = _inputs(48, 128, 136, torch.float32, seed=5)

    def run():
        return (tln.ln_linear_reference(x, gamma, beta, w),
                *tln.ln_linear_bwd_reference(x, gamma, beta, w, dy))

    plain = run()
    monkeypatch.setattr(torch, "matmul", _matmul_3xtf32)
    emulated = run()
    for name, p, e in zip(("y", "dx", "dgamma", "dbeta", "dw"), plain, emulated):
        rel = float((e.double() - p.double()).abs().mean() / p.double().abs().mean())
        assert rel <= 1e-5, (name, rel)
