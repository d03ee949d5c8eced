"""PyTorch port: the plan of kernels B6 and B7 (the fused MLP's forward and
backward on the GEMM of ``csrc/gemm_sm90.cuh``), their launches on a faked
card, and the 3xTF32 products of their f32 instances, on the CPU.

- ``mlp_plan`` at every (dim, mlp_dim) JAX's ``fused_mlp_supported`` admits
  in bf16 and fp32, and at the four backbones' widths, at ragged row counts
  (37, 2,002, 8,064): shared memory within a CTA's 232,448 bytes, each
  product's tiles on the grid of its launch's tile (one of the GEMM's
  compiled tiles, ``ops/_blocks.py``) over its output, db1's partials a
  row a tile of dg's rows, the scratch in one buffer without overlaps;
- at the backbones and at every compiled tile (``GAVIKO_MLP_BLOCK``),
  every CTA of each launch decoded as the kernel decodes its block index:
  each output tile of each product once, and B7's grouped launch taking
  the weight gradients' tiles before dh's;
- what the plan cannot take raises (vit-t16's 192 among it);
- on a faked CUDA tensor (``use_kernel`` says yes, ``launch`` records), B6
  and B7 make one call of their C entry points with the plan's scratch;
- the 3xTF32 split emulated in torch (each product's operands as hi + lo
  TF32 halves, lo * hi, hi * lo, hi * hi a step of 8 added in f32): every
  output of the MLP's forward and backward within 1e-5 relative MAE of the
  f32 plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaviko_tpu.ops import fused_mlp as jfm
from gaviko_tpu_torch.ops import _blocks, _build
from gaviko_tpu_torch.ops import fused_mlp as tfm
from gaviko_tpu_torch.ops.hash_dropout import dropout_args

DTYPES = [torch.bfloat16, torch.float32]
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
ROWS = (37, 2002, 8064)
# (dim, mlp_dim) of vit-t16, s16, b16 and l16, and Queue C 9's case.
BACKBONES = ((192, 768), (384, 1536), (768, 3072), (1024, 4096))
WIDTHS = BACKBONES[1:] + ((1152, 256),)


def _admitted(dtype):
    """Every (dim, mlp_dim) JAX's fused MLP gate admits in ``dtype``: both
    multiples of 128 with the weight pair within its VMEM budget."""
    itemsize = dtype.itemsize
    limit = tfm._WEIGHT_VMEM_BUDGET // (2 * itemsize * 128 * 128)
    pairs = [(128 * a, 128 * b) for a in range(1, limit + 1) for b in range(1, limit // a + 1)]
    return [p for p in pairs if jfm.fused_mlp_supported(*p, JAX_DTYPE[dtype])]


def _check_plan(plan, rows, dim, mlp):
    assert plan.smem <= tfm.SMEM_LIMIT
    chunk = 128 // plan.dtype.itemsize
    assert plan.chunk == chunk
    want = {"fc1": (rows, mlp, dim), "fc2": (rows, dim, mlp), "dg": (rows, mlp, dim),
            "dh": (rows, dim, mlp), "dw2": (dim, mlp, rows), "dw1": (mlp, dim, rows)}
    # B6: its LN pass and a launch a GEMM; B7: two row passes, its GEMM
    # launches and the column sums.
    assert plan.launches == (1 + len(plan.forward), 3 + len(plan.backward))
    products = [p for launch in plan.forward + plan.backward for p in launch]
    assert sorted(p.name for p in products) == sorted(want)
    for launch in plan.forward + plan.backward:
        assert len({p.tile_shape for p in launch}) == 1  # a launch runs one tile
    for p in products:
        bm, bn = p.tile_shape
        assert p.tile_shape in _blocks.TILES[plan.dtype]
        assert plan.smem >= tfm.gemm_smem(plan.dtype, p.tile_shape)
        assert (p.m, p.n, p.k) == want[p.name], p.name
        assert p.n % bn == 0 and p.tiles_n * bn == p.n
        assert (p.tiles_m - 1) * bm < p.m <= p.tiles_m * bm
    (dg,), = plan.backward[:1]
    part_db1 = next(shape for name, shape, _, _ in plan.bwd_scratch if name == "part_db1")
    assert part_db1 == (dg.tiles_m, mlp)
    for layout, nbytes in ((plan.fwd_scratch, plan.fwd_scratch_bytes),
                           (plan.bwd_scratch, plan.bwd_scratch_bytes)):
        end = 0
        for name, shape, dtype, off in layout:
            assert off % 256 == 0 and off >= end, name
            end = off + int(np.prod(shape)) * dtype.itemsize
        assert end <= nbytes


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_plan_at_every_width_the_jax_gate_admits(dtype):
    """Every width JAX's gate admits, and the backbones' (vit-l16 beyond
    the gate, as a direct call takes it), has a plan at each row count:
    within shared memory, tiles on the output grid, scratch apart."""
    admitted = _admitted(dtype)
    assert (768, 3072) in admitted if dtype == torch.bfloat16 else (384, 1536) in admitted
    assert (1152, 256) in admitted
    for dim, mlp in sorted(set(admitted) | set(WIDTHS)):
        for rows in ROWS:
            _check_plan(tfm.mlp_plan(rows, dim, mlp, dtype), rows, dim, mlp)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("dim,mlp", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_tiles_cover_every_output_once(monkeypatch, dtype, dim, mlp, rows):
    """At every compiled tile (``GAVIKO_MLP_BLOCK``), each launch's CTAs,
    decoded as the kernel decodes its block index, take every output tile
    of each of its products once, and db1's partials are a row a tile of
    dg's rows."""
    for bm, bn in _blocks.TILES[dtype]:
        monkeypatch.setenv(_blocks.MLP_ENV, str(bm))
        plan = tfm.mlp_plan(rows, dim, mlp, dtype)
        part_db1 = next(shape for name, shape, _, _ in plan.bwd_scratch if name == "part_db1")
        assert part_db1 == (-(-rows // bm), mlp)
        for launch in plan.forward + plan.backward:
            seen = set()
            for block in range(sum(p.blocks for p in launch)):
                name, m0, n0 = tfm.launch_tile(launch, block)
                p = next(q for q in launch if q.name == name)
                assert p.tile_shape == (bm, bn)
                assert m0 % bm == 0 and n0 % bn == 0
                assert 0 <= m0 < p.m and 0 <= n0 < p.n
                assert (name, m0, n0) not in seen
                seen.add((name, m0, n0))
            assert len(seen) == sum(p.tiles_m * p.tiles_n for p in launch)
            with pytest.raises(IndexError):
                tfm.launch_tile(launch, len(seen))


def test_plan_raises_on_what_the_kernels_cannot_take():
    """Widths not multiples of 128 (vit-t16's 192 among them, which JAX's
    gate refuses too), no rows, float16 and matrices of 2**31 elements."""
    with pytest.raises(NotImplementedError, match="multiples of 128"):
        tfm.mlp_plan(8064, *BACKBONES[0])
    assert not jfm.fused_mlp_supported(*BACKBONES[0], jnp.bfloat16)
    with pytest.raises(NotImplementedError, match="multiples of 128"):
        tfm.mlp_plan(64, 768, 3000)
    with pytest.raises(ValueError, match="no rows"):
        tfm.mlp_plan(0, 768, 3072)
    with pytest.raises(NotImplementedError, match="float16"):
        tfm.mlp_plan(64, 768, 3072, torch.float16)
    with pytest.raises(NotImplementedError, match="2\\*\\*31"):
        tfm.mlp_plan(2 ** 20, 768, 3072)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_weight_gradients_and_dh_share_a_launch(monkeypatch, dtype):
    """B7's launches: dg alone (its epilogue writes da16 and gd16, which the
    others read), then dW2, dW1 and dh in one launch, the weight gradients'
    long tiles (depth: the rows) first and dh's (depth: mlp) after them, so
    dh's tiles fill the weight gradients' last wave. At vit-b16 B8 that is
    144 + 144 + 378 CTAs of the same 128 x 128 tile (GAVIKO_MLP_BLOCK=128)."""
    monkeypatch.setenv(_blocks.MLP_ENV, "128")
    plan = tfm.mlp_plan(8064, 768, 3072, dtype)
    assert [[p.name for p in launch] for launch in plan.backward] == [["dg"], ["dw2", "dw1", "dh"]]
    assert [[p.name for p in launch] for launch in plan.forward] == [["fc1"], ["fc2"]]
    dw2, dw1, dh = plan.backward[1]
    assert (dw2.blocks, dw1.blocks, dh.blocks) == (144, 144, 378)
    assert dw2.k == dw1.k == 8064 > dh.k == 3072
    assert tfm.launch_tile(plan.backward[1], 287) == ("dw1", 3072 - 128, 768 - 128)
    assert tfm.launch_tile(plan.backward[1], 288) == ("dh", 0, 0)


def _fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, argtypes, *args: calls.append((name, symbol, argtypes,
                                                                            args)))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return calls


def _mlp_tensors(rows, dim, mlp, dtype):
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)

    return (t(1, rows, dim), 1.0 + 0.1 * t(dim), t(dim), t(mlp, dim), t(mlp), t(dim, mlp),
            t(dim))


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("save_a", [False, True])
def test_fused_mlp_is_one_call_on_a_faked_card(monkeypatch, dtype, suffix, save_a):
    """B6: one call of its entry point (which launches the LN pass, fc1 and
    fc2) with the tensors' pointers, the output, ``a`` where asked, the
    plan's two scratch matrices inside one buffer, the widths, the GELU
    mode, the residual, eps, the dropout arguments and the plan's tiles of
    fc1 and fc2."""
    calls = _fake_card(monkeypatch)
    args = _mlp_tensors(70, 256, 512, dtype)
    before = tfm.fused_mlp.launches
    res = tfm.fused_mlp_forward(*args, 1e-5, "tanh", 0.1, True, 5, save_a=save_a)
    assert tfm.fused_mlp.launches == before + 1
    out, a = res if save_a else (res, None)
    (name, symbol, argtypes, got), = calls
    assert (name, symbol) == ("fused_mlp", f"gaviko_fused_mlp_{suffix}")
    assert len(argtypes) == len(got) == 26
    assert got[:7] == tuple(t.data_ptr() for t in args)
    assert got[7] == out.data_ptr() and got[8] == (None if a is None else a.data_ptr())
    plan = tfm.mlp_plan(70, 256, 512, dtype)
    (_, _, _, off_h), (_, _, _, off_g) = plan.fwd_scratch
    assert got[10] - got[9] == off_g - off_h and got[9] % 16 == 0
    tiles = tuple(v for launch in plan.forward for v in launch[0].tile_shape)
    assert got[11:] == (70, 256, 512, 1, 1, 1e-5, *dropout_args(0.1, 5), 0, *tiles, 0)


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("rows", [70, 8064])
def test_fused_mlp_bwd_is_one_call_on_a_faked_card(monkeypatch, dtype, suffix, rows):
    """B7: one call of its entry point (its five launches) with the inputs,
    the seven outputs, the plan's scratch and the tiles of its two GEMM
    launches."""
    calls = _fake_card(monkeypatch)
    dim, mlp = 768, 3072
    args = _mlp_tensors(rows, dim, mlp, dtype) if rows < 100 else tuple(
        torch.zeros(s, dtype=dtype) for s in ((1, rows, dim), (dim,), (dim,), (mlp, dim),
                                              (mlp,), (dim, mlp), (dim,)))
    dy = torch.zeros(1, rows, dim, dtype=dtype)
    a = torch.zeros(rows, mlp, dtype=dtype)
    before = tfm.fused_mlp_bwd.launches
    outs = tfm.fused_mlp_bwd(*args, dy, a, 1e-5, "exact", 0.1, False, 3)
    assert tfm.fused_mlp_bwd.launches == before + 1
    (name, symbol, argtypes, got), = calls
    assert (name, symbol) == ("fused_mlp_bwd", f"gaviko_fused_mlp_bwd_{suffix}")
    assert len(argtypes) == len(got) == 40
    x, gamma, beta, w1, b1, w2, b2 = args
    assert got[:7] == tuple(t.data_ptr() for t in (x, gamma, beta, w1, w2, dy, a))
    assert got[7:14] == tuple(t.data_ptr() for t in outs)
    assert [tuple(o.shape) for o in outs] == [tuple(t.shape) for t in
                                              (x, gamma, beta, w1, b1, w2, b2)]
    plan = tfm.mlp_plan(rows, dim, mlp, dtype)
    ptrs = got[14:25]
    layout = {n: off for n, _, _, off in plan.bwd_scratch}
    base = ptrs[0] - layout["h"]
    names = ("h", "dout", "gd", "da", "dh", "mean", "rstd", "part_db2", "part_db1", "part_dg",
             "part_db")
    for n, p in zip(names, ptrs):
        assert p == base + layout[n], n
    tiles = tuple(v for launch in plan.backward for v in launch[0].tile_shape)
    assert got[25:] == (rows, dim, mlp, 0, 0, 1e-5, *dropout_args(0.1, 3), 0, *tiles, 0)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 GEMM forms it: hi = tf32(x), lo = tf32(x - hi) of
    each operand; for each step of 8 along the depth (one m16n8k8 product)
    lo * hi, hi * lo, then hi * hi added to the f32 accumulator."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k in range(0, a.shape[-1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc.double() + x[..., k:k + 8].double() @ y[..., k:k + 8, :].double()).float()
    return acc


def test_3xtf32_products_of_the_mlp_hold_the_f32_budget(monkeypatch):
    """B6's and B7's f32 outputs with every product as the GEMM's 3xTF32
    (emulated) stay within 1e-5 relative MAE of the f32 plain version (the
    card's budget is 1e-4), at 64 rows, dim 128, mlp 256, dropout 0.1."""
    args = _mlp_tensors(64, 128, 256, torch.float32)
    args = (args[0], args[1], args[2], args[3] * 128 ** -0.5, args[4] * 0.1,
            args[5] * 256 ** -0.5, args[6] * 0.1)
    dy = _mlp_tensors(64, 128, 256, torch.float32)[0].flip(1)

    def run():
        out, a = tfm.mlp_reference(*args, 1e-5, "exact", 0.1, True, 9, save_a=True)
        return (out, a, *tfm.mlp_bwd_reference(*args, dy, a, 1e-5, "exact", 0.1, True, 9))

    plain = run()
    monkeypatch.setattr(torch, "matmul", _matmul_3xtf32)
    emulated = run()
    for name, p, e in zip(("out", "a", "dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"),
                          plain, emulated):
        rel = float((e.double() - p.double()).abs().mean() / p.double().abs().mean())
        assert rel <= 1e-5, (name, rel)
