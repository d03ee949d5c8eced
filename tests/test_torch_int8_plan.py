"""PyTorch port: the plan of kernel B11 (int8 serving: ``int8_linear`` and
``int8_mlp`` on the s8 instance of ``csrc/gemm_sm90.cuh``), its padded
sidecars and its launches on a faked card, on the CPU.

- ``int8_plan`` at every width JAX's int8 functions take at the shipped
  backbones (``VIT_CONFIG_MAP``) with ``dim_head`` 64, 128, 192, 256, 320
  and 512 (the qkv projection dim -> 3 inner with its LN, the
  out-projection inner -> dim with its bias, the MLP dim -> mlp_dim), and
  at vit-t16's 3 heads of 20 (widths that are no multiple of 16), at 37,
  264 and 8,320 rows: the codes' rows padded to a multiple of 16, each
  product's tiles (at every compiled int8 tile, ``ops/_blocks.py``)
  covering every output once, the scratch in one buffer without overlaps,
  shared memory within a CTA's, the launches a call;
- the out-projections wider than 2,048 that JAX serves (vit-b16 at
  ``dim_head`` 192 and 256, vit-l16 at 192) have a plan and reach the
  kernel on a faked card (the kernel held a row in registers and refused
  them);
- ``padded_codes``: the sidecar itself where its rows are whole, else one
  zero-padded copy, kept while the sidecar lives unchanged;
- what the plan still refuses raises;
- on a faked CUDA tensor (``use_kernel`` says yes, ``launch`` records),
  ``int8_linear`` and ``int8_mlp`` make one call of their C entry points
  with the plan's scratch and padded weights.
"""

import gc

import numpy as np
import pytest
import torch

from gaviko_tpu.config import VIT_CONFIG_MAP
from gaviko_tpu_torch.ops import _blocks, _build
from gaviko_tpu_torch.ops import int8_linear as tq
from gaviko_tpu_torch.ops.fused_mlp import launch_tile
from gaviko_tpu_torch.ops.gemm_plan import gemm_smem

DTYPES = [torch.bfloat16, torch.float32]
ROWS = (37, 264, 8320)
DIM_HEADS = (64, 128, 192, 256, 320, 512)


def _sites(heads, dim, mlp_dim, dim_head):
    """(kind, k, n) of each int8 site of a layer: JAX's core/vit.py routes
    the qkv projection and the out-projection through int8_linear and the
    MLP through int8_mlp."""
    inner = heads * dim_head
    return (("linear", dim, 3 * inner), ("linear", inner, dim), ("mlp", dim, mlp_dim))


def _widths():
    out = set()
    for c in VIT_CONFIG_MAP.values():
        for dh in DIM_HEADS:
            out.update(_sites(c["heads"], c["dim"], c["mlp_dim"], dh))
    t16 = VIT_CONFIG_MAP["vit-t16"]
    out.update(_sites(3, t16["dim"], t16["mlp_dim"], 20))  # 3 x 20 = 60
    return sorted(out)


WIDTHS = _widths()


def _check_plan(plan, kind, rows, k, n):
    assert (plan.kind, plan.rows, plan.k, plan.n) == (kind, rows, k, n)
    assert plan.k_pad % tq.K_ALIGN == 0 and 0 <= plan.k_pad - k < tq.K_ALIGN
    vec = 16 // plan.dtype.itemsize
    assert plan.row_vector == (vec if k % vec == 0 else 1)
    assert plan.row_blocks * tq.ROW_BLOCK >= rows > (plan.row_blocks - 1) * tq.ROW_BLOCK
    assert plan.smem <= 232_448
    products = [p for launch in plan.products for p in launch]
    for p in products:
        assert p.tile_shape in _blocks.TILES[torch.int8]
        assert plan.smem >= gemm_smem(torch.int8, p.tile_shape)
    if kind == "linear":
        assert plan.n_pad == n
        assert [(p.name, p.m, p.n, p.k) for p in products] == [("linear", rows, n, plan.k_pad)]
        assert plan.padded == (("w",) if k % 16 else ())
        want = {"codes": ((rows, plan.k_pad), torch.int8), "sx": ((rows,), torch.float32)}
        assert plan.launches == 2  # the row pass, the GEMM
    else:
        assert plan.n_pad % tq.K_ALIGN == 0 and 0 <= plan.n_pad - n < tq.K_ALIGN
        assert [(p.name, p.m, p.n, p.k) for p in products] == [
            ("fc1", rows, n, plan.k_pad), ("fc2", rows, k, plan.n_pad)]
        assert plan.padded == tuple(w for w, kk in (("w1", k), ("w2", n)) if kk % 16)
        want = {"codes_x": ((rows, plan.k_pad), torch.int8),
                "codes_h": ((rows, plan.n_pad), torch.int8),
                "hidden": ((rows, n), torch.float32),
                "sx": ((rows,), torch.float32), "hmax": ((rows,), torch.float32)}
        assert plan.launches == 4  # the row pass, fc1, the hidden's codes, fc2
    end = 0
    assert {name: (shape, dtype) for name, shape, dtype, _ in plan.scratch} == want
    for name, shape, dtype, off in plan.scratch:
        assert off % 256 == 0 and off >= end, name
        end = off + int(np.prod(shape)) * dtype.itemsize
    assert end <= plan.scratch_bytes


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", ROWS)
def test_plan_at_every_width_jax_serves(dtype, rows):
    """Every site of every backbone at every head dim listed, and 3 heads of
    20, has a plan at each row count."""
    assert ("linear", 2304, 768) in WIDTHS and ("linear", 60, 192) in WIDTHS
    assert ("linear", 192, 180) in WIDTHS and ("mlp", 1024, 4096) in WIDTHS
    for kind, k, n in WIDTHS:
        _check_plan(tq.int8_plan(kind, rows, k, n, dtype), kind, rows, k, n)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("kind,k,n", [("linear", 1024, 3072), ("linear", 2304, 768),
                                      ("linear", 60, 192), ("linear", 7, 10),
                                      ("mlp", 1024, 4096), ("mlp", 60, 100)])
def test_tiles_cover_every_output_once(rows, kind, k, n):
    """At every compiled int8 tile (the plan's ``block`` argument), each
    GEMM launch's CTAs, decoded as the kernel decodes its block index, take
    every output tile once, the last column tile ragged where the width is
    no multiple of 128."""
    for bm, bn in _blocks.TILES[torch.int8]:
        plan = tq.int8_plan(kind, rows, k, n, block=bm)
        for launch in plan.products:
            (p,) = launch
            assert p.tile_shape == (bm, bn)
            seen = set()
            for block in range(p.blocks):
                name, m0, n0 = launch_tile(launch, block)
                assert name == p.name and m0 % bm == 0 and n0 % bn == 0
                assert 0 <= m0 < p.m and 0 <= n0 < p.n
                assert (m0, n0) not in seen
                seen.add((m0, n0))
            assert len(seen) == -(-p.m // bm) * -(-p.n // bn)
            with pytest.raises(IndexError):
                launch_tile(launch, p.blocks)


def test_plan_refuses_only_what_no_kernel_takes():
    """float16, no rows or columns, a matrix of 2**31 elements and an
    unknown kind raise; widths of any size and alignment do not."""
    with pytest.raises(NotImplementedError, match="float16"):
        tq.int8_plan("linear", 64, 768, 768, torch.float16)
    for rows, k, n in ((0, 768, 768), (64, 0, 768), (64, 768, 0)):
        with pytest.raises(ValueError, match="no rows or columns"):
            tq.int8_plan("linear", rows, k, n)
    with pytest.raises(NotImplementedError, match="2\\*\\*31"):
        tq.int8_plan("mlp", 2 ** 20, 1024, 4096)
    with pytest.raises(ValueError, match="kind"):
        tq.int8_plan("conv", 64, 768, 768)
    for k, n in ((1, 1), (4097, 3), (8192, 8192)):
        assert tq.int8_plan("linear", 3, k, n).launches == 2


def test_padded_codes_are_zero_padded_once_a_sidecar():
    """A sidecar whose rows are a multiple of 16 codes is used as it is;
    another gets one copy padded with zeros, made once and reused, made
    again after the sidecar is written to, and dropped with the sidecar."""
    w = torch.randint(-127, 128, (10, 32), dtype=torch.int8)
    assert tq.padded_codes(w, 32) is w
    w = torch.randint(-127, 128, (10, 60), dtype=torch.int8)
    pad = tq.padded_codes(w, 64)
    assert pad.shape == (10, 64) and pad.dtype == torch.int8 and pad.is_contiguous()
    assert torch.equal(pad[:, :60], w) and not pad[:, 60:].any()
    assert tq.padded_codes(w, 64) is pad
    w[0, 0] = 5
    again = tq.padded_codes(w, 64)
    assert again is not pad and again[0, 0] == 5
    key = id(w)
    assert key in tq._PADDED
    del w, pad, again
    gc.collect()
    assert key not in tq._PADDED


def _fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, argtypes, *args: calls.append((name, symbol, argtypes,
                                                                            args)))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return calls


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("din,dout,ln", [(2304, 768, False), (3072, 1024, False),
                                         (1024, 3072, True), (60, 180, False)])
def test_int8_linear_is_one_call_on_a_faked_card(monkeypatch, dtype, suffix, din, dout, ln):
    """int8_linear: one call of its entry point (the row pass and the GEMM)
    with the inputs, the (padded) sidecar, the output, the plan's codes and
    scales inside one buffer, the rows, the widths, the padded width and the
    plan's tile. The
    out-projections wider than 2,048 (Queue C 10) get there too."""
    calls = _fake_card(monkeypatch)
    rng = np.random.RandomState(0)
    x = _t(rng, 2, 9, din, dtype=dtype)
    w_i8, scale = tq.quantize_weight(_t(rng, dout, din))
    bias = _t(rng, dout, dtype=dtype)
    gamma, beta = (_t(rng, din, dtype=dtype), _t(rng, din, dtype=dtype)) if ln else (None, None)
    before = tq.int8_linear.launches
    out = tq.int8_linear(x, w_i8, scale, bias=None if ln else bias, gamma=gamma, beta=beta)
    assert tq.int8_linear.launches == before + 1
    assert out.shape == (2, 9, dout) and out.dtype == dtype
    (name, symbol, argtypes, got), = calls
    assert (name, symbol) == ("int8_linear", f"gaviko_int8_linear_{suffix}")
    assert len(argtypes) == len(got) == 17
    plan = tq.int8_plan("linear", 18, din, dout, dtype)
    w = tq.padded_codes(w_i8, plan.k_pad)
    assert (w is w_i8) == (din % 16 == 0)
    assert got[0] == x.data_ptr() and got[3] == w.data_ptr() and got[6] == out.data_ptr()
    assert got[1:3] == ((gamma.data_ptr(), beta.data_ptr()) if ln else (None, None))
    assert got[5] == (None if ln else bias.data_ptr())
    layout = {n: off for n, _, _, off in plan.scratch}
    assert got[8] - got[7] == layout["sx"] - layout["codes"] and got[7] % 16 == 0
    assert got[9:] == (18, din, plan.k_pad, dout, 1e-5, *plan.products[0][0].tile_shape, 0)


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("dim,mlp", [(1024, 4096), (60, 100)])
def test_int8_mlp_is_one_call_on_a_faked_card(monkeypatch, dtype, suffix, dim, mlp):
    """int8_mlp: one call of its entry point (its four launches) with the
    inputs, the padded sidecars, the output, the plan's scratch (codes of x
    and of the hidden, the f32 hidden, the scales), the widths and the
    tiles of fc1 and fc2."""
    calls = _fake_card(monkeypatch)
    rng = np.random.RandomState(1)
    x = _t(rng, 1, 33, dim, dtype=dtype)
    gamma, beta = _t(rng, dim, dtype=dtype), _t(rng, dim, dtype=dtype)
    (w1, s1), (w2, s2) = tq.quantize_weight(_t(rng, mlp, dim)), tq.quantize_weight(_t(rng, dim, mlp))
    b1, b2 = _t(rng, mlp, dtype=dtype), _t(rng, dim, dtype=dtype)
    before = tq.int8_mlp.launches
    out = tq.int8_mlp(x, gamma, beta, w1, s1, b1, w2, s2, b2, 1e-5, "tanh", True)
    assert tq.int8_mlp.launches == before + 1
    assert out.shape == x.shape and out.dtype == dtype
    (name, symbol, argtypes, got), = calls
    assert (name, symbol) == ("int8_linear", f"gaviko_int8_mlp_{suffix}")
    assert len(argtypes) == len(got) == 28
    plan = tq.int8_plan("mlp", 33, dim, mlp, dtype)
    pw1, pw2 = tq.padded_codes(w1, plan.k_pad), tq.padded_codes(w2, plan.n_pad)
    assert got[:3] == (x.data_ptr(), gamma.data_ptr(), beta.data_ptr())
    assert (got[3], got[6]) == (pw1.data_ptr(), pw2.data_ptr())
    assert (got[5], got[8], got[9]) == (b1.data_ptr(), b2.data_ptr(), out.data_ptr())
    layout = {n: off for n, _, _, off in plan.scratch}
    base = got[10] - layout["codes_x"]
    for i, n in enumerate(("codes_x", "codes_h", "hidden", "sx", "hmax")):
        assert got[10 + i] == base + layout[n], n
    tiles = tuple(v for launch in plan.products for v in launch[0].tile_shape)
    assert got[15:] == (33, dim, plan.k_pad, mlp, plan.n_pad, 1e-5, 1, 1, *tiles, 0)


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_f32_stream_takes_bf16_weights_widened_on_a_faked_card(monkeypatch, kind):
    """EVP served in bf16 runs its transformer on an f32 stream with bf16
    LN and bias weights. The plain versions read those weights as f32; the
    kernel path widens them to f32 (exactly) and makes its one call, where
    it used to refuse the mixed dtypes. A bf16 stream with f32 weights
    (narrowing would round them) is still refused."""
    calls = _fake_card(monkeypatch)
    rng = np.random.RandomState(2)
    dim, n = 64, 192
    x = _t(rng, 1, 9, dim)
    gamma, beta = _t(rng, dim, dtype=torch.bfloat16), _t(rng, dim, dtype=torch.bfloat16)
    (w1, s1), (w2, s2) = tq.quantize_weight(_t(rng, n, dim)), tq.quantize_weight(_t(rng, dim, n))
    b1, b2 = _t(rng, n, dtype=torch.bfloat16), _t(rng, dim, dtype=torch.bfloat16)

    def call(stream, *weights):
        if kind == "linear":
            return tq.int8_linear(stream, w1, s1, bias=weights[2], gamma=weights[0],
                                  beta=weights[1])
        return tq.int8_mlp(stream, *weights[:2], w1, s1, weights[2], w2, s2, weights[3])

    out = call(x, gamma, beta, b1, b2)
    assert out.dtype == torch.float32 and len(calls) == 1
    sent = calls[0][3][1:3]
    assert all(p not in (gamma.data_ptr(), beta.data_ptr()) for p in sent)
    for t in (gamma, beta, b1):
        wide = tq._widened(t, x)
        assert wide.dtype == torch.float32 and torch.equal(wide, t.float())
    assert tq._widened(x, x) is x and tq._widened(None, x) is None
    with pytest.raises(ValueError, match="share device and dtype"):
        call(x.bfloat16(), gamma.float(), beta.float(), b1.float(), b2.float())
