"""PyTorch port: the GEMM's tile policy (``gaviko_tpu_torch/ops/_blocks.py``,
the port of ``gaviko_tpu/ops/_blocks.py``), on the CPU.

- the policy's tile of each GEMM launch at the shapes it was set at
  (vit-b16 B1, B8 and B64, GAViKO int8 B8, GAViKO's last layer in bf16 and
  int8, patchify at GAViKO B8 and vit-b16 B1), in each dtype;
- ``GAVIKO_MLP_BLOCK`` reaches B6 and B7 only and ``GAVIKO_LNL_BLOCK`` B9
  and B12 only, B11 and patchify neither (their ``block`` argument forces a
  tile), on the plans and on a faked card;
- an override set after a first call takes effect (the plans' caches are
  keyed by the resolved tile);
- a value that names no compiled tile raises ``ValueError`` and is never
  rounded; the module imports neither JAX nor the JAX package;
- both packages read the same two variable names.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from gaviko_tpu.ops import _blocks as jblocks
from gaviko_tpu.ops import fused_mlp as jfm
from gaviko_tpu.ops import ln_linear as jln
from gaviko_tpu_torch.ops import _blocks
from gaviko_tpu_torch.ops import fused_mlp as tfm
from gaviko_tpu_torch.ops import int8_linear as tq
from gaviko_tpu_torch.ops import ln_linear as tln
from gaviko_tpu_torch.ops import patchify as tpatch
from gaviko_tpu_torch.ops.gemm_plan import patchify_plan
from tests.test_torch_mlp_plan import _fake_card, _mlp_tensors

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
ENVS = (_blocks.MLP_ENV, _blocks.LNL_ENV)


@pytest.fixture(autouse=True)
def no_overrides(monkeypatch):
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)


def _tiles(launches):
    return [launch[0].tile_shape[0] for launch in launches]


# (what, plan -> its launches' tile rows, dtype -> the policy's rows). The
# vit-b16 rows are 8 x 1,008 and 64 x 1,008, GAViKO's int8 8 x 1,040 and
# its last layer's 8 x 33, patchify's GAViKO B8 8,000.
SHIPPED = [
    ("mlp_b8", lambda dt: _tiles(tfm.mlp_plan(8064, 768, 3072, dt).forward
                                 + tfm.mlp_plan(8064, 768, 3072, dt).backward),
     {BF16: [128, 128, 128, 128], F32: [128, 128, 128, 128]}),
    ("mlp_b64", lambda dt: _tiles(tfm.mlp_plan(64512, 768, 3072, dt).forward
                                  + tfm.mlp_plan(64512, 768, 3072, dt).backward),
     {BF16: [128, 128, 128, 128], F32: [128, 128, 128, 128]}),
    ("qkv_b8", lambda dt: _tiles(tln.ln_linear_plan("forward", 8064, 768, 2304, dt).products
                                 + tln.ln_linear_plan("backward", 8064, 768, 2304, dt).products),
     {BF16: [128, 128], F32: [128, 128]}),
    ("qkv_b64", lambda dt: _tiles(tln.ln_linear_plan("forward", 64512, 768, 2304, dt).products
                                  + tln.ln_linear_plan("backward", 64512, 768, 2304,
                                                       dt).products),
     {BF16: [128, 128], F32: [128, 128]}),
    ("int8_b8", lambda dt: _tiles(tq.int8_plan("linear", 8320, 1024, 3072, dt).products
                                  + tq.int8_plan("mlp", 8320, 1024, 4096, dt).products),
     {BF16: [128, 128, 128], F32: [128, 128, 128]}),
    ("int8_last", lambda dt: _tiles(tq.int8_plan("linear", 264, 1024, 3072, dt).products
                                    + tq.int8_plan("mlp", 264, 1024, 4096, dt).products),
     {BF16: [64, 64, 64], F32: [64, 64, 64]}),
    ("patchify_b8", lambda dt: _tiles(patchify_plan(8, 1, (120, 160, 160), (12, 16, 16), 1024,
                                                    dt).products),
     {BF16: [128], F32: [128]}),
    # below one wave of 128-row tiles: vit-b16 B1 (fc2 48 tiles, fc1 192)
    # and GAViKO vit-l16's last layer at B8 (264 rows: B7's dg 96 tiles,
    # its weight gradients 536), patchify at vit-b16 B1 (48)
    # (bf16 keeps 128 rows there: PERF.md §6, the measurement below one wave)
    ("mlp_b1", lambda dt: _tiles(tfm.mlp_plan(1008, 768, 3072, dt).forward),
     {BF16: [128, 128], F32: [128, 128]}),
    ("mlp_last", lambda dt: _tiles(tfm.mlp_plan(264, 1024, 4096, dt).forward
                                   + tfm.mlp_plan(264, 1024, 4096, dt).backward),
     {BF16: [128, 128, 128, 128], F32: [128, 128, 128, 128]}),
    ("qkv_last", lambda dt: _tiles(tln.ln_linear_plan("forward", 264, 1024, 3072, dt).products),
     {BF16: [128], F32: [128]}),
    ("patchify_b1", lambda dt: _tiles(patchify_plan(1, 1, (120, 160, 160), (12, 16, 16), 768,
                                                    dt).products),
     {BF16: [128], F32: [128]}),
]


@pytest.mark.parametrize("what,tiles,want", SHIPPED, ids=[c[0] for c in SHIPPED])
def test_policy_tile_at_each_shipped_shape(what, tiles, want):
    """The policy's tile rows of each launch at the shapes it was set at
    (PERF.md, "The GEMM's tile"); B11's int8 operands whatever the
    activations' dtype."""
    for dtype, rows in want.items():
        assert tiles(dtype) == rows, (what, dtype)


def test_policy_weighs_the_last_wave_and_reuse(monkeypatch):
    """64 rows where a launch's 128-row tiles, over all its products, are
    fewer than the card's SMs (132 with no card) and its type is in
    WAVE_FILL (int8), else 128; bf16 and fp32 take 128 everywhere; every
    choice a compiled tile of 128 columns."""
    assert _blocks.sms() == _blocks.SMS == 132  # no card here
    for dtype in _blocks.WAVE_FILL:
        assert _blocks.gemm_tile(((128 * 11, 128 * 11),), dtype) == (64, 128)  # 121 tiles
        assert _blocks.gemm_tile(((128 * 11, 128 * 12),), dtype) == (128, 128)  # 132
        assert _blocks.gemm_tile(((128 * 11, 128 * 11), (128, 128 * 11)), dtype) == (128, 128)
        assert _blocks.gemm_tile(((264, 4096),), dtype) == (64, 128)  # 96 tiles
        assert _blocks.gemm_tile(((64512, 768),), dtype) == (128, 128)
        dw = (768, 768)  # weight gradients beside the row-streamed product
        assert _blocks.gemm_tile((dw, (64512, 768)), dtype) == (128, 128)
        assert _blocks.gemm_tile(((768, 3072), (3072, 768), (8064, 768)), dtype) == (128, 128)
        with monkeypatch.context() as m:  # a card of 114 SMs: its own wave
            m.setattr(_blocks, "sms", lambda: 114)
            assert _blocks.gemm_tile(((128 * 11, 128 * 11),), dtype) == (128, 128)
            assert _blocks.gemm_tile(((128 * 11, 128 * 10),), dtype) == (64, 128)  # 110 tiles
    assert _blocks.WAVE_FILL == {I8}  # int8 alone gained in every case below one wave
    for shapes in (((264, 4096),), ((64512, 768),), ((8064, 3072),), ((128 * 11, 128 * 11),)):
        assert _blocks.gemm_tile(shapes, F32) == _blocks.gemm_tile(shapes, BF16) == (128, 128)
    for dtype, tiles in _blocks.TILES.items():
        assert (128, 128) in tiles and all(bn == _blocks.BN == 128 for _, bn in tiles)
        assert len(tiles) <= 3  # 128 x 128 and at most two more


def test_each_override_reaches_only_its_kernels(monkeypatch):
    """GAVIKO_MLP_BLOCK moves B6's and B7's launches only, GAVIKO_LNL_BLOCK
    B9's and B12's only; B11 and patchify follow the policy under either
    and take a tile only through their ``block`` argument."""
    def all_tiles(dtype):
        return {"mlp": _tiles(tfm.mlp_plan(2002, 768, 3072, dtype).forward
                              + tfm.mlp_plan(2002, 768, 3072, dtype).backward),
                "lnl": _tiles(tln.ln_linear_plan("forward", 2002, 768, 2304, dtype).products
                              + tln.ln_linear_plan("backward", 2002, 768, 2304, dtype).products),
                "int8": _tiles(tq.int8_plan("mlp", 2002, 768, 3072, dtype).products),
                "patchify": _tiles(patchify_plan(2, 1, (120, 160, 160), (12, 16, 16), 768,
                                                 dtype).products)}

    for dtype in (BF16, F32):
        policy = all_tiles(dtype)
        for env, kernel in ((_blocks.MLP_ENV, "mlp"), (_blocks.LNL_ENV, "lnl")):
            for bm, _ in _blocks.TILES[dtype]:
                monkeypatch.setenv(env, str(bm))
                got = all_tiles(dtype)
                assert set(got[kernel]) == {bm}, (env, bm)
                assert {k: v for k, v in got.items() if k != kernel} == {
                    k: v for k, v in policy.items() if k != kernel}, (env, bm)
                monkeypatch.delenv(env)
    for bm, _ in _blocks.TILES[I8]:
        assert set(_tiles(tq.int8_plan("mlp", 2002, 768, 3072, BF16, bm).products)) == {bm}
    for bm, _ in _blocks.TILES[BF16]:
        plan = patchify_plan(2, 1, (120, 160, 160), (12, 16, 16), 768, BF16, block=bm)
        assert _tiles(plan.products) == [bm]


def _lnl_inputs(rows, dim, out, dtype):
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)

    return t(1, rows, dim), 1.0 + 0.1 * t(dim), t(dim), t(out, dim), t(1, rows, out)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_overrides_on_a_faked_card(monkeypatch, dtype):
    """On a faked CUDA tensor each wrapper hands its C entry point the tiles
    of its plan: GAVIKO_MLP_BLOCK reaches B6's and B7's calls and not B9's,
    B12's, B11's or patchify's, GAVIKO_LNL_BLOCK the reverse; set after a
    first call, an override reaches the next call."""
    calls = _fake_card(monkeypatch)
    mlp_args = _mlp_tensors(70, 256, 512, dtype)
    x, gamma, beta, w, dy = _lnl_inputs(70, 256, 384, dtype)
    w_i8, scale = tq.quantize_weight(torch.randn(384, 256))
    img = torch.zeros(1, 1, 24, 32, 48, dtype=dtype)
    pw = torch.ones(48, 1, 12, 16, 16, dtype=dtype)
    monkeypatch.setattr(tq, "padded_codes", lambda w, k: w)
    monkeypatch.setattr(tpatch._build, "check_cuda", lambda name, *t: None)

    def tiles_of_calls():
        calls.clear()
        tfm.fused_mlp_forward(*mlp_args)
        tfm.fused_mlp_bwd(*mlp_args, mlp_args[0], torch.zeros(70, 512, dtype=dtype))
        tln.fused_ln_linear(x, gamma, beta, w)
        tln.ln_linear_bwd(x, gamma, beta, w, dy)
        tq.int8_linear(x, w_i8, scale)
        tpatch.patchify_kernel(img, pw, torch.zeros(48, dtype=dtype))
        # the tile arguments precede the stream: (bm, bn) a GEMM launch
        n_tiles = {"fused_mlp": 2, "fused_mlp_bwd": 2, "ln_linear": 1, "ln_linear_bwd": 1,
                   "int8_linear": 1, "patchify": 1}
        return {name: args[-1 - 2 * n_tiles[name]:-1][::2]
                for name, _, _, args in calls}

    policy = tiles_of_calls()
    for name, rows in policy.items():
        compiled = _blocks.TILES[I8 if name == "int8_linear" else dtype]
        assert all(bm in {t[0] for t in compiled} for bm in rows), name
    small = min(bm for bm, _ in _blocks.TILES[dtype])
    monkeypatch.setenv(_blocks.MLP_ENV, str(small))  # after a first call
    got = tiles_of_calls()
    assert got["fused_mlp"] == got["fused_mlp_bwd"] == (small, small)
    assert {k: got[k] for k in ("ln_linear", "ln_linear_bwd", "int8_linear", "patchify")} == {
        k: policy[k] for k in ("ln_linear", "ln_linear_bwd", "int8_linear", "patchify")}
    monkeypatch.delenv(_blocks.MLP_ENV)
    monkeypatch.setenv(_blocks.LNL_ENV, str(small))
    got = tiles_of_calls()
    assert got["ln_linear"] == got["ln_linear_bwd"] == (small,)
    assert {k: got[k] for k in ("fused_mlp", "fused_mlp_bwd", "int8_linear", "patchify")} == {
        k: policy[k] for k in ("fused_mlp", "fused_mlp_bwd", "int8_linear", "patchify")}
    monkeypatch.delenv(_blocks.LNL_ENV)
    assert tiles_of_calls() == policy


def test_override_after_a_first_call_takes_effect(monkeypatch):
    """The plans are cached by the resolved tile, so an override set after a
    plan was first made (and unset again) changes the next plan."""
    first = tfm.mlp_plan(8064, 768, 3072, BF16)
    for bm, bn in _blocks.TILES[BF16]:
        monkeypatch.setenv(_blocks.MLP_ENV, str(bm))
        assert {p.tile_shape for launch in tfm.mlp_plan(8064, 768, 3072, BF16).backward
                for p in launch} == {(bm, bn)}
        monkeypatch.setenv(_blocks.LNL_ENV, str(bm))
        assert tln.ln_linear_plan("backward", 8064, 768, 2304, BF16).products[0][0].tile_shape \
            == (bm, bn)
    monkeypatch.delenv(_blocks.MLP_ENV)
    assert tfm.mlp_plan(8064, 768, 3072, BF16) == first


@pytest.mark.parametrize("value", ["96", "32", "512", "0", "-128", "128.0", "big", "0x80"])
def test_uncompiled_value_raises(monkeypatch, value):
    """A value that names no compiled tile raises ValueError naming the rows
    it takes, in every dtype, through either variable and through the
    ``block`` argument; it is never rounded to a neighbour."""
    for dtype in (BF16, F32):
        monkeypatch.setenv(_blocks.MLP_ENV, value)
        with pytest.raises(ValueError, match=_blocks.MLP_ENV):
            tfm.mlp_plan(8064, 768, 3072, dtype)
        monkeypatch.delenv(_blocks.MLP_ENV)
        monkeypatch.setenv(_blocks.LNL_ENV, value)
        with pytest.raises(ValueError, match="takes|one of"):
            tln.ln_linear_plan("forward", 8064, 768, 2304, dtype)
        monkeypatch.delenv(_blocks.LNL_ENV)
        with pytest.raises(ValueError, match="takes|one of"):
            patchify_plan(8, 1, (120, 160, 160), (12, 16, 16), 1024, dtype, block=value)
    with pytest.raises(ValueError, match="takes|one of"):
        tq.int8_plan("linear", 8320, 1024, 3072, BF16, value)


def test_fp32_has_no_256_row_tile(monkeypatch):
    """fp32 has no 256-row tile, nor any other type (none is compiled): the
    value raises in each, and fp32's one tile is 128 rows, which bf16 and
    int8 share with 64."""
    monkeypatch.setenv(_blocks.MLP_ENV, "256")
    for dtype in (F32, BF16):
        with pytest.raises(ValueError, match=f"no 256-row tile is compiled for {dtype}"):
            tfm.mlp_plan(8064, 768, 3072, dtype)
    with pytest.raises(ValueError, match="no 256-row tile is compiled for torch.int8"):
        _blocks.forced_tile(256, I8)
    with pytest.raises(ValueError, match="no 256-row tile"):
        _blocks.row_block(8064, _blocks.MLP_ENV)
    assert _blocks.TILES[F32] == ((128, 128),)
    assert _blocks.TILES[BF16] == _blocks.TILES[I8] == ((64, 128), (128, 128))


def test_both_packages_read_the_same_variables(monkeypatch):
    """JAX's fused MLP and LN + linear read GAVIKO_MLP_BLOCK and
    GAVIKO_LNL_BLOCK through ``row_block``, as the port's plans do; the
    port's module keeps JAX's ``row_block`` name and imports neither JAX nor
    the JAX package."""
    assert (_blocks.MLP_ENV, _blocks.LNL_ENV) == ("GAVIKO_MLP_BLOCK", "GAVIKO_LNL_BLOCK")
    assert 'row_block(rows, "GAVIKO_MLP_BLOCK")' in inspect.getsource(jfm)
    assert 'row_block(rows, "GAVIKO_LNL_BLOCK")' in inspect.getsource(jln)
    assert "_blocks.MLP_ENV" in inspect.getsource(tfm.mlp_tiles)
    assert "_blocks.LNL_ENV" in inspect.getsource(tln.ln_linear_plan)
    for env in ENVS:
        monkeypatch.setenv(env, "64")
        assert jblocks.row_block(8064, env) == 64
        assert _blocks.row_block(8064, env) == 64
        monkeypatch.delenv(env)
    tree = ast.parse(inspect.getsource(_blocks))
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not imported & {"jax", "jaxlib", "gaviko_tpu"}, imported
