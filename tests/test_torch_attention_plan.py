"""PyTorch port: the plan of the forward tile that kernels A and B10 share
(``csrc/attention_fwd.cuh``), the plans of kernel B (the MHSA backward) and
B8 (CLS attention), their launches on a faked card, and the 3xTF32
products of the f32 instances of A, B10 and B, on the CPU.

- ``attention_plan`` at every head dim in 8..1024 that JAX's fused gate
  admits (A) and at every head dim (B10): slices of at most 256 columns in
  bf16 and 128 in f32, each starting on a 128-byte chunk, that cover D
  exactly; compiled head dims keep their instance; to 4096 in both dtypes
  a plan within a CTA's shared memory (Q streamed above 1280 columns), and
  up to 1280 the plan the tile ran before Q could stream;
- ``mhsa_bwd_plan`` (B) at every head dim JAX's fused gate admits up to
  4096: each pass's slices cover D, at most 256 / 128 columns (dq) and
  128 / 64 (dk/dv) in bf16 / f32, the fewest such, within shared memory;
  ``cls_plan`` (B8): runs that cover the keys exactly and fill two waves of
  132 SMs at the shapes ``chip_smoke.py`` gives it;
- on a faked CUDA tensor (``use_kernel`` says yes, ``launch`` records), A
  and B10 make one launch a call with the arguments of their C entry
  points, the plan among them (the kernel runs the tile it is handed), A
  and B10 read a head dim in place unless its rows are not whole 16 bytes,
  and a layout the TMA descriptors cannot read raises;
- B and B8 make one launch a call (B's entry point runs its two passes);
- the 3xTF32 split emulated in torch (hi = tf32(x), lo = tf32(x - hi), each
  rounded to 10 mantissa bits, the three products of each step of 8 added
  to an f32 accumulator in the kernel's order): attention at GAViKO-like
  scores within 1e-5 relative MAE of the f32 plain version, where one TF32
  product alone misses the f32 budget of 1e-4; B's products (S, dP, and dV,
  dQ, dK from dS) within the f32 budget of its plain version.
"""

import math

import numpy as np
import pytest
import torch

from gaviko_tpu.ops import flash_attention as jfa
from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops import cls_attention as tcls
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops.hash_dropout import dropout_args

DTYPES = [torch.bfloat16, torch.float32]


def _admitted_by_the_fused_gate():
    return {d for d in range(8, 1025) for heads in (2, 4, 12)
            if jfa.fused_mhsa_supported(heads, d, 1008)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_plan_covers_every_head_dim_in_slices_the_tile_takes(dtype):
    """Every head dim A (JAX's fused gate) or B10 (any, at the next multiple
    of 8) takes: the slices start at 0 and cover D exactly, each starts on a
    chunk and is whole chunks but for the one that ends at D, none is wider
    than the tile's accumulators (256 columns bf16, 128 f32), and a head dim
    wider than that takes the fewest such slices. Compiled head dims keep
    their instance, other widths up to the widest one run padded."""
    widest = 256 if dtype == torch.bfloat16 else 128
    admitted = _admitted_by_the_fused_gate()
    assert {64, 128, 320, 512, 1024} <= admitted
    for d in sorted(admitted | {x + (-x) % 8 for x in range(8, 1025)}):
        plan = tfa.attention_plan(d, dtype)
        assert plan.chunk * (2 if dtype == torch.bfloat16 else 4) == 128
        ends = [c0 + n for c0, n in plan.slices]
        assert plan.slices[0][0] == 0 and ends[-1] == d
        assert [c0 for c0, _ in plan.slices[1:]] == ends[:-1]
        for c0, n in plan.slices:
            assert 0 < n <= widest and c0 % plan.chunk == 0
            assert n % plan.chunk == 0 or c0 + n == d
        groups, general, slice_chunks, rows, q_stream = plan.tile
        assert slice_chunks * plan.chunk <= 64 * groups <= widest and rows == plan.rows
        if d <= widest:
            assert plan.slices == ((0, d),) and plan.width == 64 * -(-d // 64)
            assert plan.instance == ("specialized" if d in tfa.MHSA_DIM_HEADS else "padded")
            assert not general and slice_chunks * plan.chunk == plan.width == 64 * groups
        else:
            assert plan.instance == "general" and plan.width == d
            assert len(plan.slices) == -(-d // widest)
            assert general and groups == widest // 64
            assert slice_chunks * plan.chunk == plan.slices[0][1]
        assert plan.smem <= tfa.SMEM_LIMIT and plan.rows in (32, 64)
        assert plan.keys in (64, 128) and not q_stream
    assert tfa.attention_plan(256, torch.bfloat16).instance == "specialized"
    assert tfa.attention_plan(256, torch.float32).instance == "general"


def _plan_before_the_q_stream(d, dtype):
    """The tile's plan argument as it was made before Q's chunks could
    stream (the four ints of ``tile`` then), or None where that plan raised
    (its Q chunks and ring above a CTA's shared memory)."""
    bf16 = dtype == torch.bfloat16
    chunk, max_groups = (64, 4) if bf16 else (32, 2)
    groups = -(-d // 64)
    stages = 65536 // ((128 if bf16 and groups <= 2 else 64) * 128)
    if groups <= max_groups:
        general, n_chunks = 0, 64 * groups // chunk
        per = n_chunks
    else:
        general, groups, n_chunks = 1, max_groups, -(-d // chunk)
        per = -(-n_chunks // -(-d // (64 * max_groups)))
    for rows in (64, 32) if general and not bf16 else (64,):
        if 1024 + n_chunks * rows * 128 + 65536 + 8 * (2 * stages + 1) <= 232448:
            return groups, general, per, rows
    return None


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_plan_at_every_head_dim_to_4096(dtype):
    """Every head dim of whole 16-byte rows up to 4096 has a plan within a
    CTA's shared memory whose slices cover D; up to 1280 (where Q's chunks
    fit resident) it is the plan the tile ran before Q could stream, above
    that Q streams through the ring, 64 rows a CTA."""
    for d in range(8, 4097, 8):
        plan = tfa.attention_plan(d, dtype)
        assert plan.smem <= tfa.SMEM_LIMIT
        assert plan.slices[0][0] == 0 and sum(n for _, n in plan.slices) == d
        before = _plan_before_the_q_stream(d, dtype)
        assert (before is None) == plan.q_stream == (d > 1280)
        if before is not None:
            assert plan.tile == (*before, 0)
        else:
            assert plan.rows == 64 and plan.instance == "general" and plan.tile[4] == 1


def test_plan_raises_on_what_the_tile_cannot_take():
    """Below 1 and a dtype other than bf16 and f32. A head dim whose Q
    chunks do not fit beside the ring (1344) has a plan that streams them,
    within a CTA's shared memory (it raised before ROADMAP Queue C item 6
    was repaired; the test's name dates from then)."""
    with pytest.raises(ValueError, match="dim_head"):
        tfa.attention_plan(0)
    with pytest.raises(NotImplementedError, match="float16"):
        tfa.attention_plan(64, torch.float16)
    assert tfa.attention_plan(1280, torch.bfloat16).instance == "general"
    assert [tfa.attention_plan(d, torch.float32).rows for d in (512, 576, 1280)] == [64, 64, 32]
    for dtype in DTYPES:
        plan = tfa.attention_plan(1344, dtype)
        assert plan.q_stream and plan.smem <= tfa.SMEM_LIMIT


def _fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, argtypes, *args: calls.append((name, symbol, args)))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return calls


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("dim_head", [64, 96, 320])
def test_fused_mhsa_is_one_launch_on_the_packed_qkv(monkeypatch, dtype, suffix, dim_head):
    """A reads the packed qkv in place: one launch of its entry point with
    qkv's own pointer, the output and lse buffers, the geometry, the plan
    of the head dim, the scale and the dropout arguments."""
    calls = _fake_card(monkeypatch)
    before = tfa.fused_mhsa.launches
    qkv = torch.zeros(2, 16, 3 * 2 * dim_head, dtype=dtype)
    out, lse = tfa.fused_mhsa(qkv, 2, dim_head, 0.125, 13, 0.1, with_lse=True, seed=5)
    assert tfa.fused_mhsa.launches == before + 1
    assert out.shape == (2, 16, 2 * dim_head) and out.dtype == dtype
    assert lse.shape == (2, 2, 16) and lse.dtype == torch.float32
    (name, symbol, args), = calls
    assert (name, symbol) == ("fused_mhsa", f"gaviko_fused_mhsa_{suffix}")
    assert args[:8] == (qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), 2, 16, 2, dim_head, 13)
    assert tuple(args[8]) == tfa.attention_plan(dim_head, dtype).tile
    assert args[9:] == (0.125, *dropout_args(0.1, 5), 2, 0, 0)


def test_fused_mhsa_pads_a_head_dim_of_no_16_byte_columns(monkeypatch):
    """A at a head dim that is not a multiple of 8 (36) launches once on a
    copy of qkv with each head zero-padded to 40, at the true scale, and
    slices the output back to 36 columns a head; lse is the padded run's."""
    calls = _fake_card(monkeypatch)
    qkv = torch.zeros(1, 8, 3 * 2 * 36)
    out, lse = tfa.fused_mhsa(qkv, 2, 36, 0.1, 8, with_lse=True)
    assert out.shape == (1, 8, 72) and lse.shape == (1, 2, 8)
    (_, _, args), = calls
    assert args[0] != qkv.data_ptr() and args[3:8] == (1, 8, 2, 40, 8)
    assert tuple(args[8]) == tfa.attention_plan(40, torch.float32).tile and args[9] == 0.1


def test_flash_attention_reads_any_head_dim_of_16_byte_rows_in_place(monkeypatch):
    """B10 launches once on the views it is given, at their own head dim
    (96 runs on the 128-wide tile with no copy), and pads only a head dim
    whose rows are not whole 16 bytes (263 to 264), slicing the output
    back."""
    calls = _fake_card(monkeypatch)
    before = tfa.flash_attention.launches
    qkv = torch.zeros(2, 16, 3 * 3 * 96)
    q, k, v = (t[:, :, :13] for t in tfa._split_heads(qkv, 3, 96))
    o = tfa.flash_attention(q, k, v, 0.1)
    assert o.shape == (2, 3, 13, 96) and o.transpose(1, 2).is_contiguous()
    (name, symbol, args), = calls
    assert (name, symbol) == ("flash_attention", "gaviko_flash_attention_f32")
    assert args[:8] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 2, 3, 13, 96)
    assert tuple(args[8]) == tfa.attention_plan(96, torch.float32).tile
    assert list(args[9]) == [16 * 864, 96, 864] * 3 + [13 * 288, 96, 288]
    del calls[:]
    odd = torch.zeros(1, 2, 8, 264)[..., 1:]
    o = tfa.flash_attention(odd, odd, odd, 0.1)
    assert o.shape == odd.shape
    (_, _, args), = calls
    assert args[7] == 264 and args[0] != odd.data_ptr()
    assert tfa.flash_attention.launches == before + 2


def test_layouts_the_descriptors_cannot_read_raise(monkeypatch):
    """B10: strides that are not multiples of 8, data off a 16-byte
    boundary raise, and nothing launches. A head dim whose Q chunks do not
    fit beside the ring (1344) is one launch each of A and B10 with the
    streamed-Q plan (it raised before ROADMAP Queue C item 6 was
    repaired)."""
    calls = _fake_card(monkeypatch)
    tfa.fused_mhsa(torch.zeros(1, 8, 3 * 2 * 1344, dtype=torch.bfloat16), 2, 1344, 0.1, 8)
    wide = torch.zeros(1, 1, 8, 1344)
    tfa.flash_attention(wide, wide, wide, 0.1)
    assert [(name, tuple(args[8])) for name, _, args in calls] == [
        ("fused_mhsa", tfa.attention_plan(1344, torch.bfloat16).tile),
        ("flash_attention", tfa.attention_plan(1344, torch.float32).tile)]
    assert all(tuple(args[8])[4] == 1 for _, _, args in calls)
    del calls[:]
    row36 = torch.zeros(1, 1, 8, 36)[..., :32]
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attention(row36, row36, row36, 0.1)
    shifted = torch.zeros(1, 1, 8, 48)[..., 2:34]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_attention(shifted, shifted, shifted, 0.1)
    assert calls == []


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 tile forms it: hi = tf32(x), lo = tf32(x - hi) of
    each operand; for each step of 8 along the inner dimension (one
    m16n8k8 product), lo*hi, then hi*lo, then hi*hi added to the f32
    accumulator, each 8-term product exact (11 x 11 bits) and rounded to
    f32 as it is added."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k in range(0, a.shape[-1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            step = x[..., k:k + 8].double() @ y[..., k:k + 8, :].double()
            acc = (acc.double() + step).float()
    return acc


def _matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (_tf32(a).double() @ _tf32(b).double()).float()


def test_3xtf32_products_hold_the_f32_budget():
    """Attention at GAViKO's head dim (64, 260 keys, unit-variance q, k, v,
    scale 1/8) through the emulated 3xTF32 products of both S = Q K^T and
    P V stays within 1e-5 relative MAE of the f32 plain version; one TF32
    product alone (what TF32 matmuls give) is above the f32 budget of 1e-4,
    which is why the tile spends three."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 260, 64).astype(np.float32)) for _ in range(3))
    scale = 64 ** -0.5

    def attention(matmul):
        p = torch.softmax(matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
        return matmul(p, v)

    plain = attention(torch.matmul)

    def rel(x):
        return float((x.double() - plain.double()).abs().mean() / plain.double().abs().mean())

    assert rel(attention(_matmul_3xtf32)) <= 1e-5
    assert rel(attention(_matmul_tf32)) > 1e-4
    halves = torch.from_numpy(rng.randn(4096).astype(np.float32))
    hi = _tf32(halves)
    lo = _tf32(halves - hi)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert float(((hi.double() + lo.double() - halves.double()).abs()
                  / halves.double().abs()).max()) <= 2.0 ** -21
    assert math.isclose(float(_tf32(torch.tensor([1.0 + 2.0 ** -11]))), 1.0 + 2.0 ** -10)


def _admitted_to_4096():
    """Head dims JAX's fused gate admits up to 4096 (2 heads, N 2048)."""
    return [d for d in range(8, 4097) if jfa.fused_mhsa_supported(2, d, 2048)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_mhsa_bwd_plan_covers_every_head_dim_in_the_fewest_slices(dtype):
    """Kernel B's plan at every head dim JAX's fused gate admits up to 4096:
    each pass's slices start at 0, follow on whole chunks and cover D; the
    dq pass's are at most 256 columns (bf16) or 128 (f32), the dk/dv pass's
    at most 128 or 64 (it holds dK and dV), the fewest slices of that width;
    its accumulators hold the widest slice; the owned rows stay resident up
    to 10 chunks and stream above, within a CTA's shared memory."""
    bf16 = dtype == torch.bfloat16
    widest = {"dq": 256 if bf16 else 128, "dkdv": 128 if bf16 else 64}
    admitted = _admitted_to_4096()
    assert admitted[:2] == [64, 128] and admitted[-1] == 4096
    for d in admitted:
        plan = tfa.mhsa_bwd_plan(d, dtype)
        assert plan.chunk == (64 if bf16 else 32) and plan.smem <= tfa.SMEM_LIMIT
        n_chunks = -(-d // plan.chunk)
        assert plan.own_stream == (n_chunks > 10)
        for i, name in enumerate(("dq", "dkdv")):
            slices = getattr(plan, name)
            ends = [c0 + n for c0, n in slices]
            assert slices[0][0] == 0 and ends[-1] == d
            assert [c0 for c0, _ in slices[1:]] == ends[:-1]
            assert all(0 < n <= widest[name] and c0 % plan.chunk == 0 for c0, n in slices)
            assert len(slices) == -(-d // widest[name])
            assert plan.groups[i] * 64 >= slices[0][1]
        groups_dq, chunks_dq, groups_kv, chunks_kv, stream = plan.arg
        assert (groups_dq, groups_kv, stream) == (*plan.groups, int(plan.own_stream))
        assert chunks_dq * plan.chunk == plan.dq[0][1] and chunks_kv * plan.chunk == plan.dkdv[0][1]
    assert [len(tfa.mhsa_bwd_plan(512, dtype).dq), len(tfa.mhsa_bwd_plan(512, dtype).dkdv)] == (
        [2, 4] if bf16 else [4, 8])
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.mhsa_bwd_plan(36, dtype)


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("dim_head", [64, 320, 1344])
def test_fused_mhsa_bwd_is_one_launch(monkeypatch, dtype, suffix, dim_head):
    """B is one launch of its entry point (which runs the dq pass, then the
    dk/dv pass) on the packed qkv, out, dout and lse in place, with a delta
    scratch, the packed dqkv, the geometry, the plan of the head dim, the
    scale and the dropout arguments."""
    calls = _fake_card(monkeypatch)
    before = tfa.fused_mhsa_bwd.launches
    qkv = torch.zeros(2, 16, 3 * 2 * dim_head, dtype=dtype)
    out = torch.zeros(2, 16, 2 * dim_head, dtype=dtype)
    lse = torch.zeros(2, 2, 16)
    dqkv = tfa.fused_mhsa_bwd(qkv, out, lse, out, 2, dim_head, 0.125, 13, 0.1, 5)
    assert tfa.fused_mhsa_bwd.launches == before + 1
    assert dqkv.shape == qkv.shape and dqkv.dtype == dtype
    (name, symbol, args), = calls
    assert (name, symbol) == ("fused_mhsa_bwd", f"gaviko_fused_mhsa_bwd_{suffix}")
    assert args[:3] == (qkv.data_ptr(), out.data_ptr(), out.data_ptr())
    assert args[3] == lse.data_ptr() and args[5] == dqkv.data_ptr()
    assert args[6:11] == (2, 16, 2, dim_head, 13)
    assert tuple(args[11]) == tfa.mhsa_bwd_plan(dim_head, dtype).arg
    assert args[12:] == (0.125, *dropout_args(0.1, 5), 2, 0, 0)


def test_fused_mhsa_bwd_pads_a_head_dim_of_no_16_byte_columns(monkeypatch):
    """B at head dim 36 launches once on copies of qkv, out and dout with
    each head zero-padded to 40, and slices dqkv back to 36 columns a
    head."""
    calls = _fake_card(monkeypatch)
    qkv, out = torch.zeros(1, 8, 3 * 2 * 36), torch.zeros(1, 8, 2 * 36)
    dqkv = tfa.fused_mhsa_bwd(qkv, out, torch.zeros(1, 2, 8), out, 2, 36, 0.1, 8)
    assert dqkv.shape == qkv.shape
    (_, _, args), = calls
    assert args[0] != qkv.data_ptr() and args[6:11] == (1, 8, 2, 40, 8)
    assert tuple(args[11]) == tfa.mhsa_bwd_plan(40, torch.float32).arg


def test_cls_plan_covers_the_keys_and_fills_two_waves():
    """B8's runs cover the keys below n_true exactly (none empty) at every
    n_true of N = 8..2048, and at the shapes chip_smoke.py gives B8 (vit-b16
    B8: 12 heads; its head dims 128 and 192: 12 heads; the general cases: 8
    heads of 96 and 4 of 320, B8; 1,001 keys) the grid is two waves of 132
    SMs or more. A run is MIN_KEYS keys or more unless one run takes all; a
    row's lanes are the largest power of two up to 8 that divides its
    16-byte slots (its elements where the head dim is no multiple of 16
    bytes)."""
    for n_true in range(1, 2049):
        for batch, heads in ((1, 1), (2, 4), (8, 12)):
            splits, chunk, _ = tcls.cls_plan(batch, heads, n_true)
            assert (splits - 1) * chunk < n_true <= splits * chunk
            assert chunk >= tcls.MIN_KEYS or splits == 1
    lanes = {(d, dt): tcls.cls_plan(8, 4, 1001, d, dt).lanes
             for d in (64, 96, 128, 192, 256, 320, 36) for dt in DTYPES}
    assert [lanes[(d, torch.bfloat16)] for d in (64, 96, 128, 192, 256, 320, 36)] == [
        8, 4, 8, 8, 8, 8, 4]
    assert [lanes[(d, torch.float32)] for d in (64, 96, 128, 192, 256, 320, 36)] == [
        8, 8, 8, 8, 8, 8, 1]
    for batch, heads, dim_head in ((8, 12, 64), (8, 12, 128), (8, 12, 192), (8, 8, 96),
                                   (8, 4, 320)):
        for dtype in DTYPES:
            splits = tcls.cls_plan(batch, heads, 1001, dim_head, dtype).splits
            assert batch * heads * splits >= 2 * 132


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"), (torch.float32, "f32")])
@pytest.mark.parametrize("dim_head,heads", [(64, 12), (96, 8), (36, 2)])
def test_cls_attention_is_one_launch(monkeypatch, dtype, suffix, dim_head, heads):
    """B8 is one launch on kv and q0 in place, with the device's scratch
    for the runs' partials and its tickets, the geometry and the plan's
    runs."""
    calls = _fake_card(monkeypatch)
    before = tcls.cls_attention.launches
    kv = torch.zeros(3, 40, 2 * heads * dim_head, dtype=dtype)
    q0 = torch.zeros(3, heads * dim_head, dtype=dtype)
    out = tcls.cls_attention(kv, q0, heads, dim_head, 0.125, 37)
    assert tcls.cls_attention.launches == before + 1 and out.shape == q0.shape
    (name, symbol, args), = calls
    assert (name, symbol) == ("cls_attention", f"gaviko_cls_attention_{suffix}")
    splits, chunk, lanes = tcls.cls_plan(3, heads, 37, dim_head, dtype)
    assert args[:2] == (kv.data_ptr(), q0.data_ptr()) and args[2] == out.data_ptr()
    assert args[3] == tcls._scratch[(kv.device, "partials")].data_ptr()
    assert args[4] == tcls._scratch[(kv.device, "tickets")].data_ptr()
    assert args[5:14] == (3, 40, heads, dim_head, 37, splits, chunk, lanes, 0.125)


def test_3xtf32_products_of_the_backward_hold_the_f32_budget():
    """Kernel B's f32 products at GAViKO's head dim (64, 260 keys, 2 planes,
    unit-variance q, k, v and dO, scale 1/8) emulated as the kernel forms
    them (S and dP, then dV = P^T dO, dQ = dS K and dK = dS^T Q, each through
    the 3xTF32 split, f32 accumulation in the kernel's order) stay within
    the f32 budget of 1e-4 relative MAE of the plain version; one TF32
    product a step does not."""
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 260, 64).astype(np.float32)) for _ in range(4))
    scale = 64 ** -0.5
    qs = q * (scale * tfa.LOG2E)
    lse = torch.logsumexp(torch.matmul(qs, k.transpose(-1, -2)) / tfa.LOG2E, dim=-1) * tfa.LOG2E
    o = torch.matmul(torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1), v)
    delta = (do * o).sum(-1, keepdim=True)

    def backward(matmul):
        p = torch.exp2(matmul(qs, k.transpose(-1, -2)) - lse[..., None])
        ds = p * (matmul(do, v.transpose(-1, -2)) - delta)
        return (matmul(p.transpose(-1, -2).contiguous(), do), matmul(ds, k) * scale,
                matmul(ds.transpose(-1, -2).contiguous(), q) * scale)

    plain = backward(torch.matmul)

    def worst(got):
        return max(float((g.double() - w.double()).abs().mean() / w.double().abs().mean())
                   for g, w in zip(got, plain))

    assert worst(backward(_matmul_3xtf32)) <= 1e-4
    assert worst(backward(_matmul_tf32)) > 1e-4
