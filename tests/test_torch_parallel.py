"""PyTorch port: the pieces of ``parallel/`` in one process, on the CPU.

- The dropout bits of every site on a data shard (rows [b0, ...)) and a
  tensor-parallel shard (heads [h0, ...), hidden columns [c0, ...)) are the
  whole batch's: ``layers.dropout`` (rows and a column offset), the
  probabilities of the unfused attention, the MHSA kernels A and B
  (``heads_total`` / ``head0``, their plain versions, forward and
  backward), the local kernels C and D (the salt folded into the seed) and
  the fused MLP B6 / B7 (``hidden_col0``); with the defaults the masks are
  the ones before the arguments existed.
- The shard rules and the ZeRO axis against the JAX package's
  ``param_pspec`` / ``shardings_for_params`` and ``zero_sharding_for`` on
  its own shapes; the whole numpy dict round-trips through the shards.
- The loaders with ``shard=(i, 2)``: batches bit-equal to the JAX
  package's ``Loader`` with the same shard, ``n_valid`` the global count.
- B13's sharded norm (the sum of squares reduced apart from the update)
  against the one-pass step, and a 1 x 1 mesh's step against ``make_steps``.
- An explicit topology whose init fails raises; none runs one process.
"""

import dataclasses
import logging
import os
from datetime import timedelta

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.data import pipeline as jpipe
from gaviko_tpu.data import transforms as jtf
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.parallel import mesh as jmesh
from gaviko_tpu_torch.core import layers
from gaviko_tpu_torch.core.layers import SeedStream
from gaviko_tpu_torch.data import pipeline as tpipe
from gaviko_tpu_torch.data import transforms as ttf
from gaviko_tpu_torch.data.grain_pipeline import GrainLoader
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.ops import attention as tattn
from gaviko_tpu_torch.ops import fused_adam as tadam
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops import fused_mlp as tmlp
from gaviko_tpu_torch.ops.hash_dropout import keep_mask
from gaviko_tpu_torch.parallel import mesh as pmesh
from gaviko_tpu_torch.parallel import shard
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.train import losses as tlosses
from tests.test_torch_data import _dataset
from tests.test_torch_rescale import jax_core_loaded

RATE, SEED = 0.3, 123456789
B, B0, BL = 4, 2, 2  # the whole batch, a data shard's first row and rows


def _on_shard(**kw):
    return shard.active(shard.Shard(b0=B0, batch=BL, **kw))


# ------------------------------------------------------------- masks ----

def test_layers_dropout_on_a_shard_is_the_whole_batchs():
    x = torch.ones(B, 5, 12)
    whole = layers.dropout(x, RATE, True, SeedStream([SEED]))
    with _on_shard():
        rows = layers.dropout(x[B0:], RATE, True, SeedStream([SEED]))
        cols = layers.dropout(x[B0:, :, 4:8], RATE, True, SeedStream([SEED]), col_offset=4)
    assert torch.equal(rows, whole[B0:])
    assert torch.equal(cols, whole[B0:, :, 4:8])
    assert 0.5 < float((whole == 0).float().mean()) / RATE < 1.5
    with _on_shard(), pytest.raises(ValueError, match="batch first"):
        layers.dropout(x, RATE, True, SeedStream([SEED]))


def test_unfused_attention_probabilities_on_a_shard_are_the_whole_layers():
    p = torch.rand(B, 4, 6, 6)
    whole = tattn._probs_dropout(p, RATE, SeedStream([SEED]), None, 0)
    flat = layers.dropout(p, RATE, True, SeedStream([SEED]))
    assert torch.equal(whole, flat)  # the flattened rows of layers.dropout
    with _on_shard():
        part = tattn._probs_dropout(p[B0:, 2:], RATE, SeedStream([SEED]), 4, 2)
    assert torch.equal(part, whole[B0:, 2:])


def test_mhsa_masks_default_to_the_old_planes():
    shape = (3, 4, 8, 8)
    got = tfa._mhsa_keep_factor(shape, SEED, RATE, "cpu")
    salt = torch.arange(12).reshape(3, 4, 1, 1)
    want = keep_mask(shape, SEED, RATE, salt=salt).float() / (1.0 - RATE)
    assert torch.equal(got, want)


@pytest.mark.parametrize("heads_total,head0", [(4, 2), (6, 3)])
def test_mhsa_kernels_plain_versions_on_a_shard_are_the_whole_layers(heads_total, head0):
    dh, n, hl = 8, 16, 2
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, n, 3 * heads_total * dh, generator=g)
    dout = torch.randn(B, n, heads_total * dh, generator=g)
    cols = torch.cat([torch.arange(head0 * dh, (head0 + hl) * dh) + j * heads_total * dh
                      for j in range(3)])
    part = qkv[B0:][..., cols]
    scale = dh ** -0.5
    out, lse = tfa.mhsa_reference(qkv, heads_total, dh, scale, 13, RATE, True, SEED)
    with _on_shard():
        seed = shard.fold_seed(SEED, salts=heads_total)
        pout, plse = tfa.fused_mhsa(part, hl, dh, scale, 13, RATE, True, seed,
                                    heads_total=heads_total, head0=head0)
        pd = tfa.fused_mhsa_bwd(part, pout, plse, dout[B0:, :, head0 * dh:(head0 + hl) * dh],
                                hl, dh, scale, 13, RATE, seed, heads_total, head0)
    o = slice(head0 * dh, (head0 + hl) * dh)
    torch.testing.assert_close(pout, out[B0:, :, o], rtol=0, atol=1e-6)
    torch.testing.assert_close(plse, lse[B0:, head0:head0 + hl], rtol=0, atol=1e-6)
    dqkv = tfa.mhsa_bwd_reference(qkv, out, lse, dout, heads_total, dh, scale, 13, RATE, SEED)
    torch.testing.assert_close(pd, dqkv[B0:][..., cols], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="outside a layer"):
        tfa.mhsa_reference(part, hl, dh, scale, 13, RATE, seed=SEED, heads_total=3, head0=2)


def test_local_kernels_mask_on_a_shard_is_the_whole_batchs():
    whole = tfa._local_keep((B, 8, 8), SEED, RATE, "cpu")
    with _on_shard():
        part = tfa._local_keep((BL, 8, 8), shard.fold_seed(SEED, salts=1), RATE, "cpu")
    assert torch.equal(part, whole[B0:])


def test_fused_mlp_masks_on_a_shard_are_the_whole_layers():
    n, mlp, dim, c0 = 5, 256, 128, 128
    whole_h = tmlp._keep_factor(B * n, mlp, SEED, RATE, 0, "cpu")
    whole_o = tmlp._keep_factor(B * n, dim, SEED, RATE, 1, "cpu")
    with _on_shard():
        s = shard.fold_seed(SEED, rows=n)
        part_h = tmlp._keep_factor(BL * n, mlp // 2, s, RATE, 0, "cpu", c0)
        part_o = tmlp._keep_factor(BL * n, dim, s, RATE, 1, "cpu")
    assert torch.equal(part_h, whole_h[B0 * n:, c0:])
    assert torch.equal(part_o, whole_o[B0 * n:])


def test_fused_mlp_on_hidden_slices_sums_to_the_whole():
    """Two hidden slices, b2 and the residual on the first: their outputs
    and their backward's gradients sum to the whole MLP's."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 128, generator=g)
    w1, w2 = torch.randn(256, 128, generator=g) * 0.05, torch.randn(128, 256, generator=g) * 0.05
    b1, b2 = torch.randn(256, generator=g), torch.randn(128, generator=g)
    ln = (torch.ones(128), torch.zeros(128))
    dy = torch.randn_like(x)
    want = tmlp.mlp_reference(x, *ln, w1, b1, w2, b2, 1e-5, "exact", RATE, True, SEED)
    parts, grads = [], []
    for m in range(2):
        h = slice(128 * m, 128 * (m + 1))
        args = (x, *ln, w1[h], b1[h], w2[:, h], b2 if m == 0 else torch.zeros_like(b2))
        out, a = tmlp.mlp_reference(*args, 1e-5, "exact", RATE, m == 0, SEED, save_a=True,
                                    hidden_col0=128 * m)
        parts.append(out)
        grads.append(tmlp.mlp_bwd_reference(*args, dy, a, 1e-5, "exact", RATE, m == 0, SEED,
                                            hidden_col0=128 * m))
    torch.testing.assert_close(parts[0] + parts[1], want, rtol=0, atol=1e-5)
    _, a = tmlp.mlp_reference(x, *ln, w1, b1, w2, b2, 1e-5, "exact", RATE, True, SEED,
                              save_a=True)
    whole = tmlp.mlp_bwd_reference(x, *ln, w1, b1, w2, b2, dy, a, 1e-5, "exact", RATE, True,
                                   SEED)
    torch.testing.assert_close(grads[0][0] + grads[1][0], whole[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(torch.cat([grads[0][3], grads[1][3]]), whole[3], rtol=0,
                               atol=1e-4)


# ----------------------------------------------------------- the rules ----

def _jax_params(method, backbone, **over):
    cfg = dict(num_classes=5, channels=1, pool="cls", backbone=backbone, method=method,
               image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
               num_prompts=4, prompt_latent_dim=8, local_dim=8, local_k=(2, 2, 2), **over)
    jm = jax_build_model(cfg)
    jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=2))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jm.spec))
    rng = np.random.RandomState(0)
    return jm, {k: rng.rand(*v.shape).astype(np.float32) for k, v in shapes.items()}


_HOW = {"qkv": jax.sharding.PartitionSpec("model", None),
        "rows": None, "cols": jax.sharding.PartitionSpec(None, "model")}


@pytest.mark.parametrize("method,backbone", [("fft", "vit-s16"), ("gaviko", "vit-s16"),
                                             ("fft", "vit-t16")])
def test_shard_rules_match_jax_partition_specs(method, backbone):
    jm, params = _jax_params(method, backbone)
    mesh = jmesh.make_mesh(data=2, model=2)
    want = jmesh.shardings_for_params(params, mesh, tp=True)
    plan = pmesh.tp_plan(params, jm.spec.heads, 2)
    for k, v in params.items():
        spec = want[k].spec
        if k in plan:
            how = plan[k]
            expect = (jax.sharding.PartitionSpec("model") if v.ndim == 1 else
                      jax.sharding.PartitionSpec("model", None)) if how == "rows" else _HOW[how]
            assert spec == expect, k
        elif jm.spec.heads % 2 and (".to_qkv." in k or ".to_out.0.weight" in k):
            # vit-t16's 3 heads: JAX splits the rows anyway; the port keeps
            # the attention whole (a head cannot be cut).
            assert spec != jax.sharding.PartitionSpec(), k
        else:
            assert spec == jax.sharding.PartitionSpec(), k
    if method == "gaviko":
        assert not any("local_attns" in k for k in plan)
    whole = pmesh.gather_shards([pmesh.shard_params(params, plan, m, 2, jm.spec.heads)
                                 for m in range(2)], plan, jm.spec.heads)
    assert all(np.array_equal(whole[k], params[k]) for k in params)


def test_qkv_shard_holds_its_heads_rows():
    jm, params = _jax_params("fft", "vit-s16")
    k = "transformer.layers.0.0.to_qkv.weight"
    dh, H = jm.spec.dim_head, jm.spec.heads
    part = pmesh.shard_params(params, pmesh.tp_plan(params, H, 2), 1, 2, H)[k]
    hl = H // 2
    want = np.concatenate([params[k][j * H * dh + hl * dh:j * H * dh + 2 * hl * dh]
                           for j in range(3)])
    assert np.array_equal(part, want)


@pytest.mark.parametrize("data", [2, 4, 8])
def test_zero_axis_matches_jax(data):
    _, params = _jax_params("fft", "vit-s16")
    mesh = jmesh.make_mesh(data=data, model=1)
    for k, v in params.items():
        spec = tuple(jmesh.zero_sharding_for(jnp.zeros(v.shape), mesh).spec)
        want = spec.index("data") if "data" in spec else None
        assert pmesh.zero_axis(v.shape, data) == want, k


# ---------------------------------------------------------- the loaders ----

@pytest.mark.parametrize("engine", ["native", "grain"])
def test_sharded_loaders_match_jax(tmp_path, engine):
    import functools

    import pandas as pd

    jax_core_loaded()
    csv_path, vols = _dataset(str(tmp_path), n=9)  # 7 train volumes: the last batch pads
    tf_j = functools.partial(jtf.train_transform, intensity_augs=False)
    tf_t = functools.partial(ttf.train_transform, intensity_augs=False)
    jds = jpipe.dataset_from_dataframe(jpipe.split_dataframe(pd.read_csv(csv_path), "train"),
                                       tf_j, True, vols)
    tds = tpipe.dataset_from_dataframe(tpipe.split_dataframe(tpipe.read_csv(csv_path), "train"),
                                       tf_t, True, vols)
    kw = dict(shuffle=True, num_workers=2, seed=4, pad_to_batch=True)
    cls = tpipe.Loader if engine == "native" else GrainLoader
    for i in range(2):
        jb = list(jpipe.Loader(jds, 4, shard=(i, 2), **kw))
        tb = list(cls(tds, 4, shard=(i, 2), **kw))
        assert len(jb) == len(tb) == 2
        for (jx, jy, jn), (tx, ty, tn) in zip(jb, tb):
            assert tx.shape == (2, 1, 12, 16, 16) and tn == jn
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        assert [n for _, _, n in tb] == [4, 3]  # global counts on both shards
    with pytest.raises(ValueError, match="divisible"):
        tpipe.Loader(tds, 3, shard=(0, 2), pad_to_batch=True)


# ------------------------------------------------------------ the step ----

def test_sharded_norm_matches_the_one_pass_step():
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(s, generator=g) for s in ((7, 5), (130,), (3, 3, 3))]
    mu, nu, p = ([torch.randn(t.shape, generator=g).abs() for t in grads] for _ in range(3))
    args = (0.1, 0.9, 0.1, 0.001)
    want = tadam.fused_adam(grads, mu, nu, p, *args, clip=0.5)
    got = tadam.fused_adam(grads, mu, nu, p, *args, clip=0.5, norm_reduce=lambda t: None)
    for w, gg in zip(want, got):
        assert all(torch.equal(a, b) for a, b in zip(w, gg))
    # The norm counts the first n_counted leaves, the reduce adds the rest.
    rest = sum(float(t.double().square().sum()) for t in grads[2:])
    split = tadam.fused_adam(grads, mu, nu, p, *args, clip=0.5, n_counted=2,
                             norm_reduce=lambda t: t.add_(rest))
    for w, gg in zip(want, split):
        for a, b in zip(w, gg):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_one_by_one_mesh_step_matches_make_steps():
    cfg = dict(num_classes=5, channels=1, pool="cls", backbone="vit-s16", method="gaviko",
               freeze_vit=True, attn_drop=0.2, proj_drop=0.2, image_size=32,
               image_patch_size=16, frames=24, frame_patch_size=12, num_prompts=4,
               prompt_latent_dim=8, local_dim=8, local_k=(2, 2, 2))
    model = build_model(cfg)
    model = dataclasses.replace(model, spec=dataclasses.replace(model.spec, depth=2))
    train_cfg = {"loss_fn": "focal_loss", "accumulation_steps": 1,
                 "scheduler": {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
                               "final_div_factor": 1000.0}}
    fused = tloop.make_optimizer(train_cfg, 10)
    crit = tlosses.make_criterion(train_cfg)
    params = model.init(torch.Generator().manual_seed(0), model.spec)
    rng = np.random.RandomState(0)
    x, y = torch.from_numpy(rng.rand(2, 1, 24, 32, 32).astype(np.float32)), torch.tensor([1, 3])
    tr, fr = tloop.split_params(model, params)
    step, _, _ = tloop.make_steps(model, crit, fused)
    want = step({k: v.clone() for k, v in tr.items()}, tloop.init_opt_state(tr), fr, x, y,
                SeedStream([5, 6, 7, 8]))
    par = pmesh.ParallelTrainer(model, crit, fused, pmesh.make_mesh(), tr, fr)
    got = par.train_step(par.trainable, par.opt_state, par.frozen, x, y, SeedStream([5, 6, 7, 8]))
    assert abs(float(got[2]) - float(want[2])) <= 1e-6 and float(got[3]) == float(want[3])
    assert max(float((got[0][k] - want[0][k]).abs().max()) for k in want[0]) <= 1e-7
    whole, opt = par.gather_state(got[0], got[1])
    assert opt.count == 1 and set(opt.mu) == set(tr)


# -------------------------------------------------------- the topology ----

def test_no_topology_runs_one_process(caplog, monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed({}) == (0, 1)
    with caplog.at_level(logging.WARNING):
        assert pmesh.init_distributed({"multihost": True}) == (0, 1)
    assert "running one process" in caplog.text
    assert pmesh.mesh_axes({"data": "auto", "model": 1}, 1) == (1, 1)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        pmesh.mesh_axes({"data": 2, "model": 2}, 1)


@pytest.mark.parametrize("given", [{"process_id": 1}, {"coordinator_address": "host:1"}])
def test_a_partial_topology_raises(given, monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="not given"):
        pmesh.init_distributed(given, "cpu")


def test_an_explicit_topology_whose_init_fails_raises(tmp_path):
    import torch.distributed as dist

    cfg = {"coordinator_address": f"file://{tmp_path}/store", "num_processes": 2,
           "process_id": 1}
    with pytest.raises(RuntimeError, match="Refusing to continue as one process"):
        pmesh.init_distributed(cfg, "cpu", timeout=timedelta(seconds=2))
    assert not dist.is_initialized()


def test_mesh_size_must_match_the_process_group():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.make_mesh(2, 1)
    assert pmesh.plan_layout([("h", 2), ("h", 2)], 1, "cpu") == ("gloo", 1, 2)
    assert pmesh.plan_layout([("h", 1), ("h", 1)], 1, "cuda") == ("gloo", 1, 2)
    assert os.environ.get("LOCAL_RANK") is None or pmesh.local_rank() >= 0


@pytest.mark.parametrize("ranks,rank,want", [
    ([("a", 2), ("a", 2), ("b", 2), ("b", 2)], 3, ("nccl", 1, 2)),  # a card a rank
    ([("a", 8), ("b", 8)], 1, ("nccl", 0, 1)),  # JAX's num_processes: one rank a host
    ([("a", 2), ("a", 2), ("b", 2), ("b", 2), ("b", 2)], 0, ("gloo", 0, 2)),  # b shares
    ([("a", 0)], 0, ("gloo", 0, 1)),  # no card
])
def test_backend_follows_the_observed_layout(ranks, rank, want):
    """Every rank picks the same backend from every host's ranks and cards
    (torchrun's LOCAL_WORLD_SIZE is not needed), and learns its local rank."""
    assert pmesh.plan_layout(ranks, rank, "cuda") == want
    assert all(pmesh.plan_layout(ranks, r, "cuda")[0] == want[0] for r in range(len(ranks)))


def test_what_a_mesh_does_not_take_raises_naming_its_item():
    """A mesh takes every method's tensor parallelism, the accumulating
    optimizer (tests/test_torch_parallel_{zoo,accum}.py) and mesh artifacts
    (tests/test_torch_deploy_mesh.py) now; what a mesh artifact does not
    take is a batch that its data axis does not divide, refused before any
    model is built, as in the JAX package."""
    from gaviko_tpu_torch import deploy

    assert not hasattr(pmesh, "check_tp")
    model = build_model(dict(num_classes=5, channels=1, pool="cls", backbone="vit-t16",
                             method="bitfit", image_size=32, image_patch_size=16, frames=24,
                             frame_patch_size=12))
    params = model.init(torch.Generator().manual_seed(0), model.spec)
    tr, fr = tloop.split_params(model, params)
    fused = tloop.make_optimizer({"accumulation_steps": 2, "scheduler": {"max_lr": 1e-3}}, 4)
    par = pmesh.ParallelTrainer(model, tlosses.make_criterion({}), fused, pmesh.make_mesh(),
                                tr, fr)
    assert par.opt_state.acc is not None and par.opt_state.mini_step == 0
    with pytest.raises(ValueError, match="must divide the data axis"):
        deploy.export_artifact({"model": {}}, "unused.gaviko", batch_size=3, mesh_shape=(2, 2))


def test_one_by_one_mesh_predictor_matches_one_process():
    """``Predictor(mesh_shape=(1, 1))`` needs no process group: its forward,
    reload and close run alone, equal to the unsharded Predictor's."""
    from gaviko_tpu_torch.serving import Predictor
    from tests.test_torch_serving import CONFIG

    kw = dict(batch_size=2, dtype="float32", pretrained_dir=None, device="cpu")
    mesh, one = Predictor(CONFIG, mesh_shape=(1, 1), **kw), Predictor(CONFIG, **kw)
    vols = [np.random.RandomState(i).rand(*one._shape[2:]).astype(np.float32) for i in range(3)]
    want = one.predict_logits(vols)
    np.testing.assert_array_equal(mesh.predict_logits(vols), want)
    mesh.reload_checkpoint(None)
    np.testing.assert_array_equal(mesh.predict_logits(vols), want)
    mesh.close()
    assert mesh.mesh.data == mesh.mesh.model == 1
