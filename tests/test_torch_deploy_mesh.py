"""PyTorch port: mesh deployment artifacts (``export_artifact(mesh_shape=...)``,
``DeployedPredictor`` on data x tp ranks) on the CPU.

These mirror ``tests/test_deploy.py``'s mesh tests. One spawn of 4 gloo
ranks (``tests/torch_parallel_ranks.deploy_mesh_rank``) serves the ``cpu``
programs while this process exports and computes what they are held to: a
2 x 2 fp32 artifact of a tiny GAViKO within 2e-5 of the port's
single-device artifact (JAX's own budget), within 1e-4 of the JAX
package's 2 x 2 mesh artifact from the same npz (on the conftest's virtual
CPU devices) and bit-equal to the live mesh Predictor; a hot reload; a 1 x
2 int8 artifact against the one-rank int8 artifact; the HTTP path over a
mesh DeployedPredictor and over a live ``Predictor(mesh_shape=(1, 2))``;
the refusals; the manifest, with each model rank's ``cuda`` program traced
on this CPU-only host; the collective op itself. The backbones run at
depth 2 (both packages' ``VIT_CONFIG_MAP`` patched here and in the ranks).
"""

import os
import zipfile

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from gaviko_tpu import config as jconfig
from gaviko_tpu.deploy import DeployedPredictor as JaxDeployedPredictor
from gaviko_tpu.deploy import export_artifact as jax_export_artifact
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu_torch import config as tconfig
from gaviko_tpu_torch.deploy import DeployedPredictor, export_artifact
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.parallel.mesh import tp_plan
from tests import torch_parallel_ranks as ranks

DEPTH = 2
MODEL = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
             num_classes=5, channels=1, pool="cls", backbone="vit-s16", method="gaviko",
             freeze_vit=True, num_prompts=4, prompt_latent_dim=8, local_dim=8,
             local_k=[2, 2, 2])  # tests/test_torch_deploy.py's
SHIFT = np.arange(5, dtype=np.float32)
KW = dict(batch_size=2, dtype="float32", pretrained_dir=None)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    """Every backbone at depth 2 in both packages, for this module only."""
    with pytest.MonkeyPatch.context() as mp:
        for cfg in (tconfig, jconfig):
            for name in ("vit-t16", "vit-s16", "vit-b16"):
                mp.setitem(cfg.VIT_CONFIG_MAP, name, dict(cfg.VIT_CONFIG_MAP[name], depth=DEPTH))
        yield


def _vols(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(24, 32, 32).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The artifacts, the spawn's results and what this process computed
    meanwhile from the same npz of JAX's initial params."""
    root = tmp_path_factory.mktemp("deploy_mesh")
    jm = jax_build_model(MODEL)
    ckpt = str(root / "full.npz")
    np.savez(ckpt, **{k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3),
                                                           jm.spec).items()})
    cfg = {"model": MODEL}
    paths = {"ckpt": ckpt, "folder": str(root / "volumes"), "results": str(root / "outputs"),
             **{n: str(root / f"{n}.gaviko") for n in (
                 "mesh22", "int8_12", "single", "single_int8", "jax22")}}
    metas = {
        "mesh22": export_artifact(cfg, paths["mesh22"], checkpoint=ckpt, **KW,
                                  platforms=("cpu", "cuda"), mesh_shape=(2, 2)),
        "int8_12": export_artifact(cfg, paths["int8_12"], checkpoint=ckpt, **KW,
                                   quantize="int8", platforms=("cpu", "cuda"),
                                   mesh_shape=(1, 2))}
    vols = _vols(3, 0)  # two micro-batches, the second one padded
    os.makedirs(paths["folder"])
    for i, v in enumerate(vols):
        np.savez(os.path.join(paths["folder"], f"vol_{i}.npz"), data=v)
    export_artifact(cfg, paths["single"], checkpoint=ckpt, **KW, platforms=("cpu",))
    single = DeployedPredictor(paths["single"], device="cpu")
    bias = single.params[ranks.HEAD_BIAS]
    overlays = []
    for i in (1, 2):
        overlays.append(str(root / f"overlay{i}.pt"))
        torch.save({ranks.HEAD_BIAS: bias + i * torch.from_numpy(SHIFT)}, overlays[-1])
    handle = ranks.start(ranks.deploy_mesh_rank, 4, str(root / "ranks"), paths, vols, cfg,
                         DEPTH, overlays, str(root / "ranks"))
    out = {"paths": paths, "metas": metas, "vols": vols, "bias": bias.numpy(),
           "single": single.predict_logits(vols), "params": single.params}
    export_artifact(cfg, paths["single_int8"], checkpoint=ckpt, **KW, quantize="int8",
                    platforms=("cpu",))
    out["single_int8"] = DeployedPredictor(paths["single_int8"], device="cpu").predict_logits(
        vols)
    meta = jax_export_artifact(cfg, paths["jax22"], checkpoint=ckpt, **KW, platforms=("cpu",),
                               mesh_shape=(2, 2))
    assert meta["mesh_shape"] == [2, 2]
    out["jax22"] = JaxDeployedPredictor(paths["jax22"]).predict_logits(vols)
    out["ranks"] = ranks.join(handle, timeout=150.0)
    return out


def _collectives(placements):
    """One sum over the model group a split attention or MLP block."""
    return sum(k.endswith((".to_qkv.weight", ".net.1.weight")) for k in placements)


@pytest.mark.parametrize("name", ["mesh22", "int8_12"])
def test_manifest(name, served):
    """mesh_shape, the head count, the placements of the split weights
    (``tp_plan``'s, taken once at export; int8 blocks stay whole), one
    program a model rank and platform, each model rank's cuda program
    (traced on this CPU-only host) calling each kernel op as often as one
    serving forward launches its kernel (``chip_smoke.serving_launches``)
    and the collective once a split block; the cpu programs only the
    collective."""
    meta, quantized = served["metas"][name], name.startswith("int8")
    d, t = (2, 2) if name == "mesh22" else (1, 2)
    assert meta["mesh_shape"] == [d, t] and meta["heads"] == 6
    assert meta["input_shape"] == [2, 1, 24, 32, 32] and meta["quantize"] == (
        "int8" if quantized else None)
    whole = DeployedPredictor(served["paths"]["single_int8" if quantized else "single"],
                              device="cpu").params
    assert meta["placements"] == tp_plan(whole, 6, t)
    assert set(meta["placements"].values()) == (set() if quantized else {"qkv", "rows", "cols"})
    assert meta["param_shapes"] == {k: list(v.shape) for k, v in whole.items()}
    n = _collectives(meta["placements"])
    assert n == (0 if quantized else 2 * DEPTH)
    coll = {"gaviko::model_all_reduce": n} if n else {}
    assert meta["ops"]["cpu"] == [coll] * t
    kernels = {f"gaviko::{k}": c for k, c in chip_smoke.serving_launches(
        build_model(MODEL).spec, quantized).items() if c}
    assert meta["ops"]["cuda"] == [{**kernels, **coll}] * t
    with zipfile.ZipFile(served["paths"][name]) as z:
        assert sorted(z.namelist()) == sorted(
            ["meta.json", "params.pt"] + [f"program.{p}.m{m}.pt2" for p in meta["platforms"]
                                          for m in range(t)])


def test_mesh_artifact_matches_single_device(served):
    """2 x 2 on 4 ranks: the single-device artifact's logits within 2e-5
    (tests/test_deploy.py's budget), the live mesh Predictor's bit for bit
    (the same plain versions and sums, in the same order)."""
    got = served["ranks"][0]["logits"]
    assert got.shape == (3, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, served["single"], atol=2e-5)
    np.testing.assert_array_equal(got, served["ranks"][0]["live"])


def test_mesh_artifact_matches_jax_mesh_artifact(served):
    np.testing.assert_allclose(served["ranks"][0]["logits"], served["jax22"], atol=1e-4)


def test_mesh_reload_moves_the_logits_by_the_overlay(served):
    """A reload on rank 0 reaches every rank (each re-slices its weights):
    the logits move by the classifier bias's shift."""
    r0 = served["ranks"][0]
    np.testing.assert_allclose(r0["reloaded"] - r0["logits"][:1], SHIFT[None], atol=1e-4)


def test_int8_mesh_artifact_matches_one_rank(served):
    """1 x 2 int8 (the int8 blocks whole on both ranks) against the
    one-rank int8 artifact, by the serving int8 budget."""
    got = served["ranks"][0]["int8"]
    assert got.shape == (3, 5) and np.isfinite(got).all()
    assert chip_smoke._rel_mae_np(got, served["single_int8"]) <= chip_smoke.INT8_PLAIN_BUDGET


@pytest.mark.parametrize("case", ["deployed", "predictor"])
def test_http_on_a_mesh(case, served):
    """``serving.serve`` on rank 0 over a 2 x 2 DeployedPredictor and over a
    ``Predictor(mesh_shape=(1, 2))`` from the config: POST /predict returns
    the direct call's logits, GET /healthz answers, POST /reload reaches
    the following ranks."""
    res = served["ranks"]
    http = res[0]["http" if case == "deployed" else "live_http"]
    np.testing.assert_array_equal(http["http"], http["direct"])
    assert http["healthz"] == {"status": "ok"} and http["reload"] == {"status": "reloaded"}
    want = served["bias"] + (2 if case == "deployed" else 1) * SHIFT
    for r in res[:4 if case == "deployed" else 2]:
        for bias in (r["bias"] if case == "deployed" else (r["live_bias"],)):
            np.testing.assert_allclose(bias.numpy(), want, rtol=0, atol=1e-6)


def test_infer_cli_on_a_mesh(served):
    """``cli.infer --artifact`` on the 2 ranks of a 1 x 2 artifact's group:
    rank 0 writes the versioned CSV (the one-rank int8 artifact's classes),
    rank 1 follows it and returns None."""
    res = served["ranks"]
    assert res[1]["infer_csv"] is None
    path = res[0]["infer_csv"]
    assert path.endswith("gaviko_vit_s16_inference_results_v1.csv")
    with open(path) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    want = served["single_int8"].argmax(-1)
    assert rows[0] == ["mri_path", "outputs"]
    assert sorted(rows[1:]) == [[f"vol_{i}.npz", str(c)] for i, c in enumerate(want)]


def test_mesh_serving_imports_no_model_code(served):
    """Every rank serves the 2 x 2 artifact with no module of the model
    code imported and without calling ``tp_plan`` (made to raise), and
    sums over its model group once a split block in each of the 5 forwards
    (3 volumes in two micro-batches, one after the reload, the direct call
    and the POST /predict)."""
    for r in served["ranks"]:
        assert r["model_code"] == []
    assert {r["collectives"] for r in served["ranks"]} == {5 * 2 * DEPTH}


def test_model_all_reduce_op(served):
    """The op sums over the bound group, refuses with none bound, and its
    fake gives the result's shape, dtype and strides."""
    xs = [torch.randn(3, 5, generator=torch.Generator().manual_seed(r))[:, :4]
          for r in range(4)]
    for r in served["ranks"]:
        assert "no model group is bound" in r["unbound"]
        torch.testing.assert_close(r["op"]["sum"], sum(xs))
        assert r["op"]["fake"] == r["op"]["real"] == ((3, 4), torch.float32, (4, 1))


def test_mesh_refuses_a_world_that_is_not_data_by_tp(served):
    """A mesh artifact needs a process group of exactly data x tp ranks:
    refused on 4 ranks for a 1 x 2 artifact, and in one process, naming
    the torchrun launch."""
    for r in served["ranks"]:
        assert "exactly 2 ranks; this process has 4" in r["world"]
        assert "torchrun --nproc_per_node 2" in r["world"]
    with pytest.raises(RuntimeError, match="exactly 4 ranks; this process has 1.*torchrun "
                                           "--nproc_per_node 4.*--artifact"):
        DeployedPredictor(served["paths"]["mesh22"], device="cpu")


def test_mesh_export_refuses_a_batch_the_data_axis_does_not_divide(tmp_path):
    path = str(tmp_path / "bad.gaviko")
    with pytest.raises(ValueError, match="batch_size 3 must divide the data axis 2"):
        export_artifact({"model": MODEL}, path, batch_size=3, dtype="float32",
                        pretrained_dir=None, mesh_shape=(2, 2))
    assert not os.path.exists(path)
