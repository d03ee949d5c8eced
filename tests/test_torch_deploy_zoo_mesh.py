"""PyTorch port: mesh deployment artifacts of the plain ViT (``fft``) and of
every PEFT-zoo method on the CPU, at 1 x 2.

``tests/test_torch_deploy_mesh.py`` holds GAViKO's mesh artifacts; this
module holds the methods whose shard plans differ (``parallel.mesh.tp_plan``
at tp 2: VPT's prefixed names, AdaptFormer's MLP at index 2 and its adapter
whole, SSF's ``ssf_1`` split with the qkv and fc1 rows, MeLO's LoRA-merged
qkv whole, DVPT's ``attn`` / ``mlp`` blocks, EVP's f32 stream) and the
plain ViT's CLS-fast last layer, whose B8 runs on a head shard. Tiny
vit-s16 (6 heads, 3 a model rank), depth 2 (both packages'
``VIT_CONFIG_MAP`` patched here and in the ranks), fp32, micro-batch 2,
three volumes (two micro-batches, the second padded).

Every tensor that starts constant (the switched-off branches: AdaptFormer's
up projection, MeLO's LoRA B, DVPT's gate; the LayerNorms, biases and SSF's
scales and shifts) is filled with random values, so a weight sliced in the
wrong place cannot hide behind a constant. Each method's checkpoint holds
every weight, so the JAX package's own 1 x 2 mesh artifact, exported from
the same npz, serves the same weights.

One spawn of 4 gloo ranks (``tests/torch_parallel_ranks.deploy_zoo_mesh_rank``)
exports the artifacts, a quarter on each rank, then serves each on one of
two pairs of ranks (half the methods a pair, a 2-rank group each): the mesh
artifact's logits bit-equal to the live ``Predictor(mesh_shape=(1, 2))``'s
(the same plain versions and sums in the same order) and within 2e-5 of
the single-device artifact's (``tests/test_torch_deploy_mesh.py``'s
budgets), and within 1e-4 of JAX's mesh artifact's. Each manifest holds
``tp_plan``'s placements and, in each model rank's ``cuda`` program (traced
on this CPU-only host), each kernel op as often as the method's routes
launch its kernel (``chip_smoke.zoo_launches``, ``serving_launches`` for
``fft``) and one collective a split block.
"""


import numpy as np
import pytest
import torch

import chip_smoke
from gaviko_tpu import config as jconfig
from gaviko_tpu.deploy import DeployedPredictor as JaxDeployedPredictor
from gaviko_tpu.deploy import export_artifact as jax_export_artifact
from gaviko_tpu_torch import config as tconfig
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.parallel.mesh import tp_plan
from tests import torch_parallel_ranks as ranks
from tests.test_torch_deploy import GEOMETRY, ZOO_EXTRAS

DEPTH = 2
WORLD = 4  # ranks exporting; two pairs of them serve
METHODS = ["fft", *(m for m in ZOO_EXTRAS if m != "gaviko")]
KW = dict(batch_size=2, dtype="float32", pretrained_dir=None)


def _model(method: str) -> dict:
    return dict(GEOMETRY, backbone="vit-s16", method=method, **ZOO_EXTRAS.get(method, {}))


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


def _filled(method: str, seed: int) -> dict:
    """The method's seed-0 init (the port Predictor's), each constant tensor
    filled with random values around its constant."""
    model = build_model(_model(method))
    params = model.init(torch.Generator().manual_seed(0), model.spec)
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in params.items():
        if v.numel() > 1 and bool((v == v.flatten()[0]).all()):
            out[k] = (v.numpy() + 0.05 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = v.numpy()
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The spawn's results, and the logits of JAX's mesh artifact of each
    method, exported meanwhile from the same npz."""
    root = tmp_path_factory.mktemp("deploy_zoo_mesh")
    jobs = []
    for i, method in enumerate(METHODS):
        ckpt = str(root / f"{method}.npz")
        np.savez(ckpt, **_filled(method, 100 + i))
        jobs.append((method, {"model": _model(method)}, ckpt, str(root / f"{method}_12.gaviko"),
                     str(root / f"{method}_1.gaviko")))
    vols = _vols(3, 0)
    vols_path = str(root / "vols.npy")  # a file: large arguments hold up the spawn
    np.save(vols_path, np.stack(vols))
    out_dir = str(root / "ranks")
    handle = ranks.start(ranks.deploy_zoo_mesh_rank, WORLD, out_dir, jobs, vols_path, DEPTH,
                         out_dir)
    jax_logits = {}
    for method, config, ckpt, _, _ in jobs:
        jax_path = str(root / f"{method}_jax12.gaviko")
        meta = jax_export_artifact(config, jax_path, checkpoint=ckpt, **KW, platforms=("cpu",),
                                   mesh_shape=(1, 2))
        assert meta["mesh_shape"] == [1, 2]
        jax_logits[method] = JaxDeployedPredictor(jax_path).predict_logits(vols)
    res = ranks.join(handle, timeout=150.0)
    out = {}
    for i, (method, _, ckpt, _, _) in enumerate(jobs):
        lead, follow = (res[2 * (i % 2) + r][method] for r in (0, 1))
        out[method] = {**lead, "meta": res[i % WORLD][method]["meta"], "ckpt": ckpt,
                       "collectives": (lead["collectives"], follow["collectives"]),
                       "jax": jax_logits[method]}
    return out


@pytest.mark.parametrize("method", METHODS)
def test_zoo_mesh_artifact_matches_live_and_single_device(method, served):
    """Rank 0's logits of the 1 x 2 artifact: the live mesh Predictor's bit
    for bit, the single-device artifact's within 2e-5."""
    r = served[method]
    got = r["logits"]
    assert got.shape == (3, 5) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, r["live"])
    np.testing.assert_allclose(got, r["single"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("method", METHODS)
def test_zoo_mesh_artifact_matches_jax_mesh_artifact(method, served):
    """Rank 0's logits of the 1 x 2 artifact within 1e-4 of the JAX
    package's 1 x 2 artifact of the same config and checkpoint."""
    np.testing.assert_allclose(served[method]["logits"], served[method]["jax"], rtol=0,
                               atol=1e-4)


def _collectives(placements: dict) -> int:
    """One sum over the model group a split attention or MLP block."""
    return sum(k.endswith((".to_qkv.weight", ".net.1.weight")) for k in placements)


@pytest.mark.parametrize("method", METHODS)
def test_zoo_mesh_manifest(method, served):
    """The placements are ``tp_plan``'s of the whole served weights; each
    model rank's cuda program calls each kernel op as often as the method's
    routes launch its kernel in one serving forward and the collective
    once a split block; the cpu programs call only the collective, which
    each rank ran that often in each of the two forwards."""
    r = served[method]
    meta = r["meta"]
    assert meta["mesh_shape"] == [1, 2] and meta["heads"] == 6
    model = build_model(_model(method))
    whole = {k: torch.empty(s) for k, s in meta["param_shapes"].items()}
    assert meta["placements"] == tp_plan(whole, 6, 2)
    assert set(meta["placements"].values()) <= {"qkv", "rows", "cols"}
    n = _collectives(meta["placements"])
    assert n == 2 * DEPTH - 2 * (method == "melo")  # MeLO's LoRA-merged qkv stays whole
    want = (chip_smoke.serving_launches(model.spec) if method == "fft"
            else chip_smoke.zoo_launches(model.spec, torch.float32, False))
    kernels = {f"gaviko::{k}": c for k, c in want.items() if c}
    coll = {"gaviko::model_all_reduce": n}
    assert meta["ops"]["cuda"] == [{**kernels, **coll}] * 2
    assert meta["ops"]["cpu"] == [coll] * 2
    assert r["collectives"] == (2 * n, 2 * n)
    with np.load(r["ckpt"]) as ck:
        assert set(ck.files) == set(meta["param_shapes"])
