"""PyTorch port: deployment artifacts (``deploy.py``, ``cli/export.py``, the
CLIs' ``--artifact``) on the CPU, against the live Predictor and the JAX
package's own artifacts.

These mirror ``tests/test_deploy.py``: the manifest; the ``cpu`` program's
logits bit-equal to the port's live ``Predictor`` and within 1e-4 of the JAX
package's ``export_artifact`` + ``DeployedPredictor`` from one npz of JAX's
initial params; the ``cuda`` program, traced here on fake CUDA tensors,
calling each ``gaviko::`` op as often as the routes launch its kernel
(``chip_smoke.serving_launches``); reloads, int8 sidecars, the refusals,
every method round trip, the CLIs, ``serve()``, a serving process that
imports no model code, and the kernel build directory. The backbones run
at depth 2 (both packages' ``VIT_CONFIG_MAP`` patched for this module) to
keep the module's exports fast; widths and geometry are the serving
tests' tiny ones.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from gaviko_tpu import config as jconfig
from gaviko_tpu.deploy import DeployedPredictor as JaxDeployedPredictor
from gaviko_tpu.deploy import export_artifact as jax_export_artifact
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu_torch import config as tconfig
from gaviko_tpu_torch.deploy import (
    _META_NAME, ARTIFACT_VERSION, DeployedPredictor, export_artifact)
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops.int8_linear import INT8_SUFFIX, SCALE_SUFFIX, quantize_weight
from gaviko_tpu_torch.serving import Predictor, serve
from gaviko_tpu_torch.utils import compile_cache
from tests.test_end_to_end import make_synth_dataset, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 2
GEOMETRY = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
                num_classes=5, channels=1, pool="cls")
MODEL = dict(GEOMETRY, backbone="vit-s16", method="gaviko", freeze_vit=True, num_prompts=4,
             prompt_latent_dim=8, local_dim=8, local_k=[2, 2, 2])  # test_torch_serving's
VIT_MODEL = dict(GEOMETRY, backbone="vit-b16", method="fft")  # the ViT gates' kernels

# Method-specific tiny-geometry extras (tests/test_deploy.py's).
ZOO_EXTRAS = {
    "gaviko": dict(freeze_vit=True, num_prompts=5, prompt_latent_dim=12, local_dim=12,
                   local_k=[2, 2, 2], DHW=[2, 2, 2], attn_drop=0.2, proj_drop=0.2,
                   share_factor=1),
    "evp": dict(freeze_vit=True, scale_factor=4, input_type="fft", freq_nums=0.25,
                handcrafted_tune=True, embedding_tune=True),
    "shallow_vpt": dict(freeze_vit=True, num_prompts=4, prompt_dim=16, prompt_dropout=0.1,
                        deep_prompt=False),
    "deep_vpt": dict(freeze_vit=True, num_prompts=4, prompt_dim=16, prompt_dropout=0.1,
                     deep_prompt=True),
    "adaptformer": dict(freeze_vit=True),
    "ssf": dict(freeze_vit=True),
    "dvpt": dict(freeze_vit=True, num_prompts=6, pool="mean"),
    "melo": dict(freeze_vit=True, r=4, alpha=4),
}


@pytest.fixture(scope="module", autouse=True)
def shallow():
    """Every backbone at depth 2 in both packages, for this module only."""
    with pytest.MonkeyPatch.context() as mp:
        for cfg in (tconfig, jconfig):
            for name in ("vit-t16", "vit-s16", "vit-b16"):
                mp.setitem(cfg.VIT_CONFIG_MAP, name, dict(cfg.VIT_CONFIG_MAP[name], depth=DEPTH))
        yield


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """JAX's initial params of MODEL as one npz: the weights both packages load."""
    jm = jax_build_model(MODEL)
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3), jm.spec).items()}
    path = str(tmp_path_factory.mktemp("ckpt") / "full.npz")
    np.savez(path, **params)
    return path


@pytest.fixture(scope="module")
def exported(ckpt, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("deploy") / "model.gaviko")
    meta = export_artifact({"model": MODEL}, path, checkpoint=ckpt, batch_size=2,
                           dtype="float32", pretrained_dir=None, platforms=("cpu", "cuda"))
    return path, meta


@pytest.fixture(scope="module")
def live(ckpt):
    return Predictor({"model": MODEL}, checkpoint=ckpt, batch_size=2, dtype="float32",
                     pretrained_dir=None, device="cpu")


@pytest.fixture(scope="module")
def jax_artifact(ckpt, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_deploy") / "model.gaviko")
    jax_export_artifact({"model": MODEL}, path, checkpoint=ckpt, batch_size=2,
                        dtype="float32", pretrained_dir=None, platforms=("cpu",))
    return path


@pytest.fixture(scope="module")
def exported_int8(ckpt, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("deploy_q") / "q.gaviko")
    meta = export_artifact({"model": MODEL}, path, checkpoint=ckpt, batch_size=2,
                           dtype="float32", pretrained_dir=None, quantize="int8",
                           platforms=("cpu", "cuda"))
    return path, meta


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    csv_path, volumes = make_synth_dataset(root, n_train=2, n_val=3)
    return csv_path, volumes


def _vols(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(24, 32, 32).astype(np.float32) for _ in range(n)]


def _tamper(src, dst, drop=(), **meta_updates):
    """Copy an artifact zip with manifest fields patched and members dropped."""
    with zipfile.ZipFile(src) as z:
        members = {n: z.read(n) for n in z.namelist() if n not in drop}
    meta = json.loads(members[_META_NAME].decode())
    meta.update(meta_updates)
    members[_META_NAME] = json.dumps(meta).encode()
    with zipfile.ZipFile(dst, "w") as z:
        for n, b in members.items():
            z.writestr(n, b)


def _spec(model_cfg):
    return build_model(model_cfg).spec


def _want_ops(spec, quantized=False):
    return {f"gaviko::{k}": n
            for k, n in chip_smoke.serving_launches(spec, quantized).items() if n}


def test_manifest(exported):
    path, meta = exported
    assert meta["artifact_version"] == ARTIFACT_VERSION
    assert meta["torch_version"] == torch.__version__
    assert meta["platforms"] == ["cpu", "cuda"]
    assert meta["batch_size"] == 2 and meta["dtype"] == "float32"
    assert meta["quantize"] is None and meta["mesh_shape"] is None
    assert meta["num_classes"] == 5 and meta["input_shape"] == [2, 1, 24, 32, 32]
    assert meta["model_config"] == MODEL
    assert set(meta["param_shapes"]) == set(meta["param_dtypes"])
    assert set(meta["param_dtypes"].values()) == {"float32"}
    assert meta["ops"]["cpu"] == {}
    assert meta["ops"]["cuda"] == _want_ops(_spec(MODEL))
    assert meta["kernel_sources"] == _build.sources_digest()
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["meta.json", "params.pt", "program.cpu.pt2",
                                        "program.cuda.pt2"]
        assert json.loads(z.read("meta.json")) == meta


def test_artifact_matches_live_predictor(exported, live, jax_artifact):
    """The cpu program's logits are the live Predictor's, bit for bit (the
    same plain versions in ATen ops), and within 1e-4 of the JAX package's
    artifact from the same npz."""
    dep = DeployedPredictor(exported[0], device="cpu")
    vols = _vols(3, 0)  # two micro-batches, the second one padded
    got = dep.predict_logits(vols)
    assert got.shape == (3, 5) and got.dtype == np.float32
    np.testing.assert_array_equal(got, live.predict_logits(vols))
    np.testing.assert_allclose(got, JaxDeployedPredictor(jax_artifact).predict_logits(vols),
                               atol=1e-4)
    assert (dep.predict(vols) == got.argmax(-1)).all()
    assert dep.predict_logits([]).shape == (0, 5)
    with pytest.raises(ValueError, match="the artifact takes \\(2, 1, 24, 32, 32\\)"):
        dep.predict_logits([np.zeros((24, 32, 16), np.float32)])
    # The served module runs without the exported module's per-call checks.
    assert not dep._program.validate_inputs
    assert not any(n.target is torch.ops.aten._assert_tensor_metadata.default
                   for n in dep._program.graph.nodes)


@pytest.mark.parametrize("case", ["gaviko", "gaviko_int8", "vit_b16"])
def test_cuda_program_calls_the_kernels(case, exported, exported_int8, tmp_path):
    """The cuda program, traced on this CPU-only host, calls each gaviko::
    op exactly as often as the routes launch its kernel in a serving
    forward, and keeps no plain version at those sites: the only softmaxes
    left are GAViKO's two GPA cross-attentions a layer (the cpu program
    holds the attentions' too), and the local window's mask (the plain
    version's only constant) is gone. The vit-b16 ViT is traced in bf16,
    where its gates take the LN + linear, fused MLP and CLS kernels."""
    if case == "vit_b16":
        path = str(tmp_path / "vit.gaviko")
        meta = export_artifact({"model": VIT_MODEL}, path, batch_size=2, pretrained_dir=None)
        assert meta["platforms"] == ["cuda"] and meta["dtype"] == "bfloat16"
    else:
        path, meta = exported_int8 if case == "gaviko_int8" else exported
    model = VIT_MODEL if case == "vit_b16" else MODEL
    assert meta["ops"]["cuda"] == _want_ops(_spec(model), meta["quantize"] is not None)
    programs = {}
    with zipfile.ZipFile(path) as z:
        for p in meta["platforms"]:
            programs[p] = torch.export.load(io.BytesIO(z.read(f"program.{p}.pt2")))
    softmax = {p: sum(n.target is torch.ops.aten.softmax.int
                      for n in ep.graph_module.graph.nodes) for p, ep in programs.items()}
    assert softmax["cuda"] == (2 * DEPTH if case != "vit_b16" else 0)
    assert not programs["cuda"].constants
    if case != "vit_b16":
        assert softmax["cpu"] == 4 * DEPTH and programs["cpu"].constants


def test_reload_checkpoint_overlays(exported, tmp_path):
    dep = DeployedPredictor(exported[0], device="cpu")
    vols = _vols(1, 2)
    before = dep.predict_logits(vols)
    shift = torch.arange(5, dtype=torch.float32)
    p = str(tmp_path / "overlay.pt")
    torch.save({"mlp_head.head.bias": dep.params["mlp_head.head.bias"] + shift}, p)
    old, old_device = dep.params, dep._device_params
    dep.reload_checkpoint(p)
    assert dep.params is not old and dep._device_params is not old_device  # an atomic swap
    np.testing.assert_allclose(dep.predict_logits(vols) - before, shift[None].numpy(),
                               atol=1e-4)

    with pytest.raises(ValueError, match="requires a checkpoint"):
        dep.reload_checkpoint(None)
    pb = str(tmp_path / "bad.pt")
    torch.save({"not.a.param": torch.zeros(3)}, pb)
    with pytest.raises(KeyError, match="not in the artifact"):
        dep.reload_checkpoint(pb)
    pw = str(tmp_path / "wrong.pt")
    torch.save({"mlp_head.head.bias": torch.zeros(7)}, pw)
    with pytest.raises(ValueError, match="shape mismatch"):
        dep.reload_checkpoint(pw)


def test_int8_export_and_sidecar_refresh(ckpt, exported_int8, tmp_path):
    """The int8 artifact's logits are the live int8 Predictor's (sidecars
    quantized after the cast, as the Predictor does); a reload of a quantized
    weight re-quantizes its sidecars with quantize_weight."""
    path, meta = exported_int8
    sidecars = [k for k, d in meta["param_dtypes"].items() if d == "int8"]
    assert len(sidecars) == 4 * DEPTH and all(k.endswith(INT8_SUFFIX) for k in sidecars)
    dep = DeployedPredictor(path, device="cpu")
    live = Predictor({"model": MODEL}, checkpoint=ckpt, batch_size=2, dtype="float32",
                     pretrained_dir=None, quantize="int8", device="cpu")
    for k, v in live.params.items():
        assert torch.equal(dep.params[k], v), k
    vols = _vols(2, 4)
    np.testing.assert_array_equal(dep.predict_logits(vols), live.predict_logits(vols))

    sidecars = sorted(k for k in dep.params if k.endswith(INT8_SUFFIX))
    key = sidecars[0][: -len(INT8_SUFFIX)]
    new_w = dep.params[key] * 2.0 + 0.1
    p = str(tmp_path / "w.pt")
    torch.save({key: new_w}, p)
    old = dep.params[key + INT8_SUFFIX].clone()
    dep.reload_checkpoint(p)
    w_i8, scale = quantize_weight(new_w)
    assert not torch.equal(dep.params[key + INT8_SUFFIX], old)
    assert torch.equal(dep.params[key + INT8_SUFFIX], w_i8)
    assert torch.equal(dep.params[key + SCALE_SUFFIX], scale)
    assert torch.equal(dep._device_params[key + INT8_SUFFIX], w_i8)


@pytest.mark.parametrize("gate", ["platform_cpu", "platform_cuda", "version", "kernel_sources",
                                  "jax_artifact"])
def test_refusals(gate, exported, jax_artifact, tmp_path):
    """Each is refused up front, before any program loads: a platform the
    artifact lacks (a cuda predictor never runs the cpu program), a newer
    artifact version, other CUDA kernel sources, and the JAX package's
    artifact."""
    src, bad = exported[0], str(tmp_path / "bad.gaviko")
    device, match = "cpu", None
    if gate == "platform_cpu":
        _tamper(src, bad, drop=("program.cpu.pt2",), platforms=["cuda"])
        match = "exported for platforms \\['cuda'\\].*on 'cpu'.*re-export"
    elif gate == "platform_cuda":
        _tamper(src, bad, drop=("program.cuda.pt2",), platforms=["cpu"])
        device, match = "cuda", "exported for platforms \\['cpu'\\].*on 'cuda'.*re-export"
    elif gate == "version":
        _tamper(src, bad, artifact_version=ARTIFACT_VERSION + 1)
        match = "newer"
    elif gate == "kernel_sources":
        _tamper(src, bad, kernel_sources="0" * 64)
        match = "other CUDA kernel sources.*re-export"
    else:
        bad, match = jax_artifact, "exported by gaviko_tpu.*gaviko_tpu_torch.cli.export"
    with pytest.raises(RuntimeError, match=match):
        DeployedPredictor(bad, device=device)


@pytest.mark.parametrize("mesh", ["2,2", "2", "a,b", "0,2", "2,2,1"])
def test_export_cli_mesh_flag(mesh, dataset, tmp_path, monkeypatch, capsys):
    """``cli.export --mesh data,tp`` parses as the JAX package's does and
    passes ``mesh_shape`` to ``export_artifact`` (recorded here; the mesh
    export itself: tests/test_torch_deploy_mesh.py); anything but two
    positive integers is a parser error."""
    from gaviko_tpu_torch.cli import export as export_cli

    calls = []
    monkeypatch.setattr(export_cli, "export_artifact", lambda config, path, **kw: (
        calls.append(kw), {"platforms": ["cuda"], "batch_size": 8, "dtype": "bfloat16"})[1])
    cfg_path = str(tmp_path / "tiny.yaml")
    with open(cfg_path, "w") as f:
        json.dump(tiny_config(str(tmp_path), *dataset), f)  # JSON is YAML
    args = ["--config", cfg_path, "--output", str(tmp_path / "m.gaviko"), "--mesh", mesh]
    if mesh != "2,2":
        with pytest.raises(SystemExit) as e:
            export_cli.main(args)
        assert e.value.code == 2 and "--mesh must be 'data,tp'" in capsys.readouterr().err
        assert not calls
        return
    export_cli.main(args)
    assert len(calls) == 1 and calls[0]["mesh_shape"] == (2, 2)


@pytest.mark.parametrize("method", sorted(tconfig.METHODS))
def test_zoo_artifact_roundtrip(method, dataset, tmp_path):
    """Every method's forward survives export and reproduces the live
    Predictor's logits from the artifact, bit for bit; its cuda program
    calls the ops its routes launch (``chip_smoke.zoo_launches`` for the
    zoo, ``serving_launches`` for the ViT methods and GAViKO)."""
    config = tiny_config(str(tmp_path), *dataset, method=method)
    config["model"].update(ZOO_EXTRAS.get(method, {}))
    path = str(tmp_path / f"{method}.gaviko")
    meta = export_artifact(config, path, batch_size=2, dtype="float32", pretrained_dir=None,
                           platforms=("cpu", "cuda"))
    spec = _spec(config["model"])
    want = (chip_smoke.zoo_launches(spec, torch.float32, False) if method in ZOO_EXTRAS
            and method != "gaviko" else chip_smoke.serving_launches(spec))
    assert meta["ops"]["cuda"] == {f"gaviko::{k}": n for k, n in want.items() if n}
    dep = DeployedPredictor(path, device="cpu")
    live = Predictor(config, batch_size=2, dtype="float32", pretrained_dir=None, device="cpu")
    vols = _vols(2, 11)
    np.testing.assert_array_equal(dep.predict_logits(vols), live.predict_logits(vols))


def test_export_then_infer_cli(dataset, tmp_path, capsys):
    """cli.export -> cli.infer --artifact: the versioned argmax CSV of every
    volume in the folder, the classes the artifact's predictor gives."""
    from gaviko_tpu_torch.cli import export as export_cli
    from gaviko_tpu_torch.cli import infer

    csv_path, folder = dataset
    config = tiny_config(str(tmp_path), csv_path, folder)
    cfg_path = str(tmp_path / "tiny.yaml")
    with open(cfg_path, "w") as f:
        json.dump(config, f)  # JSON is YAML
    path = str(tmp_path / "cli.gaviko")
    export_cli.main(["--config", cfg_path, "--method", "bitfit", "--output", path,
                     "--batch_size", "2", "--dtype", "float32", "--platforms", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        f"wrote {path} (platforms=['cpu'], batch=2, dtype=float32)")
    for bad in (["--image_folder", folder, "--config", cfg_path],
                ["--image_folder", folder, "--checkpoint", "x.pt"], []):
        with pytest.raises(SystemExit) as e:
            infer.main(["--artifact", path, *bad])
        assert e.value.code == 2
    out = infer.main(["--artifact", path, "--image_folder", folder,
                      "--results_dir", str(tmp_path / "outputs"), "--device", "cpu"])
    assert out.endswith("bitfit_vit_t16_inference_results_v1.csv")
    with open(out) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    names = sorted(f for f in os.listdir(folder) if f.endswith(".npz"))
    assert rows[0] == ["mri_path", "outputs"] and sorted(r[0] for r in rows[1:]) == names
    dep = DeployedPredictor(path, device="cpu")
    for name, cls in rows[1:]:
        with np.load(os.path.join(folder, name)) as z:
            assert int(cls) == int(dep.predict([z["data"]])[0])


def test_eval_cli_artifact(exported, dataset, tmp_path):
    """cli.evaluate --artifact: the val subset's metrics and versioned CSV
    from the artifact's program, the flags baked in at export refused."""
    from gaviko_tpu_torch.cli import evaluate

    csv_path, folder = dataset
    path = exported[0]
    for bad in (["--checkpoint", "x.pt"], ["--method", "fft"], ["--quantize", "int8"], []):
        args = ["--artifact", path, *bad] + (["--data_path", csv_path] if bad else [])
        with pytest.raises(SystemExit) as e:
            evaluate.main(args)
        assert e.value.code == 2
    out = evaluate.main(["--artifact", path, "--data_path", csv_path, "--image_folder", folder,
                         "--results_dir", str(tmp_path / "outputs"), "--device", "cpu"])
    assert set(out) == {"accuracy", "kappa", "auc", "csv"}
    assert out["csv"].endswith("gaviko_vit_s16_eval_results_v1.csv")
    assert os.path.exists(os.path.splitext(out["csv"])[0] + "_metrics.txt")
    with open(out["csv"]) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    assert [r[0] for r in rows] == ["vol_002.npz", "vol_003.npz", "vol_004.npz"]
    dep = DeployedPredictor(path, device="cpu")
    preds = []
    for name, cls in rows:
        with np.load(os.path.join(folder, name)) as z:
            preds.append(int(dep.predict([z["data"]])[0]))
        assert int(cls) == preds[-1]
    assert out["accuracy"] == pytest.approx(np.mean(np.asarray(preds) == 2))


def test_serve_accepts_deployed_predictor(exported):
    dep = DeployedPredictor(exported[0], device="cpu")
    for v in dep._device_params.values():
        assert v.device == dep.device
    server = serve(dep, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        vol = _vols(1, 1)[0]
        buf = io.BytesIO()
        np.savez(buf, data=vol)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.load(r)
        np.testing.assert_array_equal(np.float32(out["logits"]), dep.predict_logits([vol])[0])
    finally:
        server.shutdown()
        server.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_serving_imports_no_model_code(exported):
    """A process that loads the artifact and predicts imports no module of
    the port's model code (models, core, config)."""
    code = (
        "import sys, numpy as np\n"
        "from gaviko_tpu_torch.deploy import DeployedPredictor\n"
        f"dep = DeployedPredictor({exported[0]!r}, device='cpu')\n"
        "vol = np.random.RandomState(0).rand(24, 32, 32).astype(np.float32)\n"
        "assert dep.predict_logits([vol]).shape == (1, 5)\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('gaviko_tpu_torch.models',\n"
        "    'gaviko_tpu_torch.core', 'gaviko_tpu_torch.config', 'jax', 'gaviko_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_compile_cache_relocates_the_build(tmp_path, monkeypatch):
    """GAVIKO_COMPILE_CACHE_DIR moves the kernel libraries (sha256 names
    kept); GAVIKO_COMPILE_CACHE=0 builds into a fresh directory of the
    process; a directory that cannot be written raises, naming the
    variable."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("GAVIKO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("GAVIKO_COMPILE_CACHE_DIR", raising=False)
    default = _build.PACKAGE_DIR / "build"
    assert compile_cache.enable_compilation_cache() == str(default)
    assert _build.BUILD_DIR == default
    name = _build.library_path("fused_mhsa").name

    monkeypatch.setenv("GAVIKO_COMPILE_CACHE_DIR", str(tmp_path / "kernels"))
    assert compile_cache.enable_compilation_cache() == str(tmp_path / "kernels")
    assert _build.library_path("fused_mhsa") == tmp_path / "kernels" / name
    assert (tmp_path / "kernels").is_dir()

    monkeypatch.setenv("GAVIKO_COMPILE_CACHE", "0")
    assert compile_cache.enable_compilation_cache() is None
    fresh = _build.BUILD_DIR
    assert fresh.is_dir() and fresh.name.startswith("gaviko_kernels_")
    assert compile_cache.enable_compilation_cache() is None and _build.BUILD_DIR == fresh
    monkeypatch.delenv("GAVIKO_COMPILE_CACHE")

    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    monkeypatch.setenv("GAVIKO_COMPILE_CACHE_DIR", str(blocked / "kernels"))
    with pytest.raises(RuntimeError, match="cannot be written.*GAVIKO_COMPILE_CACHE_DIR"):
        compile_cache.enable_compilation_cache()
