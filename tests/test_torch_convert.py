"""PyTorch port: timm weight conversion (``weights/convert.py``) and the timm
path of ``models/pretrained.build_params`` against the JAX package's.

The timm state is synthetic (``convert.synthetic_timm_state``), with the
exact key inventory and shapes of timm's ``vit_tiny_patch16_224_in21k``
(``pre_logits.fc`` and the 21,843-way head that the converter drops),
values from a seed; nothing is downloaded.
Checked: the converted dicts have JAX's key set, the pure remaps bit-equal
and the pos-embedding interpolation and the kernel inflation within 1e-6;
``load_pretrain`` reads ``<name>``, ``<name>.pt`` and ``<name>.npz``; the
same keys land and drop as in JAX's ``load_state_dict`` for GAViKO and
``fft`` (only the embeddings and the final norm land there, PARITY #3/#4);
``build_params`` lands the same keys as JAX's, prefixed for deep VPT and
MeLO; and the ``python -m gaviko_tpu_torch.weights.convert`` command.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.models.pretrained import build_params as jax_build_params
from gaviko_tpu.weights import convert as jconv
from gaviko_tpu.weights.state_dict import load_state_dict as jax_load_state_dict
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.models.pretrained import build_params
from gaviko_tpu_torch.weights import convert as tconv
from gaviko_tpu_torch.weights.state_dict import load_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
            num_classes=5, channels=1, pool="cls", backbone="vit-t16")
METHODS = {"gaviko": dict(freeze_vit=True, num_prompts=4, prompt_latent_dim=8,
                          local_dim=8, local_k=[2, 2, 2]),
           "fft": {}, "deep_vpt": dict(num_prompts=2, prompt_dim=4),
           "melo": dict(r=3, alpha=7)}
INTERPOLATED = ("pos_embedding", "conv_proj.0.weight")


@pytest.fixture(scope="module")
def timm_state():
    return tconv.synthetic_timm_state("vit-t16")


@pytest.fixture(scope="module")
def pretrained_dir(tmp_path_factory, timm_state):
    path = tmp_path_factory.mktemp("pretrained")
    torch.save({k: torch.from_numpy(v) for k, v in timm_state.items()},
               path / "vit_tiny_patch16_224_in21k.pt")
    return str(path)


@pytest.mark.parametrize("num_patches,depth_dim", [(8, 12), (1000, 12), (27, 5)])
def test_convert_matches_jax(timm_state, num_patches, depth_dim):
    want = jconv.convert_timm_state(timm_state, num_patches, depth_dim)
    got = tconv.convert_timm_state(timm_state, num_patches, depth_dim)
    assert set(got) == set(want)
    assert not any("pre_logits" in k or k.startswith("head") for k in got)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        if k in INTERPOLATED:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    side = round(num_patches ** (1 / 3))
    assert got["pos_embedding"].shape == (1, 1 + side ** 3, 192)
    assert got["conv_proj.0.weight"].shape == (192, 1, depth_dim, 16, 16)


def test_interpolation_helpers_match_jax_and_torch():
    x = np.random.RandomState(1).randn(1, 8, 1, 14, 14).astype(np.float32)
    got = tconv.trilinear_resize(x, (10, 10, 10))
    np.testing.assert_allclose(got, jconv.trilinear_resize(x, (10, 10, 10)), rtol=0, atol=1e-6)
    want = torch.nn.functional.interpolate(torch.from_numpy(x), size=(10, 10, 10),
                                           mode="trilinear", align_corners=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    w = np.random.RandomState(2).randn(4, 3, 16, 16).astype(np.float32)
    np.testing.assert_allclose(tconv.mean_kernel(w, 6), jconv.mean_kernel(w, 6), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fmt", ["", ".pt", ".npz"])
def test_load_pretrain_reads_each_file_name(tmp_path, timm_state, fmt):
    name = tconv.TIMM_MODEL_NAMES["vit-t16"] + fmt
    if fmt == ".npz":
        np.savez(tmp_path / name, **timm_state)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in timm_state.items()}, tmp_path / name)
    got = tconv.load_pretrain("vit_t16", 8, 12, str(tmp_path))
    want = jconv.load_pretrain("vit_t16", 8, 12, str(tmp_path))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_load_pretrain_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="vit_base_patch16_224_in21k"):
        tconv.load_pretrain("vit-b16", 8, 12, str(tmp_path))
    with pytest.raises(ValueError, match="Unsupported backbone"):
        tconv.load_pretrain("vit-h14", 8, 12, str(tmp_path))


@pytest.mark.parametrize("method", ["gaviko", "fft"])
def test_same_keys_land_and_drop_as_jax(timm_state, method):
    cfg = {**TINY, **METHODS[method], "method": method}
    conv = tconv.convert_timm_state(timm_state, 8, 12)
    jm, tm = jax_build_model(cfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), jm.spec)
    tp = tm.init(torch.Generator().manual_seed(0), tm.spec)
    assert set(jp) == set(tp)
    _, jmiss, junexp = jax_load_state_dict(jp, jconv.convert_timm_state(timm_state, 8, 12))
    loaded, tmiss, tunexp = load_state_dict(tp, conv)
    assert sorted(tmiss) == sorted(jmiss) and sorted(tunexp) == sorted(junexp)
    landed = set(conv) - set(tunexp)
    if method == "gaviko":
        assert all("to_qkv.bias" in k for k in tunexp) and len(tunexp) == 12
    else:  # the plain ViT's layers.* names miss every block key (PARITY #4)
        assert landed == {"cls_token", "pos_embedding", "conv_proj.0.weight",
                          "conv_proj.0.bias", "transformer.norm.weight",
                          "transformer.norm.bias"}
    for k in landed:
        np.testing.assert_array_equal(loaded[k].numpy(), conv[k], err_msg=k)
    for k in tmiss:
        assert torch.equal(loaded[k], tp[k]), k


@pytest.mark.parametrize("method", ["gaviko", "deep_vpt", "melo"])
def test_build_params_lands_what_jax_lands(pretrained_dir, method):
    cfg = {**TINY, **METHODS[method], "method": method}
    jm, tm = jax_build_model(cfg), build_model(cfg)
    init_j = jm.init(jax.random.PRNGKey(0), jm.spec)
    got = build_params(tm, torch.Generator().manual_seed(0), pretrained_dir=pretrained_dir,
                       require_pretrained=True)
    want = jax_build_params(jm, jax.random.PRNGKey(0), pretrained_dir=pretrained_dir,
                            require_pretrained=True)
    landed_j = {k for k in want
                if not np.array_equal(np.asarray(want[k]), np.asarray(init_j[k]))}
    prefix = {"deep_vpt": "vision_transformer.", "melo": "lora_vit."}.get(method, "")
    assert landed_j and all(k.startswith(prefix) for k in landed_j)
    for k in landed_j:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    init_t = tm.init(torch.Generator().manual_seed(0), tm.spec)
    landed_t = {k for k in got if not torch.equal(got[k], init_t[k])}
    assert landed_t == landed_j
    with pytest.raises(FileNotFoundError):
        build_params(tm, torch.Generator().manual_seed(0), pretrained_dir=REPO,
                     require_pretrained=True)


@pytest.mark.parametrize("backbone", sorted(tconv.TIMM_WIDTHS))
def test_synthetic_state_is_timms_inventory(backbone):
    """``synthetic_timm_state``: timm's in21k keys and shapes (two blocks
    here), the same values from the same seed, and a state both packages
    convert to the same keys and shapes."""
    dim, _ = tconv.TIMM_WIDTHS[backbone]
    state = tconv.synthetic_timm_state(backbone, seed=3, depth=2)
    assert len(state) == 10 + 12 * 2 and all(v.dtype == np.float32 for v in state.values())
    assert state["head.weight"].shape == (21843, dim)
    assert state["blocks.1.mlp.fc1.weight"].shape == (4 * dim, dim)
    assert state["blocks.1.attn.qkv.bias"].shape == (3 * dim,)
    assert abs(float(state["norm.weight"].mean()) - 1.0) < 0.01
    assert abs(float(state["blocks.0.norm2.bias"].mean())) < 0.01
    again = tconv.synthetic_timm_state(backbone, seed=3, depth=2)
    assert all(np.array_equal(state[k], again[k]) for k in state)
    got = tconv.convert_timm_state(state, 8, 12)
    want = jconv.convert_timm_state(state, 8, 12)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_convert_command(tmp_path, pretrained_dir, monkeypatch, capsys):
    """The command as a process (.npz out), and its main() in this one (.pt)."""
    src = os.path.join(pretrained_dir, "vit_tiny_patch16_224_in21k.pt")
    want = jconv.convert_timm_state(jconv._read_state_file(src), 8, 12)
    for out in ("conv.npz", "conv.pt"):
        args = [src, "--backbone", "vit-t16", "--out", str(tmp_path / out),
                "--num-patches", "8", "--depth-dim", "12"]
        if out.endswith(".npz"):
            res = subprocess.run([sys.executable, "-m", "gaviko_tpu_torch.weights.convert",
                                  *args], cwd=REPO, capture_output=True, text=True,
                                 timeout=120)
            assert res.returncode == 0, res.stderr
            stdout = res.stdout
        else:
            monkeypatch.setattr(sys, "argv", ["convert", *args])
            tconv.main()
            stdout = capsys.readouterr().out
        assert f"wrote {len(want)} tensors" in stdout
        if out.endswith(".npz"):
            with np.load(tmp_path / out) as z:
                got = {k: z[k] for k in z.files}
        else:
            got = {k: v.numpy() for k, v in torch.load(tmp_path / out).items()}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
