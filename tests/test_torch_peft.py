"""PyTorch port: the PEFT zoo (deep and shallow VPT, AdaptFormer, SSF, MeLO,
DVPT, EVP) against the JAX package on the CPU.

Tiny geometry (vit-s16, 24x32x32, fp32, B2), depth cut to 3 on both sides
(two full layers and, where the method has one, the CLS-fast last one),
``freeze_vit: true`` as shipped. Deep VPT runs 2 prompts at ``prompt_dim``
4, so its stream shrinks 11 -> 9 -> 7 rows; MeLO takes r 3 and alpha 7, so
its ``alpha // r`` scaling (2, not 2.33) shows. Weights cross from the JAX
package through ``weights/from_jax.py``; the branches that start switched
off (AdaptFormer's adapter up-projection, MeLO's LoRA B, DVPT's gate) are
filled with random values first, so that a port without them would fail.
For each method:

- the key names and shapes of ``init``, its zeros, and the trainable mask
  (``freeze_vit`` true and false) equal JAX's;
- logits within MAE 1e-4 of JAX's XLA route and within 1e-5 of its kernel
  route (``set_default_impl("flash")``, the Pallas kernels in interpret
  mode), where each kernel wrapper runs as often as
  ``chip_smoke.zoo_launches`` says the kernels launch on the card;
- in bf16, the logits' dtype equals JAX's (f32 for EVP, whose f32 FFT
  feature promotes its stream; bf16 elsewhere) and the values are within
  2e-2 relative MAE of JAX's;
- int8: ``quantize_backbone``'s sidecar keys equal JAX's and the int8
  logits are within 1e-2 relative MAE of JAX's (the budget of
  ``tests/test_torch_int8.py``), with each kernel wrapper run as
  ``chip_smoke.zoo_launches(..., quantized=True)`` says; both packages
  refuse SSF, the port with JAX's warning.

Also ``ssf_ada``'s two branches and its error, ``fft_highpass`` against
JAX's (a bf16 volume gives f32 in both), every method of ``config.METHODS``
built with JAX's pretrained-key prefix and taken by each CLI's
``--method``, ``Predictor`` against JAX's for shallow VPT and EVP (full
depth), MeLO with a subset of LoRA layers, and deep VPT at ``prompt_dim``
64 and EVP at vit-b16 on the full 120x160x160 geometry, depth 2.
"""

import dataclasses
import functools
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from gaviko_tpu.core.layers import ssf_ada as jax_ssf_ada
from gaviko_tpu.models import evp as jevp
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.models.pretrained import pretrained_key_prefix as jax_prefix
from gaviko_tpu.ops import attention as jattn
from gaviko_tpu.ops import int8_linear as jq
from gaviko_tpu.serving import Predictor as JaxPredictor
from gaviko_tpu_torch.config import METHODS
from gaviko_tpu_torch.core import vit as tvit
from gaviko_tpu_torch.core.layers import ssf_ada
from gaviko_tpu_torch.models import evp as tevp
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.models.pretrained import pretrained_key_prefix
from gaviko_tpu_torch.ops import flash_attention as tfa
from gaviko_tpu_torch.ops import fused_mlp as tmlp
from gaviko_tpu_torch.ops import int8_linear as tq
from gaviko_tpu_torch.ops import ln_linear as tln
from gaviko_tpu_torch.ops import patchify as tpatch
from gaviko_tpu_torch.serving import Predictor
from gaviko_tpu_torch.train import fused_optim
from gaviko_tpu_torch.weights.from_jax import from_jax

ZOO = ["deep_vpt", "shallow_vpt", "adaptformer", "ssf", "melo", "dvpt", "evp"]
TINY = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
            num_classes=5, channels=1, pool="cls", backbone="vit-s16", freeze_vit=True,
            dropout=0.1, emb_dropout=0.1)
EXTRA = {"deep_vpt": dict(num_prompts=2, prompt_dim=4, prompt_dropout=0.1),
         "shallow_vpt": dict(num_prompts=3, prompt_dim=4, prompt_dropout=0.1),
         "adaptformer": {}, "ssf": {}, "melo": dict(r=3, alpha=7),
         "dvpt": dict(num_prompts=5, pool="mean"), "evp": dict(scale_factor=4)}
SHAPE = (2, 1, 24, 32, 32)
DEPTH = 3
# Tensors the methods initialise to zero, which switch their branch off.
SWITCHED_OFF = ("up_adapter_proj", "linear_b_", "prompt_gate")


def cfg_of(method: str, **over) -> dict:
    return {**TINY, **EXTRA[method], "method": method, **over}


def models(cfg: dict, depth=DEPTH):
    jm, tm = jax_build_model(cfg), build_model(cfg)
    if depth is not None:
        jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=depth))
        tm = dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, depth=depth))
    return jm, tm


def jax_init(jm) -> dict:
    return {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}


@functools.lru_cache(maxsize=None)
def _zoo_init(method: str) -> dict:
    return jax_init(models(cfg_of(method))[0])


def jax_params(jm, init=None) -> dict:
    """JAX's init (seed 0, or ``init``) with the switched-off tensors filled
    with random values."""
    jp = dict(jax_init(jm) if init is None else init)
    rng = np.random.RandomState(100)
    for k in jp:
        if any(s in k for s in SWITCHED_OFF):
            jp[k] = (0.05 * rng.randn(*jp[k].shape)).astype(np.float32)
    return jp


def zoo_params(method: str) -> dict:
    """``jax_params`` of a method's own configuration (its init cached)."""
    return jax_params(None, _zoo_init(method))


def volume(seed: int = 1, shape=SHAPE) -> np.ndarray:
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


# Each kernel wrapper by the function that launches its kernel on the card
# (the plain version on the CPU), as chip_smoke's counters name them.
LAUNCH_SITES = {"patchify": (tpatch, "patchify_kernel"), "fused_mhsa": (tfa, "_mhsa_forward"),
                "fused_mhsa_bwd": (tfa, "fused_mhsa_bwd"),
                "ln_linear": (tln, "_ln_linear_forward"), "ln_linear_bwd": (tln, "ln_linear_bwd"),
                "fused_mlp": (tmlp, "fused_mlp_forward"), "fused_mlp_bwd": (tmlp, "fused_mlp_bwd"),
                "cls_attention": (tvit, "cls_attention"), "flash_attention": (tfa, "_flash_forward"),
                "fused_adam": (fused_optim, "fused_adam"), "int8_linear": (tvit, "int8_linear"),
                "int8_mlp": (tvit, "int8_mlp")}


def count_launches(monkeypatch) -> dict:
    """Counts the calls of each launch site from now on."""
    counts = dict.fromkeys(LAUNCH_SITES, 0)
    for name, (module, attr) in LAUNCH_SITES.items():
        fn = getattr(module, attr)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, attr, counted)
    return counts


def expected_launches(spec, dtype, train: bool) -> dict:
    want = chip_smoke.zoo_launches(spec, dtype, train)
    return {k: want[k] for k in LAUNCH_SITES}


@pytest.mark.parametrize("method", METHODS)
def test_build_model_builds_every_method(method):
    cfg = {**TINY, "method": method}
    if method in EXTRA:
        cfg.update(EXTRA[method])
    tm = build_model(cfg)
    assert tm.spec.method == method and callable(tm.apply) and callable(tm.init)
    assert pretrained_key_prefix(method) == jax_prefix(method)


@pytest.mark.parametrize("cli", ["train", "evaluate", "infer", "serve"])
def test_cli_method_choices_reach_every_method(cli, capsys):
    """Each CLI's ``--method`` takes every method of ``config.METHODS``
    (argparse checks the choice before ``--help`` exits)."""
    import importlib

    main = importlib.import_module(f"gaviko_tpu_torch.cli.{cli}").main
    for method in METHODS:
        with pytest.raises(SystemExit) as exit_:
            main(["--method", method, "--help"])
        assert exit_.value.code == 0, (cli, method)
    with pytest.raises(SystemExit) as exit_:
        main(["--method", "vpt", "--help"])
    assert exit_.value.code == 2
    capsys.readouterr()


@pytest.mark.parametrize("method", ["shallow_vpt", "evp"])
def test_predictor_serves_like_the_jax_predictor(tmp_path, method):
    """``Predictor`` of a wrapped (``vision_transformer.``) and an FFT
    method, fp32 at full depth, from a checkpoint of JAX's params, against
    JAX's ``Predictor`` on the same volumes."""
    config = {"model": cfg_of(method)}
    jm = jax_build_model(config["model"])
    ckpt = str(tmp_path / f"{method}.npz")
    np.savez(ckpt, **jax_params(jm))
    kw = dict(checkpoint=ckpt, batch_size=2, dtype="float32", pretrained_dir=None)
    vols = [volume(10 + i, (24, 32, 32)) for i in range(3)]
    got = Predictor(config, device="cpu", **kw).predict_logits(vols)
    want = JaxPredictor(config, **kw).predict_logits(vols)
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("method", ZOO)
def test_init_keys_shapes_and_zeros_match_jax(method):
    _, tm = models(cfg_of(method))
    jp = _zoo_init(method)
    tp = tm.init(torch.Generator().manual_seed(0), tm.spec)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    for k, v in jp.items():
        if not v.any():  # zeros in JAX's init (the switched-off branches too)
            assert not tp[k].any(), k
    if method == "evp":  # the truncated normal stays within [-2, 2] at std 0.02
        w = tp["prompt_generator.shared_mlp.weight"]
        assert 0.015 < float(w.std()) < 0.025 and float(w.abs().max()) <= 2.0


@pytest.mark.parametrize("freeze", [True, False])
@pytest.mark.parametrize("method", ZOO)
def test_trainable_mask_matches_jax(method, freeze):
    jm, tm = models(cfg_of(method, freeze_vit=freeze))
    names = dict.fromkeys(_zoo_init(method))  # freeze_vit changes no name
    assert tm.trainable_mask(names) == jm.trainable_mask(names)
    assert any(tm.trainable_mask(names).values())


@pytest.fixture(scope="module", params=ZOO)
def zoo_case(request):
    """One method's JAX params (branches switched on), volume and JAX's XLA
    and kernel-route logits."""
    method = request.param
    jm, tm = models(cfg_of(method))
    jp = zoo_params(method)
    x = volume()
    xla = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jp, jnp.asarray(x)))
    jattn.set_default_impl("flash")
    try:
        kernel = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jp, jnp.asarray(x)))
    finally:
        jattn.set_default_impl("xla")
    return dict(method=method, jm=jm, tm=tm, jp=jp, x=x, xla=xla, kernel=kernel)


def test_logits_match_jax_xla_route(zoo_case):
    tm = zoo_case["tm"]
    got = tm.apply(from_jax(zoo_case["jp"]), torch.from_numpy(zoo_case["x"]), tm.spec).numpy()
    assert got.shape == zoo_case["xla"].shape == (2, 5)
    assert np.abs(got - zoo_case["xla"]).mean() < 1e-4, np.abs(got - zoo_case["xla"]).mean()


def test_logits_match_jax_kernel_route(zoo_case, monkeypatch):
    """The port's wrappers (plain versions on the CPU) against JAX's Pallas
    kernels in interpret mode; each wrapper runs as often as its kernel
    launches on the card."""
    tm = zoo_case["tm"]
    counts = count_launches(monkeypatch)
    got = tm.apply(from_jax(zoo_case["jp"]), torch.from_numpy(zoo_case["x"]), tm.spec).numpy()
    assert np.abs(got - zoo_case["kernel"]).mean() <= 1e-5, \
        np.abs(got - zoo_case["kernel"]).mean()
    assert counts == expected_launches(tm.spec, torch.float32, False)


def test_bf16_logits_match_jax_dtype(zoo_case, monkeypatch):
    """bf16 params and volume: the logits' dtype is JAX's (EVP's f32 FFT
    feature turns its stream f32), the values within 2e-2 relative, and the
    kernel wrappers run as the bf16 serving path launches them."""
    jm, tm = zoo_case["jm"], zoo_case["tm"]
    jp16 = {k: jnp.asarray(v, jnp.bfloat16) for k, v in zoo_case["jp"].items()}
    want = jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(
        jp16, jnp.asarray(zoo_case["x"], jnp.bfloat16))
    counts = count_launches(monkeypatch)
    got = tm.apply(from_jax(zoo_case["jp"], dtype=torch.bfloat16),
                   torch.from_numpy(zoo_case["x"]).bfloat16(), tm.spec)
    assert counts == expected_launches(tm.spec, torch.bfloat16, False)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert (got.dtype == torch.float32) == (zoo_case["method"] == "evp")
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 2e-2


def test_int8_sidecars_and_logits_match_jax(zoo_case, monkeypatch, caplog):
    """``quantize_backbone`` adds JAX's sidecar keys (none for SSF, which
    both refuse, the port with JAX's warning), the int8 logits stay within
    1e-2 of JAX's, and the kernel wrappers run as the int8 serving path
    launches them (``zoo_launches(..., quantized=True)``)."""
    jm, tm, jp, x = zoo_case["jm"], zoo_case["tm"], zoo_case["jp"], zoo_case["x"]
    jq8 = {k: np.asarray(v) for k, v in jq.quantize_backbone(
        {k: jnp.asarray(v) for k, v in jp.items()}).items()}
    with caplog.at_level(logging.WARNING):
        tq8 = tq.quantize_backbone(from_jax(jp), tm.spec.depth)
    ssf = zoo_case["method"] == "ssf"
    assert ("int8 quantization is not supported for SSF models" in caplog.text) == ssf
    assert sorted(tq8) == sorted(jq8)
    assert (len(tq8) == len(jp)) == ssf
    want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jq8, jnp.asarray(x)))
    counts = count_launches(monkeypatch)
    with torch.no_grad():
        got = tm.apply(tq8, torch.from_numpy(x), tm.spec).numpy()
    assert _rel(got, want) <= 1e-2
    launches = chip_smoke.zoo_launches(tm.spec, torch.float32, False, quantized=True)
    assert counts == {k: launches[k] for k in LAUNCH_SITES}
    assert (launches["int8_linear"] > 0) != ssf


@pytest.mark.parametrize("case", ["last_dim", "dim_1", "mismatch"])
def test_ssf_ada_branches_match_jax(case):
    rng = np.random.RandomState(7)
    shape = {"last_dim": (2, 5, 6), "dim_1": (2, 6, 3, 4), "mismatch": (2, 5, 7)}[case]
    x = rng.randn(*shape).astype(np.float32)
    scale, shift = (rng.randn(6).astype(np.float32) for _ in range(2))
    if case == "mismatch":
        with pytest.raises(ValueError, match="does not match"):
            ssf_ada(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift))
        with pytest.raises(ValueError, match="does not match"):
            jax_ssf_ada(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
        return
    got = ssf_ada(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift))
    want = jax_ssf_ada(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fft_highpass_matches_jax(dtype):
    """The high-pass over the shifted spectrum, the mask on dims (2, 3) with
    (H, W) extents, the shifts over every axis; a bf16 volume gives f32."""
    x = volume(3, (2, 1, 12, 16, 20))
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jevp.fft_highpass(jx, 0.25)
    got = tevp.fft_highpass(tx, 0.25)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_melo_lora_subset_matches_jax():
    """``lora_layers: [1]``: layer 1 carries the nested ``to_qkv.qkv`` name
    and its LoRA factors, layers 0 and 2 the plain name (the last one
    through the CLS-fast branch)."""
    jm, tm = models(cfg_of("melo", lora_layers=[1]))
    jp = jax_params(jm)
    assert {k for k in jp if "to_qkv" in k and "linear" not in k} == {
        "lora_vit.transformer.layers.0.0.to_qkv.weight",
        "lora_vit.transformer.layers.1.0.to_qkv.qkv.weight",
        "lora_vit.transformer.layers.2.0.to_qkv.weight"}
    x = volume(4)
    want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jp, jnp.asarray(x)))
    got = tm.apply(from_jax(jp), torch.from_numpy(x), tm.spec).numpy()
    assert np.abs(got - want).mean() < 1e-4


@pytest.mark.parametrize("method", ["deep_vpt", "evp"])
def test_full_geometry_vit_b16_matches_jax(method):
    """vit-b16 on the 120x160x160 volume, depth 2, B1: deep VPT at the
    shipped ``prompt_dim`` 64 and 8 prompts (1,009 rows, then 961), EVP at
    ``scale_factor`` 4 (192 hand-crafted columns)."""
    over = dict(image_size=160, frames=120, backbone="vit-b16")
    over.update(dict(num_prompts=8, prompt_dim=64) if method == "deep_vpt" else {})
    jm, tm = models(cfg_of(method, **over), depth=2)
    jp = jax_params(jm)
    x = volume(5, (1, 1, 120, 160, 160))
    want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, jm.spec))(jp, jnp.asarray(x)))
    got = tm.apply(from_jax(jp), torch.from_numpy(x), tm.spec).numpy()
    assert np.abs(got - want).mean() < 1e-4
    if method == "evp":
        assert jp["prompt_generator.embedding_generator.weight"].shape == (192, 768)
