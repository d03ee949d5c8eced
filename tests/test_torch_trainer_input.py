"""PyTorch port: the trainer's input and starting weights against the JAX
package's ``run_training`` on the CPU.

A 3-step oracle in the paired-run style of ``tests/test_torch_trainer.py``:
a tiny GAViKO (vit-s16 widths, depth 2, frozen backbone), every dropout 0
(so JAX's model rng does not matter), ``data.loader: grain``,
``train.device_augment: true`` and a synthetic timm file in
``model.pretrained_dir``. Both packages load that file through their own
``build_params`` (the landed tensors must be bit-equal; the random-init
rest is JAX's, moved across), train one epoch of 3 steps on the same raw
volumes, and the port is fed JAX's per-step augmentation draws
(``split(fold_in(PRNGKey(seed), step))[1]``, the JAX step's ``aug_rng``).
Per-step CSV rows within 1e-5 and the trainable params within 2e-4.
"""

import copy
import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.cli import train as jcli_train
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.models.pretrained import build_params as jax_build_params
from gaviko_tpu.train import loop as jloop
from gaviko_tpu_torch.cli import train as tcli_train
from gaviko_tpu_torch.data.grain_pipeline import GrainLoader
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.models.pretrained import build_params
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.utils.logging import TRAIN_LOG_FIELDS
from gaviko_tpu_torch.weights import convert as tconv
from gaviko_tpu_torch.weights.from_jax import from_jax
from tests.test_end_to_end import make_synth_dataset, tiny_config
from tests.test_torch_augment import jax_draws

DEPTH, SEED = 2, 0
TS = "20260101_000000"
GAVIKO = dict(backbone="vit-s16", method="gaviko", freeze_vit=True, num_prompts=4,
              prompt_latent_dim=8, local_dim=8, local_k=[2, 2, 2], attn_drop=0.0,
              proj_drop=0.0, dropout=0.0, emb_dropout=0.0)


def jax_step_augment(seed):
    """The JAX step's augmentation draws of each global step."""
    base = jax.random.PRNGKey(seed)

    def augment(step, batch):
        _, aug_rng = jax.random.split(jax.random.fold_in(base, step))
        return jax_draws(aug_rng, batch)

    return augment


def _own_dirs(config, root, name):
    config = copy.deepcopy(config)
    config["utils"]["log_dir"] = os.path.join(root, name, "log")
    config["utils"]["results_dir"] = os.path.join(root, name, "outputs")
    config["train"]["save_dir"] = os.path.join(root, name, "weights")
    return config


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def paired_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer_input"))
    csv_path, volumes = make_synth_dataset(root)
    pretrained = os.path.join(root, "pretrained")
    os.makedirs(pretrained)
    # The blocks a depth-2 model reads, of timm's vit-s16 in21k inventory.
    np.savez(os.path.join(pretrained, "vit_small_patch16_224_in21k.npz"),
             **tconv.synthetic_timm_state("vit-s16", seed=7, depth=DEPTH))
    config = tiny_config(root, csv_path, volumes, method="gaviko", epochs=1)
    config["model"].update(GAVIKO, pretrained_dir=pretrained)
    config["data"].update(loader="grain", grain_processes=0)
    config["train"].update(device_augment=True)
    config["train"]["scheduler"]["max_lr"] = 3e-4
    jm, tm = (dataclasses.replace(m, spec=dataclasses.replace(m.spec, depth=DEPTH))
              for m in (jax_build_model(config["model"]), build_model(config["model"])))
    jp = {k: np.asarray(v) for k, v in jax_build_params(
        jm, jax.random.PRNGKey(SEED), pretrained_dir=pretrained,
        require_pretrained=True).items()}
    tp = build_params(tm, torch.Generator().manual_seed(SEED), pretrained_dir=pretrained,
                      require_pretrained=True)
    conv = tconv.load_pretrain("vit-s16", tm.spec.num_patches, tm.spec.frame_patch_size,
                               pretrained)
    landed = sorted(k for k in conv if k in tp)
    for k in tp:  # the random-init rest from JAX's init
        if k not in landed:
            tp[k] = from_jax({k: jp[k]})[k]
    jcfg, tcfg = _own_dirs(config, root, "jax"), _own_dirs(config, root, "port")
    jres = jloop.run_training(jcfg, jm, {k: jnp.asarray(v) for k, v in jp.items()},
                              jcli_train.make_loaders(jcfg), TS)
    loaders = tcli_train.make_loaders(tcfg)
    assert isinstance(loaders[0], GrainLoader) and loaders[0].processes == 0
    tres = tloop.run_training(tcfg, tm, tp, loaders, TS, step_augment=jax_step_augment(SEED))
    return dict(jp=jp, tp=tp, conv=conv, landed=landed, jres=jres, tres=tres,
                trainable=[k for k in jp if tm.trainable(k)])


def test_both_packages_load_the_same_timm_tensors(paired_run):
    landed, conv = paired_run["landed"], paired_run["conv"]
    assert len(landed) == 6 + 11 * DEPTH  # of 12 a block, the to_qkv bias drops
    for k in landed:
        np.testing.assert_array_equal(paired_run["jp"][k], conv[k], err_msg=k)
    final = paired_run["tres"]["params"]
    for k in landed:  # the frozen backbone ends as it started
        np.testing.assert_array_equal(final[k].numpy(), conv[k], err_msg=k)


def test_device_augmented_steps_match_jax(paired_run):
    jrows = _rows(paired_run["jres"]["csv_log"])
    trows = _rows(paired_run["tres"]["csv_log"])
    assert len(trows) == len(jrows) == 3 + 2  # 3 train steps and 2 val steps
    assert list(trows[0]) == TRAIN_LOG_FIELDS
    for jr, tr in zip(jrows, trows):
        for f in TRAIN_LOG_FIELDS:
            if f != "time_stamp":
                assert abs(float(tr[f]) - float(jr[f])) <= 1e-5, (f, tr[f], jr[f])
    draws = [jax_step_augment(SEED)(step, 2) for step in range(3)]
    assert any(bool(d.apply.any()) for d in draws) and any(bool(d.flip.any()) for d in draws)


def test_trained_params_match_jax(paired_run):
    keys = paired_run["trainable"]
    got, want = paired_run["tres"]["params"], paired_run["jres"]["params"]
    worst = max(float(np.max(np.abs(got[k].numpy() - np.asarray(want[k])))) for k in keys)
    assert worst <= 2e-4, worst
    moved = max(float(np.max(np.abs(np.asarray(want[k]) - paired_run["jp"][k])))
                for k in keys)
    assert moved > 0
