"""PyTorch port: the trainer and the CLIs against the JAX package on the CPU.

``run_training`` of both packages from the same initial params, on the same
synthetic .npz volumes and CSV (tests/test_end_to_end.py), 2 epochs at the
tiny 24x32x32 geometry, depth 2, with dropout on and the port fed the JAX
run's per-step dropout seeds (``RngStream(fold_in(PRNGKey(seed), step))``),
at the step oracles' 3e-4 peak lr (3e-3 under pure_bf16):

- ``bitfit`` vit-t16, GAViKO (vit-s16 widths, frozen backbone), bitfit with
  ``accumulation_steps: 2`` and bitfit with ``precision: pure_bf16``;
- every CSV row (15 fields): losses and the other numeric fields within
  1e-5, the time stamp equal; the best checkpoint's name equal;
- the final trainable params within 1e-6, and each run's update (final
  params less initial ones) against JAX's: the mean absolute difference
  over every trainable element within 1e-5 of JAX's mean absolute update.
  A run whose optimizer applied nothing scores 1 there. The f32 runs
  measured 3.2e-7 (CSV), 6.0e-8 (params) and 7.6e-7 (update) at most, for
  a run's whole movement of ~5e-4 a param; with the update skipped they
  score 8.3e-3 (CSV) and 1.
- pure_bf16 computes, stores and updates in bf16 in both packages, with
  bf16 rounding at other places (XLA fuses and keeps intermediates in f32
  where eager PyTorch rounds each op), so Adam's sign-driven steps part on
  elements whose gradients are near zero, one bf16 step at a time. Its
  lr is 3e-3, so that a run moves a param by ~4.5e-3 on average (several
  bf16 ULPs of the near-zero biases; at 3e-4 a param near 0.25 moves less
  than one). Its budgets: CSV rows 1e-3 and the update 2e-2 (measured
  2.5e-4 and 4.4e-3; with the update skipped 9.2e-2 and 1). The params'
  largest difference is no test there: single bf16 elements part by up
  to 4.6e-3 of a movement of 7.3e-3.

Then the port alone: an epoch-boundary resume at epoch 2 of 4 and a
mid-epoch preemption resume, each bit-equal to the uninterrupted run; and the
``train`` -> ``evaluate`` -> ``infer`` CLIs (``--device cpu``), whose files
and metrics equal JAX's ``evaluate`` and ``inference`` on the same
checkpoint, ``evaluate --quantize int8`` too.
"""

import copy
import csv
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from gaviko_tpu.cli import evaluate as jcli_eval
from gaviko_tpu.cli import infer as jcli_infer
from gaviko_tpu.cli import train as jcli_train
from gaviko_tpu.core.layers import RngStream
from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.train import loop as jloop
from gaviko_tpu_torch.cli import evaluate as tcli_eval
from gaviko_tpu_torch.cli import infer as tcli_infer
from gaviko_tpu_torch.cli import train as tcli_train
from gaviko_tpu_torch.models.factory import build_model
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.utils.logging import TRAIN_LOG_FIELDS
from gaviko_tpu_torch.weights.from_jax import from_jax
from tests.test_end_to_end import make_synth_dataset, tiny_config

DEPTH = 2
TS = "20260101_000000"
GAVIKO = dict(backbone="vit-s16", method="gaviko", freeze_vit=True, num_prompts=4,
              prompt_latent_dim=8, local_dim=8, local_k=[2, 2, 2], attn_drop=0.2,
              proj_drop=0.2)
# name -> (model overrides, train overrides, peak lr, CSV budget, param budget,
#          update budget); no param budget under pure_bf16 (module docstring)
RUNS = {
    "bitfit": ({}, {}, 3e-4, 1e-5, 1e-6, 1e-5),
    "gaviko": (GAVIKO, {}, 3e-4, 1e-5, 1e-6, 1e-5),
    "accum2": ({}, {"accumulation_steps": 2}, 3e-4, 1e-5, 1e-6, 1e-5),
    "pure_bf16": ({}, {"precision": "pure_bf16"}, 3e-3, 1e-3, None, 2e-2),
}


def jax_step_seeds(seed: int, n: int = 64):
    """The JAX run's dropout seeds of each global step."""
    base = jax.random.PRNGKey(seed)

    def seeds(step):
        rs = RngStream(jax.random.fold_in(base, step))
        return [int(rs.next_seed()) for _ in range(n)]

    return seeds


def _config(root, method="bitfit", model_over=None, train_over=None, epochs=2,
            max_lr=3e-4):
    csv_path = os.path.join(root, "labels.csv")
    volumes = os.path.join(root, "volumes")
    if not os.path.exists(csv_path):
        make_synth_dataset(root)
    config = tiny_config(root, csv_path, volumes, method=method, epochs=epochs)
    # The step oracles' schedule (tests/test_torch_train.py) by default:
    # tiny_config's 0.3 turns a 1e-7 gradient difference on a near-zero
    # element into Adam's full step.
    config["train"]["scheduler"]["max_lr"] = max_lr
    config["model"].update(model_over or {})
    config["train"].update(train_over or {})
    return config


def _own_dirs(config, root, name):
    config = copy.deepcopy(config)
    config["utils"]["log_dir"] = os.path.join(root, name, "log")
    config["utils"]["results_dir"] = os.path.join(root, name, "outputs")
    config["train"]["save_dir"] = os.path.join(root, name, "weights")
    return config


def _models(model_cfg):
    jm, tm = jax_build_model(model_cfg), build_model(model_cfg)
    jm = dataclasses.replace(jm, spec=dataclasses.replace(jm.spec, depth=DEPTH))
    tm = dataclasses.replace(tm, spec=dataclasses.replace(tm.spec, depth=DEPTH))
    return jm, tm


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module", params=sorted(RUNS))
def paired_run(request, tmp_path_factory):
    """Both packages' run_training from the same params, data and seeds."""
    name = request.param
    model_over, train_over, max_lr, loss_budget, param_budget, update_budget = RUNS[name]
    root = str(tmp_path_factory.mktemp(name))
    config = _config(root, model_over=model_over, train_over=train_over, max_lr=max_lr)
    jm, tm = _models(config["model"])
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}
    # Every synthetic label is 2: a head bias toward it makes epoch 1's
    # validation accuracy rise above 0, so the best checkpoint is written.
    bias = next(k for k in jp if "head" in k and k.endswith("bias"))
    jp[bias] = jp[bias] + np.float32(4.0) * (np.arange(5) == 2)
    jcfg, tcfg = _own_dirs(config, root, "jax"), _own_dirs(config, root, "port")
    jres = jloop.run_training(jcfg, jm, {k: jnp.asarray(v) for k, v in jp.items()},
                              jcli_train.make_loaders(jcfg), TS)
    tres = tloop.run_training(tcfg, tm, from_jax(jp), tcli_train.make_loaders(tcfg), TS,
                              step_seeds=jax_step_seeds(0))
    trainable = [k for k in jp if tm.trainable(k)]
    # The initial params as both runs hold them: cast to bf16 once under pure_bf16.
    cast = (lambda v: torch.from_numpy(v).bfloat16().float().numpy()) \
        if name == "pure_bf16" else (lambda v: v)
    return dict(name=name, jres=jres, tres=tres, trainable=trainable,
                init={k: cast(jp[k]) for k in trainable}, loss_budget=loss_budget,
                param_budget=param_budget, update_budget=update_budget)


def test_run_training_csv_rows_match_jax(paired_run):
    jrows, trows = _rows(paired_run["jres"]["csv_log"]), _rows(paired_run["tres"]["csv_log"])
    assert len(trows) == len(jrows) == 2 * (3 + 2)  # 2 epochs x (3 train + 2 val) rows
    assert list(trows[0]) == TRAIN_LOG_FIELDS
    budget = paired_run["loss_budget"]
    for jr, tr in zip(jrows, trows):
        assert tr["time_stamp"] == jr["time_stamp"] == TS
        for f in TRAIN_LOG_FIELDS:
            if f != "time_stamp":
                assert abs(float(tr[f]) - float(jr[f])) <= budget, (f, tr[f], jr[f])


def test_run_training_final_params_match_jax(paired_run):
    """The final trainable params, and the update each package applied over
    the run against JAX's (relative mean absolute difference: 1 for an
    optimizer that applied nothing)."""
    keys, init = paired_run["trainable"], paired_run["init"]
    got = {k: paired_run["tres"]["params"][k].float().numpy() for k in keys}
    want = {k: np.asarray(paired_run["jres"]["params"][k]).astype(np.float32) for k in keys}
    if paired_run["param_budget"] is not None:
        worst = max(float(np.max(np.abs(got[k] - want[k]))) for k in keys)
        assert worst <= paired_run["param_budget"], worst
    d_got = np.concatenate([(got[k] - init[k]).ravel() for k in keys])
    d_want = np.concatenate([(want[k] - init[k]).ravel() for k in keys])
    moved = float(np.mean(np.abs(d_want)))
    assert moved > 0
    rel = float(np.mean(np.abs(d_got - d_want))) / moved
    assert rel <= paired_run["update_budget"], (rel, moved)
    if paired_run["name"] == "pure_bf16":
        assert all(paired_run["tres"]["params"][k].dtype == torch.bfloat16 for k in keys)


def test_run_training_best_checkpoint_matches_jax(paired_run):
    jpath, tpath = paired_run["jres"]["best_ckpt_path"], paired_run["tres"]["best_ckpt_path"]
    assert jpath and tpath and os.path.basename(tpath) == os.path.basename(jpath)
    saved = torch.load(tpath, weights_only=True)
    assert sorted(saved) == sorted(paired_run["trainable"])  # trainable-only (PARITY #14)
    assert paired_run["tres"]["best_val_acc"] == paired_run["jres"]["best_val_acc"]


# ------------------------------------------------------ resume (port) ----

class _SignalAt:
    """Wraps a loader; sends this process SIGTERM before yielding batch
    ``batch`` of its ``epoch``-th iteration (counted from 0)."""

    def __init__(self, inner, epoch, batch):
        self.inner, self.epoch, self.batch, self.seen = inner, epoch, batch, 0

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, e):
        self.inner.set_epoch(e)

    def skip_batches(self, k):
        self.inner.skip_batches(k)

    def __iter__(self):
        epoch, self.seen = self.seen, self.seen + 1
        for i, item in enumerate(self.inner):
            if epoch == self.epoch and i == self.batch:
                os.kill(os.getpid(), signal.SIGTERM)
            yield item


def _resume_state(config):
    path = os.path.join(config["train"]["save_dir"], "experiments", "bitfit",
                        "resume_state.npz")
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files if k != "meta::json"}, \
            json.loads(bytes(z["meta::json"]).decode())


def _port_run(config, wrap=None):
    _, tm = _models(config["model"])
    params = tm.init(torch.Generator().manual_seed(0), tm.spec)
    tr, va, tl, vl = tcli_train.make_loaders(config)
    if wrap is not None:
        tr, va = wrap(tr, va)
    return tloop.run_training(config, tm, params, (tr, va, tl, vl), TS)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume"))
    config = _own_dirs(_config(root, epochs=4, train_over={"h2d_prefetch": False}), root, "A")
    result = _port_run(config)
    assert not result["preempted"]
    return root, _resume_state(config)


@pytest.mark.parametrize("where", ["epoch_boundary", "mid_epoch"])
def test_preempted_and_resumed_run_is_bit_equal(uninterrupted, where):
    """Preempted at the end of epoch 2 of 4 (the signal lands during its
    validation) or during batch 2 of epoch 1, then resumed with ``resume:
    auto``: the final params and optimizer state equal the uninterrupted
    run's bit for bit."""
    root, (want, want_meta) = uninterrupted
    config = _own_dirs(_config(root, epochs=4, train_over={"h2d_prefetch": False}), root,
                       where)
    if where == "epoch_boundary":
        def wrap(tr, va):
            return tr, _SignalAt(va, epoch=1, batch=0)
    else:
        def wrap(tr, va):
            return _SignalAt(tr, epoch=1, batch=2), va
    first = _port_run(config, wrap)
    assert first["preempted"]
    _, meta = _resume_state(config)
    assert (meta["epoch"], meta["step_in_epoch"]) == ((2, 0) if where == "epoch_boundary"
                                                      else (1, 3))
    config["train"]["resume"] = "auto"
    second = _port_run(config)
    assert not second["preempted"]
    rows = _rows(second["csv_log"])
    assert int(rows[0]["epoch"]) == meta["epoch"]
    got, got_meta = _resume_state(config)
    assert got_meta == want_meta
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resume_continues_a_finished_run_at_its_next_epoch(tmp_path):
    """The JAX package's 2 -> 4 epochs: a finished 2-epoch run resumed
    with num_epochs 4 trains epochs 2 and 3 only."""
    root = str(tmp_path)
    config = _own_dirs(_config(root, epochs=2), root, "run")
    _port_run(config)
    config["train"].update(num_epochs=4, resume="auto")
    result = _port_run(config)
    epochs = sorted({int(r["epoch"]) for r in _rows(result["csv_log"])})
    assert epochs == [2, 3]


# ------------------------------------------------------------ the CLIs ----

def test_cli_train_evaluate_infer_match_jax(tmp_path):
    """fft (every param in the checkpoint, so both packages evaluate one
    model) through ``python -m gaviko_tpu_torch.cli.*``'s main() with
    ``--device cpu``: the port writes the JAX package's files, and its
    metrics and predictions equal JAX's ``evaluate`` and ``inference`` on
    the port's checkpoint."""
    root = str(tmp_path)
    config = _config(root, method="fft")
    config["data"]["batch_size"] = 4
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    weights = os.path.join(root, "weights")
    result = tcli_train.main(["--config", path, "--method", "fft", "--results_dir", weights,
                              "--device", "cpu"])
    ckpt = result["best_ckpt_path"]
    assert os.path.basename(ckpt).startswith("fft_vit_t16_best_model_epoch")
    assert os.path.exists(os.path.join(weights, "experiments", "fft", "resume_state.npz"))
    assert os.path.basename(result["csv_log"]) == "fft_training_log_v1.csv"

    port_out, jax_out = os.path.join(root, "port_out"), os.path.join(root, "jax_out")
    got = tcli_eval.main(["--config", path, "--method", "fft", "--checkpoint", ckpt,
                          "--results_dir", port_out, "--device", "cpu"])
    jcfg = copy.deepcopy(config)
    jcfg["utils"].update(checkpoint=ckpt, results_dir=jax_out)
    want = jcli_eval.evaluate(jcfg)
    assert os.path.basename(got["csv"]) == os.path.basename(want["csv"]) \
        == "fft_vit_t16_eval_results_v1.csv"
    for key in ("accuracy", "kappa", "auc"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
    with open(got["csv"]) as a, open(want["csv"]) as b:
        assert a.read() == b.read()
    with open(got["csv"][:-4] + "_metrics.txt") as a:
        assert a.read().startswith("Test Accuracy: ")

    got_csv = tcli_infer.main(["--config", path, "--method", "fft", "--checkpoint", ckpt,
                               "--results_dir", port_out, "--device", "cpu"])
    want_csv = jcli_infer.inference(jcfg)
    assert os.path.basename(got_csv) == os.path.basename(want_csv) \
        == "fft_vit_t16_inference_results_v1.csv"
    with open(got_csv) as a, open(want_csv) as b:
        got_rows, want_rows = a.read(), b.read()
    assert got_rows == want_rows and len(got_rows.splitlines()) == 1 + 10

    # --quantize int8: the same checkpoint with the int8 backbone GEMMs in
    # both packages (the port's plain versions, JAX's kernels in interpret
    # mode) gives the same metrics and the same CSV.
    got = tcli_eval.main(["--config", path, "--method", "fft", "--checkpoint", ckpt,
                          "--results_dir", port_out, "--quantize", "int8", "--device", "cpu"])
    jcfg["utils"]["quantize"] = "int8"
    want = jcli_eval.evaluate(jcfg)
    assert os.path.basename(got["csv"]) == os.path.basename(want["csv"]) \
        == "fft_vit_t16_eval_results_v2.csv"
    for key in ("accuracy", "kappa", "auc"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
    with open(got["csv"]) as a, open(want["csv"]) as b:
        assert a.read() == b.read()


def test_cli_train_evaluate_infer_prefixed_method(tmp_path):
    """MeLO, whose params carry the ``lora_vit.`` prefix and, in its
    adapted layers, the nested ``to_qkv.qkv`` name, through the three CLIs
    (``--device cpu``): the trainable-only best checkpoint holds exactly the
    LoRA factors and the head under those names, ``evaluate`` and ``infer``
    overlay it onto the seed-0 backbone (every checkpoint tensor lands,
    nothing is left over) and write their files, and the JAX package's
    ``build_params`` loads the same checkpoint into its own MeLO. The
    labels are the class the untrained model predicts for the first val
    volume, so that epoch 1's validation accuracy is above 0 and the best
    checkpoint is written."""
    import csv as csv_mod

    from gaviko_tpu.models.pretrained import build_params as jax_build_params
    from gaviko_tpu_torch.weights.torch_io import load_checkpoint

    root = str(tmp_path)
    config = _config(root, method="melo")
    config["data"]["batch_size"] = 4
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    untrained = tcli_eval.main(["--config", path, "--method", "melo", "--results_dir",
                                os.path.join(root, "untrained"), "--device", "cpu"])
    label = int(_rows(untrained["csv"])[0]["outputs"])
    labels = os.path.join(root, "labels.csv")
    rows = _rows(labels)
    with open(labels, "w", newline="") as f:
        writer = csv_mod.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows({**r, "kl_grade": label} for r in rows)

    weights = os.path.join(root, "weights")
    result = tcli_train.main(["--config", path, "--method", "melo", "--results_dir", weights,
                              "--device", "cpu"])
    ckpt = result["best_ckpt_path"]
    assert ckpt and os.path.basename(ckpt).startswith("melo_vit_t16_best_model_epoch")
    saved = load_checkpoint(ckpt)
    model = build_model(config["model"])
    names = [k for k in model.init(torch.Generator().manual_seed(0), model.spec)
             if model.trainable(k)]
    assert sorted(saved) == sorted(names)
    assert all(k.startswith("lora_vit.") for k in saved)
    assert any(".to_qkv.linear_b_q." in k for k in saved)
    assert any(np.abs(np.asarray(v)).max() > 0 for k, v in saved.items() if "linear_b_" in k)

    _, trainable, frozen = tcli_eval.load_model({**config, "utils": {
        **config["utils"], "checkpoint": ckpt}}, torch.device("cpu"))
    assert sorted(trainable) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(trainable[k].numpy(), np.asarray(v), err_msg=k)
    assert "lora_vit.transformer.layers.0.0.to_qkv.qkv.weight" in frozen

    out = os.path.join(root, "port_out")
    got = tcli_eval.main(["--config", path, "--method", "melo", "--checkpoint", ckpt,
                          "--results_dir", out, "--device", "cpu"])
    assert os.path.basename(got["csv"]) == "melo_vit_t16_eval_results_v1.csv"
    assert len(_rows(got["csv"])) == 4 and 0.0 <= got["accuracy"] <= 1.0
    got_csv = tcli_infer.main(["--config", path, "--method", "melo", "--checkpoint", ckpt,
                               "--results_dir", out, "--device", "cpu"])
    assert os.path.basename(got_csv) == "melo_vit_t16_inference_results_v1.csv"
    assert len(_rows(got_csv)) == 10

    jm = jax_build_model(config["model"])
    jparams = jax_build_params(jm, jax.random.PRNGKey(0), pretrained_dir=None,
                               checkpoint_path=ckpt)
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(jparams[k]), np.asarray(v), err_msg=k)
