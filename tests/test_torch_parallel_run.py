"""PyTorch port: ``cli.train`` and the Predictor on a mesh of spawned gloo
ranks on the CPU (``tests/torch_parallel_ranks.py``).

``train.parallel`` runs of fft at vit-s16 (6 heads, 12 layers) on the
tiny synthetic dataset, with ``train.device_augment`` and dropout on: one
epoch of two steps of a global batch of 4 (the second half-padded, so a
data shard holds pad rows only), the topology in the config:

- one process (a 1 x 1 mesh), data=2 with ZeRO (grain loader threads, the
  flop count on the shard) and model=2 write resume files equal leaf by
  leaf (the JAX package's multi-host dry run's test: the same keys, shapes
  and dtypes, each leaf within MAE 1e-6) with the same progress, and CSV
  losses within its tolerance; only rank 0 writes;
- either resumes the other's file: one process from the data=2 file and
  data=2 from the one-process file train a second epoch to equal states;
- ``Predictor(mesh_shape=(1, 2))``: rank 0's logits (and after a reload)
  equal one process's, the other rank following.
"""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch

from gaviko_tpu_torch.cli.train import train
from gaviko_tpu_torch.serving import Predictor
from tests import torch_parallel_ranks as ranks
from tests.test_end_to_end import make_synth_dataset, tiny_config


def _config(root, data_dir, name, data=1, model=1, epochs=1, **train_over):
    csv_path, vols = data_dir
    cfg = tiny_config(os.path.join(root, name), csv_path, vols, method="fft", epochs=epochs)
    cfg["model"]["backbone"] = "vit-s16"
    cfg["data"]["batch_size"] = 4
    cfg["train"].update(device_augment=True, resume_save_interval_s=0, seed=3, **train_over)
    cfg["train"]["scheduler"]["max_lr"] = 3e-4  # the shipped configs' (gaviko_tpu.yaml)
    cfg["train"]["parallel"] = {"enabled": True, "data": data, "model": model, "zero": True}
    if data * model > 1:
        cfg["train"]["parallel"]["coordinator_address"] = f"file://{root}/{name}_store"
    return cfg


def _state(cfg):
    path = os.path.join(cfg["train"]["save_dir"], "experiments", "fft", "resume_state.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_state(a, b):
    assert set(a) == set(b)
    assert json.loads(bytes(a.pop("meta::json"))) == json.loads(bytes(b.pop("meta::json")))
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        mae = float(np.mean(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))))
        assert mae < 1e-6, (k, mae)


def _losses(path):
    with open(path) as f:
        return [float(r["train_step_loss"]) for r in csv.DictReader(f)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("par"))
    data_dir = make_synth_dataset(os.path.join(root, "data"), n_train=6, n_val=2)
    cfgs = {"dp": _config(root, data_dir, "dp", data=2, flops_calculation=True),
            "tp": _config(root, data_dir, "tp", model=2)}
    cfgs["dp"]["data"]["loader"] = "grain"
    started = {k: ranks.start(ranks.run_cli_rank, 2, os.path.join(root, f"{k}_ranks"), c)
               for k, c in cfgs.items()}
    cfgs["one"] = _config(root, data_dir, "one")
    one = train(cfgs["one"], "cpu")
    out = {k: ranks.join(h, timeout=240) for k, h in started.items()}
    out["one"] = [{"csv": one["csv_log"], "best": one["best_ckpt_path"]}]
    # Either resumes the other's file, for a second epoch.
    resumed = {"one": _config(root, data_dir, "one_from_dp", epochs=2),
               "dp": _config(root, data_dir, "dp_from_one", data=2, epochs=2)}
    for k, src in (("one", "dp"), ("dp", "one")):
        dst = os.path.join(resumed[k]["train"]["save_dir"], "experiments", "fft")
        os.makedirs(dst)
        shutil.copy(os.path.join(cfgs[src]["train"]["save_dir"], "experiments", "fft",
                                 "resume_state.npz"), dst)
        resumed[k]["train"]["resume"] = "auto"
    handle = ranks.start(ranks.run_cli_rank, 2, os.path.join(root, "resumed_ranks"),
                         resumed["dp"])
    train(resumed["one"], "cpu")
    ranks.join(handle, timeout=240)
    return cfgs, out, resumed


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_mesh_resume_file_equals_one_process(runs, mesh):
    cfgs, out, _ = runs
    _assert_same_state(_state(cfgs[mesh]), _state(cfgs["one"]))
    np.testing.assert_allclose(_losses(out[mesh][0]["csv"]), _losses(out["one"][0]["csv"]),
                               rtol=2e-5, atol=1e-6)
    assert out[mesh][1] == {"csv": None, "best": None}  # rank 1 wrote nothing
    assert os.path.basename(out[mesh][0]["best"]) == os.path.basename(out["one"][0]["best"])


def test_either_run_resumes_the_others_file(runs):
    _, _, resumed = runs
    a, b = _state(resumed["one"]), _state(resumed["dp"])
    assert json.loads(bytes(a["meta::json"]))["epoch"] == 2
    _assert_same_state(a, b)


def test_mesh_predictor_matches_one_process(tmp_path):
    csv_path, vols = make_synth_dataset(str(tmp_path / "data"), n_train=2, n_val=1)
    cfg = _config(str(tmp_path), (csv_path, vols), "serve")
    volumes = [np.load(os.path.join(vols, f))["data"] for f in sorted(os.listdir(vols))]
    handle = ranks.start(ranks.mesh_serve_rank, 2, str(tmp_path / "ranks"), cfg, volumes, (1, 2))
    want = Predictor(cfg, batch_size=2, dtype="float32", pretrained_dir=None,
                     device="cpu").predict_logits(volumes)
    got = ranks.join(handle, timeout=120)[0]
    np.testing.assert_allclose(got[0], want, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[1], got[0])
    with pytest.raises(RuntimeError, match="exactly 4 ranks"):
        Predictor(cfg, batch_size=2, dtype="float32", pretrained_dir=None,
                  mesh_shape=(2, 2), device="cpu")


def test_zero_collectives_native_and_built_from_all_reduce_agree(tmp_path):
    """Reduce-scatter and all-gather of ZeRO's slices (mixed dtypes, axes 0
    to 2, one bucket a dtype), on gloo's native collectives and as built
    from all_reduce, equal the whole sum's slices and the whole sum."""
    from gaviko_tpu_torch.parallel.mesh import zero_axis

    shapes = [(4, 6), (3, 8), (5, 2, 4), (8,), (2, 3, 10), (6, 4)]
    res = ranks.spawn(ranks.collectives_rank, 2, str(tmp_path), shapes)
    whole = [res[0][0][i] + res[1][0][i] for i in range(len(shapes))]
    for d, (_, out) in enumerate(res):
        for path in ("native", "all_reduce"):
            parts, full = out[path]
            for i, s in enumerate(shapes):
                a = zero_axis(s, 2)
                n = s[a] // 2
                assert parts[i].dtype == res[d][0][i].dtype and parts[i].is_contiguous()
                assert torch.equal(parts[i], whole[i].narrow(a, d * n, n)), (path, s)
                assert torch.equal(full[i], whole[i]), (path, s)
