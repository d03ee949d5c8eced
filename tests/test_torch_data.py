"""PyTorch port: the data pipeline against the JAX package on the CPU.

The port's ``Loader`` and training transforms against JAX's on one
synthetic dataset: the same batch order, the same augmentation draws
(affine, flip and, with ``intensity_augs``, noise and blur), the same
``skip_batches`` and ``pad_to_batch`` behaviour, volumes bit-equal (the
port rescales with the arithmetic of the JAX package's C++ core). Also the
CSV reading and folder scan without pandas, the device prefetcher on the
CPU and ``pick_loader``'s dispatch.
"""

import functools
import os

import numpy as np
import pytest
import torch

from gaviko_tpu.data import pipeline as jpipe
from gaviko_tpu.data import transforms as jtf
from gaviko_tpu_torch.data import pipeline as tpipe
from gaviko_tpu_torch.data import transforms as ttf
from gaviko_tpu_torch.data.device_prefetch import DevicePrefetcher
from tests.test_torch_rescale import jax_core_loaded


@pytest.fixture(scope="module", autouse=True)
def jax_core():
    """The JAX package rescales on its C++ core (bit-equal batches)."""
    jax_core_loaded()


def _dataset(root, n=7, dhw=(12, 16, 16)):
    rng = np.random.RandomState(3)
    vols = os.path.join(root, "volumes")
    os.makedirs(vols)
    rows = ["mri_path,kl_grade,subset"]
    for i in range(n):
        name = f"v{i:02d}.npz"
        np.savez(os.path.join(vols, name), data=(rng.rand(*dhw) * 100).astype(np.float32))
        rows.append(f"{name},{i % 5},{'train' if i < n - 2 else 'val'}")
    csv_path = os.path.join(root, "labels.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_path, vols


@pytest.mark.parametrize("name", ["random_affine", "random_flip", "random_noise",
                                  "random_blur", "train_transform", "eval_transform"])
def test_transforms_match_jax(name):
    x = np.random.RandomState(1).rand(1, 12, 16, 16).astype(np.float32)
    for seed in range(6):  # both branches of every coin flip
        if name == "eval_transform":
            got, want = ttf.eval_transform(x), jtf.eval_transform(x)
        else:
            kw = {"intensity_augs": True} if name == "train_transform" else {}
            got = getattr(ttf, name)(x, np.random.RandomState(seed), **kw)
            want = getattr(jtf, name)(x, np.random.RandomState(seed), **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _loaders(tmp_path, batch=2, shuffle=True, pad=True, seed=4):
    import pandas as pd

    csv_path, vols = _dataset(str(tmp_path))
    tf_j = functools.partial(jtf.train_transform, intensity_augs=True)
    tf_t = functools.partial(ttf.train_transform, intensity_augs=True)
    jds = jpipe.dataset_from_dataframe(jpipe.split_dataframe(pd.read_csv(csv_path), "train"),
                                       tf_j, True, vols)
    tds = tpipe.dataset_from_dataframe(tpipe.split_dataframe(tpipe.read_csv(csv_path), "train"),
                                       tf_t, True, vols)
    assert tds.paths == jds.paths and np.array_equal(tds.labels, jds.labels)
    kw = dict(shuffle=shuffle, num_workers=2, seed=seed, pad_to_batch=pad)
    return jpipe.Loader(jds, batch, **kw), tpipe.Loader(tds, batch, **kw)


def _assert_same_epoch(jl, tl):
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb)
    for (jx, jy, jn), (tx, ty, tn) in zip(jb, tb):
        assert jn == tn and tx.shape == jx.shape and tx.dtype == jx.dtype
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tx, jx)
    return tb


def test_loader_batches_match_jax_across_epochs_skips_and_padding(tmp_path):
    jl, tl = _loaders(tmp_path)
    assert len(jl) == len(tl) == 3  # 5 train volumes at batch 2: the last is padded
    first = _assert_same_epoch(jl, tl)  # epoch 0
    assert first[-1][2] == 1 and first[-1][1][1] == -100 and not first[-1][0][1].any()
    _assert_same_epoch(jl, tl)  # epoch 1: another order and other draws
    for loader in (jl, tl):
        loader.set_epoch(0)
        loader.skip_batches(1)
    skipped = _assert_same_epoch(jl, tl)
    assert len(skipped) == 2
    for (x, y, n), (x0, y0, n0) in zip(skipped, first[1:]):  # skipping resumes the epoch
        np.testing.assert_array_equal(x, x0)


def test_loader_without_shuffle_or_padding_matches_jax(tmp_path):
    jl, tl = _loaders(tmp_path, batch=3, shuffle=False, pad=False)
    batches = _assert_same_epoch(jl, tl)
    assert [b[0].shape[0] for b in batches] == [3, 2]


def test_scan_folder_and_prefetcher_on_the_cpu(tmp_path):
    _, vols = _dataset(str(tmp_path))
    import pandas as pd

    want = jpipe.scan_folder(vols)
    got = tpipe.scan_folder(vols)
    assert isinstance(want, pd.DataFrame)
    assert [r["mri_path"] for r in got] == want["mri_path"].tolist()
    ds = tpipe.dataset_from_dataframe(got, ttf.eval_transform, False)
    assert ds.labels is None
    loader = tpipe.Loader(ds, 4, num_workers=2, pad_to_batch=True)
    staged = list(DevicePrefetcher(loader, "cpu"))
    plain = list(loader)
    assert len(staged) == len(plain) == 2
    for (x, y, n), (px, py, pn) in zip(staged, plain):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.float32 and y is None
        assert n == pn
        np.testing.assert_array_equal(x.numpy(), px)
    from gaviko_tpu_torch.data.grain_pipeline import GrainLoader

    assert tpipe.pick_loader({}) is tpipe.Loader
    grain = tpipe.pick_loader({"data": {"loader": "grain", "grain_processes": 2}})
    assert grain.func is GrainLoader and grain.keywords == {"processes": 2}
    with pytest.raises(ValueError, match="native | grain"):
        tpipe.pick_loader({"data": {"loader": "tfdata"}})
