"""PyTorch port: ``data.loader: grain`` (``data/grain_pipeline.py``) against
the JAX package's grain loader and the port's ``Loader`` on the CPU.

The port's ``GrainLoader`` runs the stream on PyTorch's runtime (threads,
or spawned ``DataLoader`` process workers kept across epochs) and never
imports grain, which imports JAX. Its batches must be bit-equal to JAX's
``GrainLoader`` (grain's thread runtime) and to the port's ``Loader`` over 2
epochs with the host train transform (affine, flip, rescale), with a padded
and an unpadded last batch, also after an abandoned epoch; the process
workers must be the same processes in every epoch, and stop on ``close``;
a load error must reach the consumer in both modes. The process workers
run with a 60 s ``DataLoader`` timeout, so a hung worker fails the test
instead of stalling the suite.
"""

import functools
import gc
import multiprocessing
import os
import time

import numpy as np
import pytest

from gaviko_tpu.data import grain_pipeline as jgrain
from gaviko_tpu.data import pipeline as jpipe
from gaviko_tpu.data import transforms as jtf
from gaviko_tpu_torch.data import pipeline as tpipe
from gaviko_tpu_torch.data import transforms as ttf
from gaviko_tpu_torch.data.grain_pipeline import GrainLoader
from tests.test_torch_rescale import jax_core_loaded

N, BATCH, TIMEOUT = 7, 3, 60.0


@pytest.fixture(scope="module", autouse=True)
def jax_core():
    """The JAX package rescales on its C++ core (bit-equal batches)."""
    jax_core_loaded()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("grain")
    rng = np.random.RandomState(1)
    paths = []
    for i in range(N):
        path = str(root / f"v{i}.npz")
        np.savez(path, data=(rng.rand(6, 8, 10) * 300).astype(np.int16))
        paths.append(path)
    return paths, np.arange(N) % 5


def _datasets(files):
    paths, labels = files
    return (jpipe.VolumeDataset(paths, labels, functools.partial(jtf.train_transform), True),
            tpipe.VolumeDataset(paths, labels, functools.partial(ttf.train_transform), True))


def _epochs(loader, n):
    return [list(loader) for _ in range(n)]


def _assert_same(got, want):
    assert [len(e) for e in got] == [len(e) for e in want]
    for ge, we in zip(got, want):
        for (gx, gy, gn), (wx, wy, wn) in zip(ge, we):
            assert gn == wn and gx.dtype == wx.dtype == np.float32
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("pad", [True, False])
def test_threads_match_jax_grain_and_loader(files, pad):
    jds, tds = _datasets(files)
    kw = dict(shuffle=True, num_workers=2, seed=3, pad_to_batch=pad)
    want = _epochs(jgrain.GrainLoader(jds, BATCH, **kw), 2)
    _assert_same(_epochs(tpipe.Loader(tds, BATCH, **kw), 2), want)
    _assert_same(_epochs(GrainLoader(tds, BATCH, processes=0, **kw), 2), want)
    last = want[0][-1]
    assert last[2] == 1 and len(last[0]) == (BATCH if pad else 1)
    if pad:
        assert list(last[1][1:]) == [-100, -100] and not last[0][1:].any()


@pytest.mark.parametrize("pad,epochs", [(True, 2), (False, 1)])
def test_processes_match_jax_grain(files, pad, epochs):
    jds, tds = _datasets(files)
    kw = dict(shuffle=True, num_workers=2, seed=3, pad_to_batch=pad)
    want = _epochs(jgrain.GrainLoader(jds, BATCH, **kw), epochs)
    loader = GrainLoader(tds, BATCH, processes=2, timeout=TIMEOUT, **kw)
    try:
        _assert_same(_epochs(loader, epochs), want)
    finally:
        loader.close()


def _children():
    return {p.pid for p in multiprocessing.active_children()}


def test_process_workers_persist_and_skip_an_abandoned_epoch(files):
    """The workers spawned for the first epoch serve the next; an epoch left
    after one batch leaves nothing behind in the next; ``close`` stops
    them."""
    jds, tds = _datasets(files)
    kw = dict(shuffle=True, num_workers=2, seed=3, pad_to_batch=True)
    want = _epochs(jgrain.GrainLoader(jds, BATCH, **kw), 3)
    before = _children()
    loader = GrainLoader(tds, BATCH, processes=2, timeout=TIMEOUT, **kw)
    try:
        first = iter(loader)
        _assert_same([[next(first)]], [want[0][:1]])
        del first
        workers = _children() - before
        assert len(workers) == 2
        _assert_same(_epochs(loader, 2), want[1:])
        assert _children() - before == workers
    finally:
        loader.close()
    gc.collect()
    deadline = time.monotonic() + TIMEOUT
    while _children() & workers and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _children() & workers


def test_resume_skip_and_epoch_pinning(files):
    """set_epoch and skip_batches act on the grain engine as on Loader."""
    _, tds = _datasets(files)
    kw = dict(shuffle=True, num_workers=2, seed=3, pad_to_batch=True)
    full = _epochs(GrainLoader(tds, BATCH, **kw), 2)[1]
    loader = GrainLoader(tds, BATCH, **kw)
    loader.set_epoch(1)
    loader.skip_batches(1)
    _assert_same([list(loader)], [full[1:]])


@pytest.mark.parametrize("processes", [0, 2])
def test_load_error_reaches_the_consumer(files, processes):
    paths, labels = files
    ds = tpipe.VolumeDataset(paths[:4] + [os.path.join(os.path.dirname(paths[0]),
                                                       "missing.npz")],
                             labels[:5], ttf.eval_transform)
    loader = GrainLoader(ds, 2, processes=processes, timeout=TIMEOUT, num_workers=2)
    try:
        with pytest.raises(FileNotFoundError, match="missing.npz"):
            list(loader)
    finally:
        loader.close()


def test_pick_loader_selects_the_engine(files):
    _, tds = _datasets(files)
    make = tpipe.pick_loader({"data": {"loader": "grain", "grain_processes": 0}})
    loader = make(tds, BATCH, shuffle=False, num_workers=2, seed=0, pad_to_batch=False)
    assert isinstance(loader, GrainLoader) and loader.processes == 0
    assert len(list(loader)) == len(loader) == 3
