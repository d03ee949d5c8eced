"""PyTorch port: the host rescale and widening against the JAX package's C++
loader core on the CPU.

The JAX package rescales and widens raw volumes on its C++ core
(``gaviko_tpu/native/loader_core.cpp``). The port does the same arithmetic
in numpy (``data/transforms.rescale_intensity``: ``(x - lo) * scale +
out_min`` with a float32 ``scale``; ``VolumeDataset.load``: ``astype``), and
must be bit-equal to the core on random volumes, a constant volume and
int16 / uint16 widening, with the core on 1 and 8 threads, below and above
its 65,536-element threading threshold, with no compiler on the ``PATH``.
"""

import time

import numpy as np
import pytest

from gaviko_tpu.data import native_loader as jnl
from gaviko_tpu.data import transforms as jtf
from gaviko_tpu_torch.data import pipeline as tpipe
from gaviko_tpu_torch.data import transforms as ttf

SIZES = [(1, 6, 8, 10), (1, 30, 48, 50)]  # 480 and 72,000 elements


def jax_core_loaded(timeout_s: float = 120.0) -> None:
    """Load the JAX package's C++ core. Its ``get_lib`` builds the library in
    place at first use, and a process that loads it half-written keeps the
    numpy fallback for good; with several test processes one may load while
    another builds. So ask again each second until it loads."""
    deadline = time.monotonic() + timeout_s
    while not jnl.native_available():
        if time.monotonic() > deadline:
            raise AssertionError("the JAX package's C++ loader core did not load (g++)")
        time.sleep(1.0)
        jnl._tried = False


@pytest.fixture(scope="module", autouse=True)
def jax_core():
    jax_core_loaded()


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("shape", SIZES)
def test_rescale_bit_equal_to_jax_core(shape, threads):
    for seed in range(3):
        x = (np.random.RandomState(seed).rand(*shape).astype(np.float32) * 700 - 123)
        for lo, hi in ((0.0, 1.0), (-1.0, 2.5)):
            want = jnl.rescale_intensity_native(x, lo, hi, nthreads=threads)
            got = ttf.rescale_intensity(x, lo, hi)
            assert got.dtype == np.float32 and got.shape == x.shape
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttf.rescale_intensity(x), jtf.rescale_intensity(x))
    # A strided view, and a float64 volume, rescale as their float32 copies.
    view = x[:, ::2]
    np.testing.assert_array_equal(ttf.rescale_intensity(view),
                                  jnl.rescale_intensity_native(view, nthreads=threads))
    np.testing.assert_array_equal(ttf.rescale_intensity(x.astype(np.float64)),
                                  jnl.rescale_intensity_native(x, nthreads=threads))


def test_constant_volume():
    c = np.full((1, 4, 5, 6), 7.0, np.float32)
    for out_min in (0.0, -2.0):
        got = ttf.rescale_intensity(c, out_min, 1.0)
        np.testing.assert_array_equal(got, jnl.rescale_intensity_native(c, out_min, 1.0))
        assert got.dtype == np.float32 and (got == out_min).all()


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.float64, np.uint8])
def test_load_widens_bit_equal_to_jax_core(tmp_path, shape, threads, dtype):
    """``VolumeDataset.load`` of a stored volume against the core's
    widening of the same array."""
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    rng = np.random.RandomState(4)
    if info is not None:
        x = rng.randint(info.min, int(info.max) + 1, size=shape[1:]).astype(dtype)
    else:
        x = rng.randn(*shape[1:]).astype(dtype) * 1e3
    path = str(tmp_path / "v.npz")
    np.savez(path, data=x)
    got = tpipe.VolumeDataset([path], None, ttf.raw_volume).load(0)
    want = jnl.widen_f32(x, nthreads=threads)[None]
    assert got.dtype == np.float32 and got.shape == shape and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)


def test_host_path_needs_no_compiler(tmp_path, monkeypatch):
    """Loading and rescaling a volume builds nothing: with no ``g++`` (nor
    anything else) on the ``PATH`` the port's batches are the core's."""
    x = (np.random.RandomState(5).rand(12, 16, 16) * 3000).astype(np.int16)
    path = str(tmp_path / "v.npz")
    np.savez(path, data=x)
    want = jnl.rescale_intensity_native(jnl.widen_f32(x)[None])
    monkeypatch.setenv("PATH", "")
    got = tpipe.VolumeDataset([path], None, ttf.eval_transform).load(0)
    np.testing.assert_array_equal(got, want)
