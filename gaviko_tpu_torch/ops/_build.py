"""Build, load and launch the port's hand-written CUDA kernels.

Each source in ``gaviko_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``gaviko_tpu_torch/build/`` (listed in ``.gitignore``). All the
sources that are not built yet compile at once, one ``nvcc`` each. A library
is named by a digest of its sources and flags, so an edited source rebuilds.
The libraries are loaded with ``ctypes``; nothing here imports a compiler or
touches CUDA when the module is imported.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.

On a CPU tensor every wrapper runs its kernel's plain PyTorch version; on a
CUDA tensor it launches the kernel or raises. :func:`plain_versions` is the
one exception, for comparing a kernel with its plain version on the card.
While ``torch.export`` traces a forward (``torch.compiler.is_exporting()``),
a forward wrapper on a CUDA tensor records its ``gaviko::`` custom op
(:func:`op`, ``ops/library.py``) instead, whose implementation is the same
launch.

Where the libraries go is ``BUILD_DIR``; ``utils/compile_cache.py`` moves
it (``GAVIKO_COMPILE_CACHE_DIR``, ``GAVIKO_COMPILE_CACHE=0``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("patchify", "fused_mhsa", "fused_mhsa_bwd", "local_attention",
           "local_attention_bwd", "ln_linear", "ln_linear_bwd", "fused_mlp",
           "fused_mlp_bwd", "cls_attention", "flash_attention", "fused_adam",
           "int8_linear")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
_plain = threading.local()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build on a machine with "
            "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources_digest() -> str:
    """sha256 of NVCC_FLAGS and every source under ``csrc/`` (by name), as
    :func:`library_path` hashes each library's: an exported artifact
    records it, and a package whose kernels differ refuses to serve it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted((*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Dict[str, str]:
    """Compile every kernel library that is not built yet, all at once.

    Returns the compiler output of each source it built, which lists each
    kernel's registers, shared memory and spills (``-Xptxas -v``)."""
    with _lock:
        todo = {n: library_path(n) for n in SOURCES}
        todo = {n: p for n, p in todo.items() if not p.exists()}
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = {}, []
        for name, (tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.gaviko_error_string.argtypes = [ctypes.c_int]
                lib.gaviko_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def launch(name: str, symbol: str, argtypes: Sequence, *args) -> None:
    """Call ``symbol`` of library ``name`` and raise if it reports an error.

    Pointers and the stream are ``ctypes.c_void_p``: passing them untyped
    would cut them to 32 bits."""
    fn = _fns.get(symbol)
    if fn is None:
        lib = _library(name)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    rc = fn(*args)
    if rc != 0:
        msg = _library(name).gaviko_error_string(rc).decode()
        raise RuntimeError(f"{symbol} failed: CUDA error {rc} ({msg})")


def op(name: str):
    """The custom op ``gaviko::<name>`` (``ops/library.py`` registers them)."""
    from gaviko_tpu_torch.ops import library  # noqa: F401 (registers the ops)

    return getattr(torch.ops.gaviko, name)


def stream_of(t: torch.Tensor) -> int:
    """The calling thread's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """In this thread, run every kernel wrapper's plain PyTorch version even
    on CUDA tensors. For comparing kernels with their plain versions on the
    card only: the serving and training paths never enter it. An autograd
    function records :func:`plain_active` in its forward and re-enters this
    with that value in its backward, which autograd runs on another thread."""
    prev = plain_active()
    _plain.on = on
    try:
        yield
    finally:
        _plain.on = prev


def plain_active() -> bool:
    return getattr(_plain, "on", False)


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` is a CUDA tensor (outside :func:`plain_versions`);
    False for a CPU tensor. Any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise NotImplementedError(
            f"no kernel for device {t.device}: the port runs on CUDA, or on "
            "the CPU through the plain versions")
    return not plain_active()


def needs_grad(*tensors) -> bool:
    """True when autograd records a call on these tensors (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, why: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a backward that ``name`` does not
    have: its output on the card is a plain buffer with no ``grad_fn``, so
    the gradient would be lost without a word. ``why`` says where the
    gradient goes instead, or which ROADMAP item ports it."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward ({why}); call it under torch.no_grad() or on "
            "inputs that need no gradient")


def dtype_suffix(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bf16"
    if t.dtype == torch.float32:
        return "f32"
    raise NotImplementedError(f"kernels take bfloat16 or float32, got {t.dtype}")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous, on one CUDA device, of one
    dtype, and 16-byte aligned."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: tensors must share device and dtype, got "
                             f"{[(x.device, x.dtype) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
