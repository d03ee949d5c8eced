"""Where the port's CUDA kernels are built and kept between runs.

Port of ``gaviko_tpu/utils/compile_cache.py``. The JAX package keeps XLA's
persistent compilation cache; the port's compiled artefacts are the kernel
libraries ``nvcc`` builds at first use (``ops/_build.py``), named by a
digest of their sources and flags. This module sets the directory they go
to (``_build.BUILD_DIR``), with the JAX package's names:

- by default ``gaviko_tpu_torch/build/`` beside the sources (listed in
  ``.gitignore``), so a second run on the same checkout loads them;
- ``GAVIKO_COMPILE_CACHE_DIR=<dir>`` moves it, e.g. where the package is
  installed read-only, as a served artifact's may be;
- ``GAVIKO_COMPILE_CACHE=0`` builds into a fresh directory of this
  process, removed at exit: nothing persists.

A directory that cannot be written raises, naming the variable that moves
it; nothing falls back to another place. The CLIs call
:func:`enable_compilation_cache` before they build anything.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

from gaviko_tpu_torch.ops import _build

_DEFAULT_DIR = str(_build.PACKAGE_DIR / "build")
_fresh: Optional[Path] = None  # this process's directory under GAVIKO_COMPILE_CACHE=0


def _fresh_dir() -> Path:
    global _fresh
    if _fresh is None:
        _fresh = Path(tempfile.mkdtemp(prefix="gaviko_kernels_"))
        atexit.register(shutil.rmtree, _fresh, True)
    return _fresh


def _writable(path: Path) -> Path:
    """Make ``path`` and check that a file can be created in it."""
    try:
        path.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=path, prefix=".probe_"):
            pass
    except OSError as e:
        raise RuntimeError(
            f"the kernel build directory {str(path)!r} cannot be written ({e}); set "
            "GAVIKO_COMPILE_CACHE_DIR to a writable directory (or GAVIKO_COMPILE_CACHE=0 "
            "to build into a temporary one)") from e
    return path


def enable_compilation_cache() -> Optional[str]:
    """Point ``_build.BUILD_DIR`` at the kernel cache and check it can be
    written (raises if not). Returns the directory in use, or None when
    nothing persists (``GAVIKO_COMPILE_CACHE=0``: a fresh directory of this
    process, removed at exit)."""
    if os.environ.get("GAVIKO_COMPILE_CACHE", "1") == "0":
        _build.BUILD_DIR = _writable(_fresh_dir())
        return None
    cache_dir = os.environ.get("GAVIKO_COMPILE_CACHE_DIR", _DEFAULT_DIR)
    _build.BUILD_DIR = _writable(Path(cache_dir).expanduser().resolve())
    return str(_build.BUILD_DIR)
