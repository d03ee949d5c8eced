"""PyTorch port: import hygiene and the entry points that must run without a GPU.

The port runs where JAX is not installed: importing any of its modules must
import neither ``jax``, ``grain`` (which imports JAX) nor ``gaviko_tpu``, and
must not need ``nvcc`` (the kernels build at first launch).
"""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

import gaviko_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(gaviko_tpu_torch.__path__, "gaviko_tpu_torch."))


def _run(args, cwd=REPO, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'grain', 'gaviko_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert len(MODULES) >= 20, MODULES
    assert {"gaviko_tpu_torch.parallel.mesh", "gaviko_tpu_torch.parallel.infer",
            "gaviko_tpu_torch.parallel.shard"} <= set(MODULES)


def test_cli_serve_help_runs_on_cpu():
    res = _run(["-m", "gaviko_tpu_torch.cli.serve", "--help"])
    assert res.returncode == 0, res.stderr
    for flag in ("--config", "--method", "--checkpoint", "--batch_size", "--dtype",
                 "--auth_token", "--checkpoint_dir", "--max_body_mb"):
        assert flag in res.stdout


@pytest.mark.parametrize("flag", ["--quantize=int8", "--mesh=2,2", "--artifact=x"])
def test_cli_serve_refuses_unported_flags(flag):
    """--quantize int8, --mesh and --artifact are ported (each was refused
    here until it came): the first two get past the flag checks and stop at
    the config file, which is missing; --artifact takes the place of
    --config (exit 2 beside it) and, alone, stops at the artifact file,
    which is missing."""
    res = _run(["-m", "gaviko_tpu_torch.cli.serve", "--config", "no_such_config.yaml", flag])
    if flag in ("--quantize=int8", "--mesh=2,2"):
        assert res.returncode != 0 and "not ported yet" not in res.stderr
        assert "No such file or directory: 'no_such_config.yaml'" in res.stderr
        return
    assert res.returncode == 2 and "exactly one of --config or --artifact" in res.stderr
    res = _run(["-m", "gaviko_tpu_torch.cli.serve", flag])
    assert res.returncode != 0 and "not ported yet" not in res.stderr
    assert "No such file or directory: 'x'" in res.stderr


def test_chip_smoke_fails_without_a_gpu():
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
