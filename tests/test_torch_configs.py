"""The port's YAML configs are byte-for-byte copies of the JAX package's.

``gaviko_tpu_torch.config.load_config`` falls back to the port's own
``configs/`` directory, so the port reads no file of the JAX package; these
tests keep the two sets of files from drifting apart.
"""

import os

import pytest

from gaviko_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "gaviko_tpu", "configs")
PORT_DIR = os.path.join(ROOT, "gaviko_tpu_torch", "configs")
NAMES = ("adaptformer.yaml", "dvpt.yaml", "evp.yaml", "gaviko.yaml", "gaviko_tpu.yaml",
         "melo.yaml", "ssf.yaml", "vit.yaml", "vpt.yaml")


def test_same_files():
    yamls = lambda d: sorted(f for f in os.listdir(d) if f.endswith(".yaml"))  # noqa: E731
    assert yamls(JAX_DIR) == yamls(PORT_DIR) == list(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_copy_is_byte_equal(name):
    with open(os.path.join(JAX_DIR, name), "rb") as a, \
            open(os.path.join(PORT_DIR, name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", NAMES)
def test_fallback_reads_the_port_copy(name, monkeypatch, tmp_path):
    """A bare basename resolves inside the port's package, never the JAX
    package's: with the JAX file's directory out of reach (the working
    directory elsewhere), the port's copy is what loads."""
    monkeypatch.chdir(tmp_path)
    opened = []
    real_open = open

    def spy(path, *args, **kwargs):
        opened.append(os.path.abspath(path))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr("builtins.open", spy)
    cfg = tconfig.load_config(name)
    assert isinstance(cfg, dict) and "model" in cfg
    assert opened == [os.path.join(PORT_DIR, name)]
