"""PyTorch port: int8 serving on a mesh (``Predictor(quantize="int8",
mesh_shape=...)``) on spawned gloo ranks (``tests/torch_parallel_ranks.py``),
against the JAX package on the CPU.

The GAViKO configuration of ``tests/test_torch_int8.py`` (vit-s16 widths,
24x32x32, fp32, a micro-batch of 2, three volumes: the second micro-batch
padded), its weights a full checkpoint of the JAX package's init. Every
rank quantizes the whole weights, as JAX does before it shards; the int8
blocks stay whole on every rank, so each runs B11's plain version on its
rows. At data=2 (each rank one row) and at model=2, rank 0's logits, and
again after a reload:

- against the one-process int8 Predictor and against the JAX package's
  int8 Predictor on its own mesh of the same shape (the conftest's virtual
  devices): within 1e-2 relative MAE and the same classes, the int8
  budget of ``tests/test_torch_int8.py`` (derived in
  ``tests/torch_int8_gaps.py``). Not closer to the one-process Predictor:
  a data rank forwards a batch of one, whose f32 attention sums round
  apart from a batch of two's by ~1e-7, and an activation that lands that
  close to a rounding boundary of its int8 code takes the other code
  (measured: up to 1.2e-2 absolute on a logit; 7e-7 in full precision).

SSF keeps the JAX package's behaviour on a mesh too: ``quantize_backbone``
warns and SSF serves full precision, its blocks split; at model=2 its
logits hold to the one-process full-precision Predictor within MAE 1e-4.
"""

import numpy as np
import pytest

import jax

from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.serving import Predictor as JaxPredictor
from gaviko_tpu_torch.serving import Predictor
from tests import torch_parallel_ranks as ranks
from tests.test_torch_int8 import CONFIG, _rel
from tests.test_torch_peft import cfg_of

MESHES = [(2, 1), (1, 2)]
SSF = {"model": cfg_of("ssf")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("int8_mesh")
    jm = jax_build_model(CONFIG["model"])
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3), jm.spec).items()}
    ckpt = str(root / "full.npz")
    np.savez(ckpt, **params)
    rng = np.random.RandomState(0)
    vols = [rng.rand(24, 32, 32).astype(np.float32) for _ in range(3)]
    kw = dict(checkpoint=ckpt, quantize="int8")
    handles = {shape: ranks.start(ranks.mesh_serve_rank, 2, str(root / f"m{shape[0]}{shape[1]}"),
                                  CONFIG, vols, shape, kw) for shape in MESHES}
    handles["ssf"] = ranks.start(ranks.mesh_serve_rank, 2, str(root / "ssf"), SSF, vols,
                                 (1, 2), {"quantize": "int8"})
    base = dict(batch_size=2, dtype="float32", pretrained_dir=None)
    one = Predictor(CONFIG, device="cpu", **base, **kw).predict_logits(vols)
    jax_mesh = {shape: JaxPredictor(CONFIG, mesh_shape=shape, **base, **kw).predict_logits(vols)
                for shape in MESHES}
    ssf_one = Predictor(SSF, device="cpu", **base).predict_logits(vols)
    port = {name: ranks.join(h, timeout=300)[0] for name, h in handles.items()}
    return dict(one=one, jax=jax_mesh, port=port, ssf_one=ssf_one)


@pytest.mark.parametrize("shape", MESHES, ids=["dp2", "tp2"])
def test_int8_mesh_matches_one_process(run, shape):
    for logits in run["port"][shape]:  # the first forward and the one after a reload
        assert _rel(logits, run["one"]) <= 1e-2
        assert (logits.argmax(-1) == run["one"].argmax(-1)).all()


@pytest.mark.parametrize("shape", MESHES, ids=["dp2", "tp2"])
def test_int8_mesh_matches_jax_int8_mesh_predictor(run, shape):
    got, want = run["port"][shape][0], run["jax"][shape]
    assert got.shape == want.shape == (3, 5)
    assert _rel(got, want) <= 1e-2 and (got.argmax(-1) == want.argmax(-1)).all()


def test_ssf_int8_on_a_mesh_serves_full_precision(run):
    for logits in run["port"]["ssf"]:
        assert float(np.mean(np.abs(logits - run["ssf_one"]))) < 1e-4
