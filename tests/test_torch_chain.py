"""PyTorch port: ``train.fused_optimizer: false`` (the optax chain's state,
stepped by B13) and ``train.checkpoint_backend: orbax`` (the resume state
as an orbax directory, through tensorstore), against the JAX package on the
CPU.

``run_training`` of both packages from the same params, on the synthetic
volumes of ``tests/test_end_to_end.py``: bitfit at vit-t16, depth 2,
dropout on, one epoch of three steps, the port fed the JAX run's dropout
seeds (``tests/test_torch_trainer.py``'s harness). Two runs:

- ``cycled``: the cycled beta1 (``scale_by_cycled_adam``), the npz resume
  file;
- ``fixed``: ``scheduler.cycle_momentum: false`` (``optax.adam``), the
  orbax resume directory ``experiments/<method>/resume_state``.

Budgets: the CSV rows (per-step losses and the other numeric fields)
within 1e-5, the trainable params after the three steps within 2e-4, the
JAX package's train budgets. The state has the chain's leaves, ``[count,
*mu, *nu, count]``. Either package's resume file (npz or directory) loads
in the other bit for bit, and each package resumes
from the other's file (``resume: auto`` finding it) to the same params
after a second epoch, within 2e-4. Both runs are fp32; a ``pure_bf16``
state (bf16 params and moments) crosses in an orbax directory either way,
bit for bit. The port's orbax code leaves ``jax``,
``orbax`` and ``grain`` out of ``sys.modules``; without tensorstore the
option raises and writes nothing.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaviko_tpu.cli import train as jcli_train
from gaviko_tpu.train import loop as jloop
from gaviko_tpu.utils import checkpoint as jckpt
from gaviko_tpu_torch.cli import train as tcli_train
from gaviko_tpu_torch.train import fused_optim
from gaviko_tpu_torch.train import loop as tloop
from gaviko_tpu_torch.utils import checkpoint as tckpt
from gaviko_tpu_torch.weights.from_jax import from_jax
from tests.test_torch_trainer import (TRAIN_LOG_FIELDS, TS, _config, _models, _own_dirs, _rows,
                                      jax_step_seeds)

RUNS = {"cycled": ({}, "npz"), "fixed": ({"cycle_momentum": False}, "orbax")}


def _resume_path(config, backend):
    return os.path.join(config["train"]["save_dir"], "experiments", "bitfit",
                        "resume_state" if backend == "orbax" else "resume_state.npz")


@pytest.fixture(scope="module", params=sorted(RUNS))
def chain_run(request, tmp_path_factory):
    name = request.param
    sched_over, backend = RUNS[name]
    root = str(tmp_path_factory.mktemp(name))
    config = _config(root, epochs=1, train_over={"fused_optimizer": False,
                                                 "checkpoint_backend": backend})
    config["train"]["scheduler"].update(sched_over)
    jm, tm = _models(config["model"])
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0), jm.spec).items()}
    jcfg, tcfg = _own_dirs(config, root, "jax"), _own_dirs(config, root, "port")
    jres = jloop.run_training(jcfg, jm, {k: jnp.asarray(v) for k, v in jp.items()},
                              jcli_train.make_loaders(jcfg), TS)
    tres = tloop.run_training(tcfg, tm, from_jax(jp), tcli_train.make_loaders(tcfg), TS,
                              step_seeds=jax_step_seeds(0))
    return dict(name=name, backend=backend, root=root, config=config, jm=jm, tm=tm, jp=jp,
                jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres,
                trainable=[k for k in jp if tm.trainable(k)])


def test_chain_csv_rows_match_jax(chain_run):
    jrows, trows = _rows(chain_run["jres"]["csv_log"]), _rows(chain_run["tres"]["csv_log"])
    assert len(trows) == len(jrows) == 3 + 2  # 3 train + 2 val rows
    for jr, tr in zip(jrows, trows):
        for f in TRAIN_LOG_FIELDS:
            if f != "time_stamp":
                assert abs(float(tr[f]) - float(jr[f])) <= 1e-5, (f, tr[f], jr[f])


def test_chain_final_params_match_jax(chain_run):
    keys, jp = chain_run["trainable"], chain_run["jp"]
    got = {k: chain_run["tres"]["params"][k].numpy() for k in keys}
    want = {k: np.asarray(chain_run["jres"]["params"][k]) for k in keys}
    assert max(float(np.max(np.abs(got[k] - want[k]))) for k in keys) <= 2e-4
    assert max(float(np.max(np.abs(want[k] - jp[k]))) for k in keys) > 1e-5  # it moved


def test_chain_state_has_the_optax_chain_leaves(chain_run):
    """The port's state is a ``ChainState`` whose leaves are the JAX
    chain's: ``[count, *mu, *nu, count]``, each the JAX leaf's shape and
    dtype."""
    tm, keys = chain_run["tm"], chain_run["trainable"]
    fused = tloop.make_optimizer({**chain_run["config"]["train"]}, 3)
    assert fused["chain"]
    tr, _ = tloop.split_params(tm, from_jax(chain_run["jp"]))
    state = tloop.init_opt_state(tr, fused)
    assert isinstance(state, fused_optim.ChainState)
    tx, _, jfused = jloop.make_optimizer(chain_run["config"]["train"], 3)
    assert jfused is None
    jleaves = jax.tree.leaves(tx.init({k: jnp.asarray(chain_run["jp"][k]) for k in keys}))
    leaves = tckpt.opt_leaves(state)
    assert len(leaves) == len(jleaves) == 2 + 2 * len(keys)
    for a, b in zip(leaves, jleaves):
        a = tckpt.tensor_to_array(a)
        assert a.shape == b.shape and a.dtype == np.asarray(b).dtype


def _jax_template(chain_run):
    keys = chain_run["trainable"]
    tr = {k: jnp.asarray(chain_run["jp"][k]) for k in keys}
    tx, _, _ = jloop.make_optimizer(chain_run["config"]["train"], 3)
    return tr, tx.init(tr)


def _port_template(chain_run):
    tr, _ = tloop.split_params(chain_run["tm"], from_jax(chain_run["jp"]))
    fused = tloop.make_optimizer(chain_run["config"]["train"], 3)
    return tr, tloop.opt_template(tr, fused)


def test_chain_resume_files_load_in_both_packages(chain_run):
    """Each package's resume file (npz, or the orbax directory) loads in
    the other with every leaf bit-equal to the writer's own reading."""
    backend = chain_run["backend"]
    jpath, tpath = (_resume_path(chain_run[c], backend) for c in ("jcfg", "tcfg"))
    assert os.path.isdir(tpath) == os.path.isdir(jpath) == (backend == "orbax")
    jload = jckpt.load_train_state_orbax if backend == "orbax" else jckpt.load_train_state
    for path in (jpath, tpath):
        jtr, jopt, jmeta = jload(path, *_jax_template(chain_run))
        ttr, topt, tmeta = tckpt.load_train_state(path, *_port_template(chain_run))
        assert isinstance(topt, fused_optim.ChainState) and tmeta == jmeta
        assert tmeta["global_step"] == 3
        for k, v in ttr.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jtr[k]))
        for a, b in zip(tckpt.opt_leaves(topt), jax.tree.leaves(jopt)):
            np.testing.assert_array_equal(tckpt.tensor_to_array(a), np.asarray(b))


def test_each_package_resumes_from_the_others_file(chain_run, tmp_path):
    """``resume: auto`` finds the other package's file where its own would
    be, and a second epoch runs to the same params in both."""
    backend = chain_run["backend"]
    cfg = dict(chain_run["config"])
    cfg["train"] = {**cfg["train"], "num_epochs": 2, "resume": "auto"}
    jcfg, tcfg = _own_dirs(cfg, str(tmp_path), "jax"), _own_dirs(cfg, str(tmp_path), "port")
    for src, dst in (("tcfg", jcfg), ("jcfg", tcfg)):
        path = _resume_path(dst, backend)
        os.makedirs(os.path.dirname(path))
        copy = shutil.copytree if backend == "orbax" else shutil.copy
        copy(_resume_path(chain_run[src], backend), path)
    jm, tm, jp = chain_run["jm"], chain_run["tm"], chain_run["jp"]
    jres = jloop.run_training(jcfg, jm, {k: jnp.asarray(v) for k, v in jp.items()},
                              jcli_train.make_loaders(jcfg), TS)
    tres = tloop.run_training(tcfg, tm, from_jax(jp), tcli_train.make_loaders(tcfg), TS,
                              step_seeds=jax_step_seeds(0))
    assert len(_rows(tres["csv_log"])) == len(_rows(jres["csv_log"])) == 3 + 2  # epoch 2 only
    keys = chain_run["trainable"]
    first = {k: chain_run["tres"]["params"][k].numpy() for k in keys}
    got = {k: tres["params"][k].numpy() for k in keys}
    want = {k: np.asarray(jres["params"][k]) for k in keys}
    assert max(float(np.max(np.abs(got[k] - want[k]))) for k in keys) <= 2e-4
    assert max(float(np.max(np.abs(got[k] - first[k]))) for k in keys) > 1e-5


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (bf16 as 2-byte integers), from a tensor or array."""
    a = tckpt.tensor_to_array(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pure_bf16_orbax_directory_loads_in_the_other_package(writer, tmp_path):
    """``precision: pure_bf16``: bf16 params and the chain's bf16 moments,
    non-zero, in an orbax directory that one package writes and the other
    restores bit for bit, each leaf with the writer's dtype."""
    rng = np.random.RandomState(3)
    shapes = {"a.weight": (8, 6), "a.bias": (6,), "cls_token": (1, 1, 6)}
    cfg = {"fused_optimizer": False, "precision": "pure_bf16",
           "scheduler": {"max_lr": 3e-4, "pct_start": 0.3, "div_factor": 10.0,
                         "final_div_factor": 1000.0, "anneal_strategy": "cos",
                         "three_phase": False}}
    jtr = {k: jnp.asarray(rng.randn(*sh), jnp.bfloat16) for k, sh in shapes.items()}
    tx, _, jfused = jloop.make_optimizer(cfg, 10)
    assert jfused is None
    jopt = tx.init(jtr)
    leaves, treedef = jax.tree.flatten(jopt)
    leaves = [jnp.asarray(np.int32(5)) if leaf.ndim == 0 else
              jnp.asarray(rng.rand(*leaf.shape) * 1e-2, leaf.dtype) for leaf in leaves]
    assert sum(leaf.dtype == jnp.bfloat16 for leaf in leaves) == 2 * len(shapes)
    jopt = jax.tree.unflatten(treedef, leaves)
    meta = {"global_step": 5, "epoch": 1}
    ttr = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
           for k, v in jtr.items()}
    fused = tloop.make_optimizer(cfg, 10)
    topt = tckpt.opt_from_leaves(tloop.opt_template(ttr, fused),
                                 [torch.from_numpy(np.asarray(leaf, np.float32)).to(
                                     torch.bfloat16) if leaf.ndim else
                                  torch.tensor(int(leaf)) for leaf in leaves])
    assert isinstance(topt, fused_optim.ChainState)
    assert [_bits(a).tolist() for a in tckpt.opt_leaves(topt)] == [_bits(b).tolist()
                                                                    for b in leaves]
    path = str(tmp_path / "resume_state")
    if writer == "jax":
        jckpt.save_train_state_orbax(path, jtr, jopt, meta)
    else:
        tckpt.save_train_state_orbax(path, ttr, topt, meta)
    rtr, ropt, rmeta = jckpt.load_train_state_orbax(path, jtr, jopt)
    qtr, qopt, qmeta = tckpt.load_train_state(path, ttr, tloop.opt_template(ttr, fused))
    assert rmeta == qmeta == meta
    for k in shapes:
        assert rtr[k].dtype == jnp.bfloat16 and qtr[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(rtr[k]), _bits(jtr[k]))
        np.testing.assert_array_equal(_bits(qtr[k]), _bits(jtr[k]))
    for a, b, c in zip(jax.tree.leaves(ropt), tckpt.opt_leaves(qopt), leaves):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(_bits(a), _bits(c))
        np.testing.assert_array_equal(_bits(b), _bits(c))


def test_orbax_code_imports_no_jax(tmp_path):
    """The port's orbax save and load, in a fresh interpreter, import
    tensorstore only: no ``jax``, ``orbax`` or ``grain``."""
    code = textwrap.dedent(f"""
        import sys, torch
        from gaviko_tpu_torch.train import fused_optim
        from gaviko_tpu_torch.utils import checkpoint as c
        tr = {{"w": torch.ones(2, 3), "b": torch.ones(4, dtype=torch.bfloat16)}}
        st = fused_optim.init(tr, chain=True)
        c.save_train_state(r"{tmp_path}/x.npz", tr, st, {{"epoch": 1}})
        c.save_train_state_orbax(r"{tmp_path}/d", tr, st, {{"epoch": 1}})
        t2, s2, m = c.load_train_state(r"{tmp_path}/d", tr, st)
        assert m == {{"epoch": 1}} and torch.equal(t2["b"], tr["b"])
        assert "tensorstore" in sys.modules
        print(sorted(m for m in ("jax", "orbax", "grain", "gaviko_tpu") if m in sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_orbax_without_tensorstore_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import raises ImportError
    tr = {"w": torch.ones(2)}
    with pytest.raises(ImportError, match="tensorstore.*checkpoint_backend"):
        tckpt.save_train_state_orbax(str(tmp_path / "d"), tr, fused_optim.init(tr), {})
    assert os.listdir(tmp_path) == []
