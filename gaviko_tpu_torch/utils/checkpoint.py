"""Mid-training resume state, in the JAX package's layouts: one npz, or an
orbax directory.

Port of ``gaviko_tpu/utils/checkpoint.py``. The full train state (trainable
params, optimizer state, progress counters and best-val bookkeeping) is,
with ``train.checkpoint_backend: npz`` (the default), one ``.npz``:

- ``param::<name>`` for every trainable tensor;
- ``opt::<i>`` for the optimizer state's leaves in ``jax.tree.leaves``
  order: for ``FusedAdamState(count, mu, nu)`` the count, then ``mu`` in
  sorted key order, then ``nu``; for the optax chain's ``ChainState`` the
  same and the schedule's count; for the accumulating state
  (``accumulation_steps > 1``) optax ``MultiStepsState``'s order, see
  :func:`opt_leaves`;
- ``meta::json``, the progress as UTF-8 JSON bytes.

With ``checkpoint_backend: orbax`` it is the directory orbax's
``StandardCheckpointer`` writes for the tree ``{"trainable": {...},
"opt_leaves": [...], "meta_json": uint8 bytes}``: ``_METADATA`` (the tree),
``_CHECKPOINT_METADATA`` and an OCDBT database of zarr (v2) arrays named
``trainable.<name>``, ``opt_leaves.<i>`` and ``meta_json``. The port reads
and writes it through tensorstore, imported inside those functions only;
without tensorstore the option raises. It writes the leaves as host arrays
(``np.ndarray`` in ``_METADATA``, so no ``_sharding``: orbax's layout for
numpy leaves), which the JAX package restores on any backend.

So a resume file written by either package loads in the other. bfloat16
tensors are written as 2-byte raw values, as numpy writes the JAX package's
bfloat16 arrays.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from gaviko_tpu_torch.train.fused_optim import ChainState, FusedAdamState, MultiStepState
from gaviko_tpu_torch.weights.from_jax import array_to_tensor

Params = Dict[str, torch.Tensor]
OptState = object  # FusedAdamState, ChainState or MultiStepState


def tensor_to_array(t) -> np.ndarray:
    """A tensor (any device) or number -> a numpy array owning a copy;
    bfloat16 becomes 2-byte raw values (numpy has no bfloat16)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy().view(np.dtype("V2"))
    return t.numpy().copy()


def _sorted(d: Params) -> List[torch.Tensor]:
    return [d[k] for k in sorted(d)]


def opt_leaves(state: OptState) -> list:
    """The state's leaves in ``jax.tree.leaves`` order of its JAX
    counterpart: ``FusedAdamState`` -> [count, *mu, *nu]; ``ChainState`` ->
    [count, *mu, *nu, count (the schedule's)]; ``MultiStepState``
    -> optax ``MultiStepsState(mini_step, gradient_step, inner_opt_state,
    acc_grads)`` over the chain clip -> Adam -> lr schedule: [mini_step,
    gradient_step, count, *mu, *nu, count (the schedule's), *acc_grads]."""
    if isinstance(state, MultiStepState):
        inner = state.inner
        return [np.int32(state.mini_step), np.int32(state.gradient_step),
                np.int32(inner.count), *_sorted(inner.mu), *_sorted(inner.nu),
                np.int32(inner.count), *_sorted(state.acc)]
    leaves = [np.int32(state.count), *_sorted(state.mu), *_sorted(state.nu)]
    return leaves + [np.int32(state.count)] if isinstance(state, ChainState) else leaves


def _check_shape(k: str, arr: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    if tuple(arr.shape) != tuple(t.shape):
        raise ValueError(f"resume state: {k} has shape {tuple(arr.shape)}, "
                         f"want {tuple(t.shape)}")
    return arr.to(device=t.device, dtype=t.dtype)


def _fill(template: Params, leaves: list) -> Params:
    return {k: _check_shape(k, leaf, template[k]) for k, leaf in zip(sorted(template), leaves)}


def opt_from_leaves(template: OptState, leaves: list) -> OptState:
    """Inverse of :func:`opt_leaves`, shaped, typed and placed as
    ``template``. ``leaves`` are CPU tensors."""
    if isinstance(template, MultiStepState):
        inner, n = template.inner, len(template.inner.mu)
        mini, gstep, count = (int(x) for x in leaves[:3])
        mu = _fill(inner.mu, leaves[3:3 + n])
        nu = _fill(inner.nu, leaves[3 + n:3 + 2 * n])
        acc = _fill(template.acc, leaves[4 + 2 * n:])
        return MultiStepState(mini, gstep, FusedAdamState(count, mu, nu), acc)
    n = len(template.mu)
    return type(template)(int(leaves[0]), _fill(template.mu, leaves[1:1 + n]),
                          _fill(template.nu, leaves[1 + n:1 + 2 * n]))


def save_train_state(path: str, trainable: Params, opt_state: OptState, meta: Dict) -> None:
    payload = {f"param::{k}": tensor_to_array(v) for k, v in trainable.items()}
    for i, leaf in enumerate(opt_leaves(opt_state)):
        payload[f"opt::{i}"] = tensor_to_array(leaf)
    payload["meta::json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **payload)


def load_train_state(path: str, trainable_template: Params,
                     opt_state_template: OptState) -> Tuple[Params, OptState, Dict]:
    """-> (trainable, opt_state, meta), on the templates' devices and in
    their dtypes. A directory is an orbax checkpoint (:func:`load_train_state_orbax`),
    as the JAX package picks its loader."""
    if os.path.isdir(path):
        return load_train_state_orbax(path, trainable_template, opt_state_template)
    n_leaves = len(opt_leaves(opt_state_template))
    with np.load(path) as z:
        trainable = {k: _check_shape(k, array_to_tensor(z[f"param::{k}"]), t)
                     for k, t in trainable_template.items()}
        leaves = [array_to_tensor(z[f"opt::{i}"]) for i in range(n_leaves)]
        meta = json.loads(bytes(z["meta::json"]).decode())
    return trainable, opt_from_leaves(opt_state_template, leaves), meta


# ------------------------------------------------------------------ orbax ----

_ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                  "StandardCheckpointHandler")


def require_tensorstore():
    """The tensorstore module the orbax backend needs, or an ImportError
    naming it and the option."""
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError("train.checkpoint_backend: orbax reads and writes its directory "
                          "through tensorstore, which is not installed here; use "
                          "checkpoint_backend: npz") from e
    return tensorstore


def _zarr_dtype(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else a.dtype.str


def save_train_state_orbax(path: str, trainable: Params, opt_state: OptState,
                           meta: Dict) -> None:
    """The resume state as the orbax directory ``path`` (replaced if it
    exists; written beside it first, then renamed into place)."""
    ts = require_tensorstore()
    tree = {f"trainable.{k}": tensor_to_array(v) for k, v in trainable.items()}
    tree.update({f"opt_leaves.{i}": tensor_to_array(v)
                 for i, v in enumerate(opt_leaves(opt_state))})
    tree["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    keys = [("trainable", 2, k) for k in trainable]
    keys += [("opt_leaves", 1, str(i)) for i in range(len(tree) - len(trainable) - 1)]
    tmp = f"{path}.orbax-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    t0 = time.time_ns()
    base = {"driver": "ocdbt", "base": f"file://{os.path.abspath(tmp)}/"}
    for name, a in tree.items():
        spec = {"driver": "zarr", "kvstore": {**base, "path": f"{name}/"},
                "metadata": {"shape": list(a.shape), "chunks": list(a.shape),
                             "dtype": _zarr_dtype(a), "compressor": {"id": "zstd", "level": 1},
                             "dimension_separator": ".", "fill_value": None, "order": "C"},
                "create": True}
        arr = ts.open(spec).result()
        arr.write(a.view(np.uint16).view(arr.dtype.numpy_dtype)
                  if a.dtype == np.dtype("V2") else a).result()
    entry = {"value_type": "np.ndarray", "skip_deserialize": False}
    tree_meta = {"('meta_json',)": {"key_metadata": [{"key": "meta_json", "key_type": 2}],
                                    "value_metadata": entry}}
    for group, kind, k in keys:
        tree_meta[str((group, k))] = {
            "key_metadata": [{"key": group, "key_type": 2}, {"key": k, "key_type": kind}],
            "value_metadata": entry}
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _ORBAX_HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_train_state_orbax(path: str, trainable_template: Params,
                           opt_state_template: OptState) -> Tuple[Params, OptState, Dict]:
    """-> (trainable, opt_state, meta) from the orbax directory ``path``
    (either package's), on the templates' devices and in their dtypes."""
    ts = require_tensorstore()
    base = {"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/"}

    def read(name: str) -> np.ndarray:
        a = ts.open({"driver": "zarr", "kvstore": {**base, "path": f"{name}/"},
                     "open": True}).result().read().result()
        return a.view(np.uint16).view(np.dtype("V2")) if a.dtype.name == "bfloat16" else a

    trainable = {k: _check_shape(k, array_to_tensor(read(f"trainable.{k}")), t)
                 for k, t in trainable_template.items()}
    n_leaves = len(opt_leaves(opt_state_template))
    leaves = [array_to_tensor(read(f"opt_leaves.{i}")) for i in range(n_leaves)]
    meta = json.loads(bytes(read("meta_json")).decode())
    return trainable, opt_from_leaves(opt_state_template, leaves), meta
