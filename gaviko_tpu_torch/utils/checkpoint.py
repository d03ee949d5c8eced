"""Mid-training resume state, in the JAX package's npz layout.

Port of ``gaviko_tpu/utils/checkpoint.py``. The full train state (trainable
params, optimizer state, progress counters and best-val bookkeeping) is one
``.npz``:

- ``param::<name>`` for every trainable tensor;
- ``opt::<i>`` for the optimizer state's leaves in ``jax.tree.leaves``
  order: for ``FusedAdamState(count, mu, nu)`` the count, then ``mu`` in
  sorted key order, then ``nu``; for the accumulating state
  (``accumulation_steps > 1``) optax ``MultiStepsState``'s order, see
  :func:`opt_leaves`;
- ``meta::json``, the progress as UTF-8 JSON bytes.

So a resume file written by either package loads in the other. bfloat16
tensors are written as 2-byte raw values, as numpy writes the JAX package's
bfloat16 arrays. The orbax backend is not ported (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from gaviko_tpu_torch.train.fused_optim import FusedAdamState, MultiStepState
from gaviko_tpu_torch.weights.from_jax import array_to_tensor

Params = Dict[str, torch.Tensor]
OptState = object  # FusedAdamState or MultiStepState


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
    counterpart: ``FusedAdamState`` -> [count, *mu, *nu]; ``MultiStepState``
    -> optax ``MultiStepsState(mini_step, gradient_step, inner_opt_state,
    acc_grads)`` over the chain clip -> Adam -> lr schedule: [mini_step,
    gradient_step, count, *mu, *nu, count (the schedule's), *acc_grads]."""
    if isinstance(state, MultiStepState):
        inner = state.inner
        return [np.int32(state.mini_step), np.int32(state.gradient_step),
                np.int32(inner.count), *_sorted(inner.mu), *_sorted(inner.nu),
                np.int32(inner.count), *_sorted(state.acc)]
    return [np.int32(state.count), *_sorted(state.mu), *_sorted(state.nu)]


def _fill(template: Params, leaves: list) -> Params:
    out = {}
    for k, leaf in zip(sorted(template), leaves):
        t = template[k]
        if tuple(leaf.shape) != tuple(t.shape):
            raise ValueError(f"resume state: {k} has shape {tuple(leaf.shape)}, "
                             f"want {tuple(t.shape)}")
        out[k] = leaf.to(device=t.device, dtype=t.dtype)
    return out


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
    return FusedAdamState(int(leaves[0]), _fill(template.mu, leaves[1:1 + n]),
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
    their dtypes."""
    n_leaves = len(opt_leaves(opt_state_template))
    with np.load(path) as z:
        trainable = {}
        for k, t in trainable_template.items():
            arr = array_to_tensor(z[f"param::{k}"])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"resume state: {k} has shape {tuple(arr.shape)}, "
                                 f"want {tuple(t.shape)}")
            trainable[k] = arr.to(device=t.device, dtype=t.dtype)
        leaves = [array_to_tensor(z[f"opt::{i}"]) for i in range(n_leaves)]
        meta = json.loads(bytes(z["meta::json"]).decode())
    return trainable, opt_from_leaves(opt_state_template, leaves), meta
