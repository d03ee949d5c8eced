"""Params from the JAX package's flat dict to the port's.

Both packages key params by the same torch ``state_dict`` names in the same
``(out, in)`` layout, so the move is a per-entry copy. Every array is copied
(JAX on the CPU can alias memory that torch would then share), alias entries
stay separate tensors, and bfloat16 arrays cross through a uint16 view,
which ``torch.from_numpy`` needs. ``opt_state_from_jax`` moves the JAX
package's ``FusedAdamState(count, mu, nu)`` the same way, so both packages
can start a train step from one mid-schedule state.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from gaviko_tpu_torch.core.layers import Params
from gaviko_tpu_torch.train.fused_optim import FusedAdamState


def array_to_tensor(v) -> torch.Tensor:
    """A numpy (or numpy-convertible) array -> a CPU tensor owning a copy.
    bfloat16 (ml_dtypes, or the raw 2-byte void dtype numpy writes to .npz)
    becomes torch.bfloat16."""
    a = np.array(v, copy=True)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax(params: Mapping[str, object], device="cpu",
             dtype: Optional[torch.dtype] = None) -> Params:
    """JAX flat params (numpy or jax arrays) -> ``{name: Tensor}`` on
    ``device``. ``dtype`` casts floating-point entries; others keep theirs."""
    out: Params = {}
    for k, v in params.items():
        t = array_to_tensor(v)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def opt_state_from_jax(state, device="cpu") -> FusedAdamState:
    """The JAX package's ``FusedAdamState`` (numpy or jax leaves) -> the
    port's, with the count as a host int."""
    return FusedAdamState(count=int(np.asarray(state.count)),
                          mu=from_jax(state.mu, device),
                          nu=from_jax(state.nu, device))
