"""Mesh-parallel (DP x TP) inference: the sharded forward behind serving.

Port of ``gaviko_tpu/parallel/infer.py``. It reuses the training side's
shard rules and sharded forward (``parallel/mesh.py``): each rank holds its
Megatron shard of the weights and forwards its rows of the batch (rows
[d * B / data, (d + 1) * B / data) of a micro-batch every rank holds whole),
and the logits come back whole on every rank. The JAX package jits one forward whose shardings
GSPMD partitions; here every rank of the process group calls the forward
together, in the dtype of the params and inputs it is given (the serving
dtype: ``parallel_predictor_fn`` is called without ``compute_dtype``, as in
the JAX package).
"""

from __future__ import annotations

from typing import Optional

import torch

from gaviko_tpu_torch.parallel.mesh import (Mesh, forward_rows, gather_rows, make_mesh,
                                            shard_params, tp_plan)


def make_parallel_forward(model, mesh: Mesh, params, compute_dtype: Optional[torch.dtype] = None):
    """-> (forward(params, inputs) -> f32 logits [B, classes], this rank's
    params). ``inputs`` is the whole micro-batch, on every rank; ``B`` must
    divide by the mesh's data size. Weights whose heads or hidden width do
    not divide stay whole, and so do int8 serving's blocks (their sidecars
    and float weights): B11 runs each on every rank, on its rows."""
    plan = tp_plan(params, model.spec.heads, mesh.model)
    sharded = shard_params(params, plan, mesh.m, mesh.model, model.spec.heads)

    @torch.inference_mode()
    def forward(prm, inputs: torch.Tensor) -> torch.Tensor:
        B = inputs.shape[0]
        if B % mesh.data:
            raise ValueError(f"a batch of {B} does not split over {mesh.data} data ranks")
        per = B // mesh.data
        rows = inputs[mesh.d * per:(mesh.d + 1) * per]
        return gather_rows(forward_rows(model, mesh, plan, prm, rows, compute_dtype), mesh)

    forward.reshard = lambda whole: shard_params(whole, plan, mesh.m, mesh.model,
                                                 model.spec.heads)
    return forward, sharded


def parallel_predictor_fn(model, params, data: int, tp: int,
                          compute_dtype: Optional[torch.dtype] = None):
    """Serving's entry: the mesh over the current process group (exactly
    data x tp ranks) -> (forward, this rank's params, mesh)."""
    mesh = make_mesh(data=data, model=tp)
    forward, sharded = make_parallel_forward(model, mesh, params, compute_dtype)
    return forward, sharded, mesh
