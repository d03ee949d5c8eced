"""The port's forward kernels as ``torch.library`` custom ops (``gaviko::*``).

The kernels are launched through ``ctypes`` on raw device pointers
(``_build.launch``), which ``torch.export`` cannot trace, and their wrappers
decide on pointers (alignment, whether K and V share a storage) that fake
tensors cannot answer. So while ``torch.export`` traces a forward
(``torch.compiler.is_exporting()``, ``deploy.export_artifact``), each wrapper
on a CUDA tensor records one of these ops instead of launching: the exported graph
holds ``torch.ops.gaviko.*`` nodes, as the JAX package's exported module
holds its kernels as ``tpu_custom_call`` payloads.

- Each op's CUDA implementation is its wrapper's own launch path, called
  outside the trace: the checks, the plan, the scratch buffers and the
  ``launches`` counter all stay inside it, so a call from an exported
  program launches exactly what an eager call launches.
- Each fake only allocates the outputs from the inputs' shapes and dtypes
  (with the strides the kernel writes); nothing in it reads the card.
- The ops take the serving path's arguments: no dropout, no saved
  statistics; an export with either raises in the wrapper.
- Backward kernels have no op: an artifact is a forward.

Eager calls never pass through these ops. A CPU tensor never reaches them
either: its wrapper runs the plain version, so a CPU export's graph holds
plain ATen ops.

One op is not a kernel: ``gaviko::model_all_reduce`` sums a tensor over the
model group of a mesh. A mesh artifact's program (``deploy.py``) holds one
rank's sharded forward; ``parallel/shard.reduce_out`` records this op where
an eager forward calls ``dist.all_reduce``. The export runs in one process
with no process group, so the group stays out of the graph, as the kernels'
pointers do: the serving predictor binds its model group around each call
(:func:`bound_model_group`), and the op refuses to run with none bound. It
is registered for ``cpu`` and ``cuda``, since a mesh artifact's ``cpu``
program holds it too.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

from gaviko_tpu_torch.ops import cls_attention as _cls
from gaviko_tpu_torch.ops import flash_attention as _fa
from gaviko_tpu_torch.ops import fused_mlp as _mlp
from gaviko_tpu_torch.ops import int8_linear as _int8
from gaviko_tpu_torch.ops import ln_linear as _ln
from gaviko_tpu_torch.ops import patchify as _patchify

Tensor = torch.Tensor


def _op(name: str):
    return torch.library.custom_op(f"gaviko::{name}", mutates_args=(), device_types="cuda")


@_op("patchify")
def patchify(img: Tensor, weight: Tensor, bias: Tensor, pos: Optional[Tensor]) -> Tensor:
    return _patchify.patchify_kernel(img, weight, bias, pos)


@patchify.register_fake
def _(img, weight, bias, pos):
    B, _, D, H, W, dim, pd, ph, pw = _patchify._geometry(img, weight)
    return img.new_empty((B, (D // pd) * (H // ph) * (W // pw), dim))


@_op("fused_mhsa")
def fused_mhsa(qkv: Tensor, heads: int, dim_head: int, scale: float, n_true: int) -> Tensor:
    return _fa._mhsa_forward(qkv, heads, dim_head, scale, n_true, 0.0, False, 0)


@fused_mhsa.register_fake
def _(qkv, heads, dim_head, scale, n_true):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], heads * dim_head))


@_op("flash_attention")
def flash_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    return _fa._flash_forward(q, k, v, scale)


@flash_attention.register_fake
def _(q, k, v, scale):
    # The kernel writes o in [B, N, H, D] memory (D padded to a multiple of
    # 8) and returns its [B, H, N, D] view.
    B, H, N, D = q.shape
    o = q.new_empty((B, N, H, D + (-D) % 8)).transpose(1, 2)
    return o[..., :D] if D % 8 else o


@_op("local_attention")
def local_attention(q: Tensor, k: Tensor, v: Tensor, scale: float, DHW: List[int],
                    local_k: List[int]) -> Tensor:
    return _fa._local_forward(q, k, v, scale, tuple(DHW), tuple(local_k), 0.0, 0)[0]


@local_attention.register_fake
def _(q, k, v, scale, DHW, local_k):
    return q.new_empty(q.shape)


@_op("fused_mlp")
def fused_mlp(x: Tensor, gamma: Tensor, beta: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
              b2: Tensor, eps: float, gelu: str, residual: bool) -> Tensor:
    return _mlp.fused_mlp_forward(x, gamma, beta, w1, b1, w2, b2, eps, gelu, 0.0, residual)


@fused_mlp.register_fake
def _(x, gamma, beta, w1, b1, w2, b2, eps, gelu, residual):
    return x.new_empty(x.shape)


@_op("cls_attention")
def cls_attention(kv: Tensor, q0: Tensor, heads: int, dim_head: int, scale: float,
                  n_true: int) -> Tensor:
    return _cls.cls_attention(kv, q0, heads, dim_head, scale, n_true)


@cls_attention.register_fake
def _(kv, q0, heads, dim_head, scale, n_true):
    return kv.new_empty((kv.shape[0], heads * dim_head))


@_op("ln_linear")
def ln_linear(x: Tensor, gamma: Tensor, beta: Tensor, w: Tensor, eps: float) -> Tensor:
    return _ln._ln_linear_forward(x, gamma, beta, w, eps)


@ln_linear.register_fake
def _(x, gamma, beta, w, eps):
    return x.new_empty((*x.shape[:-1], w.shape[0]))


@_op("int8_linear")
def int8_linear(x: Tensor, w_i8: Tensor, w_scale: Tensor, bias: Optional[Tensor],
                gamma: Optional[Tensor], beta: Optional[Tensor], eps: float) -> Tensor:
    return _int8.int8_linear(x, w_i8, w_scale, bias, gamma, beta, eps)


@int8_linear.register_fake
def _(x, w_i8, w_scale, bias, gamma, beta, eps):
    return x.new_empty((*x.shape[:-1], w_i8.shape[0]))


@_op("int8_mlp")
def int8_mlp(x: Tensor, gamma: Tensor, beta: Tensor, w1_i8: Tensor, s1: Tensor, b1: Tensor,
             w2_i8: Tensor, s2: Tensor, b2: Tensor, eps: float, gelu: str,
             residual: bool) -> Tensor:
    return _int8.int8_mlp(x, gamma, beta, w1_i8, s1, b1, w2_i8, s2, b2, eps, gelu, residual)


@int8_mlp.register_fake
def _(x, gamma, beta, w1_i8, s1, b1, w2_i8, s2, b2, eps, gelu, residual):
    return x.new_empty(x.shape)


# The model group ``model_all_reduce`` sums over, bound for this process by
# the serving predictor around a mesh forward (its dispatcher thread, the
# caller's, or a following rank's may run it), and its calls (read by
# chip_smoke.py).
_model_group = None
model_all_reduces = 0


@contextlib.contextmanager
def bound_model_group(group):
    """Bind ``group`` as the model group of ``gaviko::model_all_reduce`` in
    this process for the block (None: nothing bound)."""
    global _model_group
    before = _model_group
    _model_group = group
    try:
        yield
    finally:
        _model_group = before


@torch.library.custom_op("gaviko::model_all_reduce", mutates_args=(),
                         device_types=("cpu", "cuda"))
def model_all_reduce(y: Tensor) -> Tensor:
    global model_all_reduces
    if _model_group is None:
        raise RuntimeError(
            "gaviko::model_all_reduce: no model group is bound in this process; a mesh "
            "artifact's program runs under deploy.DeployedPredictor on its data x tp ranks")
    y = y.contiguous().clone()  # shard.reduce_out's eager sum, step for step
    dist.all_reduce(y, group=_model_group)
    model_all_reduces += 1
    return y


@model_all_reduce.register_fake
def _(y):
    return torch.empty_like(y, memory_format=torch.contiguous_format)


def graph_ops(graph_module: torch.fx.GraphModule) -> dict:
    """``{"gaviko::<op>": calls}`` of an exported graph (ops it never calls
    left out)."""
    counts: dict = {}
    for node in graph_module.graph.nodes:
        target = node.target
        if isinstance(target, torch._ops.OpOverload) and target.namespace == "gaviko":
            name = target.name().split(".")[0]
            counts[name] = counts.get(name, 0) + 1
    return counts
