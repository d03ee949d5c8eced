"""Multi-device training: the process group, the mesh, the shard rules, ZeRO
and the parallel train and eval steps.

Port of ``gaviko_tpu/parallel/mesh.py``. The JAX package places arrays on a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives; here each rank
is one process that computes on its shard itself and calls the collectives:

- topology (:func:`init_distributed`): ``torch.distributed`` from the keys
  JAX reads (``train.parallel.coordinator_address`` / ``num_processes`` /
  ``process_id``; ``num_processes`` counts ranks, one a device, where JAX's
  counts hosts) or torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``). The backend is chosen after the rendezvous,
  before the group forms, from the layout the ranks report through the
  store: NCCL where every host has a card for each of its ranks, gloo where
  ranks share a card (NCCL refuses two ranks on one device) or run on the
  CPU. Any topology given explicitly raises when init fails; with none, one
  process runs (a warning under ``multihost: true``, as in JAX);
- :class:`Mesh`: rank = d * model + m (``mesh.py:120``'s layout), with a
  ``data`` group (the ranks of one m), a ``model`` group (the ranks of one
  d) and a gloo group for host-side decisions;
- the shard rules (:func:`tp_plan`): Megatron-style over the torch-layout
  (out, in) weights. A block's ``to_qkv.weight`` splits by heads (the q, k
  and v rows of heads [h0, h0 + H / tp), not JAX's contiguous row split)
  and its ``to_out.0.weight`` by the same heads' input columns; an MLP's
  ``net.1`` by its rows (with its bias) and ``net.4`` by its input columns.
  A block whose heads (or hidden width) do not divide by tp stays whole on
  every rank, as JAX replicates a dimension that does not divide. GAViKO's
  local attention (``local_attns.*.qkv.weight``) is not a ``to_qkv`` and
  stays whole, and so do MeLO's LoRA-merged layers (``to_qkv.qkv.weight``,
  which JAX splits by rows: whole here, the same numbers) and the weights
  of every method that no rule covers (prompts, adapters, DVPT's and EVP's
  generators, the head): every model rank computes them, as JAX replicates
  them. SSF's scale and shift of a split qkv or fc1 output split with its
  rows. :func:`shard_params` and :func:`gather_shards` turn a whole
  flat dict (torch or the JAX package's numpy) into each rank's and back;
- ZeRO (``zero: true``): each data rank owns the slice of every Adam
  moment along its largest axis divisible by the data size
  (:func:`zero_axis`, JAX's ``zero_sharding_for``), updates that slice of
  the parameter and the slices are gathered; leaves that do not divide
  stay whole and every data rank updates them;
- :class:`ParallelTrainer`: the counterpart of ``make_parallel_train_step``.
  The loss of a data shard divides its sum by the whole batch's count of
  valid rows, so the gradients, summed over ``data`` in one flat bucket a
  dtype, are the whole batch's. The gradients of a split block's LayerNorm
  and output bias are partial sums over ``model`` too, and are first
  summed over ``model``. B13 runs sharded (``ops/fused_adam.py``): the sum of squares
  of the leaves a rank counts, all-reduced, then the update. With
  ``accumulation_steps`` k > 1 each micro-step folds this rank's slices of
  the summed gradients into its slices of optax ``MultiSteps``' running
  mean, and every k-th runs that sharded B13 update on the mean.

Collectives. Gradients are summed in flat buckets, one a dtype. Under ZeRO
each data rank receives only its slices of the summed gradients
(:func:`reduce_scatter_flat`) and the updated slices are gathered
(:func:`all_gather_flat`). NCCL and gloo on the CPU run these as
reduce-scatter and all-gather. gloo moves CUDA tensors through the host and
has only ``all_reduce`` and ``broadcast`` for them: there both are built
from an all-reduce (of the whole gradient, then sliced; of a zero-filled
whole that each rank fills with its slice), which moves n times the bytes.
"""

from __future__ import annotations

import logging
import os
import re
import socket
from collections import defaultdict
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from gaviko_tpu_torch.ops.int8_linear import INT8_SUFFIX
from gaviko_tpu_torch.parallel import shard as shard_lib

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------ topology ----

# How long the rendezvous and every later collective may wait.
INIT_TIMEOUT = timedelta(minutes=30)

# This process's index among the ranks of its host, as init_distributed
# observed it. None before a multi-process init.
_local_rank: Optional[int] = None


def _opt(par_cfg: dict, key: str, env: str):
    v = par_cfg.get(key)
    return os.environ.get(env) if v is None else v


def local_rank() -> int:
    """This process's index among the ranks of its host."""
    return _local_rank if _local_rank is not None else int(os.environ.get("LOCAL_RANK", 0))


def plan_layout(ranks: Sequence[Tuple[str, int]], rank: int,
                device_type: str) -> Tuple[str, int, int]:
    """(backend, local rank, ranks on this host) from every rank's (host
    name, cards on its host), in rank order. NCCL where every host has a
    card for each of its ranks; gloo where ranks share a card or compute on
    the CPU. Every rank computes the same backend from the same list."""
    hosts: Dict[str, List[int]] = defaultdict(list)
    for r, (host, _) in enumerate(ranks):
        hosts[host].append(r)
    cards = dict(ranks)
    nccl = device_type == "cuda" and all(len(rs) <= cards[h] for h, rs in hosts.items())
    mine = hosts[ranks[rank][0]]
    return ("nccl" if nccl else "gloo"), mine.index(rank), len(mine)


def rank_device(device: torch.device) -> torch.device:
    """This rank's device of ``device``'s type: ``cuda:(local rank % cards)``
    (ranks beyond the cards share them round robin), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank() % max(torch.cuda.device_count(), 1))


def init_distributed(par_cfg: dict, device_type: str = "cuda",
                     timeout: Optional[timedelta] = None) -> Tuple[int, int]:
    """Join the process group a topology asks for -> (rank, world size).

    The topology comes from ``coordinator_address`` (``host:port``, or an
    init URL such as ``file:///path``), ``num_processes`` and ``process_id``
    in ``par_cfg``, else from torchrun's environment. ``num_processes``
    counts ranks, one a device: the JAX package's counts hosts, each driving
    all its local devices, so a multi-host config carried over from JAX
    gives here the hosts times their cards. Anything given counts as a
    request: a missing piece or a failed init raises, so no rank ever trains
    alone on 1 / N of the data. With nothing given one process runs (with a
    warning under ``multihost: true``).

    The backend is chosen after the rendezvous and before the group forms,
    from the layout every rank reports through the store (its host name and
    its host's cards): NCCL where each host has a card for each of its
    ranks, else gloo (:func:`plan_layout`); no other backend is tried after
    a failure. ``timeout`` (default :data:`INIT_TIMEOUT`) bounds the
    rendezvous and every later collective."""
    global _local_rank
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    addr = par_cfg.get("coordinator_address")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    nproc = _opt(par_cfg, "num_processes", "WORLD_SIZE")
    pid = _opt(par_cfg, "process_id", "RANK")
    if addr is None and nproc is None and pid is None:
        if par_cfg.get("multihost"):
            logging.warning("train.parallel.multihost: no topology given (coordinator_address, "
                            "num_processes, process_id, or torchrun's environment); running "
                            "one process")
        return 0, 1
    missing = [k for k, v in (("coordinator_address", addr), ("num_processes", nproc),
                              ("process_id", pid)) if v is None]
    if missing:
        raise RuntimeError(f"a multi-process topology was requested but {missing} are not "
                           "given (config train.parallel, or torchrun's MASTER_ADDR / "
                           "MASTER_PORT / WORLD_SIZE / RANK)")
    world, rank = int(nproc), int(pid)
    method = str(addr) if "://" in str(addr) else f"tcp://{addr}"
    timeout = timeout or INIT_TIMEOUT
    backend = "?"
    try:
        store, _, _ = next(dist.rendezvous(method, rank, world, timeout=timeout))
        store.set_timeout(timeout)
        layout = dist.PrefixStore("gaviko_layout", store)
        cards = torch.cuda.device_count() if device_type == "cuda" else 0
        layout.set(str(rank), f"{cards} {socket.gethostname()}")
        ranks = [layout.get(str(r)).decode().split(" ", 1) for r in range(world)]
        backend, lrank, lranks = plan_layout([(h, int(c)) for c, h in ranks], rank,
                                             device_type)
        logging.info(f"torch.distributed: rank {rank} of {world} ({lrank} of {lranks} on "
                     f"its host) on {backend} at {method}"
                     + (" (ranks share a card or run on the CPU)" if backend == "gloo" else ""))
        dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                                timeout=timeout)
    except Exception as e:  # noqa: BLE001 - re-raised with the topology named
        raise RuntimeError(
            f"torch.distributed init failed for the requested {world}-process topology "
            f"(rank {rank}, {backend}, {method}): {e}. Refusing to continue as one "
            f"process, which would train on 1 / {world} of the data.") from e
    _local_rank = lrank
    return rank, world


def mesh_axes(par_cfg: dict, world: int) -> Tuple[int, int]:
    """(data, model) of ``train.parallel``: ``data: auto`` is world / model."""
    model = int(par_cfg.get("model", 1) or 1)
    data = par_cfg.get("data", "auto")
    data = world // model if data in (None, "auto") else int(data)
    if data < 1 or data * model != world:
        raise ValueError(f"train.parallel: a {data} x {model} mesh needs {data * model} ranks; "
                         f"the process group has {world}")
    return data, model


@dataclass
class Mesh:
    """The ranks as a data x model grid: rank = d * model + m. A group of one
    rank is None (its collectives are skipped)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: object = None
    model_group: object = None
    world_group: object = None
    ctrl_group: object = None  # gloo over every rank: host-side decisions

    @property
    def d(self) -> int:
        return self.rank // self.model

    @property
    def m(self) -> int:
        return self.rank % self.model

    def shard(self, batch: int, split=frozenset()) -> shard_lib.Shard:
        """This rank's part of a forward over a global batch of ``batch`` rows."""
        per = batch // self.data
        return shard_lib.Shard(b0=self.d * per, batch=per, m=self.m, tp=self.model,
                               group=self.model_group, split=frozenset(split))


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The mesh over the current process group, which must hold exactly
    data x model ranks (one process, uninitialized, for 1 x 1). Every rank
    calls it, in the same order as its other group constructors."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks; the process "
                         f"group has {world} (launch that many, e.g. torchrun "
                         f"--nproc_per_node {data * model})")
    mesh = Mesh(data, model, dist.get_rank() if world > 1 else 0)
    if world == 1:
        return mesh
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == mesh.d:
                mesh.model_group = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == mesh.m:
                mesh.data_group = g
    mesh.world_group = dist.group.WORLD
    mesh.ctrl_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
    return mesh


# ---------------------------------------------------------- collectives ----

def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over ``group``, with one collective per dtype and
    device (a flat bucket); the results are views of the buckets. No group
    (one rank): the tensors as they are."""
    if group is None or not tensors:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    buckets = defaultdict(list)
    for i, t in enumerate(tensors):
        buckets[(t.dtype, t.device)].append(i)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


# torch 2.13 renames these (the old names warn).
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _native(t: torch.Tensor, group) -> bool:
    """Whether ``group``'s backend has reduce-scatter and all-gather for
    ``t``'s device: NCCL, and gloo on the CPU (gloo on CUDA tensors has
    only ``all_reduce`` and ``broadcast``)."""
    return t.device.type == "cpu" or dist.get_backend(group) == "nccl"


def _front(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``t`` with ``axis`` moved first, as [n, numel / n]: row i is the
    i-th of n equal slices along ``axis``."""
    return t.movedim(axis, 0).reshape(n, -1)


def _back(flat: torch.Tensor, axis: int, shape) -> torch.Tensor:
    """Inverse of :func:`_front`: a tensor of ``shape`` from its rows."""
    moved = [shape[axis]] + [s for a, s in enumerate(shape) if a != axis]
    return flat.reshape(moved).movedim(0, axis)


def reduce_scatter_flat(tensors: Sequence[torch.Tensor], axes: Sequence[int],
                        group) -> List[torch.Tensor]:
    """Each tensor summed over ``group``, of which this rank gets its slice
    along its axis (slice r of n for group rank r), one collective a dtype.
    Where the backend lacks reduce-scatter: a whole all-reduce, then the
    slice."""
    if group is None or not tensors:
        return list(tensors)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if not _native(tensors[0], group):
        return [t.narrow(a, r * (t.shape[a] // n), t.shape[a] // n).contiguous()
                for t, a in zip(all_reduce_flat(tensors, group), axes)]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    buckets = defaultdict(list)
    for i, t in enumerate(tensors):
        buckets[(t.dtype, t.device)].append(i)
    for idx in buckets.values():
        rows = torch.cat([_front(tensors[i], axes[i], n) for i in idx], dim=1)
        mine = rows.new_empty(rows.shape[1])
        _REDUCE_SCATTER(mine, rows.reshape(-1), group=group)
        off = 0
        for i in idx:
            shape = list(tensors[i].shape)
            shape[axes[i]] //= n
            k = tensors[i].numel() // n
            out[i] = _back(mine[off:off + k], axes[i], shape).contiguous()
            off += k
    return out


def all_gather_flat(parts: Sequence[torch.Tensor], axes: Sequence[int],
                    group) -> List[torch.Tensor]:
    """Each whole tensor from every rank of ``group``'s slice along its axis
    (group rank r holds slice r), one collective a dtype. Where the backend
    lacks all-gather: an all-reduce of a zero-filled whole that each rank
    fills with its slice (n times the bytes)."""
    if group is None or not parts:
        return list(parts)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if not _native(parts[0], group):
        full = []
        for p, a in zip(parts, axes):
            shape = list(p.shape)
            shape[a] *= n
            buf = p.new_zeros(shape)
            buf.narrow(a, r * p.shape[a], p.shape[a]).copy_(p)
            full.append(buf)
        return all_reduce_flat(full, group)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    buckets = defaultdict(list)
    for i, p in enumerate(parts):
        buckets[(p.dtype, p.device)].append(i)
    for idx in buckets.values():
        mine = torch.cat([_front(parts[i], axes[i], 1) for i in idx], dim=1).reshape(-1)
        rows = mine.new_empty(n * mine.numel())
        _ALL_GATHER(rows, mine, group=group)
        rows = rows.view(n, -1)
        off = 0
        for i in idx:
            shape = list(parts[i].shape)
            shape[axes[i]] *= n
            k = parts[i].numel()
            out[i] = _back(rows[:, off:off + k], axes[i], shape).contiguous()
            off += k
    return out


def host_any(flag: bool, mesh: Mesh) -> bool:
    """Whether any rank's ``flag`` is set (every rank learns the same)."""
    if mesh.ctrl_group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.ctrl_group)
    return bool(t.item())


def host_decide(flag: bool, mesh: Mesh) -> bool:
    """Rank 0's ``flag``, on every rank: a decision one rank makes (a wall
    clock, a signal) so that no rank enters a collective alone."""
    if mesh.ctrl_group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.broadcast(t, src=0, group=mesh.ctrl_group)
    return bool(t.item())


# ---------------------------------------------------------- shard rules ----

_QKV = re.compile(r"(.+)\.to_qkv\.weight")
_FC1 = re.compile(r"(.+)\.net\.1\.weight")


def tp_plan(params: Mapping, heads: int, tp: int) -> Dict[str, str]:
    """name -> how it splits over ``tp`` model ranks ("qkv" by heads' rows,
    "out" by their input columns, "rows", "cols"), for every weight of a
    block that splits; names absent stay whole. ``heads`` is the model's
    head count (every ``to_qkv`` has it). SSF's scale and shift of a split
    GEMM's output (``ssf_scale_1`` / ``ssf_shift_1``) split as its rows. A
    block carrying int8 sidecars stays whole: int8 serving on a mesh runs
    B11 on the whole layer on every rank (its rows split over data)."""
    plan: Dict[str, str] = {}
    if tp <= 1:
        return plan
    for name in params:
        if name + INT8_SUFFIX in params:
            continue
        qkv, fc1 = _QKV.fullmatch(name), _FC1.fullmatch(name)
        if qkv and heads % tp == 0 and f"{qkv[1]}.to_out.0.weight" in params:
            pre, how = qkv[1], "qkv"
            plan[name], plan[f"{pre}.to_out.0.weight"] = "qkv", "cols"
        elif (fc1 and params[name].shape[0] % tp == 0
                and f"{fc1[1]}.net.4.weight" in params):
            pre, how = fc1[1], "rows"
            plan[name], plan[f"{pre}.net.4.weight"] = "rows", "cols"
            if f"{pre}.net.1.bias" in params:
                plan[f"{pre}.net.1.bias"] = "rows"
        else:
            continue
        for leaf in ("ssf_scale_1", "ssf_shift_1"):
            if f"{pre}.{leaf}" in params:
                plan[f"{pre}.{leaf}"] = how
    return plan


def partial_grad_names(plan: Mapping[str, str], names) -> frozenset:
    """The whole (replicated) weights whose gradient each model rank holds
    only a part of: a split block's LayerNorm and SSF's scale and shift
    after it (applied after ``copy_in``), and its output bias (added on
    model rank 0 only)."""
    out = set()
    for name, how in plan.items():
        if name.endswith(".to_qkv.weight"):
            pre = name[:-len(".to_qkv.weight")]
            out |= {f"{pre}.norm.weight", f"{pre}.norm.bias", f"{pre}.to_out.0.bias"}
        elif name.endswith(".net.1.weight"):
            pre = name[:-len(".net.1.weight")]
            out |= {f"{pre}.net.0.weight", f"{pre}.net.0.bias", f"{pre}.net.4.bias"}
        else:
            continue
        out |= {f"{pre}.ssf_scale_0", f"{pre}.ssf_shift_0"}
    return frozenset(out & set(names))


def _index(how: str, shape, m: int, tp: int, heads: int):
    """(reshaped view shape, index) of rank m's part of a weight of ``shape``."""
    if how == "qkv":
        hl = heads // tp
        return (3, heads, shape[0] // (3 * heads), *shape[1:]), (slice(None),
                                                                 slice(m * hl, (m + 1) * hl))
    n = shape[0 if how == "rows" else 1] // tp
    part = slice(m * n, (m + 1) * n)
    return tuple(shape), (part,) if how == "rows" else (slice(None), part)


def shard_tensor(t, how: str, m: int, tp: int, heads: int):
    """Rank m's part of weight ``t`` (torch or numpy), contiguous."""
    view, idx = _index(how, t.shape, m, tp, heads)
    part = t.reshape(view)[idx]
    part = part.reshape((-1, *t.shape[1:])) if how == "qkv" else part
    return part.contiguous() if isinstance(part, torch.Tensor) else np.ascontiguousarray(part)


def place_tensor(full, part, how: str, m: int, tp: int, heads: int) -> None:
    """Write rank m's ``part`` into its place in ``full`` (same library)."""
    view, idx = _index(how, full.shape, m, tp, heads)
    dst = full.reshape(view)
    dst[idx] = part.reshape(dst[idx].shape)


def shard_params(params: Mapping, plan: Mapping[str, str], m: int, tp: int,
                 heads: int) -> dict:
    """Rank m's flat dict: split weights cut to its part, the rest as given."""
    return {k: shard_tensor(v, plan[k], m, tp, heads) if k in plan else v
            for k, v in params.items()}


def gather_shards(shards: Sequence[Mapping], plan: Mapping[str, str], heads: int) -> dict:
    """The whole flat dict from every model rank's (in rank order)."""
    tp = len(shards)
    out = {}
    for k, v in shards[0].items():
        if k not in plan:
            out[k] = v
            continue
        shape = list(v.shape)
        shape[1 if plan[k] == "cols" else 0] *= tp
        full = (torch.zeros(shape, dtype=v.dtype, device=v.device)
                if isinstance(v, torch.Tensor) else np.zeros(shape, v.dtype))
        for m, sh in enumerate(shards):
            place_tensor(full, sh[k], plan[k], m, tp, heads)
        out[k] = full
    return out


def zero_axis(shape, data: int) -> Optional[int]:
    """ZeRO's axis for a leaf of ``shape`` over ``data`` ranks: the largest
    axis that divides (the first of equal ones), or None (JAX's
    ``zero_sharding_for``)."""
    if data > 1 and len(shape) > 0:
        for a in sorted(range(len(shape)), key=lambda a: -shape[a]):
            if shape[a] % data == 0 and shape[a] >= data:
                return a
    return None


def zero_slice(t: torch.Tensor, axis: Optional[int], d: int, data: int) -> torch.Tensor:
    """Data rank d's slice of ``t`` along ``axis`` (all of it at None)."""
    if axis is None:
        return t
    n = t.shape[axis] // data
    return t.narrow(axis, d * n, n)


# ----------------------------------------------------- sharded forward ----

def forward_rows(model, mesh: Mesh, plan: Mapping[str, str], params: Params,
                 rows: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                 train: bool = False, seeds=None) -> torch.Tensor:
    """This rank's forward of its rows of the global batch on its shard of
    the weights -> f32 logits. ``compute_dtype``: f32 weights and the rows
    are cast to it first (None: as given)."""
    if compute_dtype is not None:
        params = {k: v.to(compute_dtype) if v.dtype == torch.float32 else v
                  for k, v in params.items()}
        rows = rows.to(compute_dtype)
    with shard_lib.active(mesh.shard(rows.shape[0] * mesh.data, plan)):
        return model.apply(params, rows, model.spec, train=train, seeds=seeds).float()


def gather_rows(rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch's rows from every data rank's (collective)."""
    return all_gather_flat([rows.contiguous()], [0], mesh.data_group)[0]


# ------------------------------------------------------ the sharded step ----

class ShardedAdamState(NamedTuple):
    """A rank's optimizer state: its slices of the moments and of the
    trainable parameters (``owned``), the ones B13 updates in place. With
    ``accumulation_steps > 1`` it is the ``inner`` of a ``MultiStepState``
    whose ``acc`` holds this rank's slices of the running mean (ZeRO-sliced
    as the moments are, as JAX shards every leaf of the state)."""

    count: int
    mu: Params
    nu: Params
    owned: Params


# With accumulation a rank holds ``fused_optim.MultiStepState`` around it.
OptState = Union[ShardedAdamState, "fused_optim.MultiStepState"]


class ParallelTrainer:
    """The parallel train and eval steps of one rank (the counterpart of
    ``make_parallel_train_step``), over whole ``trainable`` and ``frozen``
    dicts given on this rank's device. ``trainable`` / ``frozen`` /
    ``opt_state`` are then this rank's (``shard_state`` makes them from
    whole ones, ``gather_state`` whole ones from them, collectively).

    ``train_step(trainable, opt_state, frozen, inputs, labels, seeds,
    augment=None)`` takes this rank's rows of the global batch and the
    global batch's augmentation draws; ``eval_step(trainable, frozen,
    inputs, labels)``; both return the whole batch's loss and correct count
    (and the eval step its logits) on every rank."""

    def __init__(self, model, criterion: Callable, fused: dict, mesh: Mesh, trainable: Params,
                 frozen: Params, *, zero: bool = True, compute_dtype=torch.float32,
                 device_augment: bool = False):
        from gaviko_tpu_torch.ops.augment import eval_rescale
        from gaviko_tpu_torch.train.loop import make_loss_and_grads

        self.model, self.criterion, self.fused, self.mesh = model, criterion, fused, mesh
        self.compute_dtype, self.device_augment = compute_dtype, device_augment
        self.accum = fused["accum"]
        self._make_loss_and_grads = make_loss_and_grads
        self._prepare = eval_rescale if device_augment else (lambda x: x)
        heads = model.spec.heads
        whole = {**frozen, **trainable}
        self.heads = heads
        self.plan = tp_plan(whole, heads, mesh.model)
        self.partial = partial_grad_names(self.plan, trainable)
        self.keys = sorted(trainable)
        d, m, D = mesh.d, mesh.m, mesh.data
        self.axis = {k: zero_axis(self._local_shape(k, trainable[k]), D) if zero else None
                     for k in self.keys}
        # The leaves this rank counts toward the global norm: each element of
        # every gradient once over the mesh, so their sums of squares add up.
        counted = {k: (self.axis[k] is not None or d == 0) and (k in self.plan or m == 0)
                   for k in self.keys}
        self.order = ([k for k in self.keys if counted[k]]
                      + [k for k in self.keys if not counted[k]])
        self.n_counted = sum(counted.values())
        self._table = None
        self.full_template = dict(trainable)
        self.frozen = self._shard(frozen)
        self.trainable, self.opt_state = self.shard_state(trainable, None)

    # -- layout --

    def _local_shape(self, k: str, t: torch.Tensor):
        if k not in self.plan:
            return tuple(t.shape)
        shape = list(t.shape)
        shape[1 if self.plan[k] == "cols" else 0] //= self.mesh.model
        return tuple(shape)

    def _shard(self, params: Params) -> Params:
        return shard_params(params, self.plan, self.mesh.m, self.mesh.model, self.heads)

    def _slice(self, k: str, t: torch.Tensor) -> torch.Tensor:
        return zero_slice(t, self.axis[k], self.mesh.d, self.mesh.data)

    def shard_state(self, trainable: Params, opt_state) -> Tuple[Params, OptState]:
        """This rank's (trainable, optimizer state) from whole ones (a whole
        state of the optimizer's layout, see ``train.loop.init_opt_state``,
        or None for a fresh state): a ``ShardedAdamState``, or with
        accumulation a ``MultiStepState`` around one."""
        from gaviko_tpu_torch.train import fused_optim

        local = self._shard(trainable)
        # B13 updates contiguous tensors in place: a ZeRO slice gets its own.
        owned = {k: self._slice(k, v).clone(memory_format=torch.contiguous_format)
                 if self.axis[k] is not None else v for k, v in local.items()}
        if opt_state is None:
            def zeros():
                return {k: torch.zeros_like(v) for k, v in owned.items()}

            inner = ShardedAdamState(0, zeros(), zeros(), owned)
            if self.accum == 1:
                return local, inner
            return local, fused_optim.MultiStepState(0, 0, inner, zeros())
        multi = isinstance(opt_state, fused_optim.MultiStepState)
        if multi != (self.accum > 1):
            raise ValueError(f"a resume state of {type(opt_state).__name__} for "
                             f"accumulation_steps {self.accum}")
        whole = opt_state.inner if multi else opt_state
        inner = ShardedAdamState(int(whole.count), self._mine(whole.mu), self._mine(whole.nu),
                                 owned)
        if not multi:
            return local, inner
        return local, fused_optim.MultiStepState(int(opt_state.mini_step),
                                                 int(opt_state.gradient_step), inner,
                                                 self._mine(opt_state.acc))

    def _mine(self, whole: Params) -> Params:
        """This rank's own copies of its parts of whole state leaves."""
        return {k: self._slice(k, v).clone(memory_format=torch.contiguous_format)
                for k, v in self._shard(whole).items()}

    def _gather_data(self, parts: Params) -> Params:
        """Whole-over-data leaves from this rank's ZeRO slices (leaves that
        are whole pass through)."""
        keys = [k for k in self.keys if self.axis[k] is not None]
        out = dict(parts)
        out.update(zip(keys, all_gather_flat([parts[k] for k in keys],
                                             [self.axis[k] for k in keys],
                                             self.mesh.data_group)))
        return out

    def _gather_model(self, local: Params) -> Params:
        """Whole leaves from this rank's tensor-parallel parts."""
        keys = [k for k in sorted(local) if k in self.plan]
        full = []
        for k in keys:
            buf = torch.zeros(self.full_template[k].shape, dtype=local[k].dtype,
                              device=local[k].device)
            place_tensor(buf, local[k], self.plan[k], self.mesh.m, self.mesh.model, self.heads)
            full.append(buf)
        out = dict(local)
        out.update(zip(keys, all_reduce_flat(full, self.mesh.model_group)))
        return out

    def gather_trainable(self, trainable: Params) -> Params:
        """Whole trainable tensors (collective: every rank calls it)."""
        return self._gather_model(trainable)

    def gather_state(self, trainable: Params, opt_state: OptState):
        """-> (whole trainable, whole optimizer state): the resume state one
        process would hold, in the optimizer's layout (``FusedAdamState``,
        the chain's ``ChainState`` or ``MultiStepState``; collective: every
        rank calls it)."""
        from gaviko_tpu_torch.train import fused_optim

        def whole(parts: Params) -> Params:
            return self._gather_model(self._gather_data(parts))

        if isinstance(opt_state, fused_optim.MultiStepState):
            inner = opt_state.inner
            state = opt_state._replace(
                inner=fused_optim.FusedAdamState(inner.count, whole(inner.mu), whole(inner.nu)),
                acc=whole(opt_state.acc))
        else:
            state = (fused_optim.ChainState if self.fused.get("chain")
                     else fused_optim.FusedAdamState)(opt_state.count, whole(opt_state.mu),
                                                      whole(opt_state.nu))
        return self._gather_model(trainable), state

    # -- steps --

    def _count(self, labels: torch.Tensor) -> torch.Tensor:
        """The whole batch's count of valid rows, on the device."""
        n = (labels != -100).sum().to(torch.float32).reshape(1)
        return all_reduce_flat([n], self.mesh.data_group)[0][0]

    def _rows(self, augment, batch: int):
        if augment is None:
            return None
        b0 = self.mesh.d * batch
        return type(augment)(*(t[b0:b0 + batch] for t in augment))

    def _sync_grads(self, grads: Params) -> Params:
        """This rank's ZeRO slice (or the whole leaf) of each gradient summed
        over data (the loss already divides by the whole batch's count); a
        split block's partial ones are first summed over model."""
        part = [k for k in self.keys if k in self.partial]
        grads = {**grads, **dict(zip(part, all_reduce_flat([grads[k] for k in part],
                                                          self.mesh.model_group)))}
        sliced = [k for k in self.keys if self.axis[k] is not None]
        whole = [k for k in self.keys if self.axis[k] is None]
        out = dict(zip(whole, all_reduce_flat([grads[k] for k in whole],
                                              self.mesh.data_group)))
        out.update(zip(sliced, reduce_scatter_flat([grads[k] for k in sliced],
                                                   [self.axis[k] for k in sliced],
                                                   self.mesh.data_group)))
        return out

    def _norm_reduce(self, total: torch.Tensor) -> None:
        if self.mesh.world_group is not None:
            dist.all_reduce(total, group=self.mesh.world_group)

    def _adam(self, grads: Params, state: ShardedAdamState, trainable: Params):
        from gaviko_tpu_torch.ops import _build
        from gaviko_tpu_torch.ops.fused_adam import AdamTable, fused_adam
        from gaviko_tpu_torch.train.fused_optim import step_scalars

        f = self.fused
        lr, beta1, c1, c2 = step_scalars(state.count, f["sched"], f["b1"])
        ks = self.order
        g = [grads[k].contiguous() for k in ks]
        mu, nu, p = ([d[k] for k in ks] for d in (state.mu, state.nu, state.owned))
        if ks and _build.use_kernel(p[0]) and (self._table is None
                                               or not self._table.holds(mu, nu, p)):
            self._table = AdamTable(mu, nu, p)
        new_p, new_m, new_v = fused_adam(g, mu, nu, p, lr, beta1, c1, c2, clip=f["clip"],
                                         eps=f["eps"], table=self._table,
                                         norm_reduce=self._norm_reduce,
                                         n_counted=self.n_counted)
        owned = dict(zip(ks, new_p))
        trainable = {**trainable, **self._gather_data(owned)}
        return trainable, state._replace(count=state.count + 1, mu=dict(zip(ks, new_m)),
                                         nu=dict(zip(ks, new_v)), owned=owned)

    def _update(self, grads: Params, state: OptState, trainable: Params):
        """B13 on this rank's slices of the summed gradients; with
        ``accumulation_steps`` k > 1, ``fused_optim.multi_step`` around it
        on the slices' running mean."""
        from gaviko_tpu_torch.train import fused_optim

        if self.accum == 1:
            return self._adam(grads, state, trainable)
        return fused_optim.multi_step(grads, state, trainable, self.accum, self._adam)

    def _sum(self, *values: torch.Tensor) -> List[torch.Tensor]:
        """Scalars summed over data, in one collective."""
        v = torch.stack([x.float() for x in values])
        v = all_reduce_flat([v], self.mesh.data_group)[0]
        return list(v.unbind())

    def train_step(self, trainable, opt_state, frozen, inputs, labels, seeds, augment=None):
        count = self._count(labels)
        criterion = lambda logits, lab: self.criterion(logits, lab, denominator=count)  # noqa: E731
        loss_and_grads = self._make_loss_and_grads(self.model, criterion, self.compute_dtype,
                                                   self.device_augment)
        with shard_lib.active(self.mesh.shard(inputs.shape[0] * self.mesh.data, self.plan)):
            loss, logits, grads = loss_and_grads(trainable, frozen, inputs, labels, seeds,
                                                 self._rows(augment, inputs.shape[0]))
        trainable, opt_state = self._update(self._sync_grads(grads), opt_state, trainable)
        correct = (logits.float().argmax(dim=1) == labels).sum()
        loss, correct = self._sum(loss, correct)
        return trainable, opt_state, loss, correct

    def forward(self, params: Params, inputs: torch.Tensor) -> torch.Tensor:
        """This rank's forward of its rows, in the compute dtype -> f32 logits."""
        return forward_rows(self.model, self.mesh, self.plan, params, inputs,
                            self.compute_dtype)

    @torch.no_grad()
    def eval_step(self, trainable, frozen, inputs, labels):
        count = self._count(labels)
        logits = self.forward({**frozen, **trainable}, self._prepare(inputs))
        loss = self.criterion(logits, labels, denominator=count)
        correct = (logits.argmax(dim=1) == labels).sum()
        loss, correct = self._sum(loss, correct)
        return loss, correct, gather_rows(logits, self.mesh)

