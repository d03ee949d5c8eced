"""Deployment artifacts: an exported forward and its weights in one file.

Port of ``gaviko_tpu/deploy.py``. A model is packaged into one zip that
serves WITHOUT the model-building code:

- :func:`export_artifact` builds the params with
  :class:`gaviko_tpu_torch.serving.Predictor`'s own ``serving.load_params``
  (seed-0 init, the timm-converted backbone, the checkpoint overlay, the
  cast to the serving dtype, then the int8 sidecars), traces ``forward(params, x) ->
  model.apply(params, x, spec).float()`` at a fixed micro-batch with
  ``torch.export`` and writes ``meta.json``, one ``program.<platform>.pt2``
  per platform (``torch.export.save``) and ``params.pt``.
- :class:`DeployedPredictor` loads it and has ``Predictor``'s surface
  (``predict_logits``, ``predict``, ``batch_size``, ``num_classes``,
  ``reload_checkpoint``), so ``serving.serve`` and ``BatchQueue`` take it
  unchanged (``cli.serve --artifact model.gaviko``).

Each platform is its own program, traced apart: ``cuda`` on fake CUDA
tensors (so any host exports it, a CPU-only one included), its graph
calling the hand-written kernels as ``gaviko::`` custom ops
(``ops/library.py``); ``cpu`` on CPU tensors, its graph the kernels' plain
versions in ATen ops, as the JAX package's CPU export holds their XLA
twins. The params are inputs of the program, not constants, so a reload
swaps weights with no re-export, as JAX's module takes them as arguments.

The manifest records the ``gaviko::`` ops each program calls and
``kernel_sources``, the digest of the CUDA sources and flags
(``_build.sources_digest``): the program names the kernels, the package
that serves it builds them, and a package whose kernels differ refuses the
artifact up front (re-export). It does not skip the kernels' build: the
first call on a fresh host compiles them (``utils/compile_cache.py`` says
where). It skips the model build, weight conversion and tracing.

``mesh_shape=(data, tp)`` exports a mesh artifact, as the JAX package's
does: the forward of ``Predictor(mesh_shape=...)`` (``parallel/infer.py``),
batch rows over ``data`` and Megatron-style heads and hidden columns over
``tp``. The shard rules run once, at export (``parallel.mesh.tp_plan``); the
manifest records each split weight's placement (``qkv``, ``rows`` or
``cols``), the head count and ``mesh_shape``, and ``params.pt`` keeps the
whole weights. There is one program a model rank and platform,
``program.<platform>.m<m>.pt2``, traced under that rank's
``parallel.shard.Shard`` on its shard's shapes: the output bias and the
fused MLP's residual are added on model rank 0 only, so the programs
differ; the sum over the model group is the op ``gaviko::model_all_reduce``
in the graph. The data ranks share a program, which takes one rank's
``batch / data`` rows (a forward has no dropout, so a data rank's first
row enters no program). The row split and the gather of the logits over
``data`` live in :class:`DeployedPredictor`, not in the program: it joins a
process group of exactly ``data x tp`` ranks (torchrun), loads its model
rank's program, slices the whole weights by the manifest's placements
(``parallel.mesh.shard_tensor``; no ``tp_plan``, no model code), binds its
model group for the op, and follows ``Predictor``'s protocol: rank 0 takes
``predict_logits`` and ``reload_checkpoint`` and broadcasts each
micro-batch, the other ranks ``follow()`` until rank 0's ``close()``.

Serving imports only the op library, ``data.transforms``, ``utils.layouts``,
``weights.torch_io``, ``serving`` and ``parallel``: no ``models``, ``core``
or ``config``.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import threading
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops import library
from gaviko_tpu_torch.parallel import shard as shard_lib
from gaviko_tpu_torch.serving import MeshServing, check_mesh_world

ARTIFACT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
_META_NAME = "meta.json"
_PARAMS_NAME = "params.pt"
_JAX_MODULE_NAME = "module.jaxexport"  # the JAX package's artifact member


def _program_name(platform: str, m: Optional[int] = None) -> str:
    """A single-device program's member, or model rank ``m``'s of a mesh."""
    return f"program.{platform}.pt2" if m is None else f"program.{platform}.m{m}.pt2"


class _Forward(torch.nn.Module):
    """``forward(params, x)``: the model's logits in f32."""

    def __init__(self, model):
        super().__init__()
        self._model = model

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return self._model.apply(params, x, self._model.spec).float()


def _basic_index(t: torch.Tensor, index):
    """``t[index]`` for basic indexing (ints, slices, None, one Ellipsis) as
    the ATen views Python's indexing records; NotImplemented for any other
    index."""
    index = index if isinstance(index, tuple) else (index,)
    if any(not (i is None or i is Ellipsis or isinstance(i, slice)
                or (isinstance(i, int) and not isinstance(i, bool))) for i in index):
        return NotImplemented
    if Ellipsis in index:
        at = index.index(Ellipsis)
        rest = sum(i is not None and i is not Ellipsis for i in index)
        index = index[:at] + (slice(None),) * (t.dim() - rest) + index[at + 1:]
    dim = 0
    for i in index:
        if i is None:
            t = torch.ops.aten.unsqueeze.default(t, dim)
            dim += 1
        elif isinstance(i, int):
            t = torch.ops.aten.select.int(t, dim, i)
        else:
            if i != slice(None):
                t = torch.ops.aten.slice.Tensor(t, dim, i.start, i.stop,
                                                1 if i.step is None else i.step)
            dim += 1
    return t


class _BasicIndexing(TorchFunctionMode):
    """Basic indexing of a tensor, read or assigned (EVP's high-pass mask),
    as ATen views, in this thread. Python's indexing of a CUDA tensor needs
    PyTorch built with CUDA even when the tensor is fake, so the ``cuda``
    program could not be traced on a CPU-only host without it; the ops are
    the ones that indexing records on a host with a card."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            out = _basic_index(*args)
            if out is not NotImplemented:
                return out
        elif func is torch.Tensor.__setitem__:
            t, index, value = args
            view = _basic_index(t, index)
            if view is not NotImplemented:
                if isinstance(value, torch.Tensor):
                    view.copy_(value)
                else:
                    view.fill_(value)
                return None
        return func(*args, **(kwargs or {}))


def _export(model, params: dict, vol_shape, cdtype, platform: str):
    """Trace the forward for ``platform`` -> the ExportedProgram. ``cuda``
    traces on fake CUDA tensors of the params' shapes and dtypes (no card
    is touched), on any host; ``cpu`` on the params themselves."""
    indexing = contextlib.nullcontext()
    if platform == "cuda":
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            p = {k: torch.empty(v.shape, dtype=v.dtype, device="cuda")
                 for k, v in params.items()}
            x = torch.empty(vol_shape, dtype=cdtype, device="cuda")
        indexing = _BasicIndexing()
    else:
        p, x = params, torch.zeros(vol_shape, dtype=cdtype)
    with indexing, torch.no_grad():
        program = torch.export.export(_Forward(model), (p, x), strict=False)
    program._example_inputs = None  # fake tensors: nothing to keep
    return program


def export_artifact(
    config: dict,
    path: str,
    checkpoint: Optional[str] = None,
    batch_size: int = 8,
    dtype: str = "bfloat16",
    pretrained_dir: Optional[str] = "./pretrained",
    quantize: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
    mesh_shape: Optional[tuple] = None,
) -> dict:
    """Trace and serialize the model forward and write the artifact zip;
    returns the manifest. ``config['model']`` drives the build, the same
    contract as ``Predictor``; ``platforms`` takes ``cuda`` and / or
    ``cpu`` (default ``("cuda",)``); ``mesh_shape=(data, tp)`` writes a
    mesh artifact (one program a model rank; the module docstring)."""
    from gaviko_tpu_torch.models.factory import build_model
    from gaviko_tpu_torch.serving import load_params

    if quantize not in (None, "int8"):
        raise ValueError(f"Unknown quantize mode: {quantize!r}")
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype!r}")
    platforms = tuple(platforms) if platforms else ("cuda",)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms must be distinct, from {PLATFORMS}; got {platforms}")
    if mesh_shape is not None:
        data, tp = (int(x) for x in mesh_shape)
        if data < 1 or tp < 1:
            raise ValueError(f"mesh_shape takes (data, tp), two positive ints; got {mesh_shape}")
        if batch_size % data:
            raise ValueError(f"batch_size {batch_size} must divide the data axis {data}")

    model = build_model(config["model"])
    spec = model.spec
    cdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    params = load_params(model, checkpoint, pretrained_dir, cdtype, quantize)
    vol_shape = (batch_size, spec.channels, spec.frames, *spec.image_size)

    # (model rank or None, its params, the Shard it is traced as)
    ranks, rows = [(None, params, None)], vol_shape
    if mesh_shape is not None:
        from gaviko_tpu_torch.parallel.mesh import shard_params, tp_plan

        plan = tp_plan(params, spec.heads, tp)
        rows = (batch_size // data, *vol_shape[1:])
        ranks = [(m, shard_params(params, plan, m, tp, spec.heads),
                  shard_lib.Shard(batch=rows[0], m=m, tp=tp, split=frozenset(plan)))
                 for m in range(tp)]
    programs, ops = {}, {}
    for platform in platforms:
        for m, rank_params, shard in ranks:
            with shard_lib.active(shard):
                program = _export(model, rank_params, rows, cdtype, platform)
            calls = library.graph_ops(program.graph_module)
            ops[platform] = calls if m is None else [*ops.get(platform, []), calls]
            buf = io.BytesIO()
            torch.export.save(program, buf)
            programs[_program_name(platform, m)] = buf.getvalue()
    weights = io.BytesIO()
    torch.save({k: v.contiguous() for k, v in params.items()}, weights)

    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "batch_size": batch_size,
        "dtype": dtype,
        "quantize": quantize,
        "mesh_shape": None if mesh_shape is None else [data, tp],
        "num_classes": spec.num_classes,
        "input_shape": list(vol_shape),
        "model_config": config["model"],
        "param_shapes": {k: list(v.shape) for k, v in params.items()},
        "param_dtypes": {k: str(v.dtype).replace("torch.", "") for k, v in params.items()},
        "ops": ops,
        "kernel_sources": _build.sources_digest(),
    }
    if mesh_shape is not None:
        meta.update(heads=spec.heads, placements=plan)
    # Stored, not deflated: the weights do not compress, and a vit-l16's
    # would take tens of seconds to deflate and inflate.
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_META_NAME, json.dumps(meta, indent=1, default=str))
        for name, blob in programs.items():
            z.writestr(name, blob)
        z.writestr(_PARAMS_NAME, weights.getvalue())
    logging.info(f"Exported {spec.method}/{spec.backbone} to {path} "
                 f"(platforms={meta['platforms']}, batch={batch_size}, {dtype}"
                 + (f", mesh data={data} x tp={tp}" if mesh_shape is not None else "") + ")")
    return meta


def _check_manifest(meta: dict, names, platform: str) -> None:
    """Refuse, before anything loads, an artifact this package cannot serve
    on ``platform``."""
    if meta["artifact_version"] > ARTIFACT_VERSION:
        raise RuntimeError(f"artifact version {meta['artifact_version']} is newer than this "
                           f"library supports ({ARTIFACT_VERSION})")
    first = 0 if meta.get("mesh_shape") else None  # a mesh has model rank 0's program
    if platform not in meta["platforms"] or _program_name(platform, first) not in names:
        raise RuntimeError(f"artifact was exported for platforms {meta['platforms']} but this "
                           f"predictor runs on {platform!r} — re-export with "
                           f"--platforms {platform}")
    if meta["kernel_sources"] != _build.sources_digest():
        raise RuntimeError("artifact was exported against other CUDA kernel sources "
                           f"(kernel_sources {meta['kernel_sources'][:16]}..., this package "
                           f"{_build.sources_digest()[:16]}...) — re-export it with this "
                           "package: python -m gaviko_tpu_torch.cli.export")


def _unchecked(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """The exported module without its per-call checks: the check of every
    input's shape and dtype against the trace (a forward pre-hook) and the
    asserts of the dtype and device of each ``.to()``'s input (graph
    nodes). Both hold by construction here: the params are the artifact's
    own (a reload keeps shapes and dtypes) and :class:`DeployedPredictor`
    checks the batch's shape. A host-bound forward pays for every one of
    them (``chip_smoke.py`` phase 22 times the module with and without)."""
    graph = module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default and not node.users:
            graph.erase_node(node)
    module.recompile()
    module.validate_inputs = False
    return module


class DeployedPredictor(MeshServing):
    """Serve from an artifact, with the surface of ``serving.Predictor``.

    ``predict_logits`` / ``predict`` / ``batch_size`` / ``num_classes`` /
    ``reload_checkpoint`` keep Predictor's contracts, so ``serving.serve``
    and ``BatchQueue`` take it unchanged. ``self.params`` holds the host
    copies, whole (the overlay's and re-quantization's substrate); calls
    run on a snapshot of them on ``device`` (a mesh rank's slices), moved
    once a (re)load, so a reload is atomic: in-flight calls finish on the
    snapshot they started with. ``device`` ``"cuda"`` runs the ``cuda``
    program (the kernels), ``"cpu"`` the ``cpu`` program; neither falls
    back to the other. A mesh artifact needs a process group of exactly
    ``data x tp`` ranks, each constructing it; rank 0 serves and the others
    run :meth:`follow` until its :meth:`close` (``serving.MeshServing``)."""

    def __init__(self, path: str, device="cuda"):
        from gaviko_tpu_torch.data.transforms import eval_transform

        self.device = torch.device(device)
        self._mesh, self._lock = None, threading.Lock()
        platform = self.device.type
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            if _JAX_MODULE_NAME in names:
                raise RuntimeError(
                    f"{path} was exported by gaviko_tpu (a jax.export module); re-export "
                    "it with python -m gaviko_tpu_torch.cli.export")
            self.meta = json.loads(z.read(_META_NAME).decode())
            _check_manifest(self.meta, names, platform)
            if self.meta.get("mesh_shape"):
                self._join_mesh(path)
            blob = z.read(_program_name(platform, None if self._mesh is None else self._mesh.m))
            self.params = torch.load(io.BytesIO(z.read(_PARAMS_NAME)), weights_only=True)
        program = torch.export.load(io.BytesIO(blob))
        if platform == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if platform == "cuda" and self.device.index != 0:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, {"cuda:0": str(self.device)})
        self._program = _unchecked(program.module())
        self._shape = tuple(self.meta["input_shape"])
        self.batch_size = int(self.meta["batch_size"])
        self.num_classes = int(self.meta["num_classes"])
        self._cdtype = torch.bfloat16 if self.meta["dtype"] == "bfloat16" else torch.float32
        self._transform = eval_transform
        self._device_params = self._commit(self.params)
        mesh = self.meta.get("mesh_shape")
        logging.info(f"DeployedPredictor ready: {path} (batch {self.batch_size}, "
                     f"{self.meta['dtype']}, {self.device}"
                     + (f", mesh data={mesh[0]} x tp={mesh[1]}, rank {self._mesh.rank}"
                        if mesh else "") + ")")

    def _join_mesh(self, path: str) -> None:
        """The mesh of the artifact over the current process group, which
        must hold exactly data x tp ranks; this rank's device."""
        from gaviko_tpu_torch.parallel.mesh import make_mesh, rank_device

        data, tp = self.meta["mesh_shape"]
        check_mesh_world(data, tp, f"--artifact {path}")
        self._mesh = make_mesh(data, tp)
        self.device = rank_device(self.device)

    def _commit(self, host_params: dict) -> dict:
        """The host params on the device (once a load): on a mesh this
        rank's slice of each split weight, by the manifest's placements."""
        if self._mesh is None:
            return {k: v.to(self.device) for k, v in host_params.items()}
        from gaviko_tpu_torch.parallel.mesh import shard_tensor

        how, heads = self.meta["placements"], self.meta["heads"]
        m, tp = self._mesh.m, self._mesh.model
        return {k: (shard_tensor(v, how[k], m, tp, heads) if k in how else v).to(self.device)
                for k, v in host_params.items()}

    def _overlay(self, checkpoint: Optional[str]) -> dict:
        """The weights a trainable-only checkpoint changes, cast to the
        artifact's dtypes, with the int8 sidecars of overlaid keys quantized
        anew; checked against the artifact's params."""
        if checkpoint is None:
            raise ValueError("DeployedPredictor.reload_checkpoint requires a checkpoint path "
                             "(the artifact has no rebuild-from-config path)")
        from gaviko_tpu_torch.ops.int8_linear import INT8_SUFFIX, SCALE_SUFFIX, quantize_weight
        from gaviko_tpu_torch.weights.torch_io import load_checkpoint

        state = load_checkpoint(checkpoint)
        unknown = [k for k in state if k not in self.params]
        if unknown:
            raise KeyError(f"checkpoint keys not in the artifact's params (first 5): "
                           f"{unknown[:5]}")
        changed = {}
        for k, v in state.items():
            ref = self.params[k]
            if tuple(v.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {k!r}: checkpoint {tuple(v.shape)} vs "
                                 f"artifact {tuple(ref.shape)}")
            changed[k] = torch.as_tensor(v).to(ref.dtype)
            if k + INT8_SUFFIX in self.params:  # keep the int8 GEMMs' sidecars fresh
                changed[k + INT8_SUFFIX], changed[k + SCALE_SUFFIX] = quantize_weight(changed[k])
        return changed

    def _reload(self, changed: dict) -> None:
        params = {**self.params, **changed}
        device_params = self._commit(params)
        self.params, self._device_params = params, device_params

    def reload_checkpoint(self, checkpoint: Optional[str]) -> None:
        """Overlay a trainable-only checkpoint onto the artifact's weights
        (an atomic swap, as in Predictor); the int8 sidecars of overlaid
        keys are quantized anew. ``None`` is refused: the artifact has no
        rebuild-from-config path. On a mesh rank 0 overlays and quantizes,
        and every rank takes the changed weights and re-slices them."""
        changed = self._overlay(checkpoint)
        if self._mesh is not None:
            self._lead_reload(changed)
        else:
            self._reload(changed)
        logging.info(f"DeployedPredictor reloaded {checkpoint!r}")

    # -- mesh serving (MeshServing): rank 0 leads, the other ranks follow --

    def _rank_forward(self, params: dict, batch: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole micro-batch through its model
        rank's program, the logits gathered over ``data``."""
        from gaviko_tpu_torch.parallel.mesh import gather_rows

        mesh = self._mesh
        per = batch.shape[0] // mesh.data
        with torch.inference_mode(), library.bound_model_group(mesh.model_group):
            rows = self._program(params, batch[mesh.d * per:(mesh.d + 1) * per])
            return gather_rows(rows, mesh)

    def _served_params(self) -> dict:
        return self._device_params

    def _forward(self, params: dict, batch: torch.Tensor) -> np.ndarray:
        if self._mesh is not None:
            return self._lead_forward(params, batch)
        with torch.inference_mode():
            return self._program(params, batch).cpu().numpy()

    def predict_logits(self, volumes: Sequence[np.ndarray]) -> np.ndarray:
        """volumes: list of (D, H, W) or (C, D, H, W) arrays -> [n, classes]."""
        from gaviko_tpu_torch.utils.layouts import put_volume

        params = self._device_params  # one snapshot: a reload cannot mix chunks
        vols = [self._transform(v if v.ndim == 4 else np.expand_dims(v, 0)) for v in volumes]
        outs = []
        for i in range(0, len(vols), self.batch_size):
            chunk = vols[i: i + self.batch_size]
            n = len(chunk)
            if n < self.batch_size:
                chunk = chunk + [np.zeros_like(chunk[0])] * (self.batch_size - n)
            chunk = np.stack(chunk)
            if chunk.shape != self._shape:
                raise ValueError(f"volumes give a batch of {chunk.shape}; the artifact takes "
                                 f"{self._shape}")
            batch = put_volume(chunk, self._cdtype, self.device)
            outs.append(self._forward(params, batch)[:n])
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, self.num_classes), np.float32))

    def predict(self, volumes: Sequence[np.ndarray]) -> np.ndarray:
        return self.predict_logits(volumes).argmax(axis=-1)


def run_on_ranks(path: str, device, work):
    """Load the artifact at ``path`` on this process group, joined from
    torchrun's environment (one process without it), and run
    ``work(predictor)`` on rank 0 while the other ranks follow its orders
    -> ``work``'s result on rank 0, None on the others. A group this call
    joined it leaves. The CLIs' ``--artifact`` runs go through here."""
    import torch.distributed as dist

    from gaviko_tpu_torch.parallel.mesh import init_distributed

    joined = not dist.is_initialized()
    init_distributed({}, torch.device(device).type)
    try:
        pred = DeployedPredictor(path, device=device)
        if pred.mesh is not None and pred.mesh.rank != 0:
            pred.follow()
            return None
        try:
            return work(pred)
        finally:
            pred.close()
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
