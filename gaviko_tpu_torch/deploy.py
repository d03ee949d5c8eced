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

Serving imports only the op library, ``data.transforms``, ``utils.layouts``
and ``weights.torch_io``: no ``models``, ``core`` or ``config``.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from gaviko_tpu_torch.ops import _build
from gaviko_tpu_torch.ops import library

ARTIFACT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
_META_NAME = "meta.json"
_PARAMS_NAME = "params.pt"
_JAX_MODULE_NAME = "module.jaxexport"  # the JAX package's artifact member


def _program_name(platform: str) -> str:
    return f"program.{platform}.pt2"


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
    ``cpu`` (default ``("cuda",)``)."""
    from gaviko_tpu_torch.models.factory import build_model
    from gaviko_tpu_torch.serving import load_params

    if mesh_shape is not None:
        raise NotImplementedError(
            "mesh artifacts are not ported: exporting the collectives needs functional "
            "collectives in the graph (ROADMAP Queue A item 16)")
    if quantize not in (None, "int8"):
        raise ValueError(f"Unknown quantize mode: {quantize!r}")
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype!r}")
    platforms = tuple(platforms) if platforms else ("cuda",)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms must be distinct, from {PLATFORMS}; got {platforms}")

    model = build_model(config["model"])
    spec = model.spec
    cdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    params = load_params(model, checkpoint, pretrained_dir, cdtype, quantize)
    vol_shape = (batch_size, spec.channels, spec.frames, *spec.image_size)

    programs, ops = {}, {}
    for platform in platforms:
        program = _export(model, params, vol_shape, cdtype, platform)
        ops[platform] = library.graph_ops(program.graph_module)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        programs[platform] = buf.getvalue()
    weights = io.BytesIO()
    torch.save({k: v.contiguous() for k, v in params.items()}, weights)

    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "batch_size": batch_size,
        "dtype": dtype,
        "quantize": quantize,
        "mesh_shape": None,
        "num_classes": spec.num_classes,
        "input_shape": list(vol_shape),
        "model_config": config["model"],
        "param_shapes": {k: list(v.shape) for k, v in params.items()},
        "param_dtypes": {k: str(v.dtype).replace("torch.", "") for k, v in params.items()},
        "ops": ops,
        "kernel_sources": _build.sources_digest(),
    }
    # Stored, not deflated: the weights do not compress, and a vit-l16's
    # would take tens of seconds to deflate and inflate.
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_META_NAME, json.dumps(meta, indent=1, default=str))
        for platform, blob in programs.items():
            z.writestr(_program_name(platform), blob)
        z.writestr(_PARAMS_NAME, weights.getvalue())
    logging.info(f"Exported {spec.method}/{spec.backbone} to {path} "
                 f"(platforms={meta['platforms']}, batch={batch_size}, {dtype})")
    return meta


def _check_manifest(meta: dict, names, platform: str) -> None:
    """Refuse, before anything loads, an artifact this package cannot serve
    on ``platform``."""
    if meta["artifact_version"] > ARTIFACT_VERSION:
        raise RuntimeError(f"artifact version {meta['artifact_version']} is newer than this "
                           f"library supports ({ARTIFACT_VERSION})")
    if platform not in meta["platforms"] or _program_name(platform) not in names:
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


class DeployedPredictor:
    """Serve from an artifact, with the surface of ``serving.Predictor``.

    ``predict_logits`` / ``predict`` / ``batch_size`` / ``num_classes`` /
    ``reload_checkpoint`` keep Predictor's contracts, so ``serving.serve``
    and ``BatchQueue`` take it unchanged. ``self.params`` holds the host
    copies (the overlay's and re-quantization's substrate); calls run on a
    snapshot of them on ``device``, moved once a (re)load, so a reload is
    atomic: in-flight calls finish on the snapshot they started with.
    ``device`` ``"cuda"`` runs the ``cuda`` program (the kernels), ``"cpu"``
    the ``cpu`` program; neither falls back to the other."""

    def __init__(self, path: str, device="cuda"):
        from gaviko_tpu_torch.data.transforms import eval_transform

        self.device = torch.device(device)
        platform = self.device.type
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            if _JAX_MODULE_NAME in names:
                raise RuntimeError(
                    f"{path} was exported by gaviko_tpu (a jax.export module); re-export "
                    "it with python -m gaviko_tpu_torch.cli.export")
            self.meta = json.loads(z.read(_META_NAME).decode())
            _check_manifest(self.meta, names, platform)
            blob = z.read(_program_name(platform))
            self.params = torch.load(io.BytesIO(z.read(_PARAMS_NAME)), weights_only=True)
        program = torch.export.load(io.BytesIO(blob))
        if platform == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if platform == "cuda" and self.device.index != 0:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, {"cuda:0": str(self.device)})
        self._program = _unchecked(program.module())
        self._input_shape = tuple(self.meta["input_shape"])
        self.batch_size = int(self.meta["batch_size"])
        self.num_classes = int(self.meta["num_classes"])
        self._cdtype = torch.bfloat16 if self.meta["dtype"] == "bfloat16" else torch.float32
        self._transform = eval_transform
        self._device_params = self._commit(self.params)
        logging.info(f"DeployedPredictor ready: {path} (batch {self.batch_size}, "
                     f"{self.meta['dtype']}, {self.device})")

    def _commit(self, host_params: dict) -> dict:
        """The host params on the device (once a load)."""
        return {k: v.to(self.device) for k, v in host_params.items()}

    def reload_checkpoint(self, checkpoint: Optional[str]) -> None:
        """Overlay a trainable-only checkpoint onto the artifact's weights
        (an atomic swap, as in Predictor); the int8 sidecars of overlaid
        keys are quantized anew. ``None`` is refused: the artifact has no
        rebuild-from-config path."""
        if checkpoint is None:
            raise ValueError("DeployedPredictor.reload_checkpoint requires a checkpoint path "
                             "(the artifact has no rebuild-from-config path)")
        from gaviko_tpu_torch.ops.int8_linear import INT8_SUFFIX, SCALE_SUFFIX, quantize_weight
        from gaviko_tpu_torch.weights.torch_io import load_checkpoint

        state = load_checkpoint(checkpoint)
        params = dict(self.params)
        unknown = [k for k in state if k not in params]
        if unknown:
            raise KeyError(f"checkpoint keys not in the artifact's params (first 5): "
                           f"{unknown[:5]}")
        for k, v in state.items():
            ref = params[k]
            if tuple(v.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {k!r}: checkpoint {tuple(v.shape)} vs "
                                 f"artifact {tuple(ref.shape)}")
            params[k] = torch.as_tensor(v).to(ref.dtype)
            if k + INT8_SUFFIX in params:  # keep the int8 GEMMs' sidecars fresh
                params[k + INT8_SUFFIX], params[k + SCALE_SUFFIX] = quantize_weight(params[k])
        device_params = self._commit(params)
        self.params, self._device_params = params, device_params
        logging.info(f"DeployedPredictor reloaded {checkpoint!r}")

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
            if chunk.shape != self._input_shape:
                raise ValueError(f"volumes give a batch of {chunk.shape}; the artifact takes "
                                 f"{self._input_shape}")
            batch = put_volume(chunk, self._cdtype, self.device)
            with torch.inference_mode():
                logits = self._program(params, batch)
            outs.append(logits.cpu().numpy()[:n])
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, self.num_classes), np.float32))

    def predict(self, volumes: Sequence[np.ndarray]) -> np.ndarray:
        return self.predict_logits(volumes).argmax(axis=-1)
