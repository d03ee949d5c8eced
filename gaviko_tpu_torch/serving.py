"""Serving: batched predictor + a minimal HTTP endpoint.

Port of ``gaviko_tpu/serving.py``:

- ``Predictor``: builds a model from config, overlays a trainable-only
  checkpoint on the initial weights, runs a fixed micro-batch (ragged
  batches are padded), bf16 by default. The JAX package compiles ahead of
  time; here one warm-up forward at construction does what that did: it
  builds the CUDA kernels and runs every shape once, so the first request
  pays no build. ``reload_checkpoint`` swaps weights atomically (in-flight
  calls finish on the old dict). ``quantize="int8"`` adds int8 sidecars to
  the backbone's GEMM weights after the cast to the serving dtype, so the
  forward runs the int8 kernels (``ops/int8_linear.py``); the warm-up
  builds them and ``reload_checkpoint`` quantizes anew.
- ``BatchQueue``: concurrent requests coalesce into one device batch (up to
  ``batch_size``, flushed after ``max_wait_ms``); one dispatcher thread owns
  the device.
- ``serve``: stdlib HTTP server; POST /predict with an .npz body (key
  ``data``) returns JSON logits + argmax class; GET /healthz, GET /metrics;
  POST /reload {"checkpoint": path} swaps weights.

Each forward enters ``torch.inference_mode()`` itself and launches on the
calling thread's current CUDA stream: both are per thread, so it makes no
difference which thread (constructor, dispatcher, caller) runs it.

``mesh_shape=(data, tp)`` serves on a mesh of ranks (``parallel/infer.py``):
the process group must hold exactly data x tp ranks (launch that many, e.g.
with torchrun), every rank builds the Predictor with its shard of the
weights, rank 0 takes the requests and broadcasts each micro-batch (and
each reload) to the others, which run :meth:`Predictor.follow` until rank
0's :meth:`Predictor.close`; the logits come back whole. It runs in the
serving dtype, as the JAX package's mesh branch does. With
``quantize="int8"`` every rank quantizes the whole weights first, as JAX
does, and the int8 blocks stay whole on every rank (``parallel/mesh.tp_plan``):
each rank runs B11 on its rows of the micro-batch, as many launches a
forward as one process.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gaviko_tpu_torch.utils.layouts import put_volume

_RECEIVE, _STOP, _FORWARD, _RELOAD = -1, 0, 1, 2  # mesh serving's orders


def load_params(model, checkpoint: Optional[str], pretrained_dir: Optional[str],
                cdtype: torch.dtype, quantize: Optional[str], device="cpu") -> dict:
    """The served weights of ``model``: seed-0 init with the pretrained
    backbone and the checkpoint overlaid, f32 tensors cast to ``cdtype`` on
    ``device``, then, for ``quantize="int8"``, the backbone's int8
    sidecars. ``Predictor`` and ``deploy.export_artifact`` both build their
    weights here."""
    from gaviko_tpu_torch.models.pretrained import build_params

    params = build_params(model, torch.Generator().manual_seed(0),
                          pretrained_dir=pretrained_dir, checkpoint_path=checkpoint)
    params = {k: (t.to(cdtype) if t.dtype == torch.float32 else t).to(device)
              for k, t in params.items()}
    if quantize == "int8":
        from gaviko_tpu_torch.ops.int8_linear import quantize_backbone

        # After the cast, as the JAX package does: codes of the serving
        # dtype's weights, f32 scales.
        params = quantize_backbone(params, model.spec.depth)
    return params


def check_mesh_world(data: int, tp: int, launch: str) -> None:
    """Refuse a process group that is not exactly ``data`` x ``tp`` ranks,
    naming the torchrun launch (``launch``: cli.serve's arguments) that
    gives one."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if data < 1 or tp < 1 or data * tp != world:
        raise RuntimeError(
            f"mesh_shape {data}x{tp} needs a process group of exactly {data * tp} ranks; "
            f"this process has {world}. Launch {data * tp} processes, e.g. torchrun "
            f"--nproc_per_node {data * tp} -m gaviko_tpu_torch.cli.serve {launch} ...")


class MeshServing:
    """Serving on a mesh of ranks (``parallel.mesh.Mesh``): rank 0 takes the
    requests and sends each micro-batch and each reload to the others, which
    run :meth:`follow` until rank 0's :meth:`close`. A subclass sets
    ``_mesh`` (None: one process), ``_lock``, ``_shape``, ``_cdtype`` and
    ``device``, and defines ``_rank_forward(params, batch)`` (this rank's
    part of a forward of the whole micro-batch -> the whole logits, on every
    rank), ``_served_params()`` and ``_reload(payload)``."""

    @property
    def mesh(self):
        """The ``parallel.mesh.Mesh`` served on, or None."""
        return self._mesh

    def _order(self, op: int, payload=None):
        """Rank 0 sends an order to every rank; the others receive it."""
        import torch.distributed as dist

        if self._mesh.rank != 0 and op != _RECEIVE:
            raise RuntimeError("on a mesh only rank 0 takes requests; the other ranks run "
                               f"{type(self).__name__}.follow()")
        msg = [op, payload]
        if self._mesh.ctrl_group is not None:  # a 1 x 1 mesh has no one to tell
            dist.broadcast_object_list(msg, src=0, group=self._mesh.ctrl_group)
        return msg

    def _mesh_forward(self, params, batch: torch.Tensor) -> np.ndarray:
        import torch.distributed as dist

        batch = batch.contiguous()
        if self._mesh.world_group is not None:
            dist.broadcast(batch, src=0, group=self._mesh.world_group)
        return self._rank_forward(params, batch).cpu().numpy()

    def _lead_forward(self, params, batch: torch.Tensor) -> np.ndarray:
        """Rank 0: order every rank to run a forward of ``batch`` and run it."""
        with self._lock:
            self._order(_FORWARD)
            return self._mesh_forward(params, batch)

    def _lead_reload(self, payload) -> None:
        """Rank 0: order every rank to reload ``payload`` and reload it."""
        with self._lock:
            self._order(_RELOAD, payload)
            self._reload(payload)

    def follow(self) -> None:
        """A rank > 0 of a mesh: run rank 0's forwards and reloads until it
        closes."""
        while True:
            op, payload = self._order(_RECEIVE)
            if op == _FORWARD:
                self._mesh_forward(self._served_params(), torch.empty(
                    self._shape, dtype=self._cdtype, device=self.device))
            elif op == _RELOAD:
                self._reload(payload)
            else:
                return

    def close(self) -> None:
        """Rank 0 of a mesh: release the following ranks (a no-op elsewhere)."""
        if self._mesh is not None and self._mesh.rank == 0:
            with self._lock:
                self._order(_STOP)


class Predictor(MeshServing):
    def __init__(
        self,
        config: dict,
        checkpoint: Optional[str] = None,
        batch_size: int = 8,
        dtype: str = "bfloat16",
        pretrained_dir: Optional[str] = "./pretrained",
        quantize: Optional[str] = None,
        mesh_shape: Optional[tuple] = None,
        device="cuda",
    ):
        """``device``: where the model runs; ``"cuda"`` launches the port's
        kernels, ``"cpu"`` runs their plain versions. The initial weights
        come from seed 0, drawn on the CPU, so every device gets the same."""
        from gaviko_tpu_torch.data.transforms import eval_transform
        from gaviko_tpu_torch.models.factory import build_model

        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode: {quantize!r}")
        if dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be bfloat16 or float32, got {dtype!r}")
        self.device = torch.device(device)
        self._mesh = None
        self._lock = threading.Lock()
        if mesh_shape is not None:
            self.device = self._join_mesh(mesh_shape, batch_size)
        self.batch_size = batch_size
        self.model = build_model(config["model"])
        self.spec = self.model.spec
        self._pretrained_dir = pretrained_dir
        self._cdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self._quantize = quantize
        self.params = self._load_params(checkpoint)
        self._transform = eval_transform
        spec = self.spec
        shape = (batch_size, spec.channels, spec.frames, *spec.image_size)
        self._shape = shape
        warm = put_volume(np.zeros(shape, np.float32), self._cdtype, self.device)
        if mesh_shape is not None:
            from gaviko_tpu_torch.parallel.infer import parallel_predictor_fn

            self._pforward, self.params, self._mesh = parallel_predictor_fn(
                self.model, self.params, *self._mesh_shape)
            self._pforward(self.params, warm)  # every rank together
            logging.info(f"Predictor ready: micro-batch {shape}, {dtype}, {self.device}, "
                         f"mesh data={self._mesh.data} x tp={self._mesh.model}, "
                         f"rank {self._mesh.rank}")
            return
        self._forward(self.params, warm)
        logging.info(f"Predictor ready: micro-batch {shape}, {dtype}, {self.device}")

    def _join_mesh(self, mesh_shape, batch_size: int) -> torch.device:
        """Check the process group against ``mesh_shape`` -> this rank's device."""
        from gaviko_tpu_torch.parallel.mesh import rank_device

        data, tp = (int(x) for x in mesh_shape)
        check_mesh_world(data, tp, f"--mesh {data},{tp}")
        if batch_size % data:
            raise ValueError(f"batch_size {batch_size} does not split over {data} data ranks")
        self._mesh_shape = (data, tp)
        return rank_device(self.device)

    def _load_params(self, checkpoint: Optional[str]):
        return load_params(self.model, checkpoint, self._pretrained_dir, self._cdtype,
                           self._quantize, self.device)

    def _forward(self, params, batch: torch.Tensor) -> np.ndarray:
        if self._mesh is not None:
            return self._lead_forward(params, batch)
        with torch.inference_mode():
            logits = self.model.apply(params, batch, self.spec)
            return logits.float().cpu().numpy()

    # -- mesh serving (MeshServing): rank 0 leads, the other ranks follow --

    def _rank_forward(self, params, batch: torch.Tensor) -> torch.Tensor:
        return self._pforward(params, batch)

    def _served_params(self):
        return self.params

    def _reload(self, checkpoint: Optional[str]) -> None:
        params = self._load_params(checkpoint)
        self.params = params if self._mesh is None else self._pforward.reshard(params)
        logging.info(f"Reloaded checkpoint {checkpoint!r}")

    def reload_checkpoint(self, checkpoint: Optional[str]) -> None:
        """Hot-swap weights: build the new dict, then replace the reference
        (in-flight predictions finish on the old one). On a mesh every rank
        loads and re-shards it."""
        if self._mesh is not None:
            self._lead_reload(checkpoint)
            return
        self._reload(checkpoint)

    def predict_logits(self, volumes: Sequence[np.ndarray]) -> np.ndarray:
        """volumes: list of (D, H, W) or (C, D, H, W) arrays -> [n, classes]."""
        # Snapshot once so a concurrent reload_checkpoint cannot mix old and
        # new weights across micro-batch chunks of one request batch.
        params = self.params
        outs = []
        vols = [self._transform(v if v.ndim == 4 else np.expand_dims(v, 0))
                for v in volumes]
        for i in range(0, len(vols), self.batch_size):
            chunk = vols[i : i + self.batch_size]
            n = len(chunk)
            if n < self.batch_size:
                chunk = chunk + [np.zeros_like(chunk[0])] * (self.batch_size - n)
            batch = put_volume(np.stack(chunk), self._cdtype, self.device)
            outs.append(self._forward(params, batch)[:n])
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, self.spec.num_classes), np.float32))

    def predict(self, volumes: Sequence[np.ndarray]) -> np.ndarray:
        return self.predict_logits(volumes).argmax(axis=-1)


class BatchQueue:
    """Cross-request batching: concurrent ``submit`` calls coalesce into one
    device batch of up to ``predictor.batch_size`` volumes; a partial batch
    flushes after ``max_wait_ms``. One dispatcher thread owns the device."""

    def __init__(self, predictor: Predictor, max_wait_ms: float = 5.0):
        self._predictor = predictor
        self._max_wait = max_wait_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # Observability counters (read by the /metrics endpoint).
        self._lock = threading.Lock()
        self.requests_total = 0
        self.batches_total = 0
        self.occupancy_sum = 0
        self._latencies: "list[float]" = []  # seconds, most recent 1000
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def metrics(self) -> dict:
        """Snapshot: request count, mean batch occupancy, latency percentiles."""
        with self._lock:
            lat = sorted(self._latencies)
            n_b = self.batches_total
            out = {
                "requests_total": self.requests_total,
                "batches_total": n_b,
                "mean_batch_occupancy": (self.occupancy_sum / n_b if n_b else 0.0),
                "batch_size": self._predictor.batch_size,
            }
            for p in (50, 90, 99):
                out[f"latency_p{p}_ms"] = (
                    lat[min(len(lat) - 1, int(len(lat) * p / 100))] * 1000.0
                    if lat else 0.0)
        return out

    def submit(self, volume: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        """Blocking: returns the logits row for one (D,H,W)/(C,D,H,W) volume."""
        done = threading.Event()
        slot: dict = {}
        self._queue.put((volume, done, slot))
        if not done.wait(timeout):
            raise TimeoutError("prediction timed out")
        if "error" in slot:
            raise slot["error"]
        return slot["logits"]

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self):
        bs = self._predictor.batch_size
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self._max_wait
            while len(batch) < bs:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            vols = [item[0] for item in batch]
            t0 = time.monotonic()
            try:
                logits = self._predictor.predict_logits(vols)
                for (_, done, slot), row in zip(batch, logits):
                    slot["logits"] = row
                    done.set()
            except Exception as e:  # noqa: BLE001 - deliver to every waiter
                logging.exception("serve: batch of %d failed", len(batch))
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()
            dt = time.monotonic() - t0
            with self._lock:
                self.requests_total += len(batch)
                self.batches_total += 1
                self.occupancy_sum += len(batch)
                self._latencies.append(dt)
                if len(self._latencies) > 1000:
                    del self._latencies[: len(self._latencies) - 1000]


def serve(
    predictor: Predictor,
    host: str = "127.0.0.1",
    port: int = 8477,
    auth_token: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    max_body_bytes: int = 128 * 1024 * 1024,
):
    """Build (not start) the HTTP server.

    - ``auth_token``: when set, every POST must carry
      ``Authorization: Bearer <token>`` (401 otherwise).
    - ``checkpoint_dir``: when set, /reload may only load checkpoints under
      this directory (realpath-checked).
    - ``max_body_bytes``: POST bodies above this are rejected with 413
      before reading (an npz volume is ~37 MB fp32).

    ``server_close()`` also stops the batching dispatcher thread.
    """
    import os

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = BatchQueue(predictor)
    ckpt_root = os.path.realpath(checkpoint_dir) if checkpoint_dir else None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logging.info("serve: " + fmt % args)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            return self.headers.get("Authorization", "") == f"Bearer {auth_token}"

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/metrics":
                self._reply(200, batcher.metrics())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                if not self._authorized():
                    self._reply(401, {"error": "unauthorized"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length > max_body_bytes:
                    self._reply(413, {
                        "error": f"body {length} bytes exceeds cap {max_body_bytes}",
                    })
                    return
                raw = self.rfile.read(length)
                if self.path == "/predict":
                    with np.load(io.BytesIO(raw)) as z:
                        vol = z["data"]
                    logits = batcher.submit(vol)
                    self._reply(200, {
                        "logits": [float(x) for x in logits],
                        "class": int(np.argmax(logits)),
                    })
                elif self.path == "/reload":
                    payload = json.loads(raw.decode() or "{}")
                    ckpt = payload.get("checkpoint")
                    if ckpt is not None and ckpt_root is not None:
                        real = os.path.realpath(ckpt)
                        if not (real == ckpt_root or real.startswith(ckpt_root + os.sep)):
                            self._reply(403, {"error": "checkpoint outside allowed dir"})
                            return
                    predictor.reload_checkpoint(ckpt)
                    self._reply(200, {"status": "reloaded"})
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as e:  # noqa: BLE001 - report to client
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    class Server(ThreadingHTTPServer):
        def server_close(self):  # stop the dispatcher with the server
            batcher.close()
            super().server_close()

    if host not in ("127.0.0.1", "localhost", "::1") and auth_token is None:
        logging.warning(
            "serve: binding %s without auth_token — /predict and /reload are "
            "open to the network", host)
    server = Server((host, port), Handler)
    server.batcher = batcher  # exposed for tests/metrics
    logging.info(f"Serving on http://{host}:{port} (POST /predict, GET /healthz)")
    return server
