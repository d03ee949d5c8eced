"""Rank bodies and a launcher for the port's multi-process CPU tests.

The ranks are spawned processes on one gloo group whose store is a file in
the test's temporary directory; they import torch and the port only (no
JAX), so they start in a few seconds. Each writes its result with
``torch.save`` to ``<dir>/rank<r>.pt``; the launcher joins every rank with
a deadline and fails if one dies or hangs.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, out_dir, args):
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    try:
        if fn is not run_cli_rank:  # the CLI joins from its config
            dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                                    world_size=world, rank=rank)
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start(fn, world: int, out_dir: str, *args):
    """Start ``fn(rank, world, *args)`` on ``world`` ranks -> a handle for
    :func:`join` (the caller may work meanwhile)."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, out_dir, args), nprocs=world,
                             start_method="spawn", join=False)
    return ctx, world, out_dir


def spawn(fn, world: int, out_dir: str, *args, timeout: float = 120.0):
    """Run ``fn(rank, world, *args)`` on ``world`` ranks -> their results."""
    return join(start(fn, world, out_dir, *args), timeout)


def join(handle, timeout: float = 120.0):
    """Wait for every rank of ``handle`` -> their results; a rank that dies
    or outlasts ``timeout`` fails the call, and the others are killed."""
    ctx, world, out_dir = handle
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    except Exception:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        errs = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
                if f.endswith(".err")]
        raise RuntimeError("a rank failed:\n" + "\n".join(errs))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------ the bodies ----

def _model(cfg: dict, depth: int):
    from gaviko_tpu_torch.models.factory import build_model

    m = build_model(cfg)
    return dataclasses.replace(m, spec=dataclasses.replace(m.spec, depth=depth))


def train_rank(rank, world, runs, data, train_cfg, total_steps, infer_batch):
    """For each run (cfg, depth, whole numpy params, per-step seeds, batches
    of the global batch): the sharded train steps on a data x model mesh ->
    the losses, the whole trainable tensors and Adam's whole moments after
    them (and, where ``infer_batch`` is given, the sharded forward's logits
    of the initial params)."""
    from gaviko_tpu_torch.core.layers import SeedStream
    from gaviko_tpu_torch.parallel.infer import make_parallel_forward
    from gaviko_tpu_torch.parallel.mesh import ParallelTrainer, make_mesh
    from gaviko_tpu_torch.train import loop, losses
    from gaviko_tpu_torch.weights.from_jax import from_jax

    mesh = make_mesh(data, world // data)
    out = []
    for cfg, depth, params, seeds, batches in runs:
        model = _model(cfg, depth)
        whole = from_jax(params)
        res = {}
        if infer_batch is not None:
            fwd, sharded = make_parallel_forward(model, mesh, whole)
            res["logits"] = fwd(sharded, torch.from_numpy(infer_batch)).numpy()
        trainable, frozen = loop.split_params(model, whole)
        par = ParallelTrainer(model, losses.make_criterion(train_cfg),
                              loop.make_optimizer(train_cfg, total_steps), mesh, trainable,
                              frozen, zero=True)
        tr, fr, opt = par.trainable, par.frozen, par.opt_state
        per = batches[0][0].shape[0] // mesh.data
        rows = slice(mesh.d * per, (mesh.d + 1) * per)
        res["losses"] = []
        for (x, y), s in zip(batches, seeds):
            tr, opt, loss, _ = par.train_step(tr, opt, fr, torch.from_numpy(x[rows]),
                                              torch.from_numpy(y[rows]).long(),
                                              SeedStream(s))
            res["losses"].append(float(loss))
        whole, state = par.gather_state(tr, opt)
        state = getattr(state, "inner", state)
        res["trainable"] = {k: v.numpy() for k, v in whole.items()}
        res["mu"], res["nu"] = ({k: v.float().numpy() for k, v in m.items()}
                                for m in (state.mu, state.nu))
        out.append(res)
    return out


def accum_rank(rank, world, cfg, depth, params, seeds, batches, data, train_cfg, total_steps,
               out_dir, resume=None):
    """Sharded train steps with the accumulating optimizer on a data x model
    mesh, from a fresh state, or from the whole resume file ``resume`` (at
    its global step) -> the losses and the whole trainable tensors after
    the last batch. A fresh run's rank 0 also writes the gathered state
    after micro-step 3 (mid-cycle at accumulation 2) to
    ``<out_dir>/mesh_step3.npz``."""
    from gaviko_tpu_torch.core.layers import SeedStream
    from gaviko_tpu_torch.parallel.mesh import ParallelTrainer, make_mesh
    from gaviko_tpu_torch.train import loop, losses
    from gaviko_tpu_torch.utils.checkpoint import load_train_state, save_train_state
    from gaviko_tpu_torch.weights.from_jax import from_jax

    mesh = make_mesh(data, world // data)
    model = _model(cfg, depth)
    fused = loop.make_optimizer(train_cfg, total_steps)
    trainable, frozen = loop.split_params(model, from_jax(params))
    par = ParallelTrainer(model, losses.make_criterion(train_cfg), fused, mesh, trainable,
                          frozen, zero=True)
    tr, opt, start = par.trainable, par.opt_state, 0
    if resume is not None:
        whole = par.full_template
        whole, whole_opt, meta = load_train_state(resume, whole,
                                                  loop.opt_template(whole, fused))
        tr, opt = par.shard_state(whole, whole_opt)
        start = meta["global_step"]
    per = batches[0][0].shape[0] // mesh.data
    rows = slice(mesh.d * per, (mesh.d + 1) * per)
    out = {"losses": []}
    for i in range(start, len(batches)):
        x, y = batches[i]
        tr, opt, loss, _ = par.train_step(tr, opt, par.frozen, torch.from_numpy(x[rows]),
                                          torch.from_numpy(y[rows]).long(), SeedStream(seeds[i]))
        out["losses"].append(float(loss))
        if i == 2 and resume is None:
            whole, whole_opt = par.gather_state(tr, opt)
            if rank == 0:
                save_train_state(os.path.join(out_dir, "mesh_step3.npz"), whole, whole_opt,
                                 {"global_step": 3})
    out["trainable"] = {k: v.numpy() for k, v in par.gather_trainable(tr).items()}
    return out


def run_cli_rank(rank, world, config):
    """``cli.train.train`` as rank ``rank`` of ``world`` (the topology in
    ``train.parallel``) -> the paths it wrote."""
    from gaviko_tpu_torch.cli.train import train
    from gaviko_tpu_torch.parallel import mesh

    mesh.INIT_TIMEOUT = timedelta(seconds=120)  # a rank that never comes fails the test
    if world > 1:
        config["train"]["parallel"].update(num_processes=world, process_id=rank)
    result = train(config, "cpu")
    return {"csv": result["csv_log"], "best": result["best_ckpt_path"]}


def mesh_serve_rank(rank, world, config, volumes, mesh_shape, kw=None):
    """``Predictor(mesh_shape=..., **kw)``: rank 0 predicts ``volumes``,
    reloads the checkpoint and predicts them again, and releases the
    others, which follow -> rank 0's logits, both times."""
    from gaviko_tpu_torch.serving import Predictor

    pred = Predictor(config, **{**dict(batch_size=2, dtype="float32", pretrained_dir=None),
                                **(kw or {})}, mesh_shape=mesh_shape, device="cpu")
    if pred.mesh.rank != 0:
        pred.follow()
        return None
    logits = pred.predict_logits(volumes)
    pred.reload_checkpoint((kw or {}).get("checkpoint"))
    again = pred.predict_logits(volumes)
    pred.close()
    return np.stack([logits, again])


def collectives_rank(rank, world, shapes):
    """ZeRO's collectives over leaves of ``shapes`` (f32 and bf16), each cut
    along its ``zero_axis``: natively (gloo on the CPU has reduce-scatter
    and all-gather) and as built from all_reduce (gloo on CUDA tensors) ->
    (this rank's leaves, {path: (reduce-scattered, all-gathered back)})."""
    from gaviko_tpu_torch.parallel import mesh

    gen = torch.Generator().manual_seed(rank)
    leaves = [torch.randn(s, generator=gen).to(torch.bfloat16 if i % 3 == 2 else torch.float32)
              for i, s in enumerate(shapes)]
    axes = [mesh.zero_axis(s, world) for s in shapes]
    out = {}
    for path, native in (("native", mesh._native), ("all_reduce", lambda t, g: False)):
        mesh._native = native
        parts = mesh.reduce_scatter_flat(leaves, axes, dist.group.WORLD)
        out[path] = (parts, mesh.all_gather_flat(parts, axes, dist.group.WORLD))
    return leaves, out


HEAD_BIAS = "mlp_head.head.bias"  # GAViKO's classifier bias, the reload tests' overlay


def _shallow(depth: int) -> None:
    """Every backbone at ``depth`` in this process (the parent's patch)."""
    from gaviko_tpu_torch import config as tconfig

    for name in ("vit-t16", "vit-s16", "vit-b16"):
        tconfig.VIT_CONFIG_MAP[name] = dict(tconfig.VIT_CONFIG_MAP[name], depth=depth)


def _http_round(pred, volume, checkpoint) -> dict:
    """``serving.serve(pred, port=0)`` on this rank: the direct call's logits
    of ``volume``, then one POST /predict of it, GET /healthz and POST
    /reload of ``checkpoint``."""
    import io
    import json
    import threading
    import urllib.request

    from gaviko_tpu_torch.serving import serve

    def call(path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                     method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.load(r)

    out = {"direct": pred.predict_logits([volume])[0]}
    server = serve(pred, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        np.savez(buf, data=volume)
        out["http"] = np.float32(call("/predict", buf.getvalue())["logits"])
        out["healthz"] = call("/healthz")
        out["reload"] = call("/reload", json.dumps({"checkpoint": checkpoint}).encode())
    finally:
        server.shutdown()
        server.server_close()
    t.join(timeout=10)
    return out


def deploy_mesh_rank(rank, world, paths, volumes, config, depth, overlays, out_dir):
    """The mesh artifacts of ``tests/test_torch_deploy_mesh.py`` on their
    ``cpu`` programs. On 4 ranks: ``gaviko::model_all_reduce`` unbound,
    bound to the world and faked; the 2 x 2 artifact with ``tp_plan`` made
    to raise (rank 0: logits, a reload of ``overlays[0]``, then ``serve()``
    with a /reload of ``overlays[1]``; the others follow), the model code
    imported by then, each rank's collectives and classifier bias after;
    the 1 x 2 artifact refused; the live 2 x 2 Predictor from ``config``.
    Then ranks 0 and 1 on a new 2-rank group: the 1 x 2 int8 artifact,
    directly and through ``cli.infer --artifact`` on the volumes in
    ``paths["folder"]``, and ``serve()`` over a live
    ``Predictor(mesh_shape=(1, 2))`` (a /reload of ``overlays[0]``)."""
    import sys

    from torch._subclasses.fake_tensor import FakeTensorMode

    from gaviko_tpu_torch.deploy import DeployedPredictor
    from gaviko_tpu_torch.ops import library
    from gaviko_tpu_torch.parallel import mesh as pmesh

    out = {}
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(rank))[:, :4]  # strided
    op = torch.ops.gaviko.model_all_reduce.default
    try:
        op(x)
        out["unbound"] = None
    except RuntimeError as e:
        out["unbound"] = str(e)
    with library.bound_model_group(dist.group.WORLD):
        real = op(x)
    with FakeTensorMode() as mode:
        fake = op(mode.from_tensor(x))
    out["op"] = {"sum": real, "real": (tuple(real.shape), real.dtype, real.stride()),
                 "fake": (tuple(fake.shape), fake.dtype, fake.stride())}

    def no_plan(*args, **kwargs):
        raise AssertionError("a mesh DeployedPredictor called tp_plan")

    tp_plan, pmesh.tp_plan = pmesh.tp_plan, no_plan
    pred = DeployedPredictor(paths["mesh22"], device="cpu")
    out["model_code"] = sorted(m for m in sys.modules if m.startswith(
        ("gaviko_tpu_torch.models", "gaviko_tpu_torch.core", "gaviko_tpu_torch.config")))
    calls = library.model_all_reduces
    if rank == 0:
        out["logits"] = pred.predict_logits(volumes)
        pred.reload_checkpoint(overlays[0])
        out["reloaded"] = pred.predict_logits(volumes[:1])
        out["http"] = _http_round(pred, volumes[0], overlays[1])
        pred.close()
    else:
        pred.follow()
    pmesh.tp_plan = tp_plan
    out["collectives"] = library.model_all_reduces - calls
    out["bias"] = (pred.params[HEAD_BIAS], pred._device_params[HEAD_BIAS])
    try:
        DeployedPredictor(paths["int8_12"], device="cpu")
        out["world"] = None
    except RuntimeError as e:
        out["world"] = str(e)

    from gaviko_tpu_torch.serving import Predictor

    _shallow(depth)
    kw = dict(checkpoint=paths["ckpt"], batch_size=2, dtype="float32", pretrained_dir=None,
              device="cpu")
    live = Predictor(config, mesh_shape=(2, 2), **kw)
    if rank == 0:
        out["live"] = live.predict_logits(volumes)
        live.close()
    else:
        live.follow()

    dist.destroy_process_group()
    if rank >= 2:
        return out
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store2", world_size=2,
                            rank=rank)
    pred = DeployedPredictor(paths["int8_12"], device="cpu")
    if rank == 0:
        out["int8"] = pred.predict_logits(volumes)
        pred.close()
    else:
        pred.follow()
    from gaviko_tpu_torch.cli import infer

    out["infer_csv"] = infer.main(["--artifact", paths["int8_12"], "--image_folder",
                                   paths["folder"], "--results_dir", paths["results"],
                                   "--device", "cpu"])
    live = Predictor(config, mesh_shape=(1, 2), **kw)
    if rank == 0:
        out["live_http"] = _http_round(live, volumes[0], overlays[0])
        live.close()
    else:
        live.follow()
    out["live_bias"] = live.params[HEAD_BIAS]
    return out


def deploy_zoo_mesh_rank(rank, world, jobs, volumes_path, depth, out_dir):
    """The zoo's mesh artifacts of ``tests/test_torch_deploy_zoo_mesh.py``.
    Each job is (name, config, checkpoint, mesh artifact path,
    single-device artifact path). On ``world`` ranks each rank first exports
    its share of the jobs (``jobs[rank::world]``): the 1 x 2 artifact
    (``cpu`` and ``cuda``) and the single-device ``cpu`` one. Then the ranks
    pair up, each pair on a 2-rank group of its own, and each pair serves
    its share of the jobs: both ranks load the mesh artifact and the live
    ``Predictor(mesh_shape=(1, 2))`` from the same config and checkpoint,
    the pair's first rank predicts the volumes stacked in the ``.npy`` at
    ``volumes_path`` with each and the other
    follows. -> {name: the mesh manifest where this rank exported it; on a
    pair's first rank the logits of the artifact, the live mesh Predictor
    and the single-device artifact; this rank's calls of the collective op
    in the artifact's forwards}."""
    from gaviko_tpu_torch.deploy import DeployedPredictor, export_artifact
    from gaviko_tpu_torch.ops import library
    from gaviko_tpu_torch.serving import Predictor

    _shallow(depth)
    volumes = list(np.load(volumes_path))
    kw = dict(batch_size=2, dtype="float32", pretrained_dir=None)
    out = {}
    for name, config, ckpt, mesh_path, single_path in jobs[rank::world]:
        out[name] = {"meta": export_artifact(config, mesh_path, checkpoint=ckpt, **kw,
                                             platforms=("cpu", "cuda"), mesh_shape=(1, 2))}
        export_artifact(config, single_path, checkpoint=ckpt, **kw, platforms=("cpu",))
    dist.barrier()
    dist.destroy_process_group()
    pair, lead = rank // 2, rank % 2 == 0
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pair{pair}", world_size=2,
                            rank=rank % 2)
    for name, config, ckpt, mesh_path, single_path in jobs[pair::world // 2]:
        res = out.setdefault(name, {})
        pred = DeployedPredictor(mesh_path, device="cpu")
        calls = library.model_all_reduces
        if lead:
            res["logits"] = pred.predict_logits(volumes)
            pred.close()
        else:
            pred.follow()
        res["collectives"] = library.model_all_reduces - calls
        live = Predictor(config, checkpoint=ckpt, **kw, mesh_shape=(1, 2), device="cpu")
        if lead:
            res["live"] = live.predict_logits(volumes)
            live.close()
            res["single"] = DeployedPredictor(single_path, device="cpu").predict_logits(volumes)
        else:
            live.follow()
    return out
