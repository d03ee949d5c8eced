"""Serving entry point: the port's Predictor behind a local HTTP endpoint.

    python -m gaviko_tpu_torch.cli.serve --config gaviko_tpu_torch/configs/gaviko.yaml \
        --method gaviko --checkpoint <ckpt> --port 8477

POST an .npz body (key ``data``, shape (D, H, W)) to /predict; GET /healthz,
GET /metrics. The flags are the JAX package's (``gaviko_tpu/cli/serve.py``);
``--quantize int8`` serves with the int8 backbone GEMMs. The model runs on
the CUDA card.

``--artifact model.gaviko`` serves a deployment artifact (``cli.export``)
through ``deploy.DeployedPredictor`` instead of building from ``--config``:
no model code runs, and ``--checkpoint``, ``--quantize`` and ``--mesh``,
baked in at export time, are refused (``/reload`` overlays a checkpoint).
A mesh artifact (``cli.export --mesh data,tp``) is served on exactly
data x tp ranks joined from torchrun's environment, e.g. ``torchrun
--nproc_per_node 4 -m gaviko_tpu_torch.cli.serve --artifact m.gaviko`` for
a 2 x 2 mesh.

``--mesh data,tp`` serves on data x tp ranks (``Predictor(mesh_shape=...)``):
launch that many processes, e.g. ``torchrun --nproc_per_node 2 -m
gaviko_tpu_torch.cli.serve ... --mesh 1,2``, or give the config's
``train.parallel`` topology keys. Either way rank 0 runs the HTTP server
and the BatchQueue; the other ranks follow its orders until it stops.
``--device cpu`` runs the plain versions (an artifact's ``cpu`` program).
"""

from __future__ import annotations

import argparse
import logging

import torch

from gaviko_tpu_torch.config import METHODS, apply_method_override, load_config
from gaviko_tpu_torch.utils.compile_cache import enable_compilation_cache


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve a gaviko model (PyTorch port)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--artifact", type=str, default=None,
                        help="serve a deployment artifact (cli.export output) instead of "
                             "building from --config")
    parser.add_argument("--method", type=str, default="gaviko", choices=list(METHODS))
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8477)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--quantize", type=str, default=None, choices=["int8"],
                        help="int8 (w8a8) backbone GEMMs")
    parser.add_argument("--mesh", type=str, default=None,
                        help="data,tp: serve sharded over data x tp ranks")
    parser.add_argument("--auth_token", type=str, default=None,
                        help="require 'Authorization: Bearer <token>' on POSTs")
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="restrict /reload to checkpoints under this dir")
    parser.add_argument("--max_body_mb", type=int, default=128,
                        help="reject POST bodies above this size")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    if (args.config is None) == (args.artifact is None):
        parser.error("exactly one of --config or --artifact is required")
    if args.artifact is not None:
        for flag in ("checkpoint", "quantize", "mesh"):
            if getattr(args, flag) is not None:
                parser.error(f"--{flag} is baked into the artifact at export time; not "
                             "accepted with --artifact")
    mesh = None
    if args.mesh is not None:
        try:
            mesh = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            mesh = ()
        if len(mesh) != 2 or min(mesh) < 1:
            parser.error(f"--mesh takes data,tp (two positive ints), got {args.mesh!r}")

    from gaviko_tpu_torch.serving import Predictor, serve

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    enable_compilation_cache()

    def run(predictor):
        server = serve(predictor, host=args.host, port=args.port,
                       auth_token=args.auth_token, checkpoint_dir=args.checkpoint_dir,
                       max_body_bytes=args.max_body_mb * 1024 * 1024)
        try:
            server.serve_forever()
        finally:
            server.server_close()

    if args.artifact is not None:
        from gaviko_tpu_torch.deploy import run_on_ranks

        run_on_ranks(args.artifact, args.device, run)
        return
    config = load_config(args.config)
    apply_method_override(config, args.method)
    if mesh is not None:
        from gaviko_tpu_torch.parallel.mesh import init_distributed

        init_distributed(config.get("train", {}).get("parallel") or {},
                         torch.device(args.device).type)
    predictor = Predictor(
        config, checkpoint=args.checkpoint, batch_size=args.batch_size,
        dtype=args.dtype,
        pretrained_dir=config["model"].get("pretrained_dir", "./pretrained"),
        quantize=args.quantize, mesh_shape=mesh, device=args.device,
    )
    try:
        if mesh is not None and predictor.mesh.rank != 0:
            predictor.follow()
            return
        try:
            run(predictor)
        finally:
            predictor.close()
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
