"""Export a model to a self-contained deployment artifact (PyTorch port).

    python -m gaviko_tpu_torch.cli.export --config <yaml> --method <m> \
        --checkpoint <ckpt> --output model.gaviko [--platforms cuda,cpu] [--quantize int8] \
        [--mesh data,tp]

Port of ``gaviko_tpu/cli/export.py``, with its flags and its last line. The
artifact (a zip: one ``torch.export`` program a platform, the weights and a
manifest) serves without model-building code: ``cli.serve --artifact
model.gaviko``. ``--platforms`` takes ``cuda`` and / or ``cpu`` (default
``cuda``; any host exports either). ``--mesh data,tp`` bakes a mesh's
forward into the artifact (one program a model rank, the placements of the
split weights in the manifest); it is served on exactly data x tp ranks,
e.g. ``torchrun --nproc_per_node 4 -m gaviko_tpu_torch.cli.serve
--artifact model.gaviko`` for ``--mesh 2,2``. See
:mod:`gaviko_tpu_torch.deploy` for the format.
"""

from __future__ import annotations

import argparse

from gaviko_tpu_torch.config import METHODS, apply_method_override, load_config
from gaviko_tpu_torch.deploy import PLATFORMS, export_artifact
from gaviko_tpu_torch.utils.compile_cache import enable_compilation_cache
from gaviko_tpu_torch.utils.logging import setup_logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a gaviko model to a deployment artifact (PyTorch port)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--method", type=str, default="gaviko", choices=list(METHODS))
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="trainable-only checkpoint to bake in")
    parser.add_argument("--output", type=str, required=True,
                        help="artifact path (e.g. model.gaviko)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--quantize", type=str, default=None, choices=["int8"])
    parser.add_argument("--platforms", type=str, default=None,
                        help="comma-separated targets from 'cuda,cpu' (default: cuda)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="'data,tp': bake a mesh's sharded forward into the artifact; "
                             "serving then needs data*tp ranks")
    args = parser.parse_args(argv)

    mesh_shape = None
    if args.mesh is not None:
        try:
            d, t = (int(x) for x in args.mesh.split(","))
            if d < 1 or t < 1:
                raise ValueError
            mesh_shape = (d, t)
        except ValueError:
            parser.error("--mesh must be 'data,tp' (two positive integers)")
    platforms = None
    if args.platforms:
        platforms = tuple(p.strip() for p in args.platforms.split(","))
        if any(p not in PLATFORMS for p in platforms):
            parser.error(f"--platforms takes {','.join(PLATFORMS)}, got {args.platforms!r}")
    enable_compilation_cache()
    config = load_config(args.config)
    apply_method_override(config, args.method)
    setup_logging(log_dir=config["utils"]["log_dir"])
    meta = export_artifact(
        config, args.output, checkpoint=args.checkpoint,
        batch_size=args.batch_size, dtype=args.dtype,
        pretrained_dir=config["model"].get("pretrained_dir", "./pretrained"),
        quantize=args.quantize, platforms=platforms, mesh_shape=mesh_shape,
    )
    print(f"wrote {args.output} (platforms={meta['platforms']}, "
          f"batch={meta['batch_size']}, dtype={meta['dtype']})")
    return meta


if __name__ == "__main__":
    main()
