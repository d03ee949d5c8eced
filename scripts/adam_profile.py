"""Device time of each launch of kernel B13 (clip + Adam), and its host time a call.

At the trainable tensors of GAViKO vit-l16 (``gaviko.yaml``: 604 tensors,
2.27 M elements) and of vit-b16 fft (``vit.yaml``: 140, 88.2 M), random
values on the card in f32 and bf16 storage, this profiles
``fused_adam.launch_table`` (the kernels alone, the table held) of the
``gaviko_tpu_torch`` in the checkout this file lies in under
``torch.profiler``, and prints for each case the device microseconds of each
kernel it launched (by name, per call), their sum, and the CUDA-event
milliseconds a call over back-to-back calls. It then times the host
microseconds a call of ``fused_adam`` spends (the step's pinned copy of
the grad pointers and scalars, and the launches). To compare two commits
on one card, copy this file and ``mlp_profile.py`` (whose timers it
imports) into the other checkout's ``scripts/`` and run both in turns::

    python3 scripts/adam_profile.py

Needs one CUDA device; builds the checkout's kernels first. Prints one JSON
line a case and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mlp_profile import _event_ms, _host_us, _profile  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = (("gaviko", "gaviko_tpu_torch/configs/gaviko.yaml", "gaviko"),
          ("vitb16", "gaviko_tpu_torch/configs/vit.yaml", "fft"))


def trainable_shapes(config_path: str, method: str) -> list:
    """The shapes of the tensors the config trains (the model built on the
    CPU from seed 0)."""
    import torch

    from gaviko_tpu_torch.config import apply_method_override, load_config
    from gaviko_tpu_torch.models.factory import build_model
    from gaviko_tpu_torch.train.loop import split_params

    config = apply_method_override(load_config(os.path.join(REPO, config_path)), method)
    model = build_model(config["model"])
    trainable, _ = split_params(model, model.init(torch.Generator().manual_seed(0), model.spec))
    return [tuple(v.shape) for v in trainable.values()]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("adam_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from gaviko_tpu_torch.ops import _build
    from gaviko_tpu_torch.ops import fused_adam as fa

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for name, config_path, method in MODELS:
        shapes = trainable_shapes(config_path, method)
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(0)

            def randn(shape, std):
                return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

            grads = [randn(s, 1.0) for s in shapes]
            mu, nu, params = ([randn(s, 1e-3) for s in shapes] for _ in range(3))
            table = fa.AdamTable(mu, nu, params)
            fa.fused_adam(grads, mu, nu, params, 3e-4, 0.9, 0.1, 0.001, table=table)

            def kernels():
                fa.launch_table(table, params[0], 1.0, 1e-8)

            def call():
                fa.fused_adam(grads, mu, nu, params, 3e-4, 0.9, 0.1, 0.001, table=table)

            line = {"case": name, "dtype": str(dtype), "leaves": len(shapes),
                    "elements": sum(p.numel() for p in params), "card": smi}
            found = _profile(kernels)
            line.update(kernels=[{"name": k, "launches": n, "device_us": us}
                                 for k, n, us in found],
                        device_us_sum=sum(us for _, _, us in found),
                        event_ms=_event_ms(kernels), host_us=_host_us(call))
            print(json.dumps(line), flush=True)
            del grads, mu, nu, params, table
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
