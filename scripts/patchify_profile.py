"""Device time of each launch of patchify, and its host time a call.

Patchify (``patchify_fused`` / ``patchify_kernel``) at the GAViKO vit-l16
shapes (120 x 160 x 160 volumes, patch 12 x 16 x 16, dim 1,024) of the B8
serving forward and the B4 train step, and at the vit-b16 B8 train shapes
(dim 768, with pos and the patch rows the weight gradient reads). In bf16
and fp32 (TF32 off), this profiles calls of the ``gaviko_tpu_torch`` in the
checkout this file lies in under ``torch.profiler``, and prints for each
case the device microseconds of each kernel it launched (by name, per
call), their sum, and the CUDA-event milliseconds a call over back-to-back
calls. It then times the host microseconds a call spends enqueueing
(checks, allocations, tensor-map encodes and launches, no synchronisation
between calls). To compare two commits on one card, copy this file and
``mlp_profile.py`` (whose timers it imports) into the other checkout's
``scripts/`` and run both in turns::

    python3 scripts/patchify_profile.py

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

# (case, batch, dim, with pos and the patch rows)
CASES = (("gaviko_serving_b8", 8, 1024, False), ("gaviko_train_b4", 4, 1024, False),
         ("vitb16_train_b8_rows", 8, 768, True))
VOLUME, PATCH = (120, 160, 160), (12, 16, 16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("patchify_profile: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from gaviko_tpu_torch.ops import _build
    from gaviko_tpu_torch.ops.patchify import patchify_fused, patchify_kernel

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    n_tok = (VOLUME[0] // PATCH[0]) * (VOLUME[1] // PATCH[1]) * (VOLUME[2] // PATCH[2])
    for dtype in (torch.bfloat16, torch.float32):
        for name, batch, dim, rows in CASES:
            gen = torch.Generator(device="cuda").manual_seed(0)
            img = torch.rand(batch, 1, *VOLUME, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(dim, 1, *PATCH, generator=gen, device="cuda") * 0.02).to(dtype)
            bias = (torch.randn(dim, generator=gen, device="cuda") * 0.02).to(dtype)
            pos = torch.randn(n_tok, dim, generator=gen, device="cuda").to(dtype)
            if rows:
                def fn():
                    return patchify_kernel(img, w, bias, pos, save_rows=True)
            else:
                def fn():
                    return patchify_fused(img, w, bias)
            line = {"case": name, "dtype": str(dtype), "batch": batch, "dim": dim,
                    "save_rows": rows, "card": smi}
            try:
                with torch.no_grad():
                    kernels = _profile(fn)
                    line.update(kernels=[{"name": k, "launches": n, "device_us": us}
                                         for k, n, us in kernels],
                                device_us_sum=sum(us for _, _, us in kernels),
                                event_ms=_event_ms(fn), host_us=_host_us(fn))
            except (NotImplementedError, RuntimeError) as e:
                line["error"] = str(e)[:200]
            print(json.dumps(line), flush=True)
            del img
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
