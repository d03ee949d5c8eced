"""Device time of each launch of kernels B9 and B12, and their host time a call.

B9 (``fused_ln_linear``) at the vit-b16 B8 serving shapes (8,064 rows, dim
768, the qkv projection to 2,304 and the last layer's kv to 1,536) and at a
Queue C 11 width (1,152 -> 1,152); B12 (``ln_linear_bwd``) at the vit-b16
B8 hybrid train shapes (8,064 rows, 768 -> 2,304) and GAViKO vit-l16 B4's
(4,160 rows, 1,024 -> 3,072), each with dW and without. In bf16 and fp32
(TF32 off), this profiles calls of the ``gaviko_tpu_torch`` in the checkout
this file lies in under ``torch.profiler``, and prints for each case the
device microseconds of each kernel it launched (by name, per call), their
sum, and the CUDA-event milliseconds a call over back-to-back calls. It
then times the host microseconds a call spends enqueueing (checks,
allocations, tensor-map encodes and launches, no synchronisation between
calls). A case the checkout refuses prints its error. To compare two
commits on one card, copy this file into the other checkout's ``scripts/``
and run both in turns::

    python3 scripts/ln_linear_profile.py

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

# (case, rows, dim, out, with dW or None for B9)
CASES = (("B9_qkv", 8 * 1008, 768, 2304, None), ("B9_kv", 8 * 1008, 768, 1536, None),
         ("B9_c11", 8 * 1008, 1152, 1152, None),
         ("B12", 8 * 1008, 768, 2304, True), ("B12_no_dw", 8 * 1008, 768, 2304, False),
         ("B12_l16", 4 * 1040, 1024, 3072, True), ("B12_l16_no_dw", 4 * 1040, 1024, 3072, False))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ln_linear_profile: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from gaviko_tpu_torch.ops import _build
    from gaviko_tpu_torch.ops.ln_linear import fused_ln_linear, ln_linear_bwd

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for dtype in (torch.bfloat16, torch.float32):
        for name, rows, dim, out, need_dw in CASES:
            gen = torch.Generator(device="cuda").manual_seed(0)

            def randn(*shape, std=1.0):
                return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

            x, w = randn(rows, dim, std=2.0) + 0.5, randn(out, dim, std=dim ** -0.5)
            gamma, beta = (1.0 + randn(dim, std=0.1)).to(dtype), randn(dim, std=0.1)
            dy = randn(rows, out, std=out ** -0.5)
            if need_dw is None:
                def fn():
                    return fused_ln_linear(x, gamma, beta, w)
            else:
                def fn():
                    return ln_linear_bwd(x, gamma, beta, w, dy, 1e-5, need_dw)
            line = {"case": name, "dtype": str(dtype), "rows": rows, "dim": dim, "out": out,
                    "card": smi}
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
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
