"""Host microseconds a call of kernels A, B10, B and C spends enqueueing.

Times the wrappers ``fused_mhsa`` (A), ``flash_attention`` (B10),
``fused_mhsa_bwd`` (B) and ``flash_local_attention``'s forward (C) of the
``gaviko_tpu_torch`` in the checkout this file lies in: the checks, the
allocations, the argument packing (the TMA descriptor encodes, where the
kernel has them) and the launch, over back-to-back calls with no
synchronisation between them. A host-bound step pays this for every launch.
To compare two commits on one card, copy this file into the other
checkout's ``scripts/`` and run both in turns::

    python3 scripts/attention_host_us.py

Needs one CUDA device; builds the checkout's kernels first. Prints one
JSON line a case (the shapes ``chip_smoke.py`` gives the two kernels on
their main paths, bf16 and fp32) and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CALLS, REPEATS, WARMUP = 50, 7, 3


def _host_us(fn) -> float:
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        times.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def _cases(dtype):
    """(name, call): A at GAViKO vit-l16 (16 heads of 64, 1,033 rows padded
    to 1,040) serving B8 and train B4 with lse and dropout 0.2, B10 at
    vit-t16 B8 on the head views of the packed qkv (3 heads of 64, 1,001
    rows), both at head dim 512 (B2, 4 heads: the general instance), and B
    at GAViKO train B4 (the train case's output, lse and a cotangent) and
    at head dim 512, and C at GAViKO vit-l16 serving B8 (the 20-wide latent's
    q, k and v views of its packed projection on the 10 x 10 x 10 grid,
    window 6, no dropout)."""
    import torch

    from gaviko_tpu_torch.ops.flash_attention import (
        _split_heads, flash_attention, flash_local_attention, fused_mhsa, fused_mhsa_bwd)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    serve, train, t16, gen_a = (randn(8, 1040, 3 * 1024), randn(4, 1040, 3 * 1024),
                                randn(8, 1008, 3 * 192), randn(2, 1008, 3 * 2048))
    q, k, v = (t[:, :, :1001] for t in _split_heads(t16, 3, 64))
    lq, lk, lv = randn(8, 1000, 3 * 20).chunk(3, dim=-1)
    qg, kg, vg = (t[:, :, :1001] for t in _split_heads(gen_a, 4, 512))
    out, lse = fused_mhsa(train, 16, 64, 0.125, 1033, 0.2, with_lse=True, seed=7)
    out_g, lse_g = fused_mhsa(gen_a, 4, 512, 512 ** -0.5, 1001, with_lse=True)
    return [
        ("fused_mhsa_serving", lambda: fused_mhsa(serve, 16, 64, 0.125, 1033)),
        ("fused_mhsa_train", lambda: fused_mhsa(train, 16, 64, 0.125, 1033, 0.2,
                                                with_lse=True, seed=7)),
        ("flash_attention_t16", lambda: flash_attention(q, k, v, 0.125)),
        ("fused_mhsa_gen512", lambda: fused_mhsa(gen_a, 4, 512, 512 ** -0.5, 1001)),
        ("flash_attention_gen512", lambda: flash_attention(qg, kg, vg, 512 ** -0.5)),
        ("fused_mhsa_bwd_train", lambda: fused_mhsa_bwd(train, out, lse, out, 16, 64, 0.125,
                                                        1033, 0.2, 7)),
        ("fused_mhsa_bwd_gen512", lambda: fused_mhsa_bwd(gen_a, out_g, lse_g, out_g, 4, 512,
                                                         512 ** -0.5, 1001)),
        ("local_attention_serving", lambda: flash_local_attention(
            lq, lk, lv, 1024 ** -0.5, (10, 10, 10), (6, 6, 6))),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_host_us: needs a CUDA device", file=sys.stderr)
        return 2
    from gaviko_tpu_torch.ops import _build

    _build.build()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for name, call in _cases(dtype):
                print(json.dumps({"checkout": root, "name": name, "dtype": str(dtype),
                                  "host_us": _host_us(call), "calls": CALLS,
                                  "repeats": REPEATS}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
