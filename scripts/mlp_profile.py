"""Device time of each launch of kernels B6 and B7, and their host time a call.

At the vit-b16 B8 train shapes (8,064 rows, dim 768, mlp 3,072; exact GELU,
dropout 0.1, the residual, B6 saving the pre-GELU hidden), in bf16 and fp32
(TF32 off), this profiles calls of ``fused_mlp_forward`` (B6) and
``fused_mlp_bwd`` (B7) of the ``gaviko_tpu_torch`` in the checkout this file
lies in under ``torch.profiler``, and prints for each the device
microseconds of each kernel it launched (by name, per call), their sum, and
the CUDA-event milliseconds a call over back-to-back calls. It then times
the host microseconds a call spends enqueueing (checks, allocations, tensor
map encodes and launches, no synchronisation between calls). To compare
two commits on one card, copy this file into the other checkout's
``scripts/`` and run both in turns::

    python3 scripts/mlp_profile.py

Needs one CUDA device; builds the checkout's kernels first. Prints one JSON
line a case and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS, DIM, MLP, RATE, SEED = 8 * 1008, 768, 3072, 0.1, -7654321
CALLS, REPEATS, WARMUP = 20, 7, 3


def _inputs(dtype):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    x, dy = randn(ROWS, DIM), randn(ROWS, DIM)
    gamma, beta = (1.0 + randn(DIM, std=0.1)).to(dtype), randn(DIM, std=0.1)
    w1, b1 = randn(MLP, DIM, std=DIM ** -0.5), randn(MLP, std=0.1)
    w2, b2 = randn(DIM, MLP, std=MLP ** -0.5), randn(DIM, std=0.1)
    return (x, gamma, beta, w1, b1, w2, b2), dy


def _event_ms(fn) -> float:
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPEATS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / CALLS)
    return statistics.median(times)


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


def _profile(fn, calls: int = 5) -> list:
    """[(kernel name, launches a call, device us a call)] of ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        kind = str(getattr(e, "device_type", ""))
        if us > 0 and e.count and "CUDA" in kind and not e.key.startswith(("cudaLaunch", "Memcpy")):
            rows.append((e.key[:160], e.count / calls, us / calls))
    return sorted(rows, key=lambda r: -r[2])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mlp_profile: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from gaviko_tpu_torch.ops import _build
    from gaviko_tpu_torch.ops import fused_mlp as fm

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for dtype in (torch.bfloat16, torch.float32):
        mlp_args, dy = _inputs(dtype)
        with torch.no_grad():
            _, a = fm.fused_mlp_forward(*mlp_args, 1e-5, "exact", RATE, True, SEED, save_a=True)
        cases = (("B6", lambda: fm.fused_mlp_forward(*mlp_args, 1e-5, "exact", RATE, True, SEED,
                                                     save_a=True)),
                 ("B7", lambda: fm.fused_mlp_bwd(*mlp_args, dy, a, 1e-5, "exact", RATE, True,
                                                 SEED)))
        for name, fn in cases:
            with torch.no_grad():
                kernels = _profile(fn)
                line = {"case": name, "dtype": str(dtype), "rows": ROWS, "dim": DIM, "mlp": MLP,
                        "kernels": [{"name": k, "launches": n, "device_us": us}
                                    for k, n, us in kernels],
                        "device_us_sum": sum(us for _, _, us in kernels),
                        "event_ms": _event_ms(fn), "host_us": _host_us(fn), "card": smi}
            print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
