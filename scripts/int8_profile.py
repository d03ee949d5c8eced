"""Device time of each launch of kernel B11 (int8 serving), and its host time a call.

At the GAViKO vit-l16 B8 int8 serving shapes (8,320 rows: the qkv
projection 1,024 -> 3,072 with its LN, the out-projection 1,024 -> 1,024
with its bias, the MLP 1,024 -> 4,096 -> 1,024 with the exact GELU, and the
last layer's MLP on its 264 pooled rows), vit-b16's residual MLP (8,064
rows, 768 -> 3,072 -> 768) and vit-b16's out-projection at ``dim_head``
192 (2,304 -> 768), in bf16 and fp32, this profiles calls of
``int8_linear`` and ``int8_mlp`` of the ``gaviko_tpu_torch`` in the
checkout this file lies in under ``torch.profiler``, and prints for each
the device microseconds of each kernel it launched (by name, per call),
their sum, and the CUDA-event milliseconds a call over back-to-back calls.
It then times the host microseconds a call spends enqueueing (checks,
allocations, tensor-map encodes and launches, no synchronisation between
calls). A case the checkout's kernels refuse prints its error. To compare
two commits on one card, copy this file into the other checkout's
``scripts/`` and run both in turns::

    python3 scripts/int8_profile.py

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

CALLS, REPEATS, WARMUP = 20, 7, 3


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


def _cases(dtype):
    """(name, rows, in, out, call) at the shapes the docstring lists."""
    import torch

    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp, quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    def linear(rows, din, dout, ln):
        x = randn(rows, din)
        w, s = quantize_weight(randn(dout, din, std=din ** -0.5))
        if ln:
            g, b = (1.0 + randn(din, std=0.1)).to(dtype), randn(din, std=0.1)
            return lambda: int8_linear(x, w, s, gamma=g, beta=b)
        bias = randn(dout, std=0.1)
        return lambda: int8_linear(x, w, s, bias=bias)

    def mlp(rows, dim, hidden, residual):
        x = randn(rows, dim)
        g, b = (1.0 + randn(dim, std=0.1)).to(dtype), randn(dim, std=0.1)
        w1, s1 = quantize_weight(randn(hidden, dim, std=dim ** -0.5))
        w2, s2 = quantize_weight(randn(dim, hidden, std=hidden ** -0.5))
        b1, b2 = randn(hidden, std=0.1), randn(dim, std=0.1)
        return lambda: int8_mlp(x, g, b, w1, s1, b1, w2, s2, b2, 1e-5, "exact", residual)

    return (("qkv_ln", 8320, 1024, 3072, lambda: linear(8320, 1024, 3072, True)),
            ("out_bias", 8320, 1024, 1024, lambda: linear(8320, 1024, 1024, False)),
            ("mlp", 8320, 1024, 4096, lambda: mlp(8320, 1024, 4096, False)),
            ("mlp_last", 264, 1024, 4096, lambda: mlp(264, 1024, 4096, False)),
            ("mlp_vitb16", 8064, 768, 3072, lambda: mlp(8064, 768, 3072, True)),
            ("out2304", 8064, 2304, 768, lambda: linear(8064, 2304, 768, False)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int8_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from gaviko_tpu_torch.ops import _build

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for dtype in (torch.bfloat16, torch.float32):
        for name, rows, din, dout, make in _cases(dtype):
            line = {"case": name, "dtype": str(dtype), "rows": rows, "in": din, "out": dout,
                    "card": smi}
            try:
                fn = make()
                with torch.no_grad():
                    fn()
                    kernels = _profile(fn)
                    line.update(kernels=[{"name": k, "launches": n, "device_us": us}
                                         for k, n, us in kernels],
                                device_us_sum=sum(us for _, _, us in kernels),
                                event_ms=_event_ms(fn), host_us=_host_us(fn))
            except (NotImplementedError, RuntimeError) as err:
                line["error"] = str(err)[:200]
            print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
