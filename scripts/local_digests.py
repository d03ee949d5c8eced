"""sha256 digests of kernels C and D's outputs on fixed inputs.

C (``_local_forward``: out and lse) and D (``local_attention_bwd``: the
packed dq, dk, dv) of the ``gaviko_tpu_torch`` in the checkout this file
lies in, at GAViKO's 10x10x10 grid and 6^3 window, B4, dropout 0.2, with q,
k and v views of one packed [B, 1000, 3 dl] projection: at the shipped
latent of 20 and at 64, in bf16 and fp32. The inputs come from a seeded
generator on the card, so two checkouts given the same card see the same
inputs, and equal digests mean bit-equal outputs. ``chip_smoke.py`` pins
them (``LOCAL_DIGESTS``); to compare two commits on one card, copy this
file into the other checkout's ``scripts/`` and run both::

    python3 scripts/local_digests.py

Needs one CUDA device; builds the checkout's kernels first. Prints one JSON
object (case -> digest) and the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DHW, WINDOW, BATCH, RATE, SEED = (10, 10, 10), (6, 6, 6), 4, 0.2, 1234567


def local_digests() -> dict:
    """Case ("dl20_bf16", ...) -> the sha256 of C's out and lse, then D's
    dqkv, as bytes."""
    import torch

    from gaviko_tpu_torch.ops.flash_attention import _local_forward, local_attention_bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    digests = {}
    for dl in (20, 64):
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            gen = torch.Generator(device="cuda").manual_seed(dl)
            n = DHW[0] * DHW[1] * DHW[2]
            q, k, v = torch.randn(BATCH, n, 3 * dl, generator=gen, device="cuda").to(
                dtype).split(dl, dim=-1)
            dout = torch.randn(BATCH, n, dl, generator=gen, device="cuda").to(dtype)
            with torch.no_grad():
                out, lse = _local_forward(q, k, v, 1024 ** -0.5, DHW, WINDOW, RATE, SEED)
                dqkv = local_attention_bwd(q, k, v, out, lse, dout, 1024 ** -0.5, DHW, WINDOW,
                                           RATE, SEED)
            h = hashlib.sha256()
            for t in (out, lse, dqkv):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            digests[f"dl{dl}_{tag}"] = h.hexdigest()
    return digests


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("local_digests: needs a CUDA device", file=sys.stderr)
        return 2
    from gaviko_tpu_torch.ops import _build

    _build.build()
    print(json.dumps(local_digests()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
