"""Readings of ``chip_smoke.py``'s 2-rank gates (phase ``parallel_two``) on
the sound code and with two planted faults.

The faults are patched into the spawned ranks only, at run time; the
checkout is not changed:

- ``vit_tp``: the gradients of a split block's LayerNorm and output bias,
  which each model rank holds only part of, are not summed over model
  (``parallel.mesh.partial_grad_names`` returns nothing);
- ``gaviko_tp``: ``copy_in``'s backward does not all-reduce over model, so
  the prompts' gradients through the frozen backbone are partial.

Each run prints the phase's JSON lines (losses, eval, the state's all-leaf
and worst-leaf relative MAE) and what its gates raised. A gate is sound if
the first run raises nothing and each fault run raises. Needs one CUDA
device; builds the checkout's kernels first::

    python3 scripts/parallel_gate_faults.py
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

_sound_rank = cs._par_rank


def fault_rank(rank, world, out_dir, job):
    from gaviko_tpu_torch.parallel import mesh, shard

    if job == "vit_tp":
        mesh.partial_grad_names = lambda plan, names: frozenset()
    else:
        shard._Enter.backward = staticmethod(lambda ctx, g: (g, None))
    _sound_rank(rank, world, out_dir, job)


def run(tag: str, smi: str) -> None:
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gate_faults_") as root:
        try:
            cs.phase_parallel_two(root, smi)
            raised = None
        except Exception as e:  # noqa: BLE001 - the reading is what the gate says
            raised = str(e)[:400]
    print(json.dumps({"run": tag, "raised": raised, "seconds": time.perf_counter() - t}),
          flush=True)


def main() -> None:
    from gaviko_tpu_torch.ops import _build

    smi = cs._nvidia_smi()
    print(json.dumps({"card": smi}), flush=True)
    _build.build()
    run("sound", smi)
    jobs = dict(cs.PAR_MESH)
    cs._par_rank = fault_rank
    for job in ("gaviko_tp", "vit_tp"):
        cs.PAR_MESH.clear()
        cs.PAR_MESH[job] = jobs[job]
        run(f"fault_{job}", smi)
    cs.PAR_MESH.update(jobs)


if __name__ == "__main__":
    main()
