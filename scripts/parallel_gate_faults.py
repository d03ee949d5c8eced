"""Readings of ``chip_smoke.py``'s 2-rank gates (phase ``parallel_two``) on
the sound code and with two planted faults.

The faults are patched into the spawned ranks only, at run time; the
checkout is not changed:

- ``vit_tp``: the gradients of a split block's LayerNorm and output bias,
  which each model rank holds only part of, are not summed over model
  (``parallel.mesh.partial_grad_names`` returns nothing);
- every other job (``gaviko_tp``, ``adaptformer_tp``, ...): ``copy_in``'s
  backward does not all-reduce over model, so the gradients of what lies
  before a split block (GAViKO's prompts through the frozen backbone,
  AdaptFormer's adapters) are partial.

Each run prints the phase's JSON lines (losses, eval, the state's all-leaf
and worst-leaf relative MAE) and what its gates raised. A gate is sound if
the first run raises nothing and each fault run raises. Needs one CUDA
device; builds the checkout's kernels first. With job names, the sound run
and the fault runs take those jobs only (default: every job sound, then
``gaviko_tp`` and ``vit_tp`` with their faults)::

    python3 scripts/parallel_gate_faults.py [adaptformer_tp ...]
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

_sound_rank = cs._par_rank


def fault_rank(rank, world, out_dir, jobs):
    from gaviko_tpu_torch.parallel import mesh, shard

    if "vit_tp" in jobs:
        mesh.partial_grad_names = lambda plan, names: frozenset()
    else:
        shard._Enter.backward = staticmethod(lambda ctx, g: (g, None))
    _sound_rank(rank, world, out_dir, jobs)


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
    jobs = dict(cs.PAR_MESH)
    chosen = sys.argv[1:]
    if chosen:
        cs.PAR_MESH.clear()
        cs.PAR_MESH.update({j: jobs[j] for j in chosen})
    run("sound", smi)
    cs._par_rank = fault_rank
    for job in chosen or ("gaviko_tp", "vit_tp"):
        cs.PAR_MESH.clear()
        cs.PAR_MESH[job] = jobs[job]
        run(f"fault_{job}", smi)
    cs.PAR_MESH.update(jobs)


if __name__ == "__main__":
    main()
