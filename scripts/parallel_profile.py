"""Device busy time of the paths that ``train.fused_optimizer: false``,
accumulation under a mesh, the PEFT zoo's tensor parallelism and int8
serving on a mesh run, each call under ``torch.profiler``
(``chip_smoke.profile_step``: the device kernels that start inside the
call's range, summed, against the call's wall time):

- ``chain`` and ``fused``: ``chip_smoke.phase_chain``'s runs (vit-b16 fft
  at CUT_DEPTH, B8 fp32), the chain's state or the fused one, one more
  step under the profiler after the timed ones;
- each job of ``chip_smoke.PAR_MESH`` named (default: vit_accum, melo_tp,
  ssf_tp, adaptformer_tp): its 1-rank run, then its two ranks on cuda:0
  over gloo, every train step (micro-step) under the profiler in each
  process;
- ``int8_serve``: GAViKO vit-l16 int8 at B8 on each mesh of
  ``PAR_INT8_MESHES``, rank 0's ``predict_logits`` and rank 1's ``follow``
  under the profiler.

Both ranks share the card and each process's profiler sees only its own
kernels, so a rank's idle share counts the other rank's kernels as idle.
The comparisons are ``chip_smoke.py``'s; this only times. Prints one JSON
line a run and process. Needs one CUDA device; builds the checkout's
kernels first::

    python3 scripts/parallel_profile.py [job ...]
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

JOBS = ("vit_accum", "melo_tp", "ssf_tp", "adaptformer_tp")
PROFILES = {}  # job -> a record of chip_smoke.profile_step for each profiled call
_job = [None]
_sound_rank = cs._par_rank


def _profiled(fn):
    def wrapped(*args, **kwargs):
        box = {}

        def call():
            box["out"] = fn(*args, **kwargs)

        rec = cs.profile_step(call)
        PROFILES.setdefault(_job[0], []).append(
            {k: rec[k] for k in ("wall_ms_under_profiler", "device_busy_ms",
                                 "device_idle_share", "device_kernels")})
        return box["out"]

    return wrapped


def _instrument() -> None:
    """In this process: the jobs' train steps and int8 forwards run under
    the profiler, filed under the job that runs them."""
    from gaviko_tpu_torch.parallel.mesh import ParallelTrainer
    from gaviko_tpu_torch.serving import Predictor
    from gaviko_tpu_torch.train import loop

    ParallelTrainer.train_step = _profiled(ParallelTrainer.train_step)
    Predictor.predict_logits = _profiled(Predictor.predict_logits)
    Predictor.follow = _profiled(Predictor.follow)
    make_steps, par_run, par_serve = loop.make_steps, cs._par_run, cs._par_serve

    def made(*args, **kwargs):
        step, eval_step, rest = make_steps(*args, **kwargs)
        return _profiled(step), eval_step, rest

    def run(job, world):
        _job[0] = job
        return par_run(job, world)

    def serve(world):
        _job[0] = "int8_serve"
        return par_serve(world)

    loop.make_steps, cs._par_run, cs._par_serve = made, run, serve


def profile_rank(rank, world, out_dir, jobs):
    _instrument()
    _sound_rank(rank, world, out_dir, jobs)
    with open(os.path.join(out_dir, f"profile{rank}.json"), "w") as f:
        json.dump(PROFILES, f)


def main() -> None:
    import torch

    from gaviko_tpu_torch.ops import _build

    smi = cs._nvidia_smi()
    print(json.dumps({"card": smi}), flush=True)
    _build.build()
    jobs = sys.argv[1:] or list(JOBS)
    torch.backends.cuda.matmul.allow_tf32 = False
    config, *rest = cs.cut_vit_train_setup(None)
    for name, flag in (("fused", True), ("chain", False)):
        cfg = {**config, "train": {**config["train"], "fused_optimizer": flag}}
        res = cs.run_train(cfg, *rest, "fp32", profiled=True)
        prof = res["profile"]
        print(json.dumps({"run": name, "process": "one", "step_ms": res["step_ms"],
                          **{k: prof[k] for k in ("wall_ms_under_profiler", "device_busy_ms",
                                                  "device_idle_share", "device_kernels")},
                          "card": smi}), flush=True)
    del rest
    torch.cuda.empty_cache()
    _instrument()
    for job in jobs:
        t = time.perf_counter()
        cs._par_run(job, 1)
        torch.cuda.empty_cache()
        print(json.dumps({"run": job, "process": "one", "calls": PROFILES.pop(job),
                          "seconds": time.perf_counter() - t, "card": smi}), flush=True)
    cs._par_rank = profile_rank
    with tempfile.TemporaryDirectory(prefix="parallel_profile_") as root:
        t = time.perf_counter()
        cs._spawn_ranks([*jobs, "int8_serve"], 2, root)
        seconds = time.perf_counter() - t
        for r in range(2):
            with open(os.path.join(root, f"profile{r}.json")) as f:
                for job, calls in json.load(f).items():
                    print(json.dumps({"run": job, "process": f"rank{r}", "calls": calls,
                                      "spawn_seconds": seconds, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
