"""Readings that set the correctness limits, at a cell's own size, many
seeds in one process (the benchmark's own runs do not run this):

  - `program`: the program's answer to one unit drawn from the seed, kept
    and judged as a run keeps and judges it: the lower readings;
  - `control`: the reference itself put in the program's place, computed
    in bfloat16 (one precision below the float32 the configurations
    state) on the inputs of the kept unit's oracle frame, judged the same
    way: the upper readings;
  - `fewer_sweeps`: the program with its search cut to one PatchMatch
    sweep an EM step and one polish sweep without random candidates,
    judged the same way: what the numbers read of a weaker search.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 \\
        [--what program control fewer_sweeps]

Prints one JSON line a seed and arm, and a summary line last.
"""

from __future__ import annotations

import argparse
import copy
import json
import random
import sys
import time

import torch

from . import judge
from . import reference as ref
from . import spec

DEVICE = "cuda"
FEWER_SWEEPS = {"pm_iters": 1, "pm_polish_iters": 1, "pm_polish_random": 0}


def keep_one(drv, seed: int, device: str) -> None:
    """One unit drawn from the seed, kept as a run keeps it."""
    rng = random.Random(int(seed))
    k = rng.randrange(4)
    answer = drv.unit(k, keep=True)
    if device == "cuda":
        torch.cuda.synchronize()
    drv.keep(k, answer, rng)
    del answer
    drv.release()


def control_readings(jobs, config, device: str):
    """The judge's numbers for the reference in bfloat16 in the program's
    place, on each kept job's oracle frame."""
    sp = ref.Spec.from_synth(config["synth"])
    out = []
    for job in jobs:
        f = job.psnr_frame
        t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        p32 = ref.prepare(t(job.a), t(job.ap), t(job.bs[f]), sp,
                          b_stats=job.b_stats)
        want, _ = ref.oracle(p32, sp)
        p16 = ref.prepare(t(job.a), t(job.ap), t(job.bs[f]), sp,
                          b_stats=job.b_stats, dtype=torch.bfloat16)
        got, nnf = ref.oracle(p16, sp)
        del p16
        h, w = job.bs[f].shape[:2]
        sample = ref.sample_rows(h * w, judge.MATCH_SAMPLE,
                                 job.sample_seed + f)
        out.append(ref.judge(got.float(), nnf, p32, sp, want, sample))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program", "control"],
                    choices=["program", "control", "fewer_sweeps"])
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    make = spec.driver_module(cell.mix["driver"]).make
    weak = copy.deepcopy(cell.config)
    weak["synth"].update(FEWER_SWEEPS)
    seen = {w: {} for w in args.what}
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = {}
        drv = make(cell.config, cell.mix, seed, DEVICE)
        keep_one(drv, seed, DEVICE)
        if "program" in args.what:
            got["program"] = {n: c["value"] for n, c in
                              drv.checks(cell.config, DEVICE).items()}
        if "control" in args.what:
            got["control"] = control_readings(drv.kept(), cell.config,
                                              DEVICE)[0]
        del drv
        if "fewer_sweeps" in args.what:
            drv = make(weak, cell.mix, seed, DEVICE)
            keep_one(drv, seed, DEVICE)
            got["fewer_sweeps"] = {n: c["value"] for n, c in
                                   drv.checks(cell.config, DEVICE).items()}
            del drv
        for arm, vals in got.items():
            seen[arm][seed] = vals
            print(json.dumps({"cell": cell.name, "seed": seed, "arm": arm,
                              **vals}), flush=True)
        torch.cuda.empty_cache()
        print(f"seed {seed} took {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    summary = {}
    for arm, by_seed in seen.items():
        if not by_seed:
            continue
        vals = list(by_seed.values())
        summary[arm] = {"seeds": len(vals)}
        for name in vals[0]:
            xs = [v[name] for v in vals]
            summary[arm][name] = [min(xs), max(xs)]
    print(json.dumps({"cell": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
