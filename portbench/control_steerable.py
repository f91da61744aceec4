"""Readings that set the `steerable` configuration's correctness limits,
at the cell's own size, many seeds in one process (the benchmark's own
runs do not run this); `control.py`'s arms with the steerable reference:

  - `program`: the program's answer to one unit drawn from the seed, kept
    as a run keeps it and judged as a run judges it: the lower readings;
  - `control`: the steerable reference itself in the program's place,
    computed in bfloat16 (one precision below the configuration's
    float32) on the kept unit's inputs, judged the same way: the upper
    readings.

Both are held to one float32 oracle a seed.

    python3 -m portbench.control_steerable --workload steerable.1024.single \\
        --seeds 11 12 13

Prints one JSON line a seed and arm, and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import judge, reference, spec
from . import reference_steerable as steer
from .control import DEVICE, keep_one


def readings(job: judge.Job, config, device: str):
    """{"program": ..., "control": ...}: the judge's numbers for the
    kept answer and for the bfloat16 reference, on the job's oracle
    frame, against one float32 oracle."""
    sp = steer.Spec.from_synth(config["synth"])
    f = job.psnr_frame
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    p32 = steer.prepare(t(job.a), t(job.ap), t(job.bs[f]), sp,
                        b_stats=job.b_stats)
    want, _ = steer.oracle(p32, sp)
    h, w = job.bs[f].shape[:2]
    sample = reference.sample_rows(h * w, judge.MATCH_SAMPLE,
                                   job.sample_seed + f)
    out = {"program": steer.judge(job.outs[f], job.nnfs[f], p32, sp, want,
                                  sample)}
    p16 = steer.prepare(t(job.a), t(job.ap), t(job.bs[f]), sp,
                        b_stats=job.b_stats, dtype=torch.bfloat16)
    got, nnf = steer.oracle(p16, sp)
    del p16
    out["control"] = steer.judge(got.float(), nnf, p32, sp, want, sample)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    make = spec.driver_module(cell.mix["driver"]).make
    seen = {"program": [], "control": []}
    for seed in args.seeds:
        t0 = time.perf_counter()
        drv = make(cell.config, cell.mix, seed, DEVICE)
        keep_one(drv, seed, DEVICE)
        got = readings(drv.kept()[0], cell.config, DEVICE)
        del drv
        for arm, vals in got.items():
            seen[arm].append(vals)
            print(json.dumps({"cell": cell.name, "seed": seed, "arm": arm,
                              **vals}), flush=True)
        torch.cuda.empty_cache()
        print(f"seed {seed} took {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    summary = {}
    for arm, vals in seen.items():
        summary[arm] = {"seeds": len(vals)}
        for name in vals[0]:
            xs = [v[name] for v in vals]
            summary[arm][name] = [min(xs), max(xs)]
    print(json.dumps({"cell": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
