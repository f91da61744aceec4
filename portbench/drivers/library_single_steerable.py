"""`library_single`'s load on a configuration with steerable-filter
features: one caller in a closed loop on `create_image_analogy(a, ap, b,
cfg)`, A and A' fixed, B drawn in turn from a pool made from the seed.

Mix keys as `library_single`'s.  Only the checks differ: the kept
answers are held to the steerable reference
(`portbench/reference_steerable.py`) with `judge.py`'s rules (every frame
for `render_max_abs` and a sample of its pixels for `match_far_share`,
the frame the seed drew for `psnr_db`, each number's worst reading beside
its limit), so `judge.holds` reads the result as it reads any other.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .. import judge, reference
from .. import reference_steerable as steer
from .library_single import SingleImage


def frame_readings(job: judge.Job, f: int, spec: steer.Spec, device: str,
                   with_oracle: bool) -> Dict[str, float]:
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    p = steer.prepare(t(job.a), t(job.ap), t(job.bs[f]), spec,
                      b_stats=job.b_stats)
    oracle_out = steer.oracle(p, spec)[0] if with_oracle else None
    h, w = job.bs[f].shape[:2]
    sample = reference.sample_rows(h * w, judge.MATCH_SAMPLE,
                                   job.sample_seed + f)
    return steer.judge(job.outs[f], job.nnfs[f], p, spec, oracle_out,
                       sample)


def checks(jobs: List[judge.Job], config: Dict[str, Any],
           device: str) -> Dict[str, Dict[str, Any]]:
    """`judge.checks` with the steerable reference."""
    spec = steer.Spec.from_synth(config["synth"])
    worst: Dict[str, float] = {}
    for job in jobs:
        for f in range(len(job.bs)):
            got = frame_readings(job, f, spec, device, f == job.psnr_frame)
            for name, v in got.items():
                keep = max if judge.LIMITS[name][1] == "<=" else min
                worst[name] = keep(worst.get(name, v), v)
    out = {}
    for name, (key, how) in judge.LIMITS.items():
        if name in worst:
            out[name] = {"value": judge.finite(worst[name]),
                         "limit": config["correct"][key], "holds": how}
    return out


class SteerableSingle(SingleImage):
    def checks(self, config: Dict[str, Any], device: str) -> Dict[str, Any]:
        jobs = self.kept()
        return checks(jobs, config, device) if jobs else {}


def make(config, mix, seed, device) -> SteerableSingle:
    return SteerableSingle(config, mix, seed, device)
