"""The comparison that decides `correct`: the program's kept answers held
to the plain reference (`reference.py`), each number beside its limit.

A kept answer is a `Job`: one unit's inputs and every frame it returned,
with its finest fields.  Every frame of a job is checked for
`render_max_abs` and `match_far_share` (the cheap checks: a render and an
exact search over a sample of its pixels); one frame drawn from the seed
is also held to the exact-search oracle (`psnr_db`, the dear one).  Each
number's worst reading over the frames is compared with the limit the
configuration file gives under `correct`.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import reference as ref

# Pixels of a frame compared for `match_far_share`.
MATCH_SAMPLE = 1 << 17


class Job(NamedTuple):
    a: np.ndarray
    ap: np.ndarray
    bs: List[np.ndarray]  # each frame's B, (H, W, 3) on the host
    b_stats: Optional[Tuple[float, float]]  # the stack's, or None
    outs: torch.Tensor  # (F, H, W, 3) B'
    nnfs: torch.Tensor  # (F, H, W, 2) finest fields
    psnr_frame: int  # the frame held to the oracle
    sample_seed: int  # draws each frame's `match_far_share` pixels


# name -> (key of its limit in the configuration's `correct`, holds)
LIMITS = {
    "render_max_abs": ("render_max_abs_max", "<="),
    "match_far_share": ("match_far_share_max", "<="),
    "psnr_db": ("psnr_db_min", ">="),
}


def frame_readings(job: Job, f: int, spec: ref.Spec, device: str,
                   with_oracle: bool) -> Dict[str, float]:
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    p = ref.prepare(t(job.a), t(job.ap), t(job.bs[f]), spec,
                    b_stats=job.b_stats)
    oracle_out = ref.oracle(p, spec)[0] if with_oracle else None
    h, w = job.bs[f].shape[:2]
    sample = ref.sample_rows(h * w, MATCH_SAMPLE, job.sample_seed + f)
    return ref.judge(job.outs[f], job.nnfs[f], p, spec, oracle_out, sample)


def checks(jobs: List[Job], config: Dict[str, Any],
           device: str) -> Dict[str, Dict[str, Any]]:
    spec = ref.Spec.from_synth(config["synth"])
    worst: Dict[str, float] = {}
    for job in jobs:
        for f in range(len(job.bs)):
            got = frame_readings(job, f, spec, device, f == job.psnr_frame)
            for name, v in got.items():
                keep = max if LIMITS[name][1] == "<=" else min
                worst[name] = keep(worst.get(name, v), v)
    out = {}
    for name, (key, how) in LIMITS.items():
        if name in worst:
            out[name] = {"value": finite(worst[name]),
                         "limit": config["correct"][key], "holds": how}
    return out


def finite(x: float) -> float:
    """A reading as a JSON number: an infinite one as the largest float."""
    return max(min(x, sys.float_info.max), -sys.float_info.max)


def holds(check: Dict[str, Any]) -> bool:
    v, lim = check["value"], check["limit"]
    return v <= lim if check["holds"] == "<=" else v >= lim
