"""Load drivers: each module here generates one kind of load from a
mix's parameters.  A mix file names its driver (`"driver"`); the driver
module's `make(config, mix, seed, device)` returns a `Driver`.

A driver implements

  - `frames_per_unit`: B' frames one unit of work returns;
  - `warm()`: every shape the mix uses, once (set-up);
  - `unit(k, keep=False, progress=None)`: unit k, through the program's
    entry as a user calls it; with `keep` also what the judge needs (the
    finest field); returns its answer (work may still be queued on the
    device: the caller synchronises);
  - `keep(k, answer, rng)`: hold that answer for the judge;
  - `kept()`: the held answers as `judge.Job`s;
  - `release()`: drop the program's device state;

and inherits, or replaces, what the harness calls around them:

  - `window(seconds, seed, sync)`: the measured window (here a closed
    loop); returns its record, which the metric readers read;
  - `traced(k, sync)`: one unit with the program's `Tracer` and one under
    `torch.profiler`, after the window;
  - `checks(config, device)`: the numbers compared, each beside its limit.

So a mix with a load of its own (an open loop against the daemon, say)
is a new driver file and a mix file, and the harness is not edited.
"""

from __future__ import annotations

import os
import random
import tempfile
import time
import traceback
from typing import Any, Dict, List

import numpy as np
import torch


def synth_config(config: Dict[str, Any], seed: int, device: str):
    """The program's `SynthConfig` from a configuration file's `synth`
    keys, on `device`, its random streams keyed by the run's seed."""
    from image_analogies_tpu_torch import SynthConfig

    return SynthConfig(**config["synth"], device=device,
                       seed=int(seed) % (1 << 63))


def on_device(x: np.ndarray, device: str) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                           device=device)


def stacked_field(nnf) -> torch.Tensor:
    """A finest-level field as one (H, W, 2) tensor: a lean level's
    (py, px) planes stacked."""
    if isinstance(nnf, tuple):
        return torch.stack(nnf, dim=-1)
    return torch.as_tensor(nnf)


def k1_launches() -> int:
    """The program's count of K1 launches so far in this process."""
    from image_analogies_tpu_torch.kernels import patchmatch_tile

    return patchmatch_tile.launches.count


class Driver:
    frames_per_unit = 1

    def window(self, seconds: float, seed: int, sync) -> Dict[str, Any]:
        """A closed loop: unit after unit until `seconds` have passed; the
        last unit ends the window.  Before each unit a reservoir draw from
        the seed decides whether its answer is kept for the judge (unit k
        with chance 1 / (k + 1), so each unit of the window is equally
        likely to be the one judged); only a kept unit asks the program
        for its field.  A unit that raises ends the loop, its frames
        failed.

        The record: `attempted`, `failed`, `frames` (returned), `units`,
        `window_s`, `unit_s` (each unit's wall), `k1_launches`."""
        rng = random.Random(int(seed))
        rec: Dict[str, Any] = {"attempted": 0, "failed": 0, "frames": 0,
                               "units": 0, "unit_s": []}
        k1_before = k1_launches()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k = rec["units"]
            keep = rng.random() * (k + 1) < 1.0
            rec["attempted"] += self.frames_per_unit
            tu = time.perf_counter()
            try:
                answer = self.unit(k, keep=keep)
                sync()
            except Exception:  # a unit that raises fails the run
                traceback.print_exc()
                rec["failed"] += self.frames_per_unit
                break
            rec["unit_s"].append(time.perf_counter() - tu)
            rec["frames"] += self.frames_per_unit
            if keep:
                self.keep(k, answer, rng)
            del answer
            rec["units"] += 1
        rec["window_s"] = time.perf_counter() - t0
        rec["k1_launches"] = k1_launches() - k1_before
        return rec

    def traced(self, k: int, sync) -> Dict[str, Any]:
        """Unit k with the program's `Tracer` (its `prologue` record and
        `level` spans), then unit k + 1 under torch.profiler: `tracer`,
        `span_frames`, `trace` (`trace_attr.summarize` of the profiled
        unit), `profiled_frames`, `profile_wall_s`."""
        from image_analogies_tpu_torch.telemetry.spans import Tracer
        from torch.profiler import ProfilerActivity, profile

        from .. import trace_attr

        tracer = Tracer()
        self.unit(k, progress=tracer)
        sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            self.unit(k + 1)
            sync()
            wall = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            summary = trace_attr.summarize(trace_attr.load_events(path))
        finally:
            os.remove(path)
        return {"tracer": tracer, "span_frames": self.frames_per_unit,
                "trace": summary, "profiled_frames": self.frames_per_unit,
                "profile_wall_s": wall}

    def checks(self, config: Dict[str, Any], device: str) -> Dict[str, Any]:
        from .. import judge

        jobs: List[Any] = self.kept()
        return judge.checks(jobs, config, device) if jobs else {}
