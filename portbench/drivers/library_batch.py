"""A closed loop of frame-stack jobs on `synthesize_batch(a, ap, frames,
cfg, frames_per_step=F)`: one shared style pair, the jobs alternating
between sequences made from the seed.

Mix keys: `size` (side of A, A' and every frame), `frames` (frames a
job), `frames_per_step` (frames resident a step), `sequences` (the
number of sequences the jobs alternate between).  A unit is the plain
job a user runs; a job the judge keeps also asks for the finest fields
(`return_nnf`), and the judge holds every frame of it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .. import gen, reference
from ..judge import Job
from . import Driver, on_device, synth_config


class FrameStack(Driver):
    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any],
                 seed: int, device: str):
        from image_analogies_tpu_torch import synthesize_batch

        self._run = synthesize_batch
        self.cfg = synth_config(config, seed, device)
        self.size = int(mix["size"])
        self.frames_per_unit = int(mix["frames"])
        self.per_step = int(mix["frames_per_step"])
        self.a, self.ap, self.seqs = gen.npr_sequences(
            int(mix["sequences"]), self.frames_per_unit, self.size, seed)
        self.dev = [on_device(x, device) for x in (self.a, self.ap)]
        self.dev_seqs = [on_device(s, device) for s in self.seqs]
        self._kept = []

    def warm(self) -> None:
        self.unit(0)

    def unit(self, k: int, keep: bool = False, progress=None):
        return self._run(self.dev[0], self.dev[1],
                         self.dev_seqs[k % len(self.dev_seqs)], self.cfg,
                         frames_per_step=self.per_step, return_nnf=keep,
                         progress=progress)

    def keep(self, k: int, answer, rng) -> None:
        out, nnf = answer
        self._kept = [(k % len(self.seqs), out.cpu(), torch.as_tensor(nnf),
                       rng.randrange(self.frames_per_unit),
                       rng.getrandbits(62))]

    def kept(self):
        res = []
        for s, outs, nnfs, f, sample_seed in self._kept:
            seq = torch.as_tensor(self.seqs[s])
            stack_stats = reference.stats(reference.rgb_to_yiq(seq)[..., 0])
            res.append(Job(self.a, self.ap, list(self.seqs[s]), stack_stats,
                           outs, nnfs, f, sample_seed))
        return res

    def release(self) -> None:
        self.dev = self.dev_seqs = None


def make(config, mix, seed, device) -> FrameStack:
    return FrameStack(config, mix, seed, device)
