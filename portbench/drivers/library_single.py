"""One caller in a closed loop on `create_image_analogy(a, ap, b, cfg)`:
A and A' fixed, B drawn in turn from a pool made from the seed.

Mix keys: `size` (side of A, A' and B), `pool` (number of B images).
The inputs are made on the host by `portbench.gen` and held on the
device before the window, as a caller with resident images holds them.
A unit is the plain call a user makes; a unit the judge keeps also asks
for the fields (`return_aux`).
"""

from __future__ import annotations

from typing import Any, Dict

from .. import gen
from ..judge import Job
from . import Driver, on_device, stacked_field, synth_config


class SingleImage(Driver):
    frames_per_unit = 1

    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any],
                 seed: int, device: str):
        from image_analogies_tpu_torch import create_image_analogy

        self._run = create_image_analogy
        self.cfg = synth_config(config, seed, device)
        self.size = int(mix["size"])
        self.a, self.ap, self.bs = gen.super_resolution_pool(
            self.size, seed, int(mix["pool"]))
        self.dev = [on_device(x, device) for x in (self.a, self.ap)]
        self.dev_b = [on_device(b, device) for b in self.bs]
        self._kept = []

    def warm(self) -> None:
        self.unit(0)

    def unit(self, k: int, keep: bool = False, progress=None):
        return self._run(self.dev[0], self.dev[1],
                         self.dev_b[k % len(self.dev_b)], self.cfg,
                         return_aux=keep, progress=progress)

    def keep(self, k: int, answer, rng) -> None:
        self._kept = [(k % len(self.bs), answer["bp"][None].cpu(),
                       stacked_field(answer["nnf"][0])[None].cpu(),
                       rng.getrandbits(62))]

    def kept(self):
        return [Job(self.a, self.ap, [self.bs[i]], None, out, nnf, 0, s)
                for i, out, nnf, s in self._kept]

    def release(self) -> None:
        self.dev = self.dev_b = None


def make(config, mix, seed, device) -> SingleImage:
    return SingleImage(config, mix, seed, device)
