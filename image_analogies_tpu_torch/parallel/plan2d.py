"""Mesh-shape planner for the 2-D bands x slabs spatial runner: the
reference's (`image_analogies_tpu/parallel/plan2d.py`), copied.

Host arithmetic on shapes only, priced with the port's copies of the
reference's models (parallel/comms.py, `kernels.patchmatch_tile.
candidate_dma_bytes_per_fetch` — the reference's TPU byte model, kept
so both packages plan the same mesh for the same shapes).
`plan_mesh_shape` and `override_plan` give the reference's `MeshPlan`
exactly.

Decision rule (in order):

1. **Feasibility** — bands divide the device count, every band owns at
   least one real A row at every level it would run, a multi-band
   candidate has at least one level where banding engages, and the
   modeled per-device peak residency fits the HBM budget when one is
   given (a capacity constraint, not a cost addend).
2. **Modeled bytes** — among the survivors, the least per-device
   collective volume + candidate traffic (`score_bytes`); a level whose
   slab falls below the kernel's floor is charged `_DELEAN_PENALTY` x
   the lean per-candidate bytes.

The chosen shape and every rejected alternative go on the run plan
(`synthesize_spatial(mesh_plan=...)`); `--bands` / `--mesh-rows` is the
manual override and skips the planner.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..config import SynthConfig

# Per-device slab-resident state arrays the residency model charges:
# src_b, flt_bp, coarse pair, py, px — boundary-halo'd f32 planes the
# level keeps live across EM iterations (spatial.py's slab views).
_N_SLAB_ARRAYS = 6
# Lean-table itemsize (bf16) — models/analogy.assemble_features_lean.
_TABLE_ITEMSIZE = 2
# Traffic multiplier for a level the kernel refuses (slab core under
# the LANE floor or A under the tile+halo floor): the standard path
# re-gathers full f32 patch windows per candidate with none of the
# packed-plane DMA coalescing, modeled as 4x the lean per-candidate
# moved bytes.  A modeled constant (like _N_SLAB_ARRAYS), not a
# measurement — its job is ordinal: de-leaning the finest level must
# cost more than any slab/band reshuffle could save.
_DELEAN_PENALTY = 4


@dataclasses.dataclass(frozen=True)
class MeshCandidate:
    """One (n_bands, n_slabs) factorization, priced."""

    n_bands: int
    n_slabs: int
    feasible: bool
    reason: str                 # infeasibility reason ("" if feasible)
    kernel_levels: int          # pyramid levels kernel-eligible at this split
    banded_levels: int          # levels where the bands axis engages
    comms_bytes: int            # modeled per-device collective payload, run
    residency_bytes: int        # modeled per-device peak residency
    dma_bytes: int              # modeled per-device candidate traffic, run
                                # (de-leaned levels carry _DELEAN_PENALTY)
    score_bytes: int            # comms + dma (lower wins; residency is
                                # a capacity constraint, not a cost)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Planner verdict: the chosen shape plus the full rejected field."""

    n_bands: int
    n_slabs: int
    chosen: MeshCandidate
    rejected: Tuple[MeshCandidate, ...]
    source: str = "planner"     # "planner" | "override"

    def as_attrs(self) -> dict:
        """Run-plan annotation payload (decision + rejected
        alternatives), recorded on the run plan."""
        return {
            "mesh_shape": [self.n_bands, self.n_slabs],
            "source": self.source,
            "chosen": self.chosen.as_dict(),
            "rejected": [c.as_dict() for c in self.rejected],
        }


def _factorizations(n_devices: int) -> List[Tuple[int, int]]:
    """All (bands, slabs) with bands * slabs == n_devices, bands
    ascending — the deterministic enumeration order ties break on."""
    return [
        (r, n_devices // r)
        for r in range(1, n_devices + 1)
        if n_devices % r == 0
    ]


def _level_shapes(a_shape, b_shape, cfg: SynthConfig, n_slabs: int):
    """(h, w, ha, wa, has_coarse) per level, finest first, with B rows
    padded to the runner's slab grain (synthesize_spatial's padding)."""
    levels = cfg.clamp_levels(tuple(a_shape), tuple(b_shape))
    h0, w0 = int(b_shape[0]), int(b_shape[1])
    ha0, wa0 = int(a_shape[0]), int(a_shape[1])
    grain = n_slabs * (2 ** (levels - 1)) * 2
    hb = h0 + ((-h0) % grain)
    out = []
    for lvl in range(levels):
        out.append((
            max(1, hb // 2 ** lvl),
            max(1, w0 // 2 ** lvl),
            max(1, ha0 // 2 ** lvl),
            max(1, wa0 // 2 ** lvl),
            lvl < levels - 1,
        ))
    return out


def _price(n_bands: int, n_slabs: int, a_shape, b_shape,
           cfg: SynthConfig,
           hbm_bytes: Optional[int] = None) -> MeshCandidate:
    from ..kernels.patchmatch_tile import (
        K_TOTAL,
        candidate_dma_bytes_per_fetch,
        plan_channels,
    )
    from .comms import (
        banded_spatial_level_collectives,
        sharded_a_band_merge_bytes,
    )
    from .spatial import slab_halo

    halo = slab_halo(cfg)
    # Channel planes per side, the level_eta_cost_units convention:
    # luminance synthesizes 1+1 planes, full color 3+3.
    n_src = n_flt = 1 if cfg.color_mode == "luminance" else 3
    kernel_levels = banded_levels = 0
    comms = residency = dma = 0
    for h, w, ha, wa, has_coarse in _level_shapes(
        a_shape, b_shape, cfg, n_slabs
    ):
        slab_h = h // n_slabs + 2 * halo
        plan = plan_channels(
            n_src, n_flt, cfg, has_coarse, slab_h, w, ha, wa,
        )
        eligible = plan is not None
        banded = eligible and n_bands > 1
        if eligible:
            kernel_levels += 1
        if banded:
            # Band ownership must survive the grain padding: a band
            # whose rows are ALL pad owns nothing and the runner
            # refuses (spatial.py's "use fewer bands" guard).
            a_grain = 2 * n_bands if has_coarse else n_bands
            ha_k = ha + ((-ha) % a_grain)
            rows_pb = ha_k // n_bands
            if (n_bands - 1) * rows_pb >= ha:
                return MeshCandidate(
                    n_bands, n_slabs, False,
                    f"band {n_bands - 1} of {n_bands} owns no real A "
                    f"row at level shape ha={ha}",
                    0, 0, 0, 0, 0, 0,
                )
            banded_levels += 1
        # Comms: the joint 2-D schedule, with a degenerate bands axis
        # when this level would not band (parallel/comms.py composes
        # exactly that way).
        sched = banded_spatial_level_collectives(
            cfg, ha, wa, h, w,
            (n_bands if banded else 1, n_slabs),
        )
        if n_slabs > 1:
            comms += sched["slabs"]["reslab_bytes"]
        if banded:
            merge = sharded_a_band_merge_bytes(cfg, slab_h, w)
            # 4 all-reduce legs per merge => bytes_per_merge / 4 is
            # the per-site plane payload.
            comms += (
                sched["bands"]["all_reduce_sites"]
                * merge["bytes_per_merge"] // 4
            )
        # Residency: slab-share-of-B' + (band-share when banded, full
        # when not) of the lean A table.  f32 slab planes; bf16 table.
        n_chan = (n_src + n_flt) * (2 if has_coarse else 1)
        slab_bytes = slab_h * w * 4 * _N_SLAB_ARRAYS
        table_bytes = ha * wa * n_chan * _TABLE_ITEMSIZE
        a_share = table_bytes // n_bands if banded else table_bytes
        # Kernel planes roughly double the A-side resident (planes +
        # table) — a modeled constant, not a measured one.
        residency = max(residency, slab_bytes + 2 * a_share)
        # Candidate traffic per device: every owned pixel fetches
        # K_TOTAL candidate windows per pm iteration per EM (the same
        # per-fetch byte model the DMA sentinel pins).  A de-leaned
        # level does the same candidate evaluation on the standard
        # path at _DELEAN_PENALTY x the lean bytes — this is where
        # kernel coverage enters the score, weighted by the pixels it
        # actually covers.
        moved, _useful = candidate_dma_bytes_per_fetch(n_chan, 8)
        per_cand = moved / 8.0
        if not eligible:
            per_cand *= _DELEAN_PENALTY
        dma += int(
            cfg.em_iters * cfg.pm_iters * K_TOTAL
            * (h * w / n_slabs) * per_cand
        )
    if n_bands > 1 and banded_levels == 0:
        return MeshCandidate(
            n_bands, n_slabs, False,
            "bands axis would never engage (no kernel-eligible level "
            "at this slab split) — pure device waste",
            kernel_levels, 0, 0, 0, 0, 0,
        )
    if hbm_bytes is not None and residency > hbm_bytes:
        # Residency is a CAPACITY constraint, not a cost addend:
        # traffic terms dwarf resident bytes, so folding residency
        # into the score could never force bands on — yet forcing
        # bands on when A outgrows a chip is the axis's whole reason
        # to exist.
        return MeshCandidate(
            n_bands, n_slabs, False,
            f"modeled per-device residency {residency} exceeds the "
            f"HBM budget {hbm_bytes}",
            kernel_levels, banded_levels, comms, residency, dma,
            comms + dma,
        )
    return MeshCandidate(
        n_bands, n_slabs, True, "", kernel_levels, banded_levels,
        comms, residency, dma, comms + dma,
    )


def plan_mesh_shape(n_devices: int, a_shape, b_shape,
                    cfg: Optional[SynthConfig] = None,
                    hbm_bytes: Optional[int] = None) -> MeshPlan:
    """Pick (n_bands, n_slabs) for `n_devices` and these shapes.

    `hbm_bytes` (optional) is the per-device HBM budget the residency
    model is held to — candidates whose modeled peak residency
    overflows it are infeasible, which is what forces bands on once A
    outgrows a chip.  Returns a `MeshPlan` whose `chosen`/`rejected`
    carry the full priced field; `as_attrs()` is the run-plan
    annotation payload.  Always succeeds: (1, n_devices) is feasible
    by construction absent an HBM cap (the 1-D runner's shape), and
    under a cap that nothing satisfies the minimum-residency candidate
    is chosen (the least-overflowing mesh, flagged by its reason)."""
    cfg = cfg or SynthConfig()
    cands = [
        _price(r, s, a_shape, b_shape, cfg, hbm_bytes)
        for r, s in _factorizations(int(n_devices))
    ]
    feasible = [c for c in cands if c.feasible]
    if feasible:
        # Feasibility -> modeled bytes (de-leaned levels already carry
        # their standard-path penalty inside dma_bytes); min() keeps
        # the FIRST minimum, and enumeration is bands-ascending, so
        # exact ties break toward fewer bands (the simpler mesh).
        best = min(feasible, key=lambda c: c.score_bytes)
    else:
        over = [c for c in cands if c.residency_bytes > 0]
        best = min(
            over or cands, key=lambda c: c.residency_bytes or 1 << 62
        )
    rejected = tuple(c for c in cands if c is not best)
    return MeshPlan(best.n_bands, best.n_slabs, best, rejected)


def override_plan(n_bands: int, n_slabs: int) -> MeshPlan:
    """A manual `--bands`/`--mesh-rows` choice, wrapped so the run
    plan records the override (and that nothing was rejected — the
    user decided)."""
    c = MeshCandidate(
        n_bands, n_slabs, True, "", -1, -1, 0, 0, 0, 0,
    )
    return MeshPlan(n_bands, n_slabs, c, (), source="override")
