"""The collective model of the multi-device runners: how many
collectives each runner's level issues, per mesh axis, and their bytes.

The model functions are the reference's (`image_analogies_tpu/parallel/
comms.py`), copied, so the mesh planner (parallel/plan2d.py) prices
shapes as the reference does:

- **batch** (parallel/batch.py): frames shard over the ranks, the A
  side is built on every rank, and an EM step issues no collective
  (`batch_em_collectives`).
- **spatial** (parallel/spatial.py): between EM steps of a level the
  re-slab trades slab boundary rows with the two neighbour ranks only,
  point to point (`spatial_reslab_collectives` exchanges a re-slab,
  `spatial_reslab_bytes` per rank); the slab cores are gathered once a
  level.
- **sharded-A** (parallel/sharded_a.py): the bands axis carries the
  field merge after every kernel sweep (`_band_merge`: 4 all-reduces)
  and one MIN all-reduce per distance evaluation of the masked local
  gather (`_sharded_dist`): the entry, the exact-metric merge and every
  polish candidate (`sharded_a_allreduce_count`).
- **2-D bands x slabs**: the two, on their own axes
  (`banded_spatial_level_collectives`).

One difference from the reference.  The reference counts trace-time
SITES, per compilation (`sharded_a_allreduce_sites`: a polish loop's
body traces once).  The port runs eagerly, so its ledger counts
EXECUTED calls, on both sides: the runners book the expected side
from `sharded_a_allreduce_count` (a sharded level) and
`sharded_a_step_allreduces` (one EM step of the 2-D runner), and the
re-slab's `spatial_reslab_collectives` per re-slab
(telemetry/metrics.py `count_collectives` /
`count_expected_collectives`; the sentinel's `check_comms` grades the
two).  The site formulas stay as the reference has them, for the
planner.  The ledger counts the collectives inside a level's EM steps;
the once-a-level gathers (slab cores, shard walls) and the gather of
outputs are not part of the model, as the reference's placement
traffic is not.
"""

from __future__ import annotations

from typing import Dict

from ..config import SynthConfig


def batch_em_collectives() -> int:
    """Collective ops inside one batched EM step body: none — frames
    are independent and the A side is already resident everywhere."""
    return 0


def spatial_reslab_bytes(
    w: int, halo: int, n_arrays: int, itemsize: int = 4
) -> int:
    """Per-device payload of ONE re-slab (the between-EM-iteration
    stitch+re-split): each slab refreshes `halo` rows of context on
    each side from its two neighbors, for each of the `n_arrays`
    re-haloed state arrays (standard path: stacked nnf counts 2
    int32 planes + bp; lean path: py, px, bp) — boundary rows only,
    independent of slab height."""
    return 2 * halo * w * n_arrays * itemsize


def _polish_dist_calls(cfg: SynthConfig, ha: int, wa: int,
                      final: bool) -> int:
    """Distance-evaluation sites of one EM step's polish under the
    sequential cascade (the sharded runners' only polish — stream mode
    leaves custom dist_fns on the cascade): the entry re-evaluation
    plus 8 propagation + n_random probes per sweep; zero on non-final
    iterations under pm_polish_final_only."""
    from ..models.patchmatch import _polish_schedule_for

    override = None if (final or not cfg.pm_polish_final_only) else 0
    iters, n_random = _polish_schedule_for(cfg, ha, wa, override)
    if iters == 0:
        return 0
    return 1 + iters * (8 + n_random)


def sharded_a_allreduce_count(
    cfg: SynthConfig, ha: int, wa: int, *, per_em: bool = False
) -> int:
    """All-reduces one band-sharded level executes (the port's
    `synthesize_sharded_a` books this per lean level), or one final EM
    step (`per_em=True`).  The reference reads it as the ops traced into
    its compiled level.

    Per EM iteration:
      4 * pm_iters   `_band_merge` after every kernel sweep
                     (MIN dist + MIN winner + SUM oy + SUM ox)
      + 2            entry dist0 + exact-metric merge d_k
                     (1 `_sharded_dist` MIN each)
      + polish       `_polish_dist_calls` MINs
      + 8 if kappa>0 coherence adoption (2 sweeps x 4 neighbors) —
                     ONLY on EM iterations whose polish is engaged:
                     `tile_patchmatch_lean` returns before the
                     Ashikhmin pass when that EM's polish_iters is 0
                     (non-final iterations under pm_polish_final_only),
                     so a mid-EM contributes no coherence collectives.
    """
    from ..models.patchmatch import _pm_iters_for

    pm_iters = _pm_iters_for(cfg, ha, wa)
    ems = 1 if per_em else cfg.em_iters
    total = 0
    for em in range(ems):
        final = per_em or em == cfg.em_iters - 1
        polish = _polish_dist_calls(cfg, ha, wa, final)
        total += 4 * pm_iters + 2
        total += polish
        if cfg.kappa > 0.0 and polish > 0:
            total += 2 * 4
    return total


def sharded_a_allreduce_sites(
    cfg: SynthConfig, ha: int, wa: int, *, per_em: bool = False,
    polish_iters=None,
) -> int:
    """The reference's count of traced collective SITES of one
    band-sharded level (or one EM step with an explicit `polish_iters`
    override): the expected side of its sentinel, and what the mesh
    planner prices (`banded_spatial_level_collectives`).

    Identical to `sharded_a_allreduce_count` except the polish term: the
    reference's polish loop traces its body once, so an engaged polish
    contributes `1 + (8 + n_random)` sites whatever its iteration count,
    where the executed count is `1 + iters * (8 + n_random)`
    (`sharded_a_step_allreduces`).  The two coincide at
    pm_polish_iters == 1."""
    from ..models.patchmatch import _pm_iters_for, _polish_schedule_for

    pm_iters = _pm_iters_for(cfg, ha, wa)
    ems = 1 if per_em else cfg.em_iters
    total = 0
    for em in range(ems):
        if per_em:
            iters, n_random = _polish_schedule_for(
                cfg, ha, wa, polish_iters
            )
        else:
            final = em == cfg.em_iters - 1
            override = (
                None if (final or not cfg.pm_polish_final_only) else 0
            )
            iters, n_random = _polish_schedule_for(cfg, ha, wa, override)
        total += 4 * pm_iters + 2
        if iters > 0:
            total += 1 + 8 + n_random  # the loop body, once
            if cfg.kappa > 0.0:
                total += 2 * 4  # the kappa pass
    return total


def spatial_reslab_collectives(n_arrays: int) -> int:
    """Exchanges of one re-slab (`spatial._reslab`): each slab-shaped
    array trades `halo` boundary rows with both neighbours, one exchange
    a direction an array (the reference's collective-permute sites)."""
    return 2 * n_arrays


def banded_spatial_level_collectives(
    cfg: SynthConfig, ha: int, wa: int, h: int, w: int,
    mesh_shape,
) -> Dict[str, Dict[str, int]]:
    """Joint 2-D comms schedule for ONE lean banded spatial level on a
    (n_bands, n_slabs) mesh: the per-axis collective counts and the
    slabs-axis payload bytes, composed from the two already-pinned 1-D
    models.  The two axes carry disjoint traffic:

    - **bands**: `sharded_a_allreduce_sites(per_em=True)` per EM
      iteration, with the polish schedule the spatial runner passes
      (`polish_iters=0` on non-final iterations under
      pm_polish_final_only): the reference's sites, as the planner
      prices them (the port's runner books executed calls,
      `sharded_a_step_allreduces`).
    - **slabs**: one re-slab between consecutive EM iterations
      (`em_iters - 1` per level), `spatial_reslab_collectives(3)`
      permute sites each (lean state: py, px, bp) moving
      `spatial_reslab_bytes` of boundary rows.

    With one band or one slab the corresponding axis entry is zero —
    the single-axis models apply directly (this function is the 2-D
    composition, not a replacement)."""
    n_bands, n_slabs = mesh_shape
    from .spatial import slab_halo

    halo = slab_halo(cfg)
    bands_sites = 0
    if n_bands > 1:
        for em in range(cfg.em_iters):
            final = em == cfg.em_iters - 1
            override = (
                None if (final or not cfg.pm_polish_final_only) else 0
            )
            bands_sites += sharded_a_allreduce_sites(
                cfg, ha, wa, per_em=True, polish_iters=override
            )
    # The re-slab runs whenever the mesh is 2-D, one band or several.
    n_reslabs = max(cfg.em_iters - 1, 0)
    permutes = n_reslabs * spatial_reslab_collectives(3)
    return {
        "bands": {"all_reduce_sites": bands_sites},
        "slabs": {
            "reslabs": n_reslabs,
            "collective_permutes": permutes,
            "reslab_bytes": n_reslabs * spatial_reslab_bytes(w, halo, 3),
        },
    }


def sharded_a_band_merge_bytes(
    cfg: SynthConfig, h: int, w: int
) -> Dict[str, int]:
    """Per-device payload of ONE `_band_merge` (4 all-reduces over the
    state planes), as the reference prices it: its halo-blocked planes
    are (n_ty * thp, n_tx * 128), thp the tile's rows with their halo
    rounded up to 8; one f32/int32 plane each for the MIN-d,
    MIN-winner, SUM-oy, SUM-ox legs.  (The port's compact planes are
    (n_ty * 64, n_tx * tile_w); the planner keeps the reference's
    price so both plan alike.)"""
    from ..kernels.patchmatch_tile import (
        TILE_H,
        channel_specs,
        tile_geometry,
    )

    specs = channel_specs(1, 1, cfg, False)
    geom = tile_geometry(h, w, specs)
    thp = -(-(TILE_H + 2 * geom.halo) // 8) * 8
    elems = geom.n_ty * thp * geom.n_tx * 128
    return {
        "elems_per_plane": elems,
        "bytes_per_merge": 4 * elems * 4,
    }


def sharded_a_step_allreduces(cfg: SynthConfig, ha: int, wa: int,
                              polish_iters=None) -> int:
    """All-reduces one band-sharded EM step executes with this polish
    override (None: `cfg.pm_polish_iters`; 0 on the non-final steps
    under pm_polish_final_only): 4 a kernel sweep, 2 for the entry and
    the exact-metric merge, the polish's distance evaluations, and the
    kappa pass's 8 when the polish runs.  The port's 2-D runner books
    this per EM step; summed over a level with the final-only rule it
    is `sharded_a_allreduce_count`."""
    from ..models.patchmatch import _pm_iters_for, _polish_schedule_for

    iters, n_random = _polish_schedule_for(cfg, ha, wa, polish_iters)
    polish = 1 + iters * (8 + n_random) if iters else 0
    total = 4 * _pm_iters_for(cfg, ha, wa) + 2 + polish
    if cfg.kappa > 0.0 and polish > 0:
        total += 2 * 4
    return total
