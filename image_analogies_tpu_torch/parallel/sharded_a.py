"""Band-sharded A: style pairs past one device's lean A table.

The port's runner of the reference's `parallel/sharded_a.py`, SPMD on
`torch.distributed`: every rank of a one-axis ("bands") mesh runs this
function on the same inputs.  A's rows split into as many ownership
bands as ranks, and on a lean level each rank holds only

  - its band's slice of the (N_A, D) bf16 feature table, assembled from
    a halo'd row slab of the A pyramids (`_band_assembly_aligned`,
    `_band_assemble`; global assembly and a slice where the coarse rows
    would not land on band boundaries), and
  - its band's K1 planes (`prepare_a_planes(n_bands=, band=)`, built
    from the band's own rows: TILE_H - 1 rows past them and the halo),
    swept with its band's bounds,

so the A-side residency per rank is 1/n of the single-device lean
path's.  An EM step is the single-device lean step (`models/analogy.py`
`lean_em_step`) with three hooks:

  - after every kernel sweep the fields merge across the bands
    (`_band_merge`: MIN of the distance, MIN of the band index among
    ties so ties go to the lower band, then SUM of the offsets masked
    to the winner: 4 all-reduces);
  - every feature-metric distance is a masked local gather, +inf for
    rows a band does not own, merged by MIN (`_sharded_dist`: 1
    all-reduce); each flat A index has one owner, so the merged value
    is the single-table value bit for bit;
  - the bands' bounds.

The bands axis uses `all_reduce` only, never `all_gather` or point to
point, so it also runs on gloo over CUDA tensors.  Every rank carries
the same field after each merge, and returns the same B'.

Equivalence, as in the reference: at kappa = 0 the sharded lean levels
are bit-identical to the single-device lean path (strict-improvement
accepts make the MIN merge order-equivalent to the single band's slot
order; exact float ties aside); at kappa > 0 the merge of raw distances
weakens the cross-band coherence bias slightly.  On CUDA tensors the
single-device sequential polish runs kernel K4 on the default distance,
while these levels keep the eager cascade on their own, so there the
bit-identical twin is the single-device run with the "stream" polish
(K3's rows through the same eager cascade).  Levels the planner
keeps standard run the single-device level body on every rank, the A
side replicated (their tables are 4^-l of the finest's).
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import SynthConfig
from ..models.analogy import (
    _finalize,
    _frame,
    _level_state_glue,
    _save_level,
    assemble_features_lean,
    lean_em_step,
    level_energy,
    plan_frames,
    prologue,
    record_level_span,
    record_prologue,
    resolve_device,
    resume_prologue,
    run_level,
    shard_sync_walls,
)
from ..models.matcher import candidate_dist_lean
from ..models.patchmatch import RawPlanes, SweepDraws, init_generator
from ..runtime.faults import fire as _fault_fire
from ..telemetry.metrics import (
    count_collectives,
    count_expected_collectives,
    get_registry,
)
from ..telemetry.spans import as_tracer, scope
from .mesh import (
    BANDS_AXIS,
    axis_group,
    axis_rank,
    axis_size,
    in_mesh,
    make_mesh,
)

_AXIS = BANDS_AXIS
log = logging.getLogger("image_analogies_tpu_torch")


def _band_merge(oy, ox, d, *, group, band: int):
    """Cross-band argmin of the sweep state, ties to the lower band:
    the parallel form of the bands swept in turn with carried state.
    4 all-reduces (MIN, MIN, SUM, SUM)."""
    count_collectives(4, _AXIS)
    d_min = d.clone()
    dist.all_reduce(d_min, op=dist.ReduceOp.MIN, group=group)
    big = torch.iinfo(torch.int32).max
    mine = torch.where(d == d_min, torch.full_like(oy, band),
                       torch.full_like(oy, big))
    winner = mine.clone()
    dist.all_reduce(winner, op=dist.ReduceOp.MIN, group=group)
    sel = mine == winner
    oy_m = torch.where(sel, oy, torch.zeros_like(oy))
    ox_m = torch.where(sel, ox, torch.zeros_like(ox))
    dist.all_reduce(oy_m, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(ox_m, op=dist.ReduceOp.SUM, group=group)
    return oy_m, ox_m, d_min


def _sharded_dist(f_b_tab, f_a_shard, row_lo_flat: int, group, idx):
    """Candidate distances from this rank's slice of the A table, +inf
    where another band owns the row, merged by MIN across the bands: the
    single-table `candidate_dist_lean` value, bit for bit.  The local
    index is clamped into the slice (torch raises where JAX clamps; the
    clamped rows are masked out)."""
    count_collectives(1, _AXIS)
    n_loc = f_a_shard.shape[0]
    get_registry().counter(
        "ia_sharded_gather_bytes_total",
        "bytes gathered per rank by sharded-A candidate evaluations",
    ).inc(float(idx.numel()) * f_a_shard.shape[1]
          * f_a_shard.element_size())
    loc = (idx - row_lo_flat).clamp(0, n_loc - 1)
    d_loc = candidate_dist_lean(f_b_tab, f_a_shard, loc)
    owned = (idx >= row_lo_flat) & (idx < row_lo_flat + n_loc)
    d = torch.where(owned, d_loc, torch.full_like(d_loc, float("inf")))
    dist.all_reduce(d, op=dist.ReduceOp.MIN, group=group)
    return d


def band_hooks(f_a_shard, band_bounds_own, row_lo_flat: int, group,
               band: int) -> dict:
    """The three band hooks of `lean_em_step` for this rank's band."""
    return dict(
        dist_fn=lambda f_b_tab: functools.partial(
            _sharded_dist, f_b_tab, f_a_shard, row_lo_flat, group),
        bounds=(band_bounds_own,),
        sweep_merge=functools.partial(_band_merge, group=group, band=band),
    )


def _band_assembly_aligned(ha: int, hc, n_dev: int,
                           has_coarse: bool) -> bool:
    """Whether the band-sharded assembly's slab geometry is exact: A's
    rows split evenly and, with a coarse level, every band's rows are
    even and the coarse rows (exactly half) split on the same band
    boundaries.  Otherwise the table is assembled whole and sliced."""
    if ha % n_dev:
        return False
    if not has_coarse:
        return True
    rows_pb = ha // n_dev
    return (rows_pb % 2 == 0 and hc is not None and hc * 2 == ha
            and hc % n_dev == 0)


def _band_assemble(cfg: SynthConfig, src_a, flt_a, src_c, flt_c,
                   n_dev: int, band: int):
    """This band's (rows / n * wa, D) slice of the lean A table,
    assembled from its halo'd row slab of the A pyramids (and the coarse
    pair's at half the rows and halo), core rows kept: equal to slicing
    the whole table, while no rank holds the whole table or its
    assembly temporaries."""
    from .spatial import _slab_of, slab_halo

    halo = slab_halo(cfg)
    has_coarse = src_c is not None
    s_src = _slab_of(src_a, n_dev, halo, band)
    s_flt = _slab_of(flt_a, n_dev, halo, band)
    s_src_c = _slab_of(src_c, n_dev, halo // 2, band) if has_coarse \
        else None
    s_flt_c = _slab_of(flt_c, n_dev, halo // 2, band) if has_coarse \
        else None
    rows_pb = s_src.shape[0] - 2 * halo
    wa = s_src.shape[1]
    tab = assemble_features_lean(s_src, s_flt, cfg, s_src_c, s_flt_c)
    return tab[halo * wa : (halo + rows_pb) * wa].clone()


def band_table(cfg: SynthConfig, src_a, flt_a, src_c, flt_c, n_dev: int,
               band: int):
    """This band's slice of the lean A table (A's rows split evenly over
    `n_dev` bands), by the band-sharded assembly where its geometry is
    exact, else assembled whole and sliced."""
    ha, wa = src_a.shape[:2]
    hc = src_c.shape[0] if src_c is not None else None
    if _band_assembly_aligned(ha, hc, n_dev, src_c is not None):
        return _band_assemble(cfg, src_a, flt_a, src_c, flt_c, n_dev, band)
    rows = ha // n_dev
    tab = assemble_features_lean(src_a, flt_a, cfg, src_c, flt_c)
    return tab[band * rows * wa : (band + 1) * rows * wa].clone()


def _sharded_level(cfg: SynthConfig, level: int, levels: int, pyr,
                   prev_nnf, prev_bp, plan, mesh, tracer, level_t0):
    """One lean level with A band-sharded: returns (nnf, dist, bp) with
    the frame axis, nnf a (py, px) pair, and the assembly's shard walls
    (None when the tracer is off)."""
    from ..kernels.patchmatch_tile import prepare_a_planes

    pyr_src_a, pyr_flt_a, pyr_src_b, pyr_copy_a, pyr_raw_b, _ = pyr
    n_dev, band = axis_size(mesh, _AXIS), axis_rank(mesh, _AXIS)
    group = axis_group(mesh, _AXIS)
    has_coarse = level < levels - 1
    src_a_l, flt_a_l = pyr_src_a[level], pyr_flt_a[level]
    src_a_c = pyr_src_a[level + 1] if has_coarse else None
    flt_a_c = pyr_flt_a[level + 1] if has_coarse else None
    h, w = pyr_src_b[level].shape[1:3]
    ha, wa = src_a_l.shape[:2]
    if ha % n_dev:
        raise ValueError(f"sharded-A level {level}: A rows ({ha}) must "
                         f"split evenly over {n_dev} devices")
    rows_pb = ha // n_dev
    row0 = band * rows_pb
    f_a = band_table(cfg, src_a_l, flt_a_l, src_a_c, flt_a_c, n_dev, band)
    walls = None
    if tracer.enabled:
        # The bands synchronise at every merge, so a slow band shows in
        # its own assembly: the walls are taken right after it.
        walls = shard_sync_walls(level_t0, f_a.device, group)
    specs, use_coarse = plan.tile
    a_band = prepare_a_planes(src_a_l, flt_a_l,
                              src_a_c if use_coarse else None,
                              flt_a_c if use_coarse else None, specs,
                              n_bands=n_dev, band=band)
    dev = src_a_l.device
    nnf, flt_bp, flt_bp_c = _level_state_glue(
        True, plan.prev_kind, _frame(prev_nnf, 0), _frame(prev_bp, 0),
        pyr_raw_b[level][0], h, w, ha, wa,
        init_generator(cfg.seed, level, dev))
    nnf = (nnf[0][None], nnf[1][None])
    flt_bp, flt_bp_c = flt_bp[None], flt_bp_c[None]
    src_b = pyr_src_b[level]
    src_b_c = pyr_src_b[level + 1] if has_coarse else src_b
    hooks = band_hooks(f_a, (row0, rows_pb), row0 * wa, group, band)
    from .comms import sharded_a_allreduce_count

    count_expected_collectives(sharded_a_allreduce_count(cfg, ha, wa), _AXIS)
    dist_l = bp = None
    for em in range(cfg.em_iters):
        polish = (None if em == cfg.em_iters - 1
                  or not cfg.pm_polish_final_only else 0)
        raw = RawPlanes(src_b, flt_bp, src_b_c if has_coarse else None,
                        flt_bp_c if has_coarse else None, (a_band,),
                        plan.tile)
        with scope(f"tlm_em{em}", "em_iter", em=em):
            nnf, dist_l, bp = lean_em_step(
                cfg, level, has_coarse, polish, src_b, flt_bp, src_b_c,
                flt_bp_c if has_coarse else flt_bp, f_a, pyr_copy_a[level],
                nnf, [SweepDraws(cfg.seed, level, em)], raw, **hooks)
        flt_bp = bp
    return nnf, dist_l, bp, walls


def synthesize_sharded_a(
    a,
    ap,
    b,
    cfg: Optional[SynthConfig] = None,
    mesh=None,
    progress=None,
    resume_from: Optional[str] = None,
    resume_strict: bool = False,
):
    """B' for `b` against a style pair whose lean A tables and K1 planes
    are band-sharded over the ranks of `mesh` (one "bands" axis;
    default: every rank of the world, or a world of one).  Called by
    every rank of the mesh with the same inputs; returns the same B' on
    every rank (None on a rank outside the mesh).

    Bit-identical to the single-device lean path at kappa = 0 (module
    docstring).  A sharded level's A rows must split evenly over the
    ranks.  A run where no level went lean warns (nothing was sharded:
    lower `feature_bytes_budget`).  `progress` (every rank's, or none:
    the shard walls are a collective) gets the prologue, the run plan
    and one level span a level with the bands' assembly walls.
    `cfg.save_level_artifacts` is written by rank 0 in the reference's
    schema; `resume_from` is read by every rank."""
    cfg = cfg or SynthConfig()
    tracer = as_tracer(progress)
    dev = resolve_device(cfg)
    mesh = mesh or make_mesh(axis_names=(_AXIS,), device_type=dev.type)
    if tuple(mesh.mesh_dim_names) != (_AXIS,):
        raise ValueError(f"sharded-A mesh must have a single '{_AXIS}' "
                         f"axis, got {tuple(mesh.mesh_dim_names)}")
    if not in_mesh(mesh):
        return None
    n_dev = axis_size(mesh, _AXIS)
    rank0 = axis_rank(mesh, _AXIS) == 0

    def as_t(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    a, ap, b = as_t(a), as_t(ap), as_t(b)
    if a.shape != ap.shape:
        raise ValueError(f"A {tuple(a.shape)} and A' {tuple(ap.shape)} "
                         "must match")
    levels = cfg.clamp_levels(tuple(a.shape[:2]), tuple(b.shape[:2]))
    _fault_fire("xfer", 0)
    prologue_t0 = time.perf_counter()
    pyr = prologue(a, ap, b[None], cfg, levels)
    record_prologue(tracer, pyr[4], levels, prologue_t0, cfg=cfg,
                    a_hw=tuple(a.shape[:2]), runner="sharded_a")
    yiq_b = None if pyr[5] is None else pyr[5][0]

    nnf = bp = None
    n_sharded = 0
    start = levels - 1
    resumed = resume_prologue(resume_from, levels, cfg, b.shape,
                              strict=resume_strict, progress=tracer)
    if resumed is not None:
        start, nnf, bp, _ = resumed
        nnf = torch.as_tensor(nnf, device=dev).long()[None]
        bp = torch.as_tensor(np.asarray(bp, np.float32), device=dev)[None]
        # The earlier run warned if it sharded nothing.
        n_sharded = levels - 1 - start
        if start < 0:
            return _finalize(bp[0], yiq_b, b, cfg)
    tracer.bind_device(dev)
    for level in range(start, -1, -1):
        _fault_fire("level", level)
        with tracer.span("level", level=level) as lvl_span:
            level_t0 = time.perf_counter()
            plan = plan_frames(cfg, level, levels, pyr, nnf,
                               brute_lean=False)
            _fault_fire("kernel", level)
            walls = None
            if plan.lean:
                nnf, dist_l, bp, walls = _sharded_level(
                    cfg, level, levels, pyr, nnf, bp, plan, mesh, tracer,
                    level_t0)
                n_sharded += 1
            else:
                nnf, dist_l, bp = run_level(cfg, level, levels, pyr, nnf,
                                            bp, plan)
            if tracer.enabled:
                h, w = pyr[2][level].shape[1:3]
                record_level_span(
                    tracer, cfg, lvl_span, level, h, w,
                    level_energy(dist_l), shard_walls=walls,
                    shard_axis=_AXIS,
                    **({"shard_phase": "assemble"} if walls else {}))
        if cfg.save_level_artifacts and rank0:
            _save_level(cfg.save_level_artifacts, level, _frame(nnf, 0),
                        dist_l[0], bp[0], cfg, b.shape)
    if not n_sharded:
        log.warning(
            "sharded-A run never engaged the sharded step: every level "
            "fit under feature_bytes_budget (%d bytes) or was not "
            "kernel-eligible, so the A side was REPLICATED on all %d "
            "ranks; the synthesis is correct but nothing was sharded.  "
            "Lower cfg.feature_bytes_budget (--feature-bytes-budget) to "
            "engage A-side sharding.", cfg.feature_bytes_budget, n_dev,
        )
    return _finalize(bp[0], yiq_b, b, cfg)
