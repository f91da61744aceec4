"""Spatial parallelism: one large B' split into row slabs over the ranks.

The port's runner of the reference's `parallel/spatial.py`, SPMD on
`torch.distributed`: every rank of the mesh runs `synthesize_spatial`
on the same inputs and synthesizes one row slab of B'.  Feature windows
read past a slab's rows, so each slab carries `slab_halo(cfg)` rows of
context on each side.  Per level:

  - every rank builds the A side (replicated; see the 2-D mesh below)
    and the level's incoming global state, and takes its slab;
  - an EM step runs the single-device level body (`make_em_step`, or
    `lean_em_step` on a lean level) on the slab, with the slab's own
    random streams (the reference's per-slab keys: slab s draws as frame
    s of a batch; a single slab draws as the single image);
  - between EM steps the re-slab trades `halo` boundary rows with the
    two neighbour ranks only, point to point (`batch_isend_irecv` on the
    slabs group; edge slabs re-clamp their outer halo), never an
    all-gather of the global arrays;
  - after the level the slab cores are gathered once, into the global
    state the next level upsamples.

Exactness: with the halo covering the windows' reach, per-pixel
matchers see the whole image's features in slab cores, so the brute
matcher's spatial B' equals the single-device B' bit for bit.
PatchMatch propagation is slab-local within an EM step, as in the
reference.  One slab has no halo: it is the single image, and gives the
single-device B'.

2-D ("bands", "slabs") meshes: B' rows split over the slabs axis, and
on lean levels the A side additionally splits into ownership bands over
the bands axis (parallel/sharded_a.py's data path: band-sharded table
assembly, band planes, the three band hooks), so a rank holds its
slab's share of B and its band's share of A.  Every band row of ranks
runs the same slabs; the re-slab runs on each row's slabs group, the
band merges on each column's bands group.  Non-banded levels run
replicated over the band rows.  With one band the 2-D path is the 1-D
path; with several it keeps bit-identity at kappa = 0 (sharded_a.py).

B's height is padded with edge rows to n_slabs * 2^levels so every
level splits into equal, even slab cores, and cropped from the result;
checkpoints carry the padded shape (rank 0 writes, every rank reads).
The runner needs slab cores of at least `halo` rows at every level.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import SynthConfig
from ..kernels.patchmatch_tile import prepare_a_planes
from ..models.analogy import (
    _finalize,
    _level_state_glue,
    _save_level,
    assemble_features_lean,
    lean_em_step,
    level_energy,
    make_em_step,
    plan_level,
    prologue,
    record_level_span,
    record_prologue,
    resolve_device,
    resume_prologue,
    shard_sync_walls,
)
from ..models.patchmatch import RawPlanes, SweepDraws, init_generator
from ..ops.features import assemble_features
from ..ops.pca import fit_and_project
from ..runtime.faults import fire as _fault_fire
from ..telemetry.metrics import count_collectives, count_expected_collectives
from ..telemetry.spans import as_tracer
from .comms import sharded_a_step_allreduces, spatial_reslab_collectives
from .mesh import axis_group, axis_rank, axis_size, in_mesh, make_mesh
from .sharded_a import band_hooks, band_table

BANDS_AXIS = "bands"
SLABS_AXIS = "slabs"


def slab_halo(cfg: SynthConfig) -> int:
    """Rows of context on each side of a slab: the larger of the fine
    window's reach (patch_size // 2 rows) and the coarse window's
    (coarse_patch_size // 2 coarse rows, twice that in fine rows),
    rounded up to even so coarse slabs split at exactly half resolution
    (their halo is halo // 2)."""
    reach = max(cfg.patch_size // 2, 2 * (cfg.coarse_patch_size // 2))
    return reach + (reach % 2)


def _split_slabs(x: torch.Tensor, n_slabs: int, halo: int) -> torch.Tensor:
    """(H, ...) -> (n_slabs, H // n_slabs + 2 * halo, ...), edge-clamped."""
    h = x.shape[0]
    hs = h // n_slabs
    rows = torch.arange(-halo, h + halo, device=x.device).clamp(0, h - 1)
    xp = x.index_select(0, rows)
    return torch.stack(
        [xp[i * hs : i * hs + hs + 2 * halo] for i in range(n_slabs)]
    )


def _merge_cores(slabs: torch.Tensor, halo: int) -> torch.Tensor:
    """Inverse of `_split_slabs`: drop the halos, concatenate the cores."""
    core = slabs[:, halo : slabs.shape[1] - halo]
    return core.reshape(-1, *core.shape[2:])


def _slab_of(x: torch.Tensor, n_slabs: int, halo: int, slab: int):
    """Slab `slab` of `_split_slabs(x, n_slabs, halo)`, built alone."""
    h = x.shape[0]
    hs = h // n_slabs
    rows = torch.arange(slab * hs - halo, (slab + 1) * hs + halo,
                        device=x.device).clamp(0, h - 1)
    return x.index_select(0, rows)


def _reslab(arrays, halo: int, slab: int, n_slabs: int, group, axis: str):
    """Fresh halos for slab-shaped `arrays` (core + 2 * halo rows): each
    core's first and last `halo` rows go to the previous and the next
    slab's rank, point to point, and come back as their halos; the
    edge slabs repeat their core's first / last row.  Equal to
    `_split_slabs(_merge_cores(...))` of the gathered arrays.  Two
    exchanges an array (one a direction), counted on `axis`."""
    outs = []
    peer = {d: dist.get_global_rank(group, slab + d)
            for d in (-1, 1) if 0 <= slab + d < n_slabs}
    for x in arrays:
        core = x[halo : x.shape[0] - halo]
        if core.shape[0] < halo:
            raise ValueError(f"slab core of {core.shape[0]} rows under the "
                             f"{halo}-row halo: use fewer slabs")
        count_collectives(2, axis, kind="p2p")
        top = core[:1].expand(halo, *core.shape[1:]).clone()
        bot = core[-1:].expand(halo, *core.shape[1:]).clone()
        ops = []
        if -1 in peer:
            top = torch.empty_like(top)
            ops += [dist.P2POp(dist.isend, core[:halo].contiguous(),
                               peer[-1], group),
                    dist.P2POp(dist.irecv, top, peer[-1], group)]
        if 1 in peer:
            bot = torch.empty_like(bot)
            ops += [dist.P2POp(dist.isend, core[-halo:].contiguous(),
                               peer[1], group),
                    dist.P2POp(dist.irecv, bot, peer[1], group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        outs.append(torch.cat([top, core, bot]))
    return outs


def _gather_cores(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """The global array from every slab's core, in slab order: the
    once-a-level gather."""
    core = x[halo : x.shape[0] - halo].contiguous()
    parts = [torch.empty_like(core)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, core, group=group)
    return torch.cat(parts)


def synthesize_spatial(
    a,
    ap,
    b,
    cfg: Optional[SynthConfig] = None,
    mesh=None,
    progress=None,
    resume_from: Optional[str] = None,
    resume_strict: bool = False,
    mesh_plan: Optional[dict] = None,
):
    """B' for one (large) `b`, its rows split over the ranks of `mesh`
    (1-D, any axis name, default every rank of the world or a world of
    one; or 2-D ("bands", "slabs")).  Called by every rank with the same
    inputs; returns the whole B' on every rank (None outside the mesh).

    `resume_from`: a per-level checkpoint directory of an earlier run
    (`cfg.save_level_artifacts`, written by rank 0); its fingerprint
    covers the padded B shape, so it resumes onto a mesh with the same
    padding grain.  `mesh_plan`: the parallel/plan2d.py verdict
    (`MeshPlan.as_attrs()`), recorded on the run plan.  `progress`:
    every rank's tracer or none (the shard walls are a collective)."""
    tracer = as_tracer(progress)
    cfg = cfg or SynthConfig()
    dev = resolve_device(cfg)
    mesh = mesh or make_mesh(device_type=dev.type)
    names = tuple(mesh.mesh_dim_names)
    if BANDS_AXIS in names:
        if names != (BANDS_AXIS, SLABS_AXIS):
            raise ValueError(
                "2-D spatial mesh must have axis names "
                f"('{BANDS_AXIS}', '{SLABS_AXIS}'), got {names}")
        n_bands = axis_size(mesh, BANDS_AXIS)
        slab_axis = SLABS_AXIS
    elif len(names) == 1:
        n_bands = 1
        slab_axis = names[0]
    else:
        raise ValueError(f"spatial mesh axes {names}: one axis, or "
                         f"('{BANDS_AXIS}', '{SLABS_AXIS}')")
    if not in_mesh(mesh):
        return None
    n_slabs = axis_size(mesh, slab_axis)
    slab = axis_rank(mesh, slab_axis)
    slab_group = axis_group(mesh, slab_axis)
    band = axis_rank(mesh, BANDS_AXIS) if n_bands > 1 else 0
    band_group = axis_group(mesh, BANDS_AXIS) if n_bands > 1 else None
    rank0 = slab == 0 and band == 0
    # One slab needs no context rows: it is the whole image.
    halo = slab_halo(cfg) if n_slabs > 1 else 0
    frame = slab if n_slabs > 1 else None

    def as_t(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    a, ap, b = as_t(a), as_t(ap), as_t(b)
    h0 = b.shape[0]
    levels = cfg.clamp_levels(tuple(a.shape[:2]), tuple(b.shape[:2]))
    grain = n_slabs * (2 ** (levels - 1)) * 2
    pad_h = (-h0) % grain if n_slabs > 1 else 0
    if pad_h:
        rows = torch.arange(h0 + pad_h, device=dev).clamp(max=h0 - 1)
        b = b.index_select(0, rows)

    _fault_fire("xfer", 0)
    prologue_t0 = time.perf_counter()
    pyr = prologue(a, ap, b[None], cfg, levels)
    pyr_src_a, pyr_flt_a, pyr_src_b, pyr_copy_a, pyr_raw_b, yiq = pyr
    record_prologue(
        tracer, pyr_raw_b, levels, prologue_t0, cfg=cfg,
        a_hw=tuple(a.shape[:2]),
        runner="spatial-banded" if n_bands > 1 else "spatial",
        mesh_plan=mesh_plan,
    )
    yiq_b = None if yiq is None else yiq[0]

    bp = nnf = None
    start = levels - 1
    resumed = resume_prologue(resume_from, levels, cfg, b.shape,
                              strict=resume_strict, progress=tracer)
    if resumed is not None:
        start, nnf, bp, _ = resumed
        nnf = torch.as_tensor(nnf, device=dev).long()
        bp = torch.as_tensor(np.asarray(bp, np.float32), device=dev)
        if start < 0:
            return _finalize(bp, yiq_b, b, cfg)[:h0]

    def slab_of(x, hal=None):
        return _slab_of(x, n_slabs, halo if hal is None else hal, slab)

    for level in range(start, -1, -1):
        _fault_fire("level", level)
        level_t0 = time.perf_counter()
        has_coarse = level < levels - 1
        src_a_l, flt_a_l = pyr_src_a[level], pyr_flt_a[level]
        src_a_c = pyr_src_a[level + 1] if has_coarse else None
        flt_a_c = pyr_flt_a[level + 1] if has_coarse else None
        h, w = pyr_src_b[level].shape[1:3]
        ha, wa = src_a_l.shape[:2]
        # The tile plan is made against the slab the step sees, the
        # byte estimate against the global tables.
        slab_shape = (h // n_slabs + 2 * halo, w)
        plan = plan_level(cfg, level, src_a_l, flt_a_l, has_coarse, h, w,
                          prev_nnf=nnf, eligible_shape=slab_shape,
                          brute_lean=False)
        _fault_fire("kernel", level)
        banded = plan.lean and n_bands > 1
        proj = a_planes = hooks = None
        band_walls = None
        if banded:
            # A rows pad with edge rows to the band grain (twice the
            # bands with a coarse level, so the coarse rows split on the
            # same boundaries); the bounds stay on the real rows, so no
            # origin in the pad is ever owned.
            a_grain = 2 * n_bands if has_coarse else n_bands
            a_pad = (-ha) % a_grain
            rows_pb = (ha + a_pad) // n_bands
            if (n_bands - 1) * rows_pb >= ha:
                raise ValueError(
                    f"2-D spatial level {level}: A rows ({ha}) leave band "
                    f"{n_bands - 1} of {n_bands} without a real row to "
                    "own; use fewer bands")

            def pad_rows(x, n):
                if not n:
                    return x
                idx = torch.arange(x.shape[0] + n, device=x.device)
                return x.index_select(0, idx.clamp(max=x.shape[0] - 1))

            ha_k = ha + a_pad
            src_k, flt_k = pad_rows(src_a_l, a_pad), pad_rows(flt_a_l, a_pad)
            src_ck = flt_ck = None
            if has_coarse:
                hc_pad = ha_k // 2 - src_a_c.shape[0]
                src_ck = pad_rows(src_a_c, hc_pad)
                flt_ck = pad_rows(flt_a_c, hc_pad)
            row0 = band * rows_pb
            f_a = band_table(cfg, src_k, flt_k, src_ck, flt_ck, n_bands,
                             band)
            if tracer.enabled:
                band_walls = shard_sync_walls(level_t0, dev, band_group)
            specs, use_coarse = plan.tile
            a_planes = (prepare_a_planes(
                src_k, flt_k, src_ck if use_coarse else None,
                flt_ck if use_coarse else None, specs,
                n_bands=n_bands, band=band),)
            hooks = band_hooks(f_a, (row0, min(rows_pb, ha - row0)),
                               row0 * wa, band_group, band)
        elif plan.lean:
            f_a = assemble_features_lean(src_a_l, flt_a_l, cfg, src_a_c,
                                         flt_a_c)
        else:
            f_a = assemble_features(src_a_l, flt_a_l, cfg, src_a_c, flt_a_c)
            f_a, proj = fit_and_project(f_a, cfg.pca_dims)
        if plan.tile is not None and not banded:
            specs, use_coarse = plan.tile
            a_planes = prepare_a_planes(
                src_a_l, flt_a_l, src_a_c if use_coarse else None,
                flt_a_c if use_coarse else None, specs)

        # The level's incoming global state, then this rank's slab.
        nnf, flt_bp, flt_bp_c = _level_state_glue(
            plan.lean, plan.prev_kind, nnf, bp, pyr_raw_b[level][0], h, w,
            ha, wa, init_generator(cfg.seed, level, dev))
        s_src_b = slab_of(pyr_src_b[level][0])[None]
        if has_coarse:
            s_src_b_c = slab_of(pyr_src_b[level + 1][0], halo // 2)[None]
            s_flt_c = slab_of(flt_bp_c, halo // 2)[None]
        else:
            s_src_b_c = s_src_b
        s_nnf = ((slab_of(nnf[0])[None], slab_of(nnf[1])[None])
                 if plan.lean else slab_of(nnf)[None])
        s_flt = slab_of(flt_bp)[None]
        copy_a = pyr_copy_a[level]
        dist_s = bp_s = None
        for em in range(cfg.em_iters):
            last = em == cfg.em_iters - 1
            polish = None if last or not cfg.pm_polish_final_only else 0
            draws = [SweepDraws(cfg.seed, level, em, frame)]
            flt_c = s_flt_c if has_coarse else s_flt
            if banded:
                count_expected_collectives(
                    sharded_a_step_allreduces(cfg, ha, wa, polish),
                    BANDS_AXIS)
                raw = RawPlanes(s_src_b, s_flt,
                                s_src_b_c if has_coarse else None,
                                s_flt_c if has_coarse else None, a_planes,
                                plan.tile)
                s_nnf, dist_s, bp_s = lean_em_step(
                    cfg, level, has_coarse, polish, s_src_b, s_flt,
                    s_src_b_c, flt_c, f_a, copy_a, s_nnf, draws, raw,
                    **hooks)
            else:
                step = make_em_step(cfg, level, has_coarse, plan.lean,
                                    polish_iters=polish)
                s_nnf, dist_s, bp_s = step(
                    s_src_b, s_flt, s_src_b_c, flt_c, f_a, copy_a, s_nnf,
                    draws, proj, a_planes, plan.tile)
            if not last:
                state = ([p[0] for p in s_nnf] if plan.lean
                         else [s_nnf[0]]) + [bp_s[0]]
                count_expected_collectives(
                    spatial_reslab_collectives(len(state)), slab_axis)
                state = _reslab(state, halo, slab, n_slabs, slab_group,
                                slab_axis)
                s_nnf = (tuple(x[None] for x in state[:-1]) if plan.lean
                         else state[0][None])
                s_flt = state[-1][None]
        shard_walls = None
        if tracer.enabled:
            shard_walls = shard_sync_walls(level_t0, dev, slab_group)
        if plan.lean:
            nnf = (_gather_cores(s_nnf[0][0], halo, slab_group),
                   _gather_cores(s_nnf[1][0], halo, slab_group))
        else:
            nnf = _gather_cores(s_nnf[0], halo, slab_group)
        dist_l = _gather_cores(dist_s[0], halo, slab_group)
        bp = _gather_cores(bp_s[0], halo, slab_group)
        if tracer.enabled:
            record_level_span(
                tracer, cfg, level_t0, level, h, w, level_energy(dist_l),
                spatial_slabs=n_slabs, shard_walls=shard_walls,
                shard_axis=slab_axis,
                extra_shard_walls=({BANDS_AXIS: band_walls}
                                   if band_walls else None),
            )
        if cfg.save_level_artifacts and rank0:
            _save_level(cfg.save_level_artifacts, level, nnf, dist_l, bp,
                        cfg, b.shape)
    return _finalize(bp, yiq_b, b, cfg)[:h0]
