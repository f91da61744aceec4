"""PatchMatch NN-field matcher (Barnes 2009) with the kappa rule
(Hertzmann §3.2).

Two paths, chosen by `SynthConfig.pallas_mode` and the level's shape:

  - the tile path (`tile_patchmatch`, levels with min side >= 128 under
    "auto"/"interpret"): bulk global search with kernel K1 (or its plain
    version) in the raw-plane metric, then a merge with the incoming
    field and a per-pixel polish under the feature metric on bf16 tables,
    the kappa coherence pass, and an exact float32 re-rank.  The polish
    engine is the module global `_POLISH_MODE` ("sequential", "stream"
    through kernel K3, or "jump"), and the compressed-candidate modes of
    kernels/patchmatch_tile.py apply to the sweeps and the polish rows.
    The staging itself is `tile_patchmatch_lean`, on (N, D) bf16 tables
    and a (py, px) plane-pair field: the lean levels (models/analogy.py)
    call it directly, `tile_patchmatch` on the standard levels' casts;
  - the per-pixel path (`patchmatch_sweeps`): 4 propagation candidates,
    4 unshifted neighbour matches and `n_random` random-search candidates
    per sweep, accepted with canonical lowest-index tie-breaking.

Randomness.  Functions that consume random numbers take them as
arguments (candidate draws, sweep offsets); `SweepDraws` makes them from
torch.Generators seeded by a documented scheme (see `seed_for`), on the
device of the run.  The streams are not JAX's: a test that compares the
two packages hands both the same draws.
"""

from __future__ import annotations

import os
from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SynthConfig
from .matcher import (
    Matcher,
    candidate_dist,
    candidate_dist_lean,
    nnf_dist,
    register_matcher,
)


class RawPlanes(NamedTuple):
    """Raw channel images backing the tile path's metric; `a_planes` is
    the level's `prepare_a_planes` tensor, built from `plan`, the level's
    tile plan (specs, use_coarse) from `plan_level`."""

    src_b: torch.Tensor
    flt_b: torch.Tensor
    src_b_coarse: Optional[torch.Tensor]
    flt_b_coarse: Optional[torch.Tensor]
    a_planes: torch.Tensor
    plan: tuple


# Propagation neighbourhood: left, right, up, down.
DELTAS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def seed_for(*path: int) -> int:
    """A 63-bit generator seed for a path of non-negative ints, mixed by
    numpy's SeedSequence (stable across versions and platforms)."""
    state = np.random.SeedSequence([int(p) for p in path]).generate_state(
        2, np.uint32
    )
    return int(state[0]) << 31 | int(state[1]) >> 1


def _frame_path(frame: Optional[int]) -> tuple:
    """The frame index's part of a `seed_for` path: nothing for a
    single image, (frame,) for a frame of a batch or a video."""
    return () if frame is None else (int(frame),)


class SweepDraws(NamedTuple):
    """The random-number source of one matcher call.

    Scheme: the generator for slot `slot` of EM step `em` at pyramid
    level `level` is seeded with seed_for(seed, level, 1 + em, slot),
    and for a frame of a batch or a video with the frame index appended,
    seed_for(seed, level, 1 + em, slot, frame): a frame's streams depend
    on (seed, level, em, slot, frame) alone, so batched outputs do not
    depend on the chunking.  Slots 0 .. pm_iters-1 feed the tile sweeps'
    candidate tables, slot pm_iters the polish's random offsets; the
    per-pixel path uses slot 0 for all of its sweeps (`offsets`).  The
    coarsest level's random field uses seed_for(seed, level, 0, 0[,
    frame]) (`init_generator`)."""

    seed: int
    level: int
    em: int
    frame: Optional[int] = None

    def gen(self, slot: int, device) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(seed_for(self.seed, self.level, 1 + self.em, slot,
                               *_frame_path(self.frame)))
        return g

    def offsets(self, iters: int, radii, h: int, w: int, device):
        """The per-pixel path's random-search offsets (`sweep_offsets`
        from slot 0)."""
        return sweep_offsets(self.gen(0, device), iters, radii, h, w)


def init_generator(seed: int, level: int, device,
                   frame: Optional[int] = None) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, level, 0, 0, *_frame_path(frame)))
    return g


def random_init_planes(gen: torch.Generator, h: int, w: int, ha: int,
                       wa: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform random (py, px) planes over A's domain, py drawn first:
    the lean path's field, equal to `random_init` unstacked."""
    py = torch.randint(0, ha, (h, w), generator=gen, device=gen.device)
    px = torch.randint(0, wa, (h, w), generator=gen, device=gen.device)
    return py, px


def random_init(gen: torch.Generator, h: int, w: int, ha: int,
                wa: int) -> torch.Tensor:
    """Uniform random NNF (H, W, 2) over A's domain."""
    return torch.stack(random_init_planes(gen, h, w, ha, wa), dim=-1)


def sweep_radii(ha: int, wa: int, n_random: int) -> list:
    """Exponential random-search radii: max dim, halving per scale,
    floored at 1 px."""
    m = max(ha, wa)
    return [max(1, int(m * (0.5**s))) for s in range(n_random)]


def sweep_offsets(gen: torch.Generator, iters: int, radii, h: int, w: int):
    """Lazily drawn random-search offsets, one (n_random, H, W, 2) int64
    tensor per sweep, offset s uniform in [-radii[s], radii[s]]."""
    for _ in range(iters):
        yield torch.stack([
            torch.randint(-r, r + 1, (h, w, 2), generator=gen,
                          device=gen.device)
            for r in radii
        ]) if radii else torch.zeros(0, h, w, 2, dtype=torch.long,
                                     device=gen.device)


def patchmatch_sweeps_lean(
    f_b_tab: torch.Tensor,
    f_a_tab: torch.Tensor,
    py: torch.Tensor,
    px: torch.Tensor,
    offsets: Iterable[torch.Tensor],
    *,
    ha: int,
    wa: int,
    coh_factor: float,
    dist_fn=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One propagate + random-search sweep per entry of `offsets` (each
    (n_random, H, W, 2), added to the current match) over (N, D) tables
    and a (py, px) plane-pair field; returns (py, px, dist).  Random
    candidates must satisfy d * coh_factor < d_cur; exact ties break
    toward the lower flat index, the representative the brute oracle's
    argmin picks.  Distances go through `dist_fn` (flat indices ->
    distances), by default `candidate_dist_lean` on the tables."""
    h, w = py.shape
    if dist_fn is None:
        def dist_fn(idx):
            return candidate_dist_lean(f_b_tab, f_a_tab, idx)

    py = py.long().clamp(0, ha - 1)
    px = px.long().clamp(0, wa - 1)
    dist = dist_fn((py * wa + px).reshape(-1)).reshape(h, w)

    def try_candidates(py, px, dist, cy, cx, factor):
        cy = cy.clamp(0, ha - 1)
        cx = cx.clamp(0, wa - 1)
        idx = cy * wa + cx
        d_cand = dist_fn(idx.reshape(-1)).reshape(h, w)
        accept = (d_cand * factor < dist) | (
            (d_cand == dist) & (idx < py * wa + px)
        )
        return (
            torch.where(accept, cy, py),
            torch.where(accept, cx, px),
            torch.where(accept, d_cand, dist),
        )

    for off in offsets:
        for dy, dx in DELTAS:
            py, px, dist = try_candidates(
                py, px, dist, torch.roll(py, (dy, dx), (0, 1)) + dy,
                torch.roll(px, (dy, dx), (0, 1)) + dx, 1.0,
            )
        for dy, dx in DELTAS:
            py, px, dist = try_candidates(
                py, px, dist, torch.roll(py, (dy, dx), (0, 1)),
                torch.roll(px, (dy, dx), (0, 1)), 1.0,
            )
        off = off.to(py.device)
        for s in range(off.shape[0]):
            py, px, dist = try_candidates(
                py, px, dist, py + off[s, ..., 0], px + off[s, ..., 1],
                coh_factor,
            )
    return py, px, dist


def temporal_penalty_fn(temporal: Optional[torch.Tensor], tau: float,
                        ha: int, wa: int):
    """The temporal-coherence penalty toward the previous frame's
    mapping (video): candidate (cy, cx) at pixel q pays
    tau * ((cy - ty)^2 + (cx - tx)^2) / (ha^2 + wa^2), where (ty, tx) is
    the previous frame's converged match at q, clamped to A; the squared
    A diagonal makes tau the price of a full-diagonal divergence.
    Returns a function of flat candidate indices (N,) -> penalties (N,)
    float32, or None when the term is off (tau == 0 or no field)."""
    if temporal is None or tau <= 0.0:
        return None
    ty = temporal[..., 0].clamp(0, ha - 1).reshape(-1).float()
    tx = temporal[..., 1].clamp(0, wa - 1).reshape(-1).float()
    scale = float(tau) / float(ha * ha + wa * wa)

    def penalty(idx: torch.Tensor) -> torch.Tensor:
        cy = (idx // wa).float()
        cx = (idx % wa).float()
        return scale * ((cy - ty) ** 2 + (cx - tx) ** 2)

    return penalty


def temporal_active(temporal, cfg: SynthConfig) -> bool:
    """Whether a matcher call carries the temporal term: a previous
    frame's field and tau > 0.  An active term runs the per-pixel sweeps
    (the tile path's candidate tables have no previous-frame field)."""
    return temporal is not None and cfg.tau > 0.0


def patchmatch_sweeps(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    nnf: torch.Tensor,
    offsets: Iterable[torch.Tensor],
    *,
    coh_factor: float,
    gather_fn=None,
    temporal: Optional[torch.Tensor] = None,
    tau: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`patchmatch_sweeps_lean` on the standard path's (H, W, D) feature
    fields and stacked (H, W, 2) field, with distances by
    `candidate_dist` (`gather_fn` swaps its row fetch: the stream and
    int8 polish engines); returns (nnf, dist).  With a previous frame's
    (H, W, 2) field `temporal` and tau > 0, every candidate's distance,
    the incumbent's included, carries `temporal_penalty_fn`'s term, so
    the accept tests and the returned distances are in that metric."""
    d = f_b.shape[-1]
    ha, wa = f_a.shape[:2]
    f_b_flat = f_b.reshape(-1, d)
    f_a_flat = f_a.reshape(-1, d)
    pen_fn = temporal_penalty_fn(temporal, tau, ha, wa)

    def dist_fn(idx):
        dist = candidate_dist(f_b_flat, f_a_flat, idx, gather_fn=gather_fn)
        return dist if pen_fn is None else dist + pen_fn(idx)

    py, px, dist = patchmatch_sweeps_lean(
        f_b_flat, f_a_flat, nnf[..., 0], nnf[..., 1], offsets, ha=ha,
        wa=wa, coh_factor=coh_factor, dist_fn=dist_fn,
    )
    return torch.stack([py, px], dim=-1), dist


def kappa_factor(kappa: float, level: int) -> float:
    """Hertzmann §3.2 acceptance factor, level 0 = finest."""
    return 1.0 + kappa * (2.0 ** (-level))


# Size-aware schedules, as the reference: levels whose A domain exceeds
# 4 Mpx run 2 extra kernel sweeps and cap the polish's random probes.
_PM_BOOST_AREA = 4 * 1024 * 1024
_PM_ITERS_BOOST = 2
_POLISH_RANDOM_LARGE = 2


def _pm_iters_for(cfg: SynthConfig, ha: int, wa: int) -> int:
    return cfg.pm_iters + (
        _PM_ITERS_BOOST if ha * wa > _PM_BOOST_AREA else 0
    )


def _polish_schedule_for(cfg: SynthConfig, ha: int, wa: int,
                         polish_iters=None) -> Tuple[int, int]:
    """(iters, n_random) of the per-pixel polish at this A domain."""
    iters = cfg.pm_polish_iters if polish_iters is None else polish_iters
    n_random = cfg.pm_polish_random
    if ha * wa > _PM_BOOST_AREA:
        n_random = min(n_random, _POLISH_RANDOM_LARGE)
    return iters, n_random


# Polish engine (a module global with the reference's env override and
# setter, not a config field): "sequential", the chained per-candidate
# cascade (`patchmatch_sweeps`); "stream", the same cascade with its row
# fetches through kernel K3, bit-identical to "sequential"; "jump", the
# batched jump-flooding polish (`polish_sweeps_planes`).
_POLISH_MODE = os.environ.get("IA_POLISH_MODE", "sequential")
_POLISH_MODES = ("sequential", "jump", "stream")


def set_polish_mode(mode: str) -> None:
    """Install a polish engine process-wide; validates before assigning.
    (The reference also drops its compiled level graphs here; the port
    compiles none.)"""
    global _POLISH_MODE
    if mode not in _POLISH_MODES:
        raise ValueError(f"polish mode {mode!r} names none of {_POLISH_MODES}")
    _POLISH_MODE = mode


# Pure-roll steps of the jump polish's canonical-tie flood per sweep.
_TIE_FLOOD_STEPS = 16

# Jump-flooding propagation distances, coarse to fine, per sweep.
_JUMP_STEPS = (8, 4, 2, 1)


def _stream_gather_fn(f_a_tab: torch.Tensor, plain: bool):
    """`gather_fn` of the streamed polish: kernel K3 over a LANE-padded
    copy of the table, built once per polish call.  `candidate_dist`
    slices the rows back to the feature width, dropping only zero pad."""
    from ..kernels.polish_stream import gather_rows, prepare_polish_table

    f_a_pad = prepare_polish_table(f_a_tab)
    return lambda _tab, ix: gather_rows(f_a_pad, ix, plain=plain)


def _polish_gather_fn(f_a_tab: torch.Tensor, plain: bool, cand_dtype: str,
                      polish_mode: str):
    """The polish's row fetch under (polish_mode, cand_dtype); None is the
    default `index_select` (bf16, sequential).  Under "int8" the rows come
    from the per-patch-quantized table (`quantize_rows`) and are
    dequantized q * scale next to the distance math; under "stream"
    through kernel K3, else by `index_select`, the scales by
    `index_select` beside them either way.  The jump engine keeps its
    exact tables and never calls this, as in the reference."""
    from ..kernels.polish_stream import (
        gather_rows,
        prepare_polish_table,
        quantize_rows,
    )

    stream = polish_mode == "stream"
    if cand_dtype != "int8":
        return _stream_gather_fn(f_a_tab, plain) if stream else None
    q_tab, scales = quantize_rows(f_a_tab)
    if stream:
        q_pad = prepare_polish_table(q_tab)

        def gf(_tab, ix):
            rows = gather_rows(q_pad, ix, plain=plain)
            return rows.float() * scales.index_select(0, ix.reshape(-1))

        return gf

    def gf(_tab, ix):
        flat = ix.reshape(-1)
        return q_tab.index_select(0, flat).float() \
            * scales.index_select(0, flat)

    return gf


def _prune_setup(prune, f_b_flat, f_a_flat, geom, h: int, w: int):
    """Per-call state of the coarse pre-prune, or None when it is off: a
    PCA basis fit on the A table (at the B width: wider A columns are
    zero pad), both sides projected to its k dims, and the projected B
    rows at each tile's sample pixels."""
    if prune is None:
        return None
    from ..kernels.patchmatch_tile import tile_sample_positions
    from ..ops.pca import pca_basis, project

    k_dims, m_keep = prune
    d = f_b_flat.shape[-1]
    f_a_flat = f_a_flat[:, :d].float()
    basis = pca_basis(f_a_flat, k_dims)
    proj_a = project(f_a_flat, basis)
    proj_b = project(f_b_flat.float(), basis)
    qy, qx = tile_sample_positions(geom, h, w, device=f_b_flat.device)
    proj_b_tiles = proj_b.index_select(0, (qy * w + qx).reshape(-1)).reshape(
        *qy.shape, proj_b.shape[-1]
    )
    return proj_b_tiles, qy, qx, proj_a, m_keep


def _lex_min(d: torch.Tensor, idx: torch.Tensor):
    """Lexicographic (distance, flat index) minimum over axis 0: the
    smallest distance, ties to the lowest index."""
    d_min = d.min(dim=0).values
    big = torch.full_like(idx, torch.iinfo(idx.dtype).max)
    return d_min, torch.where(d == d_min, idx, big).min(dim=0).values


def polish_sweeps_planes(
    py: torch.Tensor,
    px: torch.Tensor,
    dist: torch.Tensor,
    offsets: Iterable[torch.Tensor],
    *,
    ha: int,
    wa: int,
    coh_factor: float,
    dist_fn,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched jump-flooding polish over a (py, px) field with its
    distances in the accept metric; one sweep per entry of `offsets`
    (each (n_random, H, W, 2), the random probes' offsets).  Per sweep:
    jump-flooding propagation (4 directions x `_JUMP_STEPS` in one
    `dist_fn` call, best by (distance, index), accepted at factor 1);
    the random probes in one call, best-of-R, accepted under
    `coh_factor`; then a gather-free canonical-tie flood verified by one
    call.  `dist_fn` maps flat indices (..., N) to distances (..., N).
    Returns (py, px, dist)."""
    h, w = py.shape
    for off in offsets:
        i_cur = py * wa + px
        cys, cxs = [], []
        for s in _JUMP_STEPS:
            for dy, dx in DELTAS:
                cys.append(torch.roll(py, (s * dy, s * dx), (0, 1)) + s * dy)
                cxs.append(torch.roll(px, (s * dy, s * dx), (0, 1)) + s * dx)
        cy = torch.stack(cys).clamp(0, ha - 1)
        cx = torch.stack(cxs).clamp(0, wa - 1)
        idx = cy * wa + cx
        d_all = dist_fn(idx.reshape(len(cys), h * w)).reshape(idx.shape)
        d_coh, i_coh = _lex_min(d_all, idx)
        accept = (d_coh < dist) | ((d_coh == dist) & (i_coh < i_cur))
        d1 = torch.where(accept, d_coh, dist)
        i1 = torch.where(accept, i_coh, i_cur)
        py, px = i1 // wa, i1 % wa

        if off.shape[0]:
            off = off.to(py.device)
            cy = (py[None] + off[..., 0]).clamp(0, ha - 1)
            cx = (px[None] + off[..., 1]).clamp(0, wa - 1)
            idx = cy * wa + cx
            d_all = dist_fn(idx.reshape(off.shape[0], h * w)).reshape(
                idx.shape
            )
            d_rnd, i_rnd = _lex_min(d_all, idx)
            accept = (d_rnd * coh_factor < d1) | (
                (d_rnd == d1) & (i_rnd < i1)
            )
            d1 = torch.where(accept, d_rnd, d1)
            i1 = torch.where(accept, i_rnd, i1)

        i_prop = i1
        for _ in range(_TIE_FLOOD_STEPS):
            for dy, dx in DELTAS:
                n_i = torch.roll(i_prop, (dy, dx), (0, 1))
                n_d = torch.roll(d1, (dy, dx), (0, 1))
                take = (n_d == d1) & (n_i < i_prop)
                i_prop = torch.where(take, n_i, i_prop)
        d_prop = dist_fn(i_prop.reshape(-1)).reshape(h, w)
        accept = (d_prop < d1) | ((d_prop == d1) & (i_prop < i1))
        dist = torch.where(accept, d_prop, d1)
        i1 = torch.where(accept, i_prop, i1)
        py, px = i1 // wa, i1 % wa
    return py, px, dist


def polish_sweeps(
    f_b16: torch.Tensor,
    f_a16: torch.Tensor,
    nnf: torch.Tensor,
    dist: torch.Tensor,
    offsets: Iterable[torch.Tensor],
    *,
    coh_factor: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`polish_sweeps_planes` on the stacked (H, W, 2) field of the
    standard path; `dist` is the incoming field's distance in the same
    bf16 accept metric."""
    d = f_b16.shape[-1]
    ha, wa = f_a16.shape[:2]
    f_b_tab = f_b16.reshape(-1, d)
    f_a_tab = f_a16.reshape(-1, f_a16.shape[-1])
    py, px, dist = polish_sweeps_planes(
        nnf[..., 0], nnf[..., 1], dist, offsets, ha=ha, wa=wa,
        coh_factor=coh_factor,
        dist_fn=lambda idx: candidate_dist_lean(f_b_tab, f_a_tab, idx),
    )
    return torch.stack([py, px], dim=-1), dist


def tile_patchmatch(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    nnf: torch.Tensor,
    draws,
    *,
    raw: RawPlanes,
    cfg: SynthConfig,
    level: int,
    plain: bool,
    polish_iters: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile path of the standard levels: `tile_patchmatch_lean` on
    the bf16 casts of the (H, W, D) feature fields (the accept metric;
    the PCA prune is fit on the float32 fields), then, when the polish
    ran, the exact float32 distance of the result.  Returns (nnf, dist)
    on the stacked (H, W, 2) field.  With a leading frame axis (f_b
    (F, H, W, D), nnf (F, H, W, 2), `draws` one `SweepDraws` a frame and
    `raw`'s B images stacked) every sweep is one K1 launch for all F
    frames, and the result carries the axis."""
    if nnf.ndim == 3:
        nnf, dist = tile_patchmatch(
            f_b[None], f_a, nnf[None], [draws], raw=_frames_of(raw, None),
            cfg=cfg, level=level, plain=plain, polish_iters=polish_iters,
        )
        return nnf[0], dist[0]
    n_f, h, w, d = f_b.shape
    ha, wa = f_a.shape[:2]
    f_b_flat = f_b.reshape(n_f, h * w, d)
    f_a_flat = f_a.reshape(-1, f_a.shape[-1])
    py, px, dist = tile_patchmatch_lean(
        f_b_flat.to(torch.bfloat16), f_a_flat.to(torch.bfloat16),
        nnf[..., 0], nnf[..., 1], draws, raw=raw, cfg=cfg, level=level,
        plain=plain, ha=ha, wa=wa, polish_iters=polish_iters,
        prune_tabs=(f_b_flat, f_a_flat),
    )
    nnf = torch.stack([py, px], dim=-1)
    if _polish_schedule_for(cfg, ha, wa, polish_iters)[0] == 0:
        return nnf, dist
    return nnf, torch.stack([
        nnf_dist(f_b[i], f_a_flat, nnf[i], wa) for i in range(n_f)
    ])


def _frames_of(raw: RawPlanes, i: Optional[int]) -> RawPlanes:
    """`raw` with a frame axis added to its B images (i None), or frame i
    of a frame-stacked `raw`."""
    def sel(x):
        if x is None:
            return None
        return x[None] if i is None else x[i]

    return raw._replace(src_b=sel(raw.src_b), flt_b=sel(raw.flt_b),
                        src_b_coarse=sel(raw.src_b_coarse),
                        flt_b_coarse=sel(raw.flt_b_coarse))


def tile_patchmatch_lean(
    f_b_tab: torch.Tensor,
    f_a_tab: torch.Tensor,
    py: torch.Tensor,
    px: torch.Tensor,
    draws,
    *,
    raw: RawPlanes,
    cfg: SynthConfig,
    level: int,
    plain: bool,
    ha: int,
    wa: int,
    polish_iters: Optional[int] = None,
    prune_tabs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tile path on (N, D) bf16 tables and a (py, px) plane-pair
    field: `pm_iters` K1 sweeps in the raw-plane metric, a merge with the
    incoming field under the feature metric, the polish under
    `_POLISH_MODE`, and the kappa pass, every feature-metric distance
    through `candidate_dist_lean` (chunked, f32 math).  The lean levels
    (models/analogy.py `plan_level`) pass `assemble_features_lean`'s
    tables; `tile_patchmatch` passes the standard levels' fields cast to
    bf16, and the float32 fields as `prune_tabs` (the PCA prune's fit;
    default: the bf16 tables).  The compressed-candidate modes (A-plane
    dtype, PCA prune, restart mode) and the polish engine are resolved
    once per call.  `plain` runs the kernels' plain versions on either
    device (pallas_mode="interpret").  The returned distances are in the
    bf16-table metric.  One A band (`n_bands == 1`).  Returns
    (py, px, dist).

    Frames.  With a leading frame axis F on `f_b_tab` (F, N, D), on
    `py` / `px` (F, H, W), on `raw`'s B images and on the B side of
    `prune_tabs`, and `draws` a sequence of F `SweepDraws`, each frame
    is staged with its own draws and every sweep is one K1 launch over
    all F frames (A is shared); the merge, the polish and the kappa pass
    run frame by frame.  The result carries the axis.  Frame i's result
    is the single-frame call's on frame i's inputs."""
    from ..kernels import patchmatch_tile as pt

    if py.ndim == 2:
        py, px, dist = tile_patchmatch_lean(
            f_b_tab[None], f_a_tab, py[None], px[None], [draws],
            raw=_frames_of(raw, None), cfg=cfg, level=level, plain=plain,
            ha=ha, wa=wa, polish_iters=polish_iters,
            prune_tabs=None if prune_tabs is None
            else (prune_tabs[0][None], prune_tabs[1]),
        )
        return py[0], px[0], dist[0]

    n_f, h, w = py.shape
    if len(draws) != n_f:
        raise ValueError(f"{len(draws)} draws for {n_f} frames")
    dev = py.device
    specs, use_coarse = raw.plan
    geom = pt.tile_geometry(h, w, specs)
    coh = kappa_factor(cfg.kappa, level)
    pm_iters = _pm_iters_for(cfg, ha, wa)
    polish_iters, polish_random = _polish_schedule_for(
        cfg, ha, wa, polish_iters
    )
    cand_dtype, polish_mode = pt.resolve_cand_dtype(), _POLISH_MODE
    coarse_restarts = pt._RESTART_MODE == "coarse"
    prune = pt.resolve_prune()
    b_prune, a_prune = prune_tabs or (f_b_tab, f_a_tab)
    prune_states = [
        _prune_setup(prune, b_prune[i], a_prune, geom, h, w)
        for i in range(n_f)
    ]

    def dist_fn(i):
        return lambda idx: candidate_dist_lean(f_b_tab[i], f_a_tab, idx)

    py = py.long().clamp(0, ha - 1)
    px = px.long().clamp(0, wa - 1)
    dist0 = torch.stack([
        dist_fn(i)((py[i] * wa + px[i]).reshape(-1)).reshape(h, w)
        for i in range(n_f)
    ])

    # K1 sweeps (candidate slots 0 .. pm_iters-1 of each frame's draws)
    # in the raw-plane metric, on compact offsets from the incoming
    # field; one launch a sweep for all frames.
    def coarse(x, i):
        return x[i] if use_coarse else None

    b_planes = torch.stack([
        pt.prepare_b_planes(raw.src_b[i], raw.flt_b[i],
                            coarse(raw.src_b_coarse, i),
                            coarse(raw.flt_b_coarse, i), geom)
        for i in range(n_f)
    ])
    qy = torch.arange(h, device=dev)[:, None].expand(h, w)
    qx = torch.arange(w, device=dev)[None, :].expand(h, w)
    oy = torch.stack([pt.to_compact((py[i] - qy).to(torch.int32), geom)
                      for i in range(n_f)])
    ox = torch.stack([pt.to_compact((px[i] - qx).to(torch.int32), geom)
                      for i in range(n_f)])
    # Kernel-metric incumbents start at +inf: the raw-plane metric and
    # the feature metric must not meet in one accept test.
    d = torch.full(oy.shape, float("inf"), dtype=torch.float32, device=dev)
    for t in range(pm_iters):
        tables = []
        for i in range(n_f):
            cand_y, cand_x, cand_valid = pt.sample_candidates_blocked(
                oy[i], ox[i],
                pt.draw_candidates(draws[i].gen(t, dev), geom, ha, wa,
                                   coarse_restarts),
                geom, ha, wa,
            )
            if prune_states[i] is not None:
                proj_b_tiles, qy_s, qx_s, proj_a, m_keep = prune_states[i]
                cand_valid = pt.prune_candidates(
                    cand_y, cand_x, cand_valid, proj_b_tiles, qy_s, qx_s,
                    proj_a, ha, wa, m_keep,
                )
            tables.append((cand_y, cand_x, cand_valid))
        cand_y, cand_x, cand_valid = (torch.stack(c) for c in zip(*tables))
        oy, ox, d = pt.tile_sweep(
            raw.a_planes, b_planes, cand_y, cand_x, cand_valid, oy, ox, d,
            specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=coh,
            plain=plain, cand_dtype=cand_dtype,
        )
    ky = (qy + oy[:, :h, :w].long()).clamp(0, ha - 1)
    kx = (qx + ox[:, :h, :w].long()).clamp(0, wa - 1)
    # The sweep state is dead from here; free it before the polish.
    del b_planes, oy, ox, d, prune_states
    outs = [
        _merge_and_polish(
            py[i], px[i], dist0[i], ky[i], kx[i], draws[i], dist_fn(i),
            f_b_tab[i], f_a_tab, cfg=cfg, plain=plain, ha=ha, wa=wa,
            coh=coh, pm_iters=pm_iters, polish_iters=polish_iters,
            polish_random=polish_random, cand_dtype=cand_dtype,
            polish_mode=polish_mode,
        )
        for i in range(n_f)
    ]
    return tuple(torch.stack(x) for x in zip(*outs))


def _merge_and_polish(py, px, dist0, ky, kx, draws: SweepDraws, dist_fn,
                      f_b_tab, f_a_tab, *, cfg: SynthConfig, plain: bool,
                      ha: int, wa: int, coh: float, pm_iters: int,
                      polish_iters: int, polish_random: int,
                      cand_dtype: str, polish_mode: str):
    """One frame's tail of the tile path: the exact-metric merge of the
    kernel's match (ky, kx) into the incoming field (py, px; distances
    dist0), the polish from slot `pm_iters` of `draws`, and the kappa
    pass.  Returns (py, px, dist)."""
    h, w = py.shape
    dev = py.device
    # Exact-metric merge: adopt the kernel's match only where it wins.
    d_k = dist_fn((ky * wa + kx).reshape(-1)).reshape(h, w)
    better = d_k < dist0
    py = torch.where(better, ky, py)
    px = torch.where(better, kx, px)
    dist = torch.where(better, d_k, dist0)
    if polish_iters == 0:
        return py, px, dist
    offsets = sweep_offsets(draws.gen(pm_iters, dev), polish_iters,
                            sweep_radii(ha, wa, polish_random), h, w)
    if polish_mode in ("sequential", "stream"):
        gf = _polish_gather_fn(f_a_tab, plain, cand_dtype, polish_mode)
        py, px, dist = patchmatch_sweeps_lean(
            f_b_tab, f_a_tab, py, px, offsets, ha=ha, wa=wa,
            coh_factor=coh,
            dist_fn=lambda idx: candidate_dist_lean(
                f_b_tab, f_a_tab, idx, gather_fn=gf),
        )
    else:
        py, px, dist = polish_sweeps_planes(
            py, px, dist, offsets, ha=ha, wa=wa, coh_factor=coh,
            dist_fn=dist_fn,
        )
    if cfg.kappa > 0.0:
        from .coherence import coherence_sweeps_lean

        py, px, dist = coherence_sweeps_lean(
            py, px, dist, ha=ha, wa=wa, factor=coh, sweeps=2,
            dist_fn=dist_fn,
        )
    return py, px, dist


class PatchMatchMatcher(Matcher):
    """PatchMatch seeded from the incoming NNF.  The per-pixel sweeps
    with the temporal term when it is active (`temporal_active`); else
    the tile path when raw planes are given (the level's plan chose
    it); else the per-pixel sweeps."""

    name = "patchmatch"

    def match(self, f_b, f_a, nnf, *, level, cfg: SynthConfig,
              draws: SweepDraws = None, raw: Optional[RawPlanes] = None,
              polish_iters=None, temporal=None):
        h, w = f_b.shape[:2]
        ha, wa = f_a.shape[:2]
        active = temporal_active(temporal, cfg)
        if raw is not None and not active:
            return tile_patchmatch(
                f_b, f_a, nnf, draws, raw=raw, cfg=cfg, level=level,
                plain=cfg.pallas_mode == "interpret",
                polish_iters=polish_iters,
            )
        coh = kappa_factor(cfg.kappa, level)
        nnf, dist = patchmatch_sweeps(
            f_b, f_a, nnf,
            draws.offsets(_pm_iters_for(cfg, ha, wa),
                          sweep_radii(ha, wa, cfg.pm_random_candidates),
                          h, w, f_b.device),
            coh_factor=coh, temporal=temporal if active else None,
            tau=cfg.tau,
        )
        if cfg.kappa > 0.0:
            from .coherence import coherence_sweeps

            nnf, dist = coherence_sweeps(
                f_b, f_a, nnf, dist, factor=coh, sweeps=2
            )
        return nnf, dist

    def match_frames(self, f_b, f_a, nnf, *, level, cfg: SynthConfig,
                     draws=None, raw: Optional[RawPlanes] = None,
                     polish_iters=None, temporal=None):
        """The tile path takes all frames at once (one K1 launch a
        sweep); the per-pixel paths go frame by frame."""
        if raw is not None and not temporal_active(temporal, cfg):
            return tile_patchmatch(
                f_b, f_a, nnf, draws, raw=raw, cfg=cfg, level=level,
                plain=cfg.pallas_mode == "interpret",
                polish_iters=polish_iters,
            )
        return super().match_frames(
            f_b, f_a, nnf, level=level, cfg=cfg, draws=draws, raw=raw,
            polish_iters=polish_iters, temporal=temporal,
        )


register_matcher("patchmatch", PatchMatchMatcher())
