"""PatchMatch NN-field matcher (Barnes 2009) with the kappa rule
(Hertzmann §3.2).

Two paths, chosen by `SynthConfig.pallas_mode` and the level's shape:

  - the tile path (`tile_patchmatch`, levels with min side >= 128 under
    "auto"/"interpret"): bulk global search with kernel K1 (or its plain
    version) in the raw-plane metric, then a merge with the incoming
    field and a per-pixel polish under the feature metric on bf16 tables,
    the kappa coherence pass, and an exact float32 re-rank;
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

from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SynthConfig
from .matcher import (
    Matcher,
    candidate_dist,
    clamp_nnf,
    nnf_dist,
    nnf_to_flat,
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


class SweepDraws(NamedTuple):
    """The random-number source of one matcher call.

    Scheme: the generator for slot `slot` of EM step `em` at pyramid
    level `level` is seeded with seed_for(seed, level, 1 + em, slot).
    Slots 0 .. pm_iters-1 feed the tile sweeps' candidate tables, slot
    pm_iters the polish's random offsets; the per-pixel path uses slot 0
    for all of its sweeps.  The coarsest level's random field uses
    seed_for(seed, level, 0, 0) (`init_generator`)."""

    seed: int
    level: int
    em: int

    def gen(self, slot: int, device) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(seed_for(self.seed, self.level, 1 + self.em, slot))
        return g


def init_generator(seed: int, level: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, level, 0, 0))
    return g


def random_init(gen: torch.Generator, h: int, w: int, ha: int,
                wa: int) -> torch.Tensor:
    """Uniform random NNF (H, W, 2) over A's domain."""
    py = torch.randint(0, ha, (h, w), generator=gen, device=gen.device)
    px = torch.randint(0, wa, (h, w), generator=gen, device=gen.device)
    return torch.stack([py, px], dim=-1)


def shifted(nnf: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Propagation candidate field nnf(q - delta) + delta (a roll:
    wrapped rows/cols give harmless candidates that lose after
    clamping)."""
    cand = torch.roll(nnf, shifts=(dy, dx), dims=(0, 1))
    return cand + torch.tensor([dy, dx], dtype=nnf.dtype, device=nnf.device)


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


def patchmatch_sweeps(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    nnf: torch.Tensor,
    offsets: Iterable[torch.Tensor],
    *,
    coh_factor: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One propagate + random-search sweep per entry of `offsets` (each
    (n_random, H, W, 2), added to the current match); returns
    (nnf, dist).  Random candidates must satisfy d * coh_factor < d_cur;
    exact ties break toward the lower flat index, the representative
    the brute oracle's argmin picks."""
    h, w, d = f_b.shape
    ha, wa = f_a.shape[:2]
    f_b_flat = f_b.reshape(-1, d)
    f_a_flat = f_a.reshape(-1, d)

    def d_fn(idx):
        return candidate_dist(f_b_flat, f_a_flat, idx).reshape(h, w)

    nnf = clamp_nnf(nnf.long(), ha, wa)
    dist = d_fn(nnf_to_flat(nnf, wa))

    def try_candidates(nnf_cur, dist_cur, cand, factor):
        cand = clamp_nnf(cand, ha, wa)
        idx = nnf_to_flat(cand, wa)
        d_cand = d_fn(idx)
        idx_cur = nnf_to_flat(nnf_cur, wa).reshape(h, w)
        better = d_cand * factor < dist_cur
        tie_lower = (d_cand == dist_cur) & (idx.reshape(h, w) < idx_cur)
        accept = better | tie_lower
        return (
            torch.where(accept[..., None], cand, nnf_cur),
            torch.where(accept, d_cand, dist_cur),
        )

    for off in offsets:
        for dy, dx in DELTAS:
            nnf, dist = try_candidates(nnf, dist, shifted(nnf, dy, dx), 1.0)
        for dy, dx in DELTAS:
            cand = torch.roll(nnf, shifts=(dy, dx), dims=(0, 1))
            nnf, dist = try_candidates(nnf, dist, cand, 1.0)
        for s in range(off.shape[0]):
            nnf, dist = try_candidates(
                nnf, dist, nnf + off[s].to(nnf.device), coh_factor
            )
    return nnf, dist


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


def tile_patchmatch(
    f_b: torch.Tensor,
    f_a: torch.Tensor,
    nnf: torch.Tensor,
    draws: SweepDraws,
    *,
    raw: RawPlanes,
    cfg: SynthConfig,
    level: int,
    plain: bool,
    polish_iters: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile path: `pm_iters` K1 sweeps in the raw-plane metric, a
    merge with the incoming field under the feature metric on bf16
    tables, the sequential polish, the kappa pass, and the exact float32
    distance of the result.  `plain` runs K1's plain version on either
    device (pallas_mode="interpret")."""
    from ..kernels.patchmatch_tile import (
        draw_candidates,
        from_compact,
        prepare_b_planes,
        sample_candidates_blocked,
        tile_geometry,
        tile_sweep,
        to_compact,
    )

    h, w = f_b.shape[:2]
    ha, wa = f_a.shape[:2]
    dev = f_b.device
    f_a_flat = f_a.reshape(-1, f_a.shape[-1])
    specs, use_coarse = raw.plan
    geom = tile_geometry(h, w, specs)
    coh = kappa_factor(cfg.kappa, level)
    pm_iters = _pm_iters_for(cfg, ha, wa)
    polish_iters, polish_random = _polish_schedule_for(
        cfg, ha, wa, polish_iters
    )
    # bf16 accept-metric tables; candidate_dist does its math in f32.
    f_b16 = f_b.to(torch.bfloat16)
    f_a16 = f_a.to(torch.bfloat16)
    f_a16_flat = f_a16.reshape(-1, f_a16.shape[-1])

    b_planes = prepare_b_planes(
        raw.src_b, raw.flt_b,
        raw.src_b_coarse if use_coarse else None,
        raw.flt_b_coarse if use_coarse else None,
        geom,
    )
    nnf = clamp_nnf(nnf.long(), ha, wa)
    qy = torch.arange(h, device=dev)[:, None].expand(h, w)
    qx = torch.arange(w, device=dev)[None, :].expand(h, w)
    dist0 = nnf_dist(f_b16, f_a16_flat, nnf, wa)

    oy = to_compact((nnf[..., 0] - qy).to(torch.int32), geom)
    ox = to_compact((nnf[..., 1] - qx).to(torch.int32), geom)
    # Kernel-metric incumbents start at +inf: the raw-plane metric and
    # the feature metric must not meet in one accept test.
    d = torch.full(oy.shape, float("inf"), dtype=torch.float32, device=dev)
    for t in range(pm_iters):
        cand_y, cand_x, cand_valid = sample_candidates_blocked(
            oy, ox, draw_candidates(draws.gen(t, dev), geom, ha, wa),
            geom, ha, wa,
        )
        oy, ox, d = tile_sweep(
            raw.a_planes, b_planes, cand_y, cand_x, cand_valid, oy, ox, d,
            specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=coh,
            plain=plain,
        )
    nnf_k = clamp_nnf(
        torch.stack([
            qy + from_compact(oy, h, w).long(),
            qx + from_compact(ox, h, w).long(),
        ], dim=-1),
        ha, wa,
    )
    d_k = nnf_dist(f_b16, f_a16_flat, nnf_k, wa)
    better = d_k < dist0
    nnf_m = torch.where(better[..., None], nnf_k, nnf)
    d_m = torch.where(better, d_k, dist0)
    if polish_iters == 0:
        return nnf_m, d_m
    nnf_p, d_p = patchmatch_sweeps(
        f_b16, f_a16, nnf_m,
        sweep_offsets(draws.gen(pm_iters, dev), polish_iters,
                      sweep_radii(ha, wa, polish_random), h, w),
        coh_factor=coh,
    )
    if cfg.kappa > 0.0:
        from .coherence import coherence_sweeps

        nnf_p, _ = coherence_sweeps(
            f_b16, f_a16, nnf_p, d_p, factor=coh, sweeps=2
        )
    return nnf_p, nnf_dist(f_b, f_a_flat, nnf_p, wa)


class PatchMatchMatcher(Matcher):
    """PatchMatch seeded from the incoming NNF.  The tile path when raw
    planes are given (the level's plan chose it); the per-pixel sweeps
    otherwise."""

    name = "patchmatch"

    def match(self, f_b, f_a, nnf, *, level, cfg: SynthConfig,
              draws: SweepDraws = None, raw: Optional[RawPlanes] = None,
              polish_iters=None):
        h, w = f_b.shape[:2]
        ha, wa = f_a.shape[:2]
        if raw is not None:
            return tile_patchmatch(
                f_b, f_a, nnf, draws, raw=raw, cfg=cfg, level=level,
                plain=cfg.pallas_mode == "interpret",
                polish_iters=polish_iters,
            )
        coh = kappa_factor(cfg.kappa, level)
        nnf, dist = patchmatch_sweeps(
            f_b, f_a, nnf,
            sweep_offsets(
                draws.gen(0, f_b.device), _pm_iters_for(cfg, ha, wa),
                sweep_radii(ha, wa, cfg.pm_random_candidates), h, w,
            ),
            coh_factor=coh,
        )
        if cfg.kappa > 0.0:
            from .coherence import coherence_sweeps

            nnf, dist = coherence_sweeps(
                f_b, f_a, nnf, dist, factor=coh, sweeps=2
            )
        return nnf, dist


register_matcher("patchmatch", PatchMatchMatcher())
