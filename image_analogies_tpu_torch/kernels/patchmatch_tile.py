"""K1: the PatchMatch tile sweep, and the host side of the tile path.

Each 64 x tile_w B'-tile (tile_w = 128 - 2 * halo) evaluates 36 candidate
OFFSETS shared by all its pixels; every pixel keeps its own best, and
candidates are resampled from the per-pixel state every sweep.  Distances
are Gaussian-windowed SSDs over raw channel planes (fine source/filtered
channels at dilation 1, 2x repeat-upsampled coarse channels at
dilation 2), not over assembled feature rows.

Slot layout (the kappa split is positional):
  [0, 4)    own-tile state samples       (coherent)
  [4, 20)   neighbour-tile samples       (coherent: propagation)
  [20, 32)  shrinking-radius perturbations (approximate: random search)
  [32, 36)  uniform restarts over A       (approximate)

State layout.  The TPU kernel kept its state in halo-blocked planes; the
port keeps it COMPACT and tile-padded, (n_ty * 64, n_tx * tile_w): exactly
the interiors of the TPU's blocked planes, so the own-tile samples read
the same values and, given the same draws, the candidate tables come out
identical.  Positions past (h, w) in the last tile row/column start as
edge copies of the field, as the TPU's edge-padded blocking gives them.

Plane layout.  A planes are (C, ha + 2P, wa + 2P) and B planes
(C, n_ty * 64 + 2P, n_tx * tile_w + 2P), both edge-padded by the halo P,
so every window read is in bounds and edge-clamped like the reference's
padding.

Randomness.  The sampler takes its draws as an argument
(`CandidateDraws`); `draw_candidates` makes them from a torch.Generator.

Compressed candidates (module globals with the reference's env
overrides and setters, resolved once per matcher call):
  - `_CAND_DTYPE` "int8" stores the A planes on the static [0, 1]
    affine grid q = round(x * 254 - 127) and the sweep dequantizes
    (q + 127) / 254 next to its distance math;
  - `_CAND_PRUNE` "K:M" ranks each tile's 36 shared candidates by a
    K-dim PCA distance at 4 sample pixels and keeps the top M valid
    (`prune_candidates`); the mask rides `cand_valid`;
  - `_RESTART_MODE` "coarse" draws the restart slots from the evolving
    field at random other positions (`_field_restarts`).

  - `tile_sweep_kernel`: the CUDA kernel (`csrc/tile_sweep.cu`), replacing
    the Pallas `_make_kernel` of image_analogies_tpu/kernels/
    patchmatch_tile.py, for float32 and int8 A planes, over one frame or
    a leading frame axis (the batch runner's resident frames, which the
    reference's `vmap` gives its kernel as a leading grid dimension);
  - `tile_sweep_plain`: the plain PyTorch version (a loop over the 36
    slots with batched window gathers);
  - `tile_sweep`: the dispatch by device;
  - `unexplained_offsets`: where two sweeps' offsets differ other than
    at ties, for holding the kernel against a reference.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SynthConfig
from ..telemetry.metrics import count_kernel_launch
from . import LaunchCounter, check, library, on_cuda, require, stream_ptr

LANE = 128
TILE_H = 64

K_OWN = 4
K_PROP = 16
K_LOCAL = 12
K_GLOBAL = 4
K_TOTAL = K_OWN + K_PROP + K_LOCAL + K_GLOBAL
K_COHERENT = K_OWN + K_PROP

# Resources of the CUDA kernel (csrc/tile_sweep.cu): the output rows per
# block it is instantiated for, the halos, the taps per window axis, the
# shared memory a block may use on Hopper, and what a block may use when
# two are to share an SM (228 KB less 1 KB a block).
STRIP_ROWS = 8
STRIP_ROWS_TALL = 16
MAX_HALO = 6
MAX_TAPS = 16
SMEM_LIMIT = 232_448
SMEM_TWO_BLOCKS = 115_712
_SLOT_LIST = 40
# Frames one launch takes: the grid's z dimension.
_MAX_FRAMES = 65_535

launches = LaunchCounter("tile_sweep")
launches_int8 = LaunchCounter("tile_sweep_int8")

# ---------------------------------------------------------------------------
# Mode selection.  The reference's setters also drop its compiled level
# graphs, which resolved the modes at trace time; the port compiles no
# graphs, so its setters only validate and assign
# (`clear_compiled_level_caches` has no counterpart here).

# "bf16" is the uncompressed representation (float32 sweep planes, bf16
# polish rows); "int8" quantizes both candidate tables.
_CAND_DTYPES = ("bf16", "int8")
_CAND_DTYPE = os.environ.get("IA_CAND_DTYPE", "bf16")

# int8 A-plane affine grid: the planes are images in [0, 1].
_Q_SCALE = 254.0
_Q_ZERO = 127.0


def resolve_cand_dtype(cand_dtype: Optional[str] = None) -> str:
    """The candidate-table mode: an explicit value wins, else the module
    default; raises on a name outside `_CAND_DTYPES`."""
    dt = _CAND_DTYPE if cand_dtype is None else cand_dtype
    if dt not in _CAND_DTYPES:
        raise ValueError(f"cand_dtype {dt!r} names none of {_CAND_DTYPES}")
    return dt


def parse_prune(spec) -> Optional[Tuple[int, int]]:
    """A "K:M" PCA-prune spec (K coarse PCA dims, M candidates kept per
    tile per sweep) as (k, m), or None for "off" / "" / None."""
    if spec in (None, "", "off"):
        return None
    if isinstance(spec, (tuple, list)):
        k, m = spec
    else:
        try:
            k_s, m_s = str(spec).split(":")
            k, m = int(k_s), int(m_s)
        except ValueError:
            raise ValueError(
                f"pca-prune spec {spec!r} is not 'K:M' (e.g. '16:8') or 'off'"
            ) from None
    if not 1 <= k <= LANE:
        raise ValueError(f"pca-prune K={k} outside [1, {LANE}]")
    if not 1 <= m <= K_TOTAL:
        raise ValueError(f"pca-prune M={m} outside [1, {K_TOTAL}]")
    return int(k), int(m)


_CAND_PRUNE = os.environ.get("IA_CAND_PRUNE", "off")


def resolve_prune(prune=None) -> Optional[Tuple[int, int]]:
    """The PCA prune: an explicit spec wins, else the module default."""
    return parse_prune(_CAND_PRUNE if prune is None else prune)


def set_cand_compression(cand_dtype: Optional[str] = None,
                         prune=None) -> None:
    """Install a compressed-candidate mode process-wide; validates before
    assigning.  None leaves a knob untouched."""
    global _CAND_DTYPE, _CAND_PRUNE
    if cand_dtype is not None:
        _CAND_DTYPE = resolve_cand_dtype(cand_dtype)
    if prune is not None:
        parse_prune(prune)
        _CAND_PRUNE = prune


# Restart slots: "uniform" over A (the default), or "coarse", read from
# the evolving field (`_field_restarts`).
_RESTART_MODE = os.environ.get("IA_RESTART_MODE", "uniform")


class ChannelSpec(NamedTuple):
    """Static per-channel window description (hashable)."""

    dilation: int
    wy: Tuple[float, ...]
    wx: Tuple[float, ...]


class TileGeometry(NamedTuple):
    halo: int
    tile_h: int
    tile_w: int
    n_ty: int
    n_tx: int


def _gauss1d(n: int, sigma_frac: float = 0.4) -> np.ndarray:
    """1-D factor of ops.features._gauss_weights (exactly separable)."""
    r = n // 2
    sigma = max(n * sigma_frac, 1e-3)
    x = np.arange(-r, r + 1, dtype=np.float32)
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def channel_specs(
    n_src: int, n_flt: int, cfg: SynthConfig, has_coarse: bool,
    coarse_scale: float = 1.0,
) -> Tuple[ChannelSpec, ...]:
    """Window spec per plane, matching ops.features.feature_weights."""
    if cfg.gaussian_weighting:
        wf = _gauss1d(cfg.patch_size)
        wc = _gauss1d(cfg.coarse_patch_size)
    else:
        wf = np.full(cfg.patch_size, 1.0 / cfg.patch_size, np.float32)
        wc = np.full(
            cfg.coarse_patch_size, 1.0 / cfg.coarse_patch_size, np.float32
        )
    fine = ChannelSpec(1, tuple(wf.tolist()), tuple(wf.tolist()))
    specs = [fine] * (n_src + n_flt)
    if has_coarse:
        s = math.sqrt(coarse_scale)
        wcy = tuple((wc * s).tolist())
        specs += [ChannelSpec(2, wcy, wcy)] * (n_src + n_flt)
    return tuple(specs)


def halo_for(specs: Sequence[ChannelSpec]) -> int:
    return max(sp.dilation * (len(sp.wy) // 2) for sp in specs)


def tile_geometry(h: int, w: int, specs: Sequence[ChannelSpec]) -> TileGeometry:
    p = halo_for(specs)
    tile_w = LANE - 2 * p
    return TileGeometry(
        halo=p, tile_h=TILE_H, tile_w=tile_w,
        n_ty=-(-h // TILE_H), n_tx=-(-w // tile_w),
    )


def spec_groups(specs: Tuple[ChannelSpec, ...]):
    """Channels grouped by identical window spec, first-seen order."""
    groups: list = []
    for c, sp in enumerate(specs):
        for g, (gsp, chans) in enumerate(groups):
            if gsp == sp:
                groups[g] = (gsp, chans + (c,))
                break
        else:
            groups.append((sp, (c,)))
    return tuple(groups)


# ---------------------------------------------------------------------------
# Planes


def _split_channels(img: torch.Tensor) -> list:
    if img.ndim == 2:
        return [img]
    return [img[..., c] for c in range(img.shape[-1])]


def _upsample2x(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest 2x repeat-upsample, cropped: the parent-pixel lookup."""
    return img.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]


def channel_images(src, flt, src_coarse, flt_coarse) -> list:
    """Ordered 2-D channel planes: fine src, fine flt, upsampled coarse
    src, upsampled coarse flt — the layout channel_specs describes."""
    h, w = src.shape[:2]
    chans = _split_channels(src) + _split_channels(flt)
    if src_coarse is not None:
        for img in (src_coarse, flt_coarse):
            chans += [_upsample2x(c, h, w) for c in _split_channels(img)]
    return chans


def _edge_pad(planes: torch.Tensor, top, bottom, left, right) -> torch.Tensor:
    return F.pad(planes[None], (left, right, top, bottom), mode="replicate")[0]


def prepare_a_planes(src, flt, src_coarse, flt_coarse, specs,
                     cand_dtype: Optional[str] = None) -> torch.Tensor:
    """A-side planes (C, ha + 2P, wa + 2P), edge-padded: float32, or
    under the resolved `cand_dtype` "int8" the int8 grid
    clip(round(x * 254 - 127), -127, 127) (edge padding and pointwise
    quantization commute)."""
    p = halo_for(specs)
    planes = torch.stack(
        [c.float() for c in channel_images(src, flt, src_coarse, flt_coarse)]
    )
    if len(planes) != len(specs):
        raise ValueError(f"{len(planes)} planes for {len(specs)} specs")
    planes = _edge_pad(planes, p, p, p, p)
    if resolve_cand_dtype(cand_dtype) == "int8":
        planes = torch.clamp(
            torch.round(planes * _Q_SCALE - _Q_ZERO), -127.0, 127.0
        ).to(torch.int8)
    return planes.contiguous()


def dequantize_planes(a_planes: torch.Tensor) -> torch.Tensor:
    """int8 A planes -> float32 (q + 127) * (1 / 254), the formula the
    kernel applies next to its distance math; float32 planes pass."""
    if a_planes.dtype != torch.int8:
        return a_planes
    return (a_planes.float() + _Q_ZERO) * (1.0 / _Q_SCALE)


def prepare_b_planes(src, flt, src_coarse, flt_coarse,
                     geom: TileGeometry) -> torch.Tensor:
    """B-side planes (C, n_ty * 64 + 2P, n_tx * tile_w + 2P) float32,
    edge-padded: the halo, then the tile padding past (h, w)."""
    p = geom.halo
    planes = torch.stack(
        [c.float() for c in channel_images(src, flt, src_coarse, flt_coarse)]
    )
    h, w = planes.shape[1:]
    return _edge_pad(
        planes, p, geom.n_ty * geom.tile_h - h + p,
        p, geom.n_tx * geom.tile_w - w + p,
    ).contiguous()


def to_compact(plane: torch.Tensor, geom: TileGeometry) -> torch.Tensor:
    """(h, w) -> tile-padded (n_ty * 64, n_tx * tile_w), edge-padded."""
    h, w = plane.shape
    dt = plane.dtype
    x = plane.float() if not dt.is_floating_point else plane
    x = _edge_pad(
        x[None], 0, geom.n_ty * geom.tile_h - h,
        0, geom.n_tx * geom.tile_w - w,
    )[0]
    return x.to(dt).contiguous()


# ---------------------------------------------------------------------------
# Candidate sampling


class CandidateDraws(NamedTuple):
    """The random numbers one sweep's candidate sampling consumes:
    `jitter` (2,) in [0, min(64, tile_w)), the subgrid offset;
    `pert` (2, n_ty, n_tx, K_LOCAL) in [-rmax, rmax], the local
    perturbations (rmax = max(ha, wa) >> 1); `glob_y` / `glob_x`
    (n_ty, n_tx, K_GLOBAL) in [0, max(ha - 64, 1)) / [0, max(wa - tile_w,
    1)), the restart origins; `restart`, drawn only under the "coarse"
    restart mode, (4, n_ty, n_tx, K_GLOBAL): the tile row in [0, n_ty),
    tile column in [0, n_tx), row in [0, 64) and column in [0, tile_w)
    of the field positions `_field_restarts` reads (None: uniform
    restarts from glob_y / glob_x)."""

    jitter: torch.Tensor
    pert: torch.Tensor
    glob_y: torch.Tensor
    glob_x: torch.Tensor
    restart: Optional[torch.Tensor] = None


def _radii(ha: int, wa: int) -> np.ndarray:
    m = max(ha, wa)
    return np.array([max(1, m >> (s + 1)) for s in range(K_LOCAL)], np.int64)


def draw_candidates(gen: torch.Generator, geom: TileGeometry, ha: int,
                    wa: int, coarse_restarts: bool = False) -> CandidateDraws:
    """One sweep's `CandidateDraws` from `gen`, on its device; the
    restart positions only when `coarse_restarts`."""
    dev = gen.device
    th, tw, n_ty, n_tx = geom.tile_h, geom.tile_w, geom.n_ty, geom.n_tx
    rmax = int(_radii(ha, wa).max())
    shape = (n_ty, n_tx, K_GLOBAL)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    return CandidateDraws(
        jitter=randint(0, min(th, tw), (2,)),
        pert=randint(-rmax, rmax + 1, (2, n_ty, n_tx, K_LOCAL)),
        glob_y=randint(0, max(ha - th, 1), shape),
        glob_x=randint(0, max(wa - tw, 1), shape),
        restart=torch.stack([
            randint(0, n_ty, shape), randint(0, n_tx, shape),
            randint(0, th, shape), randint(0, tw, shape),
        ]) if coarse_restarts else None,
    )


def _subgrid(jitter: torch.Tensor, geom: TileGeometry):
    """Jittered side x side in-tile sample coordinates (uy, ux)."""
    th, tw = geom.tile_h, geom.tile_w
    side = int(math.isqrt(K_OWN))
    ar = torch.arange(side, device=jitter.device)
    uy = (jitter[0] + (th // side) * ar) % th
    ux = (jitter[1] + (tw // side) * ar) % tw
    return uy, ux


def candidate_valid_mask(cand_y: torch.Tensor, cand_x: torch.Tensor):
    """Dedup mask over the slot axis: slot k is valid iff no earlier slot
    carries the same (oy, ox); int32."""
    same = (cand_y[..., :, None] == cand_y[..., None, :]) & (
        cand_x[..., :, None] == cand_x[..., None, :]
    )
    earlier = torch.tril(
        torch.ones(K_TOTAL, K_TOTAL, dtype=torch.bool, device=cand_y.device),
        diagonal=-1,
    )
    return (~(same & earlier).any(dim=-1)).to(torch.int32)


def _field_restarts(off_y, off_x, restart: torch.Tensor, geom: TileGeometry):
    """K_GLOBAL field-informed restart offsets per tile: read the field's
    offset at the drawn position q' (tile si, sj; in-tile su, sv) and
    re-express its match as an offset for this tile, q' + off(q') -
    tile origin.  `off_y` / `off_x` are the compact state planes, whose
    positions are the interiors the reference reads."""
    th, tw, n_ty, n_tx = geom.tile_h, geom.tile_w, geom.n_ty, geom.n_tx
    dev = off_y.device
    si, sj, su, sv = restart.to(dev, torch.int64)
    src_y = si * th + su
    src_x = sj * tw + sv
    oy = off_y[src_y, src_x].long()
    ox = off_x[src_y, src_x].long()
    ty0 = (torch.arange(n_ty, device=dev) * th)[:, None, None]
    tx0 = (torch.arange(n_tx, device=dev) * tw)[None, :, None]
    return src_y + oy - ty0, src_x + ox - tx0


def _candidate_tables(own_y, own_x, draws: CandidateDraws,
                      geom: TileGeometry, ha: int, wa: int, glob=None):
    """Propagation / random-search / restart tail; returns
    (cand_y, cand_x, cand_valid), each (n_ty, n_tx, K_TOTAL) int32.
    `glob` overrides the uniform restart slots (`_field_restarts`)."""
    th, tw, n_ty, n_tx = geom.tile_h, geom.tile_w, geom.n_ty, geom.n_tx
    dev = own_y.device
    per = K_PROP // 4
    prop_y, prop_x = [], []
    for shift in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        prop_y.append(torch.roll(own_y[..., :per], shift, dims=(0, 1)))
        prop_x.append(torch.roll(own_x[..., :per], shift, dims=(0, 1)))
    prop_y = torch.cat(prop_y, dim=-1)
    prop_x = torch.cat(prop_x, dim=-1)

    reps = -(-K_LOCAL // K_OWN)
    centers_y = torch.cat([own_y] * reps, dim=-1)[..., :K_LOCAL]
    centers_x = torch.cat([own_x] * reps, dim=-1)[..., :K_LOCAL]
    scale = torch.as_tensor(_radii(ha, wa), device=dev)
    pert = draws.pert.to(dev, torch.int64)
    loc_y = centers_y + torch.maximum(torch.minimum(pert[0], scale), -scale)
    loc_x = centers_x + torch.maximum(torch.minimum(pert[1], scale), -scale)

    if glob is None:
        ty0 = (torch.arange(n_ty, device=dev) * th)[:, None, None]
        tx0 = (torch.arange(n_tx, device=dev) * tw)[None, :, None]
        glob = (draws.glob_y.to(dev, torch.int64) - ty0,
                draws.glob_x.to(dev, torch.int64) - tx0)
    glob_y, glob_x = glob

    cand_y = torch.cat([own_y, prop_y, loc_y, glob_y], dim=-1).to(torch.int32)
    cand_x = torch.cat([own_x, prop_x, loc_x, glob_x], dim=-1).to(torch.int32)
    return (
        cand_y.contiguous(), cand_x.contiguous(),
        candidate_valid_mask(cand_y, cand_x).contiguous(),
    )


def sample_candidates_blocked(off_y, off_x, draws: CandidateDraws,
                              geom: TileGeometry, ha: int, wa: int):
    """Per-tile candidate tables from the compact state planes: own-tile
    samples at the jittered subgrid, then `_candidate_tables`; the
    restart slots come from the field when the draws carry `restart`."""
    th, tw, n_ty, n_tx = geom.tile_h, geom.tile_w, geom.n_ty, geom.n_tx
    uy, ux = _subgrid(draws.jitter.to(off_y.device), geom)

    def pick(plane):
        t = plane.reshape(n_ty, th, n_tx, tw).long()
        t = t.index_select(1, uy).index_select(3, ux)
        return t.permute(0, 2, 1, 3).reshape(n_ty, n_tx, K_OWN)

    glob = None
    if draws.restart is not None:
        glob = _field_restarts(off_y, off_x, draws.restart, geom)
    return _candidate_tables(pick(off_y), pick(off_x), draws, geom, ha, wa,
                             glob=glob)


# Sample pixels per tile for the coarse pre-prune ranking: a 2 x 2
# subgrid of quarter positions.
_PRUNE_SAMPLES = 4


def tile_sample_positions(geom: TileGeometry, h: int, w: int, device=None):
    """(qy, qx), each (n_ty, n_tx, _PRUNE_SAMPLES) int64: the B pixels the
    coarse prune ranks candidates at, clipped to the image."""
    th, tw = geom.tile_h, geom.tile_w
    sy = torch.tensor([th // 4, th // 4, (3 * th) // 4, (3 * th) // 4],
                      device=device)
    sx = torch.tensor([tw // 4, (3 * tw) // 4, tw // 4, (3 * tw) // 4],
                      device=device)
    qy = ((torch.arange(geom.n_ty, device=device) * th)[:, None, None]
          + sy).clamp(0, h - 1)
    qx = ((torch.arange(geom.n_tx, device=device) * tw)[None, :, None]
          + sx).clamp(0, w - 1)
    shape = (geom.n_ty, geom.n_tx, _PRUNE_SAMPLES)
    return qy.expand(shape), qx.expand(shape)


def prune_candidates(cand_y, cand_x, cand_valid, proj_b_tiles, qy, qx,
                     proj_a_flat, ha: int, wa: int, m_keep: int):
    """PCA coarse pre-prune: rank each tile's K_TOTAL candidates by their
    summed projected-feature SSD at the tile's sample pixels and keep the
    top `m_keep` valid ones; returns the new int32 `cand_valid`.  Invalid
    candidates rank at +inf and are never resurrected; the stable double
    argsort keeps earlier slots on ties, as the reference's does.
    `proj_b_tiles` is (n_ty, n_tx, S, k), `proj_a_flat` (ha * wa, k)."""
    k = proj_a_flat.shape[-1]
    py = (qy[..., None, :] + cand_y[..., :, None].long()).clamp(0, ha - 1)
    px = (qx[..., None, :] + cand_x[..., :, None].long()).clamp(0, wa - 1)
    rows = proj_a_flat.index_select(0, (py * wa + px).reshape(-1))
    diff = rows.reshape(*py.shape, k).float() \
        - proj_b_tiles[..., None, :, :].float()
    d = (diff * diff).sum(dim=(-1, -2))
    d = torch.where(cand_valid > 0, d, torch.full_like(d, float("inf")))
    order = torch.argsort(d, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return ((rank < m_keep) & (cand_valid > 0)).to(torch.int32)


# ---------------------------------------------------------------------------
# The sweep


def _check_shapes(a_planes, b_planes, cand_y, off_y, specs, geom, ha, wa):
    """The sweep's shape contract; returns the frame count F, or None
    when the B side has no frame axis."""
    p, th, tw = geom.halo, geom.tile_h, geom.tile_w
    c = len(specs)
    if tuple(a_planes.shape) != (c, ha + 2 * p, wa + 2 * p):
        raise ValueError(f"a_planes {tuple(a_planes.shape)}")
    frames = b_planes.ndim == 4
    lead = tuple(b_planes.shape[:1]) if frames else ()
    if tuple(b_planes.shape) != lead + (
        c, geom.n_ty * th + 2 * p, geom.n_tx * tw + 2 * p
    ):
        raise ValueError(f"b_planes {tuple(b_planes.shape)}")
    if tuple(cand_y.shape) != lead + (geom.n_ty, geom.n_tx, K_TOTAL):
        raise ValueError(f"cand tables {tuple(cand_y.shape)}")
    if tuple(off_y.shape) != lead + (geom.n_ty * th, geom.n_tx * tw):
        raise ValueError(f"state planes {tuple(off_y.shape)}")
    if ha < th or wa < tw:
        raise ValueError(f"A ({ha}, {wa}) smaller than one tile")
    return lead[0] if frames else None


def tile_sweep_plain(a_planes, b_planes, cand_y, cand_x, cand_valid,
                     off_y, off_x, dist, *, specs, geom: TileGeometry,
                     ha: int, wa: int, coh_factor: float):
    """The plain PyTorch version of one sweep; returns the new compact
    (off_y int32, off_x int32, dist float32).  int8 A planes are
    dequantized first (`dequantize_planes`).  With a leading frame axis
    on the B planes, the candidate tables and the state (A is shared),
    each frame is swept on its own and the results are stacked."""
    n_f = _check_shapes(a_planes, b_planes, cand_y, off_y, specs, geom,
                        ha, wa)
    if n_f is not None:
        outs = [
            tile_sweep_plain(
                a_planes, b_planes[i], cand_y[i], cand_x[i], cand_valid[i],
                off_y[i], off_x[i], dist[i], specs=specs, geom=geom, ha=ha,
                wa=wa, coh_factor=coh_factor,
            )
            for i in range(n_f)
        ]
        return tuple(torch.stack(x) for x in zip(*outs))
    a_planes = dequantize_planes(a_planes)
    p, th, tw, n_ty, n_tx = geom
    dev = a_planes.device
    hp, wp = th + 2 * p, tw + 2 * p
    ty0 = torch.arange(n_ty, device=dev) * th
    tx0 = torch.arange(n_tx, device=dev) * tw
    ar_y = torch.arange(hp, device=dev)
    ar_x = torch.arange(wp, device=dev)

    def windows(planes, oy, ox):
        """(C, n_ty, n_tx, hp, wp) windows with origins (oy, ox)."""
        rows = (oy[:, :, None] + ar_y)[:, :, :, None]
        cols = (ox[:, :, None] + ar_x)[:, :, None, :]
        return planes[:, rows, cols]

    b_t = windows(b_planes, ty0[:, None].expand(n_ty, n_tx),
                  tx0[None, :].expand(n_ty, n_tx))

    def tiles(plane):
        return plane.reshape(n_ty, th, n_tx, tw).permute(0, 2, 1, 3)

    d_coh = tiles(dist).float()
    y_coh = tiles(off_y).to(torch.int32)
    x_coh = tiles(off_x).to(torch.int32)
    d_app = torch.full_like(d_coh, float("inf"))
    y_app = torch.zeros_like(y_coh)
    x_app = torch.zeros_like(x_coh)
    groups = spec_groups(tuple(specs))
    for k in range(K_TOTAL):
        sy = (ty0[:, None] + cand_y[..., k].long()).clamp(0, ha - th)
        sx = (tx0[None, :] + cand_x[..., k].long()).clamp(0, wa - tw)
        dq = (b_t - windows(a_planes, sy, sx)) ** 2
        d = None
        for sp, chans in groups:
            acc = dq[chans[0]]
            for c in chans[1:]:
                acc = acc + dq[c]
            r = len(sp.wx) // 2
            xs = None
            for t, wt in enumerate(sp.wx):
                o = p + (t - r) * sp.dilation
                term = wt * acc[..., o : o + tw]
                xs = term if xs is None else xs + term
            dg = None
            for t, wt in enumerate(sp.wy):
                o = p + (t - r) * sp.dilation
                term = wt * xs[..., o : o + th, :]
                dg = term if dg is None else dg + term
            d = dg if d is None else d + dg
        ok = (cand_valid[..., k] > 0)[:, :, None, None]
        d = torch.where(ok, d, torch.full_like(d, float("inf")))
        oy_o = (sy - ty0[:, None]).to(torch.int32)[:, :, None, None]
        ox_o = (sx - tx0[None, :]).to(torch.int32)[:, :, None, None]
        if k < K_COHERENT:
            acc_c = d < d_coh
            d_coh = torch.where(acc_c, d, d_coh)
            y_coh = torch.where(acc_c, oy_o, y_coh)
            x_coh = torch.where(acc_c, ox_o, x_coh)
        else:
            acc_a = d < d_app
            d_app = torch.where(acc_a, d, d_app)
            y_app = torch.where(acc_a, oy_o, y_app)
            x_app = torch.where(acc_a, ox_o, x_app)
    take = d_app * coh_factor < d_coh

    def compact(t):
        return t.permute(0, 2, 1, 3).reshape(n_ty * th, n_tx * tw)

    return (
        compact(torch.where(take, y_app, y_coh)),
        compact(torch.where(take, x_app, x_coh)),
        compact(torch.where(take, d_app, d_coh)),
    )


def pixel_dist(a_planes, b_planes, qy, qx, off_y, off_x, *, specs,
               geom: TileGeometry, ha: int, wa: int) -> torch.Tensor:
    """The sweep's windowed distance of B' pixels (qy, qx) matched to A
    pixels (qy + off_y, qx + off_x), all 1-D int64, summed tap by tap:
    the metric the sweep minimizes, one pixel at a time.  A match
    outside A gets +inf."""
    p = geom.halo
    a_planes = dequantize_planes(a_planes)
    ay, ax = qy + off_y, qx + off_x
    inside = (ay >= 0) & (ay < ha) & (ax >= 0) & (ax < wa)
    ay, ax = ay.clamp(0, ha - 1), ax.clamp(0, wa - 1)
    d = torch.zeros(qy.shape, dtype=torch.float32, device=qy.device)
    for c, sp in enumerate(specs):
        r = len(sp.wy) // 2
        for ty, wt_y in enumerate(sp.wy):
            dy = p + (ty - r) * sp.dilation
            for tx, wt_x in enumerate(sp.wx):
                dx = p + (tx - r) * sp.dilation
                diff = (b_planes[c, qy + dy, qx + dx]
                        - a_planes[c, ay + dy, ax + dx])
                d = d + (wt_y * wt_x) * diff * diff
    return torch.where(inside, d, torch.full_like(d, float("inf")))


def unexplained_offsets(got, want, state_in, a_planes, b_planes, *, specs,
                        geom: TileGeometry, ha: int, wa: int, h: int,
                        w: int) -> torch.Tensor:
    """The pixels of [0, h) x [0, w) where sweep result `got` = (off_y,
    off_x, dist) records another offset than `want` does, and that is
    not a tie: the distance `got`'s offset reaches is not within rtol
    1e-4 / atol 1e-5 of `want`'s distance, neither its window distance
    (`pixel_dist`) nor, where it is the incoming offset of `state_in`,
    the incoming distance.  Each triple holds compact or (h, w) planes;
    returns a bool (h, w) mask."""
    gy, gx, wy, wx, iy, ix, wd, di = (
        t[:h, :w] for t in (*got[:2], *want[:2], *state_in[:2], want[2],
                            state_in[2])
    )
    bad = torch.zeros((h, w), dtype=torch.bool, device=gy.device)
    qy, qx = torch.nonzero((gy != wy) | (gx != wx), as_tuple=True)
    if qy.numel() == 0:
        return bad
    oy, ox = gy[qy, qx].long(), gx[qy, qx].long()
    ref = wd[qy, qx].float()
    tol = 1e-5 + 1e-4 * ref.abs()
    ok = (pixel_dist(a_planes, b_planes, qy, qx, oy, ox, specs=specs,
                     geom=geom, ha=ha, wa=wa) - ref).abs() <= tol
    kept = (oy == iy[qy, qx]) & (ox == ix[qy, qx])
    ok |= kept & ((di[qy, qx].float() - ref).abs() <= tol)
    bad[qy, qx] = ~ok
    return bad


def window_weights(specs) -> Tuple[np.ndarray, list]:
    """(2, 2, MAX_TAPS) float32 window weights ([group][y, x][tap]) and
    the kernel's group description [(n_channels, taps, dilation)] for
    at most two contiguous channel groups."""
    groups = spec_groups(tuple(specs))
    if len(groups) > 2:
        raise ValueError(f"{len(groups)} window groups; the kernel takes 2")
    w = np.zeros((2, 2, MAX_TAPS), np.float32)
    desc = []
    first = 0
    for g, (sp, chans) in enumerate(groups):
        if chans != tuple(range(first, first + len(chans))):
            raise ValueError("window groups must be contiguous channels")
        if len(sp.wy) > MAX_TAPS or len(sp.wx) != len(sp.wy):
            raise ValueError(f"window of {len(sp.wy)} taps")
        w[g, 0, : len(sp.wy)] = sp.wy
        w[g, 1, : len(sp.wx)] = sp.wx
        desc.append((len(chans), len(sp.wy), sp.dilation))
        first += len(chans)
    return w, desc


@functools.lru_cache(maxsize=None)
def _device_weights(specs, device: torch.device) -> torch.Tensor:
    """`window_weights(specs)` on `device`, copied there once per specs
    rather than once per launch."""
    return torch.as_tensor(window_weights(specs)[0]).to(device)


def kernel_smem_bytes(n_chan: int, halo: int, rows: int = STRIP_ROWS) -> int:
    """Dynamic shared memory of one block of the CUDA kernel with strips
    of `rows` output rows: the B strip (C planes) and the double-buffered
    group sums (4 planes) of (rows + 2 * halo) x 128 float32, the weights
    and the slot lists."""
    r = rows + 2 * halo
    return ((n_chan + 4) * r * LANE + 2 * 2 * MAX_TAPS + 4 * _SLOT_LIST) * 4


def sweep_plan(n_chan: int, halo: int):
    """The output rows per block of the CUDA kernel for a channel count
    and halo, or None when even a strip of 8 rows does not fit a block.
    As measured on the H100 (PERF.md), two resident blocks an SM count
    for most, then the taller strip (less halo per output row): the
    tallest strip of which two blocks fit, else 8 rows in one block."""
    for rows in (STRIP_ROWS_TALL, STRIP_ROWS):
        if kernel_smem_bytes(n_chan, halo, rows) <= SMEM_TWO_BLOCKS:
            return rows
    if kernel_smem_bytes(n_chan, halo, STRIP_ROWS) <= SMEM_LIMIT:
        return STRIP_ROWS
    return None


def kernel_fits(specs) -> bool:
    """The CUDA kernel's resource check: its halo is instantiated, its
    windows fit, and a strip's shared memory fits a Hopper block."""
    try:
        window_weights(specs)
    except ValueError:
        return False
    halo = halo_for(specs)
    return 1 <= halo <= MAX_HALO and sweep_plan(len(specs), halo) is not None


def window_bytes(cand_valid, specs, geom: TileGeometry,
                 itemsize: int) -> int:
    """The A-window bytes one launch pulls from L2: per valid slot and
    strip, C x (rows + 2 * halo) x 128 elements."""
    rows = sweep_plan(len(specs), geom.halo)
    strips = geom.tile_h // rows
    return int((cand_valid > 0).sum()) * strips * len(specs) \
        * (rows + 2 * geom.halo) * LANE * itemsize


def tile_sweep_kernel(a_planes, b_planes, cand_y, cand_x, cand_valid,
                      off_y, off_x, dist, *, specs, geom: TileGeometry,
                      ha: int, wa: int, coh_factor: float,
                      general: bool = False):
    """The CUDA kernel on CUDA tensors; same contract as
    `tile_sweep_plain`, for float32 or int8 A planes (the int8 mode
    dequantizes in the kernel and counts in `launches_int8`).  `general`
    forces the run-time tap loops where the main path's windows would
    take the compile-time instantiation.  A leading frame axis F on the
    B side is the grid's z dimension: one launch sweeps every frame,
    each block's work is the single-frame launch's, and the launch
    counts once.  Launches on the current stream."""
    n_f = _check_shapes(a_planes, b_planes, cand_y, off_y, specs, geom,
                        ha, wa)
    if n_f is None:
        out = tile_sweep_kernel(
            a_planes, b_planes[None], cand_y[None], cand_x[None],
            cand_valid[None], off_y[None], off_x[None], dist[None],
            specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=coh_factor,
            general=general,
        )
        return tuple(t[0] for t in out)
    if not kernel_fits(specs):
        raise ValueError("channel specs exceed the tile-sweep kernel")
    if not 1 <= n_f <= _MAX_FRAMES:
        raise ValueError(f"{n_f} frames in one launch (1 to {_MAX_FRAMES})")
    p, th, tw, n_ty, n_tx = geom
    c = len(specs)
    dev = a_planes.device
    cand_shape = (n_f, n_ty, n_tx, K_TOTAL)
    state_shape = (n_f, n_ty * th, n_tx * tw)
    int8 = a_planes.dtype == torch.int8
    require(a_planes, torch.int8 if int8 else torch.float32, a_planes.shape,
            "tile_sweep a_planes")
    require(b_planes, torch.float32, (n_f,) + tuple(b_planes.shape[1:]),
            "tile_sweep b_planes")
    for t, name in ((cand_y, "cand_y"), (cand_x, "cand_x"),
                    (cand_valid, "cand_valid")):
        require(t, torch.int32, cand_shape, f"tile_sweep {name}")
    require(off_y, torch.int32, state_shape, "tile_sweep off_y")
    require(off_x, torch.int32, state_shape, "tile_sweep off_x")
    require(dist, torch.float32, state_shape, "tile_sweep dist")
    for t in (b_planes, cand_y, cand_x, cand_valid, off_y, off_x, dist):
        if t.device != dev:
            raise ValueError("tile_sweep: tensors on different devices")
    rows = sweep_plan(c, p)
    _, desc = window_weights(specs)
    weights = _device_weights(tuple(specs), dev)
    n0, taps0, dil0 = desc[0]
    _, taps1, dil1 = desc[1] if len(desc) > 1 else (0, 1, 1)
    oy_o = torch.empty(state_shape, dtype=torch.int32, device=dev)
    ox_o = torch.empty(state_shape, dtype=torch.int32, device=dev)
    d_o = torch.empty(state_shape, dtype=torch.float32, device=dev)
    err = library("tile_sweep").ia_tile_sweep(
        a_planes.data_ptr(), b_planes.data_ptr(), cand_y.data_ptr(),
        cand_x.data_ptr(), cand_valid.data_ptr(), off_y.data_ptr(),
        off_x.data_ptr(), dist.data_ptr(), oy_o.data_ptr(), ox_o.data_ptr(),
        d_o.data_ptr(), weights.data_ptr(),
        c, n0, ha, wa, a_planes.shape[1], a_planes.shape[2],
        b_planes.shape[2], b_planes.shape[3], n_ty, n_tx, tw, p,
        taps0, dil0, taps1, dil1, int(int8), rows, int(general), n_f,
        float(coh_factor), stream_ptr(a_planes),
    )
    check(err, "ia_tile_sweep")
    (launches_int8 if int8 else launches).add()
    count_kernel_launch("tile_sweep")
    return oy_o, ox_o, d_o


def tile_sweep(a_planes, b_planes, cand_y, cand_x, cand_valid, off_y,
               off_x, dist, *, specs, geom, ha, wa, coh_factor,
               plain: bool = False, cand_dtype: Optional[str] = None):
    """One sweep: the kernel for CUDA tensors, the plain version for CPU
    tensors, or the plain version on either device when `plain` (the
    explicit `pallas_mode="interpret"`).  The B side may carry a leading
    frame axis (one launch for all frames).  Raises when the A planes'
    dtype does not match the resolved `cand_dtype` (int8 planes for
    "int8", float32 for "bf16")."""
    mode = resolve_cand_dtype(cand_dtype)
    want = torch.int8 if mode == "int8" else torch.float32
    if a_planes.dtype != want:
        raise ValueError(
            f"a_planes dtype {a_planes.dtype} does not match cand_dtype "
            f"{mode!r} (expected {want}): prepare_a_planes and the sweep "
            "must resolve the same compression mode"
        )
    fn = (
        tile_sweep_kernel if on_cuda(a_planes) and not plain
        else tile_sweep_plain
    )
    return fn(
        a_planes, b_planes, cand_y, cand_x, cand_valid, off_y, off_x, dist,
        specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=coh_factor,
    )


def candidate_dma_bytes_per_fetch(n_chan: int, thp: int,
                                  cand_dtype: Optional[str] = None):
    """(moved, useful) bytes of ONE candidate-window fetch of the
    reference's TPU kernel: `useful` is 2 lane blocks x n_chan channels
    x thp rows at the plane itemsize, `moved` adds the sublane padding
    of its default packed layout (2C sublanes rounded up to 8 for f32
    planes, 32 for int8).  A copy of the reference's byte model, kept
    only so `models/analogy.py` `level_eta_cost_units` prices levels as
    the reference does: it describes TPU DMA geometry, not what K1 moves
    on the card."""
    dt = resolve_cand_dtype(cand_dtype)
    item = 1 if dt == "int8" else 4
    gran = 32 if dt == "int8" else 8
    useful = thp * 2 * n_chan * LANE * item
    moved = thp * (-(-2 * n_chan // gran) * gran) * LANE * item
    return moved, useful


# ---------------------------------------------------------------------------
# Eligibility


def plan_channels(
    n_src: int, n_flt: int, cfg: SynthConfig, has_coarse: bool,
    h: int, w: int, ha: int, wa: int,
):
    """The tile plan (specs, use_coarse) for a level, or None when the
    level is tile-ineligible.  The geometry rule is the reference's; its
    VMEM check is replaced by the CUDA kernel's own resource check
    (`kernel_fits`), which the plain version follows too so both take
    the same levels."""
    geom_ok = (
        min(h, w) >= LANE
        and ha >= TILE_H + 2 * halo_for(
            channel_specs(n_src, n_flt, cfg, False)
        )
        and wa >= LANE
    )
    if not geom_ok:
        return None
    for coarse in ([True, False] if has_coarse else [False]):
        specs = channel_specs(n_src, n_flt, cfg, coarse)
        if kernel_fits(specs):
            return specs, coarse
    return None
