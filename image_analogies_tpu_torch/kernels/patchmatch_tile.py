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

  - `tile_sweep_kernel`: the CUDA kernel (`csrc/tile_sweep.cu`), replacing
    the Pallas `_make_kernel` of image_analogies_tpu/kernels/
    patchmatch_tile.py;
  - `tile_sweep_plain`: the plain PyTorch version (a loop over the 36
    slots with batched window gathers);
  - `tile_sweep`: the dispatch by device;
  - `unexplained_offsets`: where two sweeps' offsets differ other than
    at ties, for holding the kernel against a reference.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SynthConfig
from . import LaunchCounter, check, library, on_cuda, require, stream_ptr

LANE = 128
TILE_H = 64

K_OWN = 4
K_PROP = 16
K_LOCAL = 12
K_GLOBAL = 4
K_TOTAL = K_OWN + K_PROP + K_LOCAL + K_GLOBAL
K_COHERENT = K_OWN + K_PROP

# Resources of the CUDA kernel (csrc/tile_sweep.cu): rows per block, the
# halos it is instantiated for, the taps per window axis, and the shared
# memory a block may use on Hopper.
STRIP_ROWS = 8
MAX_HALO = 6
MAX_TAPS = 16
SMEM_LIMIT = 232_448

launches = LaunchCounter("tile_sweep")


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


def prepare_a_planes(src, flt, src_coarse, flt_coarse, specs) -> torch.Tensor:
    """A-side planes (C, ha + 2P, wa + 2P) float32, edge-padded."""
    p = halo_for(specs)
    planes = torch.stack(
        [c.float() for c in channel_images(src, flt, src_coarse, flt_coarse)]
    )
    if len(planes) != len(specs):
        raise ValueError(f"{len(planes)} planes for {len(specs)} specs")
    return _edge_pad(planes, p, p, p, p).contiguous()


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


def from_compact(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return plane[:h, :w]


# ---------------------------------------------------------------------------
# Candidate sampling


class CandidateDraws(NamedTuple):
    """The random numbers one sweep's candidate sampling consumes:
    `jitter` (2,) in [0, min(64, tile_w)), the subgrid offset;
    `pert` (2, n_ty, n_tx, K_LOCAL) in [-rmax, rmax], the local
    perturbations (rmax = max(ha, wa) >> 1); `glob_y` / `glob_x`
    (n_ty, n_tx, K_GLOBAL) in [0, max(ha - 64, 1)) / [0, max(wa - tile_w,
    1)), the restart origins."""

    jitter: torch.Tensor
    pert: torch.Tensor
    glob_y: torch.Tensor
    glob_x: torch.Tensor


def _radii(ha: int, wa: int) -> np.ndarray:
    m = max(ha, wa)
    return np.array([max(1, m >> (s + 1)) for s in range(K_LOCAL)], np.int64)


def draw_candidates(gen: torch.Generator, geom: TileGeometry, ha: int,
                    wa: int) -> CandidateDraws:
    """One sweep's `CandidateDraws` from `gen`, on its device."""
    dev = gen.device
    th, tw, n_ty, n_tx = geom.tile_h, geom.tile_w, geom.n_ty, geom.n_tx
    rmax = int(_radii(ha, wa).max())

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    return CandidateDraws(
        jitter=randint(0, min(th, tw), (2,)),
        pert=randint(-rmax, rmax + 1, (2, n_ty, n_tx, K_LOCAL)),
        glob_y=randint(0, max(ha - th, 1), (n_ty, n_tx, K_GLOBAL)),
        glob_x=randint(0, max(wa - tw, 1), (n_ty, n_tx, K_GLOBAL)),
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


def _candidate_tables(own_y, own_x, draws: CandidateDraws,
                      geom: TileGeometry, ha: int, wa: int):
    """Propagation / random-search / restart tail; returns
    (cand_y, cand_x, cand_valid), each (n_ty, n_tx, K_TOTAL) int32."""
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

    ty0 = (torch.arange(n_ty, device=dev) * th)[:, None, None]
    tx0 = (torch.arange(n_tx, device=dev) * tw)[None, :, None]
    glob_y = draws.glob_y.to(dev, torch.int64) - ty0
    glob_x = draws.glob_x.to(dev, torch.int64) - tx0

    cand_y = torch.cat([own_y, prop_y, loc_y, glob_y], dim=-1).to(torch.int32)
    cand_x = torch.cat([own_x, prop_x, loc_x, glob_x], dim=-1).to(torch.int32)
    return (
        cand_y.contiguous(), cand_x.contiguous(),
        candidate_valid_mask(cand_y, cand_x).contiguous(),
    )


def sample_candidates_blocked(off_y, off_x, draws: CandidateDraws,
                              geom: TileGeometry, ha: int, wa: int):
    """Per-tile candidate tables from the compact state planes: own-tile
    samples at the jittered subgrid, then `_candidate_tables`."""
    th, tw, n_ty, n_tx = geom.tile_h, geom.tile_w, geom.n_ty, geom.n_tx
    uy, ux = _subgrid(draws.jitter.to(off_y.device), geom)

    def pick(plane):
        t = plane.reshape(n_ty, th, n_tx, tw).long()
        t = t.index_select(1, uy).index_select(3, ux)
        return t.permute(0, 2, 1, 3).reshape(n_ty, n_tx, K_OWN)

    return _candidate_tables(pick(off_y), pick(off_x), draws, geom, ha, wa)


# ---------------------------------------------------------------------------
# The sweep


def _check_shapes(a_planes, b_planes, cand_y, off_y, specs, geom, ha, wa):
    p, th, tw = geom.halo, geom.tile_h, geom.tile_w
    c = len(specs)
    if tuple(a_planes.shape) != (c, ha + 2 * p, wa + 2 * p):
        raise ValueError(f"a_planes {tuple(a_planes.shape)}")
    if tuple(b_planes.shape) != (
        c, geom.n_ty * th + 2 * p, geom.n_tx * tw + 2 * p
    ):
        raise ValueError(f"b_planes {tuple(b_planes.shape)}")
    if tuple(cand_y.shape) != (geom.n_ty, geom.n_tx, K_TOTAL):
        raise ValueError(f"cand tables {tuple(cand_y.shape)}")
    if tuple(off_y.shape) != (geom.n_ty * th, geom.n_tx * tw):
        raise ValueError(f"state planes {tuple(off_y.shape)}")
    if ha < th or wa < tw:
        raise ValueError(f"A ({ha}, {wa}) smaller than one tile")


def tile_sweep_plain(a_planes, b_planes, cand_y, cand_x, cand_valid,
                     off_y, off_x, dist, *, specs, geom: TileGeometry,
                     ha: int, wa: int, coh_factor: float):
    """The plain PyTorch version of one sweep; returns the new compact
    (off_y int32, off_x int32, dist float32)."""
    _check_shapes(a_planes, b_planes, cand_y, off_y, specs, geom, ha, wa)
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


def kernel_smem_bytes(n_chan: int, halo: int) -> int:
    """Dynamic shared memory of one block of the CUDA kernel: the B strip
    (C planes), the two window-sum buffers per group (4 planes) of
    (8 + 2 * halo) x 128 float32, and the weights."""
    rows = STRIP_ROWS + 2 * halo
    return ((n_chan + 4) * rows * LANE + 2 * 2 * MAX_TAPS) * 4


def kernel_fits(specs) -> bool:
    """The CUDA kernel's resource check: its halo is instantiated, its
    windows fit, and its shared memory fits a Hopper block."""
    try:
        window_weights(specs)
    except ValueError:
        return False
    halo = halo_for(specs)
    return (
        1 <= halo <= MAX_HALO
        and kernel_smem_bytes(len(specs), halo) <= SMEM_LIMIT
    )


def tile_sweep_kernel(a_planes, b_planes, cand_y, cand_x, cand_valid,
                      off_y, off_x, dist, *, specs, geom: TileGeometry,
                      ha: int, wa: int, coh_factor: float):
    """The CUDA kernel on CUDA tensors; same contract as
    `tile_sweep_plain`.  Launches on the current stream."""
    _check_shapes(a_planes, b_planes, cand_y, off_y, specs, geom, ha, wa)
    if not kernel_fits(specs):
        raise ValueError("channel specs exceed the tile-sweep kernel")
    p, th, tw, n_ty, n_tx = geom
    c = len(specs)
    dev = a_planes.device
    cand_shape = (n_ty, n_tx, K_TOTAL)
    state_shape = (n_ty * th, n_tx * tw)
    require(a_planes, torch.float32, a_planes.shape, "tile_sweep a_planes")
    require(b_planes, torch.float32, b_planes.shape, "tile_sweep b_planes")
    for t, name in ((cand_y, "cand_y"), (cand_x, "cand_x"),
                    (cand_valid, "cand_valid")):
        require(t, torch.int32, cand_shape, f"tile_sweep {name}")
    require(off_y, torch.int32, state_shape, "tile_sweep off_y")
    require(off_x, torch.int32, state_shape, "tile_sweep off_x")
    require(dist, torch.float32, state_shape, "tile_sweep dist")
    for t in (b_planes, cand_y, cand_x, cand_valid, off_y, off_x, dist):
        if t.device != dev:
            raise ValueError("tile_sweep: tensors on different devices")
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
        b_planes.shape[1], b_planes.shape[2], n_ty, n_tx, tw, p,
        taps0, dil0, taps1, dil1, float(coh_factor), stream_ptr(a_planes),
    )
    check(err, "ia_tile_sweep")
    launches.add()
    return oy_o, ox_o, d_o


def tile_sweep(a_planes, b_planes, cand_y, cand_x, cand_valid, off_y,
               off_x, dist, *, specs, geom, ha, wa, coh_factor,
               plain: bool = False):
    """One sweep: the kernel for CUDA tensors, the plain version for CPU
    tensors, or the plain version on either device when `plain` (the
    explicit `pallas_mode="interpret"`)."""
    fn = (
        tile_sweep_kernel if on_cuda(a_planes) and not plain
        else tile_sweep_plain
    )
    return fn(
        a_planes, b_planes, cand_y, cand_x, cand_valid, off_y, off_x, dist,
        specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=coh_factor,
    )


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
