"""K5: every frame's K1 candidate tables for one tile sweep in one launch.

K1 (`patchmatch_tile.tile_sweep`) reads, each sweep, 36 candidate
offsets a tile (`sample_candidates_blocked`: own samples, propagation,
local search, restarts, and the dedup mask).  Built eagerly, a frame's
tables are ~60 launches and a blocking copy of the search radii, whose
stream sync makes the host wait for the card once a frame and sweep;
at every tile level the host's issue of them, not the device, set the
pace of the sweep phase.  The JAX package builds the tables as `jnp`
under `jit`, where XLA fuses them; no TPU kernel is replaced.

  - `candidate_tables_kernel`: the CUDA kernel (`csrc/cand_tables.cu`)
    over a leading frame axis F, bit for bit the plain version's tables
    (integer arithmetic only);
  - `candidate_tables_plain`: `sample_candidates_blocked` frame by
    frame, stacked;
  - `candidate_tables`: the dispatch: the kernel on CUDA state planes
    unless `plain` (pallas_mode="interpret"), the plain version
    otherwise;
  - `draw_frames`: the frames' `draw_candidates`, each from its own
    generator as before, stacked along the frame axis.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..telemetry.metrics import count_kernel_launch
from . import LaunchCounter, check, library, on_cuda, require, stream_ptr
from . import patchmatch_tile as pt
from .patchmatch_tile import CandidateDraws, TileGeometry

launches = LaunchCounter("cand_tables")


def draw_frames(gens: Sequence[torch.Generator], geom: TileGeometry,
                ha: int, wa: int,
                coarse_restarts: bool = False) -> CandidateDraws:
    """One sweep's `CandidateDraws` for F frames, frame i's drawn from
    `gens[i]` by `draw_candidates` (the same calls in the same order, so
    the same numbers), each field with a leading frame axis."""
    draws = [pt.draw_candidates(g, geom, ha, wa, coarse_restarts)
             for g in gens]
    if len(draws) == 1:
        return CandidateDraws(*(None if x is None else x[None]
                                for x in draws[0]))
    return CandidateDraws(*(None if xs[0] is None else torch.stack(xs)
                            for xs in zip(*draws)))


def frame_draws(draws: CandidateDraws, i: int) -> CandidateDraws:
    """Frame i of frame-stacked `draws`."""
    return CandidateDraws(*(None if x is None else x[i] for x in draws))


def candidate_tables_plain(off_y, off_x, draws: CandidateDraws,
                           geom: TileGeometry, ha: int, wa: int):
    """(cand_y, cand_x, cand_valid), each (F, n_ty, n_tx, K_TOTAL) int32:
    `sample_candidates_blocked` on each frame's (F, n_ty * 64, n_tx *
    tile_w) state planes and draws, stacked."""
    tabs = [pt.sample_candidates_blocked(off_y[i], off_x[i],
                                         frame_draws(draws, i), geom, ha, wa)
            for i in range(off_y.shape[0])]
    return tuple(torch.stack(t) for t in zip(*tabs))


def candidate_tables_kernel(off_y, off_x, draws: CandidateDraws,
                            geom: TileGeometry, ha: int, wa: int):
    """The CUDA kernel: `candidate_tables_plain`'s tables in one launch
    for all F frames, on contiguous CUDA tensors: int32 state planes,
    int64 draws as `draw_frames` stacks them (`restart` None: uniform
    restarts).  Launches on the current stream; reads nothing back."""
    th, tw, n_ty, n_tx = geom.tile_h, geom.tile_w, geom.n_ty, geom.n_tx
    n_f = off_y.shape[0] if off_y.ndim == 3 else -1
    tiles = (n_f, n_ty, n_tx)
    require(off_y, torch.int32, (n_f, n_ty * th, n_tx * tw),
            "cand_tables off_y")
    require(off_x, torch.int32, (n_f, n_ty * th, n_tx * tw),
            "cand_tables off_x")
    require(draws.jitter, torch.int64, (n_f, 2), "cand_tables jitter")
    require(draws.pert, torch.int64, (n_f, 2, n_ty, n_tx, pt.K_LOCAL),
            "cand_tables pert")
    require(draws.glob_y, torch.int64, tiles + (pt.K_GLOBAL,),
            "cand_tables glob_y")
    require(draws.glob_x, torch.int64, tiles + (pt.K_GLOBAL,),
            "cand_tables glob_x")
    if draws.restart is not None:
        require(draws.restart, torch.int64,
                (n_f, 4, n_ty, n_tx, pt.K_GLOBAL), "cand_tables restart")
    dev = off_y.device
    if any(t is not None and t.device != dev for t in (off_x,) + draws):
        raise ValueError("cand_tables: tensors on different devices")
    out = [torch.empty(tiles + (pt.K_TOTAL,), dtype=torch.int32, device=dev)
           for _ in range(3)]
    err = library("cand_tables").ia_cand_tables(
        off_y.data_ptr(), off_x.data_ptr(), draws.jitter.data_ptr(),
        draws.pert.data_ptr(), draws.glob_y.data_ptr(),
        draws.glob_x.data_ptr(),
        None if draws.restart is None else draws.restart.data_ptr(),
        n_f, n_ty, n_tx, th, tw, ha, wa,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        stream_ptr(off_y),
    )
    check(err, "ia_cand_tables")
    launches.add()
    count_kernel_launch("cand_tables")
    return tuple(out)


def candidate_tables(off_y, off_x, draws: CandidateDraws,
                     geom: TileGeometry, ha: int, wa: int, *,
                     plain: bool = False):
    """One sweep's candidate tables for all frames: the kernel on CUDA
    state planes unless `plain`, the plain version otherwise."""
    if on_cuda(off_y) and not plain:
        return candidate_tables_kernel(off_y, off_x, draws, geom, ha, wa)
    return candidate_tables_plain(off_y, off_x, draws, geom, ha, wa)
