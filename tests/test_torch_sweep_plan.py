"""The host side of K1's CUDA kernel, on the CPU: the strip height the
wrapper plans for a channel set (`sweep_plan`), the shared memory that
plan takes against a Hopper block's limit, which channel sets the kernel
admits, and the slot order the sweep keeps when slots are invalid (the
kernel compacts a tile's valid slots at block start; the plain version
is its yardstick on the card)."""

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch.config import SynthConfig
from image_analogies_tpu_torch.kernels import patchmatch_tile as pt


def _fits_a_block(n_chan, halo):
    """A block's B strip and four sum planes at strips of 8 rows, the
    weights and the slot lists, against the block limit."""
    return ((n_chan + 4) * (8 + 2 * halo) * 128 + 64 + 160) * 4 \
        <= pt.SMEM_LIMIT


@pytest.mark.parametrize("halo", range(1, pt.MAX_HALO + 1))
def test_sweep_plan_fits_a_block_for_every_admitted_channel_set(halo):
    for n_chan in range(1, 64):
        rows = pt.sweep_plan(n_chan, halo)
        assert (rows is not None) == _fits_a_block(n_chan, halo)
        if rows is None:
            continue
        assert rows in (pt.STRIP_ROWS, pt.STRIP_ROWS_TALL)
        nbytes = pt.kernel_smem_bytes(n_chan, halo, rows)
        assert nbytes <= pt.SMEM_LIMIT
        if rows == pt.STRIP_ROWS_TALL:
            # A tall strip only where two blocks share an SM.
            assert nbytes <= pt.SMEM_TWO_BLOCKS
        else:
            assert pt.kernel_smem_bytes(
                n_chan, halo, pt.STRIP_ROWS_TALL) > pt.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("n_chan,halo,want", [
    (4, 2, 16), (2, 2, 16), (7, 2, 16), (8, 2, 8), (12, 2, 8), (16, 2, 8),
    (33, 2, 8), (34, 2, None), (4, 6, 16), (2, 1, 16),
])
def test_sweep_plan_of_the_main_path_channel_sets(n_chan, halo, want):
    rows = pt.sweep_plan(n_chan, halo)
    assert rows == want
    # Two blocks an SM at the headline's 4 channels.
    if n_chan <= 4:
        assert pt.kernel_smem_bytes(n_chan, halo, rows) <= pt.SMEM_TWO_BLOCKS


def test_kernel_smem_bytes_counts_strip_planes_weights_and_lists():
    # 4 channels at halo 2, strips of 8: 12 rows; (4 + 4) planes of
    # 12 x 128 float32, 64 weights, 4 lists of 40 ints.
    assert pt.kernel_smem_bytes(4, 2) == (8 * 12 * 128 + 64 + 160) * 4
    assert pt.kernel_smem_bytes(4, 2, 16) == (8 * 20 * 128 + 64 + 160) * 4
    assert pt.kernel_smem_bytes(12, 3, 8) == (16 * 14 * 128 + 64 + 160) * 4


@pytest.mark.parametrize("kw,n_src,n_flt,coarse", [
    ({}, 1, 1, True), ({}, 1, 1, False),
    ({"color_mode": "rgb"}, 3, 3, True), ({"color_mode": "rgb"}, 3, 3, False),
    ({"steerable": True}, 5, 1, True),
    ({"patch_size": 7, "coarse_patch_size": 5}, 1, 1, True),
])
def test_kernel_fits_the_channel_sets_channel_specs_yields(kw, n_src, n_flt,
                                                           coarse):
    specs = pt.channel_specs(n_src, n_flt, SynthConfig(**kw), coarse)
    assert pt.kernel_fits(specs)
    rows = pt.sweep_plan(len(specs), pt.halo_for(specs))
    assert pt.kernel_smem_bytes(len(specs), pt.halo_for(specs),
                                rows) <= pt.SMEM_LIMIT


def test_a_channel_set_past_the_kernel_is_refused_with_value_error():
    fine = pt.channel_specs(1, 1, SynthConfig(), False)[0]
    specs = (fine,) * 40
    assert not pt.kernel_fits(specs)
    geom = pt.tile_geometry(64, 124, specs)
    p = geom.halo
    z = torch.zeros
    with pytest.raises(ValueError, match="exceed the tile-sweep kernel"):
        pt.tile_sweep_kernel(
            z(40, 64 + 2 * p, 124 + 2 * p), z(40, 64 + 2 * p, 124 + 2 * p),
            z(1, 1, pt.K_TOTAL, dtype=torch.int32),
            z(1, 1, pt.K_TOTAL, dtype=torch.int32),
            z(1, 1, pt.K_TOTAL, dtype=torch.int32),
            z(64, 124, dtype=torch.int32), z(64, 124, dtype=torch.int32),
            z(64, 124), specs=specs, geom=geom, ha=64, wa=124,
            coh_factor=1.0)


def tied_case(rng, keep, int8=False, device="cpu"):
    """A sweep in which every candidate of a pixel scores the same: flat
    A planes, so the A window does not depend on the offset.  With no
    incoming match and kappa = 1 the strict `<` leaves each pixel with
    its tile's first valid coherent slot (0-19), else its first valid
    approximate slot (20-35), else the incoming offset."""
    specs = pt.channel_specs(1, 1, SynthConfig(), True)
    h, w, ha, wa = 128, 248, 200, 300
    geom = pt.tile_geometry(h, w, specs)
    p = geom.halo
    a_planes = torch.full((len(specs), ha + 2 * p, wa + 2 * p), 0.5)
    if int8:
        a_planes = torch.zeros(a_planes.shape, dtype=torch.int8)
    b_planes = torch.as_tensor(rng.random(
        (len(specs), geom.n_ty * geom.tile_h + 2 * p,
         geom.n_tx * geom.tile_w + 2 * p), dtype=np.float32))
    shape = (geom.n_ty, geom.n_tx, pt.K_TOTAL)
    cand_y = torch.as_tensor(rng.integers(-300, 300, shape), dtype=torch.int32)
    cand_x = torch.as_tensor(rng.integers(-400, 400, shape), dtype=torch.int32)
    valid = torch.as_tensor(rng.random(shape) < keep).to(torch.int32)
    state = (geom.n_ty * geom.tile_h, geom.n_tx * geom.tile_w)
    oy = torch.full(state, -7, dtype=torch.int32)
    ox = torch.full(state, 9, dtype=torch.int32)
    d_in = torch.full(state, float("inf"))
    args = tuple(t.to(device) for t in (a_planes, b_planes, cand_y, cand_x,
                                        valid, oy, ox, d_in))
    kw = dict(specs=specs, geom=geom, ha=ha, wa=wa, coh_factor=1.0)
    return args, kw


def first_valid_offsets(cand_y, cand_x, valid, geom, ha, wa):
    """Per tile the clamped offset of the slot a tied sweep must keep."""
    want_y = np.full((geom.n_ty, geom.n_tx), -7)
    want_x = np.full((geom.n_ty, geom.n_tx), 9)
    for i in range(geom.n_ty):
        for j in range(geom.n_tx):
            slots = np.nonzero(valid[i, j].numpy() > 0)[0]
            if not len(slots):
                continue
            coherent = slots[slots < pt.K_COHERENT]
            k = coherent[0] if len(coherent) else slots[0]
            ty0, tx0 = i * geom.tile_h, j * geom.tile_w
            want_y[i, j] = np.clip(ty0 + int(cand_y[i, j, k]), 0,
                                   ha - geom.tile_h) - ty0
            want_x[i, j] = np.clip(tx0 + int(cand_x[i, j, k]), 0,
                                   wa - geom.tile_w) - tx0
    return want_y, want_x


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("seed,keep", [(0, 0.7), (1, 0.1), (2, 1.0),
                                       (3, 0.0)])
def test_tied_sweep_keeps_the_first_valid_slot(seed, keep, int8):
    rng = np.random.default_rng(seed)
    args, kw = tied_case(rng, keep, int8)
    geom = kw["geom"]
    got_y, got_x, _ = pt.tile_sweep_plain(*args, **kw)
    want_y, want_x = first_valid_offsets(args[2], args[3], args[4], geom,
                                         kw["ha"], kw["wa"])
    th, tw = geom.tile_h, geom.tile_w
    np.testing.assert_array_equal(
        got_y.numpy(), np.repeat(np.repeat(want_y, th, 0), tw, 1))
    np.testing.assert_array_equal(
        got_x.numpy(), np.repeat(np.repeat(want_x, th, 0), tw, 1))


@pytest.mark.parametrize("itemsize", [1, 4])
def test_window_bytes_counts_valid_slots_strips_and_halo_rows(itemsize):
    specs = pt.channel_specs(1, 1, SynthConfig(), True)
    geom = pt.tile_geometry(128, 128, specs)
    valid = torch.zeros((geom.n_ty, geom.n_tx, pt.K_TOTAL), dtype=torch.int32)
    valid[0, 0, :5] = 1
    rows = pt.sweep_plan(len(specs), geom.halo)
    want = 5 * (64 // rows) * 4 * (rows + 4) * 128 * itemsize
    assert pt.window_bytes(valid, specs, geom, itemsize) == want
