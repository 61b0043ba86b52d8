"""The raster kernels' exact footprint rejection, in its plain version
(raster_kernel.footprint_keep), against the plain coverage test: a block of
pixels × samples that a triangle covers at a depth >= the floor is never
rejected, and rejection does reject.

No tolerance: the rejection is exact by construction (each bound is the
plane evaluated in the kernels' rounding order at the box corner that
maximises it), so one covered sample in a rejected block fails the test.
The bins are tests/torch_bins.py's edge cases: edges through sample
positions and footprint corners, sub-pixel triangles, 1/w crossing 0 and
whole-tile triangles in depth order.
"""

import pytest
import torch

import tests.torch_parity  # noqa: F401  (one torch thread per worker)
from renderer_tpu_torch.raster import raster_kernel as rk
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS
from tests.torch_bins import CASES, H, TILE_H, TILE_W, W, crafted_bins, crafted_floor


def _needed(binned, starts, counts, zfloor, spos, fp_w, fp_h, spb):
    """Blocks [pairs, G, FY, FX] holding a sample the triangle covers at a
    depth >= zfloor (0 when None)."""
    tiles_x, tiles_y = W // TILE_W, H // TILE_H
    counts = counts.long()
    tile = torch.repeat_interleave(torch.arange(tiles_x * tiles_y), counts)
    first = torch.cumsum(counts, 0) - counts
    col = starts.long()[tile] + torch.arange(tile.numel()) - first[tile]
    x0, y0 = rk.tile_grid(tiles_x, tiles_y, TILE_W, TILE_H, 0, 1, "cpu")
    px, py = rk.sample_coords(spos, x0, y0, TILE_H, TILE_W)
    floor = None if zfloor is None else rk.to_tiles(zfloor, TILE_H, TILE_W)
    out = []
    for lo in range(0, tile.numel(), 128):
        t, rows = tile[lo:lo + 128], binned[:, col[lo:lo + 128]]
        cover, z, _ = rk.fragment(lambda k: rows[k][:, None, None, None],
                                  px[:, t].transpose(0, 1), py[:, t].transpose(0, 1))
        if floor is not None:
            cover &= z >= floor[:, t].transpose(0, 1)
        n = t.numel()
        blocks = cover.reshape(n, len(spos) // spb, spb, TILE_H // fp_h, fp_h,
                               TILE_W // fp_w, fp_w)
        out.append(blocks.any(dim=6).any(dim=4).any(dim=2))
    return torch.cat(out)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("msaa,fp_w,spb,floor", [
    # the kernels' footprints: K1 one pixel a thread at every S; K2 picks
    # TS samples x P pixels a thread from its layer count K
    (1, 8, 1, False),    # K1 at S = 1
    (4, 8, 4, False),    # K1 at S = 4
    (8, 8, 8, False),    # K1 at S = 8
    (1, 32, 1, True),    # K2 at S = 1, K <= 8: P = 4
    (1, 16, 1, True),    # K2 at S = 1, K = 16: P = 2
    (4, 8, 4, True),     # K2 at S = 4, K <= 8
    (8, 8, 2, True),     # K2 at S = 8, K = 16: two samples a block
])
def test_rejection_never_drops_a_covered_block(case, msaa, fp_w, spb, floor):
    binned, starts, counts = crafted_bins(case, "cpu")
    spos = STANDARD_SAMPLE_POSITIONS[msaa]
    zfloor = crafted_floor(msaa, "cpu") if floor else None
    keep = rk.footprint_keep(binned, starts, counts, zfloor, fp_w=fp_w, fp_h=4,
                             samples_per_block=spb, padded_height=H,
                             padded_width=W, sample_positions=spos)
    needed = _needed(binned, starts, counts, zfloor, spos, fp_w, 4, spb)
    assert keep.shape == needed.shape
    assert int(needed.sum()) > 0
    assert not bool((needed & ~keep).any()), "a covered block was rejected"
    # the corner test rejects most blocks of the small or one-sided
    # triangles (depth-skip's cover whole tiles)
    if case != "depth-skip":
        assert float(keep.float().mean()) < 0.75
