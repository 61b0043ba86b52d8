"""Opaque visibility raster over per-tile bins: kernel K1 and its plain
PyTorch version.

Replaces the Vulkan fixed-function rasterizer + depth test. The screen is
cut into tile_h × tile_w tiles; each tile walks its contiguous bin of
triangle planes (binning.py) and, for every MSAA sample position, evaluates
the three edge functions (top-left ownership, eps pre-folded into C), the
depth plane and the 1/w plane, clips to z ∈ [0, 1] and 1/w > 0, and merges
into the per-sample (depth, triangle id) buffers.

Depth semantics parity: clear depth = 0.0, compare GREATER_OR_EQUAL
(reference: render_passes.rs:192-197, pipelines.rs:152-158); on equal depth
the later-submitted triangle wins. The merge is a lexicographic (z, id) max —
equivalent to the submission-order semantics (stream index = submission
order) and ORDER-INVARIANT, so binning may feed the opaque class
nearest-first without changing any pixel.

`rasterize_binned` dispatches on the tensors' device: CPU tensors take the
plain version, CUDA tensors the hand-written kernel
(csrc/raster_kernel.cu). Output: depth [S, Hp, Wp] f32 and tri_id
[S, Hp, Wp] i32 (-1 where uncovered).
"""

from __future__ import annotations

import torch

from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.raster.binning import B_ROWS, B_TID

#: K1's launch counter in profiling.COUNTERS (the plain version does not
#: count; pipeline.launch_counts reads it)
LAUNCHES = ("k1",)
profiling.register_launches(LAUNCHES)

# bin positions evaluated together by the plain version (any value gives
# the same result: the merge is order-invariant)
PLAIN_CHUNK = 8


def tile_grid(tiles_x: int, tiles_y: int, tile_w: int, tile_h: int,
              tile_row_offset: int, row_stride: int, device):
    """Per-tile pixel origins (tile_x0 [T], tile_y0 [T] f32) of the
    tiles_y × tiles_x grid in tile order T = ty·tiles_x + tx (binning's
    tile keys); local tile rows map to global rows ty·stride + offset."""
    t = torch.arange(tiles_x * tiles_y, device=device)
    tx = t % tiles_x
    gty = torch.div(t, tiles_x, rounding_mode="floor") * row_stride + tile_row_offset
    return (tx * tile_w).to(torch.float32), (gty * tile_h).to(torch.float32)


def to_tiles(img: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """[..., Hp, Wp] → [..., T, tile_h, tile_w] in tile order."""
    *lead, hp, wp = img.shape
    ty, tx = hp // tile_h, wp // tile_w
    x = img.reshape(*lead, ty, tile_h, tx, tile_w).transpose(-3, -2)
    return x.reshape(*lead, ty * tx, tile_h, tile_w)


def from_tiles(tiles: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """Inverse of to_tiles: [..., T, tile_h, tile_w] → [..., Hp, Wp]."""
    *lead, t, th, tw = tiles.shape
    x = tiles.reshape(*lead, t // tiles_x, tiles_x, th, tw).transpose(-3, -2)
    return x.reshape(*lead, (t // tiles_x) * th, tiles_x * tw)


def fragment(row, px, py):
    """Coverage, depth and triangle id of the binned planes `row(k)` at
    sample positions (px, py). Zeroed (padding / dead) planes never cover:
    e' = 0 fails the strict test and ownership needs a > 0 or b > 0."""
    def edge(a, b, c):
        e = a * px + b * py + c
        own = (a > 0.0) | ((a == 0.0) & (b > 0.0))
        return (e > 0.0) | (own & (e >= 0.0))

    cover = (edge(row(0), row(1), row(2))
             & edge(row(3), row(4), row(5))
             & edge(row(6), row(7), row(8)))
    z = row(9) * px + row(10) * py + row(11)
    # 1/w > 0 excludes the anti-triangle branch of near-crossing triangles;
    # z ∈ [0, 1] is the Vulkan depth-range clip (= near clip under reverse-Z)
    inv_w = row(12) * px + row(13) * py + row(14)
    cover = cover & (inv_w > 0.0) & (z >= 0.0) & (z <= 1.0)
    return cover, z, row(B_TID).to(torch.int32)


def sample_coords(sample_positions, tile_x0, tile_y0, tile_h, tile_w):
    """px [S, T, 1, tw] and py [S, T, th, 1], each summed as
    (tile origin + in-pixel offset) + pixel index, the kernels' order."""
    dev = tile_x0.device
    ix = torch.arange(tile_w, dtype=torch.float32, device=dev)
    iy = torch.arange(tile_h, dtype=torch.float32, device=dev)
    px = torch.stack([(tile_x0 + dx)[:, None] + ix for dx, _ in sample_positions])
    py = torch.stack([(tile_y0 + dy)[:, None] + iy for _, dy in sample_positions])
    return px[:, :, None, :], py[:, :, :, None]


def rasterize_binned_plain(
    binned: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor, *,
    tile_row_offset: int = 0, padded_height: int, padded_width: int,
    tile_h: int = 32, tile_w: int = 128,
    sample_positions: tuple = ((0.5, 0.5),), row_stride: int = 1,
):
    """Plain PyTorch version of K1: steps through bin position i on all
    tiles at once, PLAIN_CHUNK positions per step."""
    dev = binned.device
    tiles_x = padded_width // tile_w
    tiles_y = padded_height // tile_h
    n_s = len(sample_positions)
    n_tiles = tiles_x * tiles_y
    x0, y0 = tile_grid(tiles_x, tiles_y, tile_w, tile_h, tile_row_offset,
                       row_stride, dev)
    px, py = sample_coords(sample_positions, x0, y0, tile_h, tile_w)
    px, py = px[:, :, None], py[:, :, None]  # [S, T, 1, ·, ·]
    depth = torch.zeros((n_s, n_tiles, tile_h, tile_w), dtype=torch.float32, device=dev)
    tid = torch.full((n_s, n_tiles, tile_h, tile_w), -1, dtype=torch.int32, device=dev)
    pp = binned.shape[1]
    starts = starts.long()
    counts = counts.long()
    max_count = int(counts.max()) if n_tiles else 0
    for base in range(0, max_count, PLAIN_CHUNK):
        i = torch.arange(base, base + PLAIN_CHUNK, device=dev)
        live = i[None, :] < counts[:, None]  # [T, C]
        rows = binned[:, torch.clamp(starts[:, None] + i[None, :], max=pp - 1)]

        def row(k):
            return rows[k][None, :, :, None, None]  # [1, T, C, 1, 1]

        cover, z, t = fragment(row, px, py)
        cover = cover & live[None, :, :, None, None]
        zc = torch.where(cover, z, torch.full_like(z, -1.0))
        zbest = torch.amax(zc, dim=2)
        tid_best = torch.amax(
            torch.where(zc == zbest[:, :, None], t, torch.full_like(t, -1)), dim=2)
        write = (zbest >= 0.0) & ((zbest > depth) | ((zbest == depth) & (tid_best > tid)))
        depth = torch.where(write, zbest, depth)
        tid = torch.where(write, tid_best, tid)
    return from_tiles(depth, tiles_x), from_tiles(tid, tiles_x)


def footprint_keep(
    binned, starts, counts, zfloor=None, *, fp_w: int, fp_h: int,
    samples_per_block: int, padded_height: int, padded_width: int,
    tile_h: int = 32, tile_w: int = 128,
    sample_positions: tuple = ((0.5, 0.5),), tile_row_offset: int = 0,
    row_stride: int = 1,
):
    """Plain version of the kernels' exact footprint rejection
    (csrc/raster_common.cuh): for every binned pair, in bin order, and every
    block of fp_w × fp_h pixels × `samples_per_block` samples of its tile,
    whether the corner test keeps the triangle. Returns bool
    [pairs, S / samples_per_block, tile_h / fp_h, tile_w / fp_w].

    A block is rejected when an edge plane's upper bound over the block's
    samples is < 0, or the depth plane's bound, clamped to 1, is below the
    block's smallest `zfloor` [S, Hp, Wp] (0 when None). The bounds evaluate
    each plane at the box corner that maximises it, in the kernels' rounding
    order, so a rejected block holds no sample the triangle covers at a
    depth >= the floor."""
    dev = binned.device
    tiles_x = padded_width // tile_w
    tiles_y = padded_height // tile_h
    n_s = len(sample_positions)
    n_g = n_s // samples_per_block
    counts = counts.long()
    tile = torch.repeat_interleave(torch.arange(tiles_x * tiles_y, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    col = starts.long()[tile] + torch.arange(tile.numel(), device=dev) - first[tile]
    rows = binned[:, col]
    x0, y0 = tile_grid(tiles_x, tiles_y, tile_w, tile_h, tile_row_offset,
                       row_stride, dev)
    pos = torch.tensor(sample_positions, dtype=torch.float32, device=dev)
    pos = pos.reshape(n_g, samples_per_block, 2)
    fx = torch.arange(0, tile_w, fp_w, dtype=torch.float32, device=dev)
    fy = torch.arange(0, tile_h, fp_h, dtype=torch.float32, device=dev)[:, None]

    def box_edge(origin, offsets, pixel):
        # (tile origin + in-pixel offset) + pixel index, as the kernels sum
        return (origin[tile][:, None] + offsets)[:, :, None, None] + pixel

    xlo = box_edge(x0, pos[..., 0].amin(1), fx)
    xhi = box_edge(x0, pos[..., 0].amax(1), fx + (fp_w - 1))
    ylo = box_edge(y0, pos[..., 1].amin(1), fy)
    yhi = box_edge(y0, pos[..., 1].amax(1), fy + (fp_h - 1))

    def bound(k):
        a, b, c = (rows[k + i][:, None, None, None] for i in range(3))
        return a * torch.where(a > 0, xhi, xlo) + b * torch.where(b > 0, yhi, ylo) + c

    keep = ~(bound(0) < 0) & ~(bound(3) < 0) & ~(bound(6) < 0)
    if zfloor is None:
        zmin = torch.zeros((), device=dev)
    else:
        z = to_tiles(zfloor, tile_h, tile_w).reshape(
            n_g, samples_per_block, tiles_x * tiles_y, tile_h // fp_h, fp_h,
            tile_w // fp_w, fp_w)
        zmin = z.amin(dim=(1, 4, 6)).transpose(0, 1)[tile]
    return keep & ~(torch.fmin(bound(9), torch.ones((), device=dev)) < zmin)


def check_bins(binned, starts, counts, n_tiles: int) -> None:
    dev = binned.device
    if binned.dtype != torch.float32 or binned.ndim != 2 or binned.shape[0] != B_ROWS:
        raise ValueError(f"binned must be f32 [{B_ROWS}, P], got "
                         f"{binned.dtype} {tuple(binned.shape)}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or t.shape != (n_tiles,):
            raise ValueError(f"{name} must be i32 [{n_tiles}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, binned on {dev}")
    for name, t in (("binned", binned), ("starts", starts), ("counts", counts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_tiling(padded_height, padded_width, tile_h, tile_w) -> None:
    """The kernels cut a tile into blocks of up to 128 columns × 8 rows."""
    if padded_height % tile_h or padded_width % tile_w or tile_h % 8:
        raise ValueError(f"tiling {tile_h}x{tile_w} over {padded_height}x"
                         f"{padded_width} is not supported by the kernels")
    if tile_w % 128:
        raise ValueError("tile_w must be a multiple of 128")


def rasterize_binned(
    binned: torch.Tensor,  # [B_ROWS, Pp] f32 slim SoA from binning
    starts: torch.Tensor,  # [tiles] i32
    counts: torch.Tensor,  # [tiles] i32
    *,
    tile_row_offset: int = 0,
    padded_height: int,
    padded_width: int,
    tile_h: int = 32,
    tile_w: int = 128,
    sample_positions: tuple = ((0.5, 0.5),),  # in-pixel positions (MSAA)
    row_stride: int = 1,
):
    """Per-tile-binned visibility raster. Returns (depth [S, Hp, Wp] f32,
    tri_id [S, Hp, Wp] i32). CPU tensors run the plain version; CUDA tensors
    launch K1."""
    kw = dict(tile_row_offset=tile_row_offset, padded_height=padded_height,
              padded_width=padded_width, tile_h=tile_h, tile_w=tile_w,
              sample_positions=tuple(sample_positions), row_stride=row_stride)
    if binned.device.type == "cpu":
        return rasterize_binned_plain(binned, starts, counts, **kw)
    if binned.device.type != "cuda":
        raise ValueError(f"rasterize_binned: unsupported device {binned.device}")
    n_s = len(sample_positions)
    if n_s not in (1, 2, 4, 8):
        raise ValueError(f"{n_s} sample positions; the kernel takes 1, 2, 4 or 8")
    tiles_x = padded_width // tile_w
    tiles_y = padded_height // tile_h
    check_tiling(padded_height, padded_width, tile_h, tile_w)
    check_bins(binned, starts, counts, tiles_x * tiles_y)
    dev = binned.device
    depth = torch.empty((n_s, padded_height, padded_width), dtype=torch.float32, device=dev)
    tid = torch.empty((n_s, padded_height, padded_width), dtype=torch.int32, device=dev)
    lib = kernels.load()
    spos = kernels.sample_xy(sample_positions)
    with torch.cuda.device(dev):
        err = lib.rt_rasterize_binned(
            binned.data_ptr(), binned.shape[1], starts.data_ptr(),
            counts.data_ptr(), depth.data_ptr(), tid.data_ptr(),
            tiles_x * tiles_y, tiles_x, tile_h, tile_w, padded_height,
            padded_width, int(tile_row_offset), row_stride, n_s, spos,
            kernels.current_stream())
    kernels.check_launch("rasterize_binned", err)
    profiling.count("k1")
    return depth, tid
