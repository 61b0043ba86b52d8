"""Layered raster for non-opaque geometry: kernel K2 and its plain PyTorch
version.

The reference renders alpha-to-coverage ("masked") and blended geometry
through the same fixed-function raster path with different pipeline state
(pipeline_parameters.rs:227-233 — a2c and blended both inherit depth test
GREATER_OR_EQUAL *and depth write* from the opaque pipelines, drawn after
opaque in pipeline order, renderer.rs:433-441). In a visibility-buffer
renderer those passes cannot be a single winner-takes-all z-test:

- **Masked** (alpha cutoff): the fragment shader may discard, so the raster
  result is "the nearest fragment whose alpha passes". Failed fragments never
  write depth, so the result is order-independent → capture the top-K nearest
  candidate fragments per sample above the opaque floor (insertion, `≥` on
  ties keeps later submissions first), alpha-test them in the deferred
  stage, take the nearest passer. aux counts the candidates.
- **Blended**: src-alpha blending is order-dependent and depth-write prunes:
  a fragment is accepted iff its depth ≥ the running chain depth
  (submission order). The accepted chain (up to K layers, in order) is
  captured per sample, shaded deferred and composited in order. Only a
  stored fragment writes the chain depth; aux counts every accept.

Both walk each tile's bin strictly in submission order. `rasterize_layers`
dispatches on the tensors' device: CPU tensors take the plain version, CUDA
tensors the hand-written kernel (csrc/layers.cu).
"""

from __future__ import annotations

import torch

from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.raster.raster_kernel import (
    check_bins,
    check_tiling,
    fragment,
    from_tiles,
    sample_coords,
    tile_grid,
    to_tiles,
)

#: K2's launch counters in profiling.COUNTERS, per mode, with the UI pass's
#: blended launches (raster/ui_stage.py) counted apart under "ui" (the plain
#: version does not count)
LAUNCHES = ("masked", "blended", "ui")
profiling.register_launches(LAUNCHES)

#: largest layer count the kernel is instantiated for (the Renderer's
#: growth ceiling, engine/renderer.py MAX_LAYERS)
MAX_KERNEL_LAYERS = 16


def rasterize_layers_plain(
    binned, starts, counts, depth_in, *, mode: str, n_layers: int,
    tile_row_offset: int = 0, padded_height: int, padded_width: int,
    tile_h: int = 32, tile_w: int = 128,
    sample_positions: tuple = ((0.5, 0.5),), row_stride: int = 1,
):
    """Plain PyTorch version of K2: steps through bin position i, in order,
    on all tiles at once."""
    assert mode in ("masked", "blended")
    dev = binned.device
    tiles_x = padded_width // tile_w
    tiles_y = padded_height // tile_h
    n_s = len(sample_positions)
    n_tiles = tiles_x * tiles_y
    x0, y0 = tile_grid(tiles_x, tiles_y, tile_w, tile_h, tile_row_offset,
                       row_stride, dev)
    px, py = sample_coords(sample_positions, x0, y0, tile_h, tile_w)
    shape = (n_s, n_tiles, tile_h, tile_w)
    lz = [torch.full(shape, -1.0, dtype=torch.float32, device=dev)
          for _ in range(n_layers)]
    lt = [torch.full(shape, -1, dtype=torch.int32, device=dev)
          for _ in range(n_layers)]
    aux = torch.zeros(shape, dtype=torch.int32, device=dev)
    cur_z = to_tiles(depth_in, tile_h, tile_w)
    pp = binned.shape[1]
    starts = starts.long()
    counts = counts.long()
    max_count = int(counts.max()) if n_tiles else 0
    neg_z = torch.full(shape, -1.0, dtype=torch.float32, device=dev)
    neg_t = torch.full(shape, -1, dtype=torch.int32, device=dev)
    for i in range(max_count):
        rows = binned[:, torch.clamp(starts + i, max=pp - 1)]  # [B_ROWS, T]

        def row(k):
            return rows[k][None, :, None, None]  # [1, T, 1, 1]

        cover, z, tid = fragment(row, px, py)
        live = (i < counts)[None, :, None, None]
        c = cover & live & (z >= cur_z)
        if mode == "masked":
            aux = aux + c.to(torch.int32)
            cz = torch.where(c, z, neg_z)
            ct = torch.where(c, tid, neg_t)
            for k in range(n_layers):
                lzk, ltk = lz[k], lt[k]
                sw = cz >= lzk
                lz[k] = torch.where(sw, cz, lzk)
                lt[k] = torch.where(sw, ct, ltk)
                cz = torch.where(sw, lzk, cz)
                ct = torch.where(sw, ltk, ct)
        else:
            nacc = aux
            stored = c & (nacc < n_layers)
            for k in range(n_layers):
                put = c & (nacc == k)
                lt[k] = torch.where(put, tid, lt[k])
                lz[k] = torch.where(put, z, lz[k])
            aux = nacc + c.to(torch.int32)
            cur_z = torch.where(stored, z, cur_z)
    lz_img = from_tiles(torch.stack(lz, dim=1), tiles_x)
    lt_img = from_tiles(torch.stack(lt, dim=1), tiles_x)
    return lz_img, lt_img, from_tiles(aux, tiles_x)


def rasterize_layers(
    binned: torch.Tensor,  # [B_ROWS, Pp] f32 slim SoA (binning output)
    starts: torch.Tensor,
    counts: torch.Tensor,
    depth_in: torch.Tensor,  # [S, Hp, Wp] f32 — per-sample depth floor
    *,
    mode: str,
    n_layers: int,
    tile_row_offset: int = 0,
    padded_height: int,
    padded_width: int,
    tile_h: int = 32,
    tile_w: int = 128,
    sample_positions: tuple = ((0.5, 0.5),),  # in-pixel positions (MSAA)
    row_stride: int = 1,
    launch_key: str | None = None,  # launch counter (default: mode)
):
    """Returns (layer_z [S,K,Hp,Wp] f32, layer_tid [S,K,Hp,Wp] i32,
    aux [S,Hp,Wp] i32 — per-(sample, pixel) candidate/accept count;
    aux > n_layers marks pixels whose capture was truncated). Layer order:
    masked = nearest first; blended = acceptance (submission) order."""
    if mode not in ("masked", "blended"):
        raise ValueError(f"mode must be 'masked' or 'blended', got {mode!r}")
    n_s = len(sample_positions)
    if depth_in.shape != (n_s, padded_height, padded_width):
        raise ValueError(f"depth_in shape {tuple(depth_in.shape)} != "
                         f"{(n_s, padded_height, padded_width)}")
    kw = dict(mode=mode, n_layers=n_layers, tile_row_offset=tile_row_offset,
              padded_height=padded_height, padded_width=padded_width,
              tile_h=tile_h, tile_w=tile_w,
              sample_positions=tuple(sample_positions), row_stride=row_stride)
    if binned.device.type == "cpu":
        return rasterize_layers_plain(binned, starts, counts, depth_in, **kw)
    if binned.device.type != "cuda":
        raise ValueError(f"rasterize_layers: unsupported device {binned.device}")
    if not 1 <= n_layers <= MAX_KERNEL_LAYERS:
        raise ValueError(f"n_layers={n_layers}; the kernel takes 1..{MAX_KERNEL_LAYERS}")
    if n_s not in (1, 2, 4, 8):
        raise ValueError(f"{n_s} sample positions; the kernel takes 1, 2, 4 or 8")
    tiles_x = padded_width // tile_w
    tiles_y = padded_height // tile_h
    check_tiling(padded_height, padded_width, tile_h, tile_w)
    check_bins(binned, starts, counts, tiles_x * tiles_y)
    if (depth_in.dtype != torch.float32 or depth_in.device != binned.device
            or not depth_in.is_contiguous()):
        raise ValueError("depth_in must be a contiguous f32 tensor beside binned")
    dev = binned.device
    lz = torch.empty((n_s, n_layers, padded_height, padded_width),
                     dtype=torch.float32, device=dev)
    lt = torch.empty((n_s, n_layers, padded_height, padded_width),
                     dtype=torch.int32, device=dev)
    aux = torch.empty((n_s, padded_height, padded_width), dtype=torch.int32, device=dev)
    lib = kernels.load()
    spos = kernels.sample_xy(sample_positions)
    with torch.cuda.device(dev):
        err = lib.rt_rasterize_layers(
            binned.data_ptr(), binned.shape[1], starts.data_ptr(),
            counts.data_ptr(), depth_in.data_ptr(), lz.data_ptr(),
            lt.data_ptr(), aux.data_ptr(), int(mode == "masked"), n_layers,
            tiles_x * tiles_y, tiles_x, tile_h, tile_w, padded_height,
            padded_width, int(tile_row_offset), row_stride, n_s, spos,
            kernels.current_stream())
    kernels.check_launch(f"rasterize_layers[{mode}]", err)
    profiling.count(launch_key or mode)
    return lz, lt, aux
