# Frozen copy of renderer_tpu_torch/raster/layers.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
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

from benchmark.reference.raster.raster_kernel import (
    check_bins,
    check_tiling,
    fragment,
    from_tiles,
    sample_coords,
    tile_grid,
    to_tiles,
)

#: CUDA kernel launches in this process, per mode, with the UI pass's
#: blended launches (raster/ui_stage.py) counted apart under "ui" (the plain
#: version does not count); callers reset the entries to 0 to see which
#: kernels ran
launches = {"masked": 0, "blended": 0, "ui": 0}

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


