# Restated per frame from renderer_tpu_torch/tools/frontend_probe.py
# `frontend_work` at commit 5822f29: the same bytes a step, counted on the
# reference's own setup and binning of the frame (benchmark/reference/frame.py
# `probe`) instead of a record of the port's calls. Part of the benchmark's
# yardstick; do not edit.
"""Work of the front end's hand-written kernels (F1 setup; F2 spans and
rows, F3 pairs, F4 scan and scatter) in one frame: each input read once and
each output written once, per triangle only the valid triangles of the
frame's bounds (F2 spans' tri_info only those with rows), per row the live
rows, per pair the live and the kept pairs. The two cumsums and the sort
between the kernels are library calls, counted with the torch ops, not
here. The operations, a few tens a row or pair, are far below the bytes'
time: each step is counted as bytes alone."""

from __future__ import annotations

import torch

from benchmark.reference.raster import binning, setup


def count(probe: dict, cfg) -> list:
    """[(step, operations, bytes)] of one frame's front-end kernels."""
    td, bounds = probe["tri_data"], probe["bounds"]
    tri_v = probe["geom"]["tri_v"]
    tc = td.shape[1]
    rc, pc = cfg.row_capacity, cfg.pair_capacity
    counts = probe["c_all"]
    n_classes, n_tiles = counts.shape
    n_keys = n_classes * n_tiles
    idx = torch.arange(tc, device=td.device)
    valid = int(((td[setup.VALID_ROW] > 0) & (idx >= bounds[0]) & (idx < bounds[-1])).sum())
    rows = min(int(probe["row_demand"]), rc)
    pairs = min(int(probe["pair_demand"]), pc)
    kept = int(counts.sum())
    z_rows = 12 if cfg.opaque_z_buckets > 1 else 0
    with_rows = int((binning.band_rows(td, bounds, n_classes, tiles_x=cfg.tiles_x,
                                       tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                                       tile_h=cfg.tile_h)[3] > 0).sum())
    binned = probe["b_all"]
    steps = {
        "F1 setup": 12 * tc + 16 * int(torch.unique(tri_v).numel()) + 96 * tc,
        "F2 spans": (4 * tc + valid * (16 + z_rows) + 4 * tc + 16 * with_rows
                     + 4 * (n_keys + n_classes + 1)),
        "F2 rows": 4 * tc + valid * 64 + 4 * rc + 16 * rows,
        "F3 pairs": 4 * rc + 20 * rows + 36 * valid + 4 * pc + 4 * pairs + 4 * n_keys,
        "F4 scan": 4 * (n_keys + n_classes + 1) + 4 * (2 * n_keys + n_classes + 3) + 8,
        "F4 scatter": 12 * kept + 60 * min(kept, valid) + 12 * n_keys + binned.numel() * 4,
    }
    return [(name, 0, b) for name, b in steps.items()]
