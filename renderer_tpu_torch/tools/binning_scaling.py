"""Binning cost against pair count: `bin_triangle_classes` timed at pair
capacities 1M/2M/4M/8M on the 1080p tile grid, with a synthetic workload
sized so the ACTUAL pair count tracks capacity (~60% full, the steady state
the Renderer's grow/shrink feedback keeps), beside the stable sort alone on
the same number of keys (the sort binning runs, binning.py).

Each time is engine.stats._time_call's median of `reps` runs on the card:
"device" replays the stage captured as a CUDA graph, queued behind a spin
kernel (its device time); "host" times the eager stage as the host issues
it. It prints one JSON line: per capacity, the triangles, the actual pairs,
the device and host-paced ms of binning, and the device ms of the sort.

Run: python -m renderer_tpu_torch.tools.binning_scaling [reps] [device]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from renderer_tpu_torch.engine.stats import _time_call
from renderer_tpu_torch.interop import resolve_device
from renderer_tpu_torch.raster import binning
from renderer_tpu_torch.raster.setup import triangle_setup

GRID = dict(tiles_x=15, tiles_y=34, tile_w=128, tile_h=32)  # the 1080p grid
FILL = 0.6  # actual pairs / capacity
CAPACITIES = tuple(1 << k for k in (20, 21, 22, 23))


def _make_tri_data(n: int, w: int, h: int, rng, device="cuda"):
    """n random triangles for the REAL triangle_setup (screen-space, w = 1):
    a mix of small (sub-tile) and medium (several-tile) right triangles,
    each covering ~half its bbox, so the ragged expansion's per-row edge
    windows and the trivial reject see authentic planes. Returns (clip
    [3n, 4] f32, tri_v [n, 3] i32) on `device`."""
    x0 = rng.uniform(0, w - 2, n)
    y0 = rng.uniform(0, h - 2, n)
    medium = rng.random(n) < 0.2
    bw = np.where(medium, rng.uniform(128, 3 * 128, n), rng.uniform(2, 64, n))
    bh = np.where(medium, rng.uniform(32, 4 * 32, n), rng.uniform(2, 32, n))
    bw = np.minimum(bw, w - x0)
    bh = np.minimum(bh, h - y0)
    # right triangle on the bbox: (x0,y0) (x0,y0+bh) (x0+bw,y0), the vertex
    # order that survives setup's front-face test
    px = np.stack([x0, x0, x0 + bw], axis=1).ravel()
    py = np.stack([y0, y0 + bh, y0], axis=1).ravel()
    clip = np.zeros((3 * n, 4), np.float32)
    clip[:, 0] = 2.0 * px / w - 1.0  # setup: xs = (X/W·0.5+0.5)·width, W=1
    clip[:, 1] = 2.0 * py / h - 1.0
    clip[:, 2] = rng.uniform(0.05, 0.95, 3 * n)
    clip[:, 3] = 1.0
    tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return torch.from_numpy(clip).to(device), torch.from_numpy(tri_v).to(device)


def synthetic_tri_data(n_pairs_target: int, tiles_x: int, tiles_y: int,
                       tile_w: int, tile_h: int, seed: int = 11, device="cuda"):
    """Triangle-setup output whose RAGGED expansion demand (the quantity
    pair_capacity holds) is ~n_pairs_target, and its triangle count. Demand
    per triangle depends on the edge-plane row windows, so it is calibrated:
    a probe batch's demand is measured with bin_triangle_classes, then the
    triangle count is scaled."""
    rng = np.random.default_rng(seed)
    w, h = tiles_x * tile_w, tiles_y * tile_h

    def setup(n):
        clip, tri_v = _make_tri_data(n, w, h, rng, device)
        return triangle_setup(clip, tri_v, n, w, h)

    probe_n = 4096
    td = setup(probe_n)
    cap = 1 << 20
    out = binning.bin_triangle_classes(
        td, (0, probe_n), tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=tile_w, tile_h=tile_h, pair_capacity=cap, row_capacity=cap)
    probe_demand = int(out[5])
    if probe_demand <= 0:
        raise RuntimeError("synthetic workload produced no coverage")
    n = int(round(n_pairs_target * probe_n / probe_demand))
    return setup(n), n


def scaling(reps: int = 16, device="cuda", capacities=CAPACITIES) -> list[dict]:
    """One row a capacity (module docstring)."""
    dev = resolve_device(device)
    rows = []
    for cap in capacities:
        td, n_tris = synthetic_tri_data(int(cap * FILL), **GRID, device=dev)

        def bin_fn(td_, cap=cap, n=n_tris):
            return binning.bin_triangle_classes(
                td_, (0, n), **GRID, pair_capacity=cap, row_capacity=cap)

        out = bin_fn(td)
        actual, overflow = int(out[5]), int(out[3].sum()) + int(out[4])
        ms = {paced: _time_call(bin_fn, td, iters=reps, device=dev, paced=paced)
              for paced in ("device", "host")}
        # the sort alone on `cap` keys of the binning's key range
        keys = torch.from_numpy(np.random.default_rng(3).integers(
            0, GRID["tiles_x"] * GRID["tiles_y"], cap).astype(np.int32)).to(dev)
        sort_ms = _time_call(lambda k: torch.sort(k, stable=True), keys,
                             iters=reps, device=dev, paced="device")
        rows.append({
            "pair_capacity": cap, "triangles": n_tris, "actual_pairs": actual,
            "fill": actual / cap, "overflow": overflow,
            "binning_ms": ms["device"], "binning_host_paced_ms": ms["host"],
            "sort_ms": sort_ms, "sort_share": sort_ms / ms["device"],
        })
        del td, keys
    return rows


def main() -> None:
    args = sys.argv[1:]
    reps = int(args[0]) if args and args[0].isdigit() else 16
    device = args[-1] if args and not args[-1].isdigit() else "cuda"
    dev = resolve_device(device)
    rows = scaling(reps, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"binning_scaling": rows, "device": name, "reps": reps}),
          flush=True)


if __name__ == "__main__":
    main()
