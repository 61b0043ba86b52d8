"""Multi-device binning work count: how binning's work divides under the sp
tile-row sharding of parallel/mesh.py.

For one frame it bins the whole screen, then each shard's tile rows for sp
in {2, 4, 8}, contiguous and interleaved, and reports the per-device
(triangle, tile-row) and (tile, triangle) expansion demands: the widths
each device's pair sort and bin scatter run at. The shards partition the
full-screen expansion exactly (asserted), so the max-per-device column is
the per-device cost. Then dp×sp: two frames of the timeline over dp=2
groups, with per_shard_config's bucket and whether the demand fits it.

Scenes, rendered at 1920×1080 and binned at 1920×1024 (the multi-device
shape: 32 tile rows divide 2, 4, 8), as the JAX package's
tools/shard_workcount.py does:
- "triangle": the two-triangle scene that the benchmark falls back to
  without the Sponza assets (bench.build_triangle_bench);
- "stress": scene A's >1M-triangle stress field (demo_scenes.stress_scene),
  which loads the shards far more.

    python -m renderer_tpu_torch.tools.shard_workcount [triangle|stress]
        [device] [sp ...]        (defaults: triangle cuda 2 4 8)
"""

from __future__ import annotations

import sys
from dataclasses import replace

import torch

W, H = 1920, 1080  # the renderer's frame (camera aspect)
BIN_H = 1024  # the binned height: height == padded_height, 32 tile rows


def build(scene_name: str, device):
    """(name, renderer, make_scene(t)) of one scene at W×H."""
    import renderer_tpu_torch as rt

    if scene_name == "triangle":
        from renderer_tpu_torch.apps.triangle import build_scene, build_triangle_assets

        registry, meshes, material = build_triangle_assets()
        config = rt.RenderConfig(width=W, height=H)

        def make_scene(game_time: float):
            return build_scene(meshes, material)
    elif scene_name == "stress":
        from renderer_tpu_torch.assets import demo_scenes

        registry, scene = demo_scenes.stress_scene()
        config = rt.RenderConfig(width=W, height=H, max_triangles=1 << 21,
                                 pair_capacity=1 << 20, row_capacity=1 << 20)

        def make_scene(game_time: float):
            return scene
    else:
        raise ValueError(f"unknown scene {scene_name!r} (triangle | stress)")
    renderer = rt.Renderer(registry, config.validate(), overflow_policy="off",
                           device=device)
    return f"{scene_name}-{W}x{BIN_H}", renderer, make_scene


def frame_demands(renderer, scene, cfg):
    """demands(tile_row_lo, local_tiles_y, row_stride) -> (pair demand,
    tile-row demand) of one frame's binning over those tile rows, set up
    and binned at `cfg`'s size."""
    from renderer_tpu_torch.parallel.mesh import frame_inputs
    from renderer_tpu_torch.raster import binning, setup, vertex_stage
    from renderer_tpu_torch.scene import draw_stream

    gs, geom, frame, _mats, joint_cap = frame_inputs(renderer, scene)
    frame = draw_stream.unpack_frame(frame, morph_k=gs.morph_k, joint_cap=joint_cap)
    vs = vertex_stage.run_vertex_stage(geom, frame, skin_start=gs.skin_start,
                                       morph_k=gs.morph_k)
    td = setup.triangle_setup(vs["clip"], geom["tri_v"], frame["num_tris"],
                              cfg.width, cfg.height,
                              bbox_pad=(0.5 if cfg.msaa_samples > 1 else 0.0))
    bounds = [0, frame["n_opaque"]]
    if gs.num_masked_tris > 0:
        bounds.append(frame["n_opaque"] + frame["n_masked"])
    if gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris:
        bounds.append(frame["num_tris"])
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
              tile_h=cfg.tile_h, pair_capacity=cfg.pair_capacity,
              row_capacity=cfg.row_capacity)

    def demands(tile_row_lo, local_tiles_y, row_stride=1):
        out = binning.bin_triangle_classes(
            td, tuple(bounds), tile_row_lo=tile_row_lo,
            local_tiles_y=local_tiles_y, row_stride=row_stride, **kw)
        _b, _s, _c, ov, row_ov, pair_dem, row_dem = out
        assert int(ov.sum()) == 0 and int(row_ov) == 0
        return int(pair_dem), int(row_dem)

    return demands


def main(scene_name: str = "triangle", device="cuda",
         shard_counts=(2, 4, 8)) -> list[dict]:
    from renderer_tpu_torch.parallel.mesh import per_shard_config

    name, renderer, make_scene = build(scene_name, torch.device(device))
    cfg = replace(renderer.config, height=BIN_H).validate()
    # the timeline's first timed frame
    demands = frame_demands(renderer, make_scene(1.0), cfg)
    full_pairs, full_rows = demands(0, cfg.tiles_y)
    rows = [{"sp": 1, "pairs_per_dev_max": full_pairs,
             "rows_per_dev_max": full_rows, "pairs_sum": full_pairs,
             "speedup_vs_replicated": 1.0}]
    print(f"# scene {name}: frame t=1.0, {cfg.tiles_y} tile rows, "
          f"full-screen demand {full_pairs} pairs / {full_rows} tile-rows")
    print(f"{'sp':>3} {'layout':>12} {'pairs/dev (max)':>16} "
          f"{'rows/dev (max)':>15} {'sum(pairs)':>11} {'work vs replicated':>19}")
    print(f"{1:>3} {'-':>12} {full_pairs:>16} {full_rows:>15} "
          f"{full_pairs:>11} {'1.00x (baseline)':>19}")
    for sp in shard_counts:
        if cfg.tiles_y % sp:
            print(f"{sp:>3}  (skipped: {cfg.tiles_y} tile rows not divisible)")
            continue
        local = cfg.tiles_y // sp
        for layout, per in (
            ("contiguous", [demands(k * local, local) for k in range(sp)]),
            ("interleaved", [demands(k, local, sp) for k in range(sp)]),
        ):
            pmax = max(p for p, _ in per)
            rmax = max(r for _, r in per)
            psum = sum(p for p, _ in per)
            assert psum == full_pairs, (psum, full_pairs)  # exact partition
            assert sum(r for _, r in per) == full_rows
            rows.append({"sp": sp, "layout": layout, "pairs_per_dev_max": pmax,
                         "rows_per_dev_max": rmax, "pairs_sum": psum,
                         "speedup_vs_replicated": round(full_pairs / max(pmax, 1), 2)})
            print(f"{sp:>3} {layout:>12} {pmax:>16} {rmax:>15} {psum:>11} "
                  f"{full_pairs / max(pmax, 1):>17.2f}x")

    # dp×sp: each dp group runs the same sp sharding on its own frame, so
    # the per-device demand is the max over the batch's frames (dp=2 frames
    # of the timeline), and per_shard_config's bucket must hold that max
    dp = 2
    sp = max(s for s in shard_counts if cfg.tiles_y % s == 0) // dp
    if sp >= 2:
        local = cfg.tiles_y // sp
        d2 = frame_demands(renderer, make_scene(2.0), cfg)  # a second camera/time
        for layout, stride in (("contiguous", 1), ("interleaved", sp)):
            per = []
            for dem in (demands, d2):
                per += [dem(k * (local if stride == 1 else 1), local, stride)
                        for k in range(sp)]
            pmax = max(p for p, _ in per)
            rmax = max(r for _, r in per)
            shard_cfg = per_shard_config(cfg, sp)
            fits = pmax <= shard_cfg.pair_capacity and rmax <= shard_cfg.row_capacity
            rows.append({"dp": dp, "sp": sp, "layout": layout,
                         "pairs_per_dev_max": pmax, "rows_per_dev_max": rmax,
                         "per_shard_pair_capacity": shard_cfg.pair_capacity,
                         "per_shard_fits": fits})
            print(f"dp×sp=({dp},{sp}) {layout:>12} {pmax:>16} {rmax:>15} "
                  f"{'':>11} per-shard bucket {shard_cfg.pair_capacity}"
                  f" {'OK' if fits else 'OVERFLOWS'}")
    return rows


if __name__ == "__main__":
    argv = sys.argv[1:]
    scene_arg = argv.pop(0) if argv and not argv[0].isdigit() else "triangle"
    dev_arg = argv.pop(0) if argv and not argv[0].isdigit() else "cuda"
    main(scene_arg, dev_arg, tuple(int(a) for a in argv) or (2, 4, 8))
