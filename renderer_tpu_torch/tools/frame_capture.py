"""Frame capture: dump one frame's per-stage intermediate buffers as PNGs —
the RenderDoc / debug-utils analog. The reference names every Vulkan object
so capture tooling can inspect the frame (debug_utils.rs:16-28); this tool
re-runs the frame's own stage functions (vertex → setup → binning → the
visibility raster K1 → the layered captures K2, masked and blended) and
writes the intermediate arrays themselves. It runs on the card unless it is
given device "cpu".

Outputs in OUT_DIR (PNGs through assets/png.py):
  00-final.png        the composed frame (Renderer output, lit mode)
  01-visibility.png   sample-0 triangle-id visibility buffer, hashed colors
                      (the per-TRIANGLE analog of debug mode 2's per-draw hash)
  02-depth.png        sample-0 reverse-Z depth, white = near, black = far/bg
  03-bins.png         binning heatmap: (tile, triangle) pairs per screen tile
                      (white = the frame's busiest tile), all classes summed
  04-mask-demand.png / 05-blend-demand.png  per-pixel fragment demand of the
                      layered masked/blended captures (white = deepest stack;
                      only written when the scene has that alpha class)
  capture.json        stats vector, per-class pair counts, capacities, the
                      busiest-tile coordinate

Run from the repository root:
  python -m renderer_tpu_torch.tools.frame_capture OUT_DIR [triangle|sandbox] [game_time] [device]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from renderer_tpu_torch.assets import png

DUMPS = ("00-final.png", "01-visibility.png", "02-depth.png", "03-bins.png",
         "04-mask-demand.png", "05-blend-demand.png")


def _gray(x: np.ndarray, lo=None, hi=None) -> np.ndarray:
    x = np.asarray(x, np.float32)
    lo = float(x.min()) if lo is None else lo
    hi = float(x.max()) if hi is None else hi
    if hi <= lo:
        hi = lo + 1.0
    return (np.clip((x - lo) / (hi - lo), 0.0, 1.0) * 255.0).astype(np.uint8)


def _hash_colors(ids: np.ndarray) -> np.ndarray:
    """Per-id hashed color (the main.vert:67-77 hash, applied to triangle ids
    instead of draw ids); id < 0 = background = black."""
    d = 1.0 + ids.astype(np.float64)

    def rnd(x):
        return np.mod(np.sin(x) * 43758.5453123, 1.0)

    rgb = np.stack(
        [rnd(d * 641.65433), rnd(d * 1864.251623), rnd(d * 182362.365)], axis=-1
    )
    rgb = np.where((ids >= 0)[..., None], rgb, 0.0)
    return (rgb * 255.0).astype(np.uint8)


def _scene(scene_name, game_time, config, sandbox, device):
    """(registry, scene, config) of the named scene."""
    import renderer_tpu_torch as rt

    if scene_name == "triangle":
        from renderer_tpu_torch.apps.triangle import build_scene, build_triangle_assets

        registry, meshes, material = build_triangle_assets()
        return (registry, build_scene(meshes, material),
                config or rt.RenderConfig(width=640, height=480))
    if scene_name == "sandbox":
        if sandbox is None:
            from renderer_tpu_torch.apps.sandbox import Sandbox

            sandbox = Sandbox(device=device)
        return (sandbox.registry, sandbox.build_scene(float(game_time)),
                config or rt.RenderConfig(width=1280, height=720))
    raise ValueError(f"unknown scene {scene_name!r} (triangle|sandbox)")


def capture(out_dir, scene_name: str = "triangle", game_time: float = 1.0,
            config=None, sandbox=None, device="cuda") -> dict:
    """Render one frame and write the stage dumps. `sandbox` is the scene
    source of "sandbox" (default: apps.sandbox.Sandbox on `device`).
    Returns the summary written to capture.json, plus what capture.json
    leaves out: "dumps", each PNG's array as written, and "buffers", the
    re-run's tensors on the device (the bins; the pair and tile-row
    demand; K1's outputs; per layered mode, its class, n_layers and K2's
    outputs)."""
    import renderer_tpu_torch as rt
    from renderer_tpu_torch.raster import binning, layers, raster_kernel, setup, vertex_stage
    from renderer_tpu_torch.scene import draw_stream

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    registry, scene, config = _scene(scene_name, game_time, config, sandbox, device)
    renderer = rt.Renderer(registry, config, overflow_policy="sync", device=device)
    dumps = {}

    def save(name, arr):
        dumps[name] = arr
        png.write_png(out / name, arr)

    # final image first ("sync" leaves cfg right-sized, so the stage re-run
    # below bins at the same capacities the composed frame used)
    img = renderer.render_frame(scene, debug_mode=0)
    cfg = renderer.config
    save(DUMPS[0], img)

    # the renderer's own frame preparation (identical to _dispatch)
    fv = draw_stream.frame_view(scene)
    gs, geom_dev = renderer._geometry(scene, fv.order, fv.geom_key)
    frame = renderer._frame_arrays(scene, fv, gs)
    frame = draw_stream.unpack_frame(frame, morph_k=gs.morph_k,
                                     joint_cap=renderer._joint_cap(scene))

    # stage 1: vertex transform (+skinning/morphs)
    vs = vertex_stage.run_vertex_stage(geom_dev, frame, gs.skin_start,
                                       morph_k=gs.morph_k)

    # stage 2: clipless triangle setup
    tri_data = setup.triangle_setup(vs["clip"], geom_dev["tri_v"],
                                    frame["num_tris"], cfg.width, cfg.height)

    # stage 3: one-sort multi-class binning
    has_masked = gs.num_masked_tris > 0
    has_blended = gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris
    bounds = [0, frame["n_opaque"]]
    if has_masked:
        bounds.append(frame["n_opaque"] + frame["n_masked"])
    if has_blended:
        bounds.append(frame["num_tris"])
    b_all, s_all, c_all, ov_all, _row_ov, pair_demand, row_demand = \
        binning.bin_triangle_classes(
            tri_data, tuple(bounds), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h,
            pair_capacity=cfg.pair_capacity, row_capacity=cfg.row_capacity,
        )
    counts = c_all.cpu().numpy()  # [C, tiles]
    per_tile = counts.sum(axis=0).reshape(cfg.tiles_y, cfg.tiles_x)
    heat = np.kron(_gray(per_tile, lo=0.0), np.ones((8, 8), np.uint8))
    save(DUMPS[3], heat)

    # stage 4: sample-0 visibility raster (depth + triangle ids), K1
    kw = dict(padded_height=cfg.padded_height, padded_width=cfg.padded_width,
              tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    zs, ts = raster_kernel.rasterize_binned(b_all, s_all[0], c_all[0], **kw)
    tid = ts[0].cpu().numpy()[: cfg.height, : cfg.width]
    z = zs[0].cpu().numpy()[: cfg.height, : cfg.width]
    save(DUMPS[1], _hash_colors(tid))
    # reverse-Z: higher = nearer; background stays at the clear value 0
    save(DUMPS[2], _gray(z, lo=0.0))
    buffers = {"bins": (b_all, s_all, c_all), "demand": (pair_demand, row_demand),
               "k1": (zs, ts)}

    # layered captures (K2): per-pixel fragment demand maps
    cls_i = 1
    demand_paths = {}
    for flag, mode, n_layers, name in (
        (has_masked, "masked", cfg.mask_layers, DUMPS[4]),
        (has_blended, "blended", cfg.blend_layers, DUMPS[5]),
    ):
        if not flag:
            continue
        lz, lt, aux = layers.rasterize_layers(
            b_all, s_all[cls_i], c_all[cls_i], zs, mode=mode,
            n_layers=n_layers, **kw)
        demand = aux[0].cpu().numpy()[: cfg.height, : cfg.width]
        save(name, _gray(demand, lo=0.0))
        demand_paths[mode] = name
        buffers[mode] = (cls_i, n_layers, (lz, lt, aux))
        cls_i += 1

    stats = renderer.frame_stats()
    busiest = int(per_tile.argmax())
    summary = {
        "scene": scene_name,
        "resolution": [cfg.width, cfg.height],
        "msaa": cfg.msaa_samples,
        "num_tris": int(gs.num_tris),
        "pairs_per_class": counts.sum(axis=1).tolist(),
        "overflow_per_class": ov_all.cpu().numpy().tolist(),
        "pair_capacity": cfg.pair_capacity,
        "busiest_tile": [busiest % cfg.tiles_x, busiest // cfg.tiles_x],
        "busiest_tile_pairs": int(per_tile.max()),
        "stats": stats,
        "layer_demand_maps": demand_paths,
    }
    (out / "capture.json").write_text(json.dumps(summary, indent=1))
    return {**summary, "dumps": dumps, "buffers": buffers}


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else "frame_capture"
    scene = sys.argv[2] if len(sys.argv) > 2 else "triangle"
    t = float(sys.argv[3]) if len(sys.argv) > 3 else 1.0
    device = sys.argv[4] if len(sys.argv) > 4 else "cuda"
    summary = capture(out, scene, t, device=device)
    del summary["dumps"], summary["buffers"]
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
