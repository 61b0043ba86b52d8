"""Host-prologue breakdown: the per-frame CPU cost of the frame loop BEFORE
the frame is queued (scene rebuild + animation + sort/merge/pack), the
analog of the reference's ~120 µs CPU frame cost (README.md:85-87: ~20 µs
queue + ~100 µs Vulkan submission). Each stage is the median of `reps`
runs on the host clock; nothing is rendered.

The scene source is `sandbox=` (default: the sandbox assets, or the
mini-sandbox of assets/demo_scenes.py when they are absent), on a
1920×1080, 4×MSAA renderer on `device` (its geometry is uploaded once).
The sort, the pack and the animation run on the host library
(tools/native.py) when it is there, on their numpy plain versions inside
`native.plain()`; `host_library` names which. It prints one JSON line.

Run: python -m renderer_tpu_torch.tools.prologue_probe [reps] [device]
"""

from __future__ import annotations

import json
import sys
import time


def median_us(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    ts.sort()
    return ts[len(ts) // 2]


def _default_source(device):
    from renderer_tpu_torch.apps.sandbox import Sandbox
    from renderer_tpu_torch.assets.demo_scenes import MiniSandbox
    from renderer_tpu_torch.assets.gltf_loader import GltfLoadingError

    try:
        return Sandbox(device=device)
    except (OSError, GltfLoadingError) as e:
        print(f"# sandbox assets unavailable ({type(e).__name__}: {e}); "
              "probing the mini-sandbox", file=sys.stderr)
        return MiniSandbox()


def main(reps: int = 200, sandbox=None, device="cuda") -> dict:
    import renderer_tpu_torch as rt
    from renderer_tpu_torch.apps.sandbox import orbit_camera
    from renderer_tpu_torch.scene import draw_stream
    from renderer_tpu_torch.tools import native

    sb = sandbox if sandbox is not None else _default_source(device)
    renderer = rt.Renderer(sb.registry, rt.RenderConfig(
        width=1920, height=1080, msaa_samples=4), overflow_policy="off",
        device=device)

    pooled = [None]

    def make_scene(game_time):
        scene = pooled[0] = sb.build_scene(game_time, scene=pooled[0])
        pos, orient = orbit_camera(0.25 * game_time)
        scene.camera.position = pos
        scene.camera.orientation = orient
        return scene

    # warm every cache (compiled animations, walk arrays, draw blocks, the
    # device geometry)
    scene = make_scene(1.0)
    fv = draw_stream.frame_view(scene)
    gs, _dev = renderer._geometry(scene, fv.order, fv.geom_key)
    meta = (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris, 0)
    pv = renderer._proj_view(scene)

    t = {"build_scene_us": median_us(lambda: make_scene(1.01), reps)}
    scene = make_scene(1.0)
    t["frame_view_us"] = median_us(lambda: draw_stream.frame_view(scene), reps)
    fv = draw_stream.frame_view(scene)
    jc = renderer._joint_cap(scene)
    t["pack_blob_us"] = median_us(
        lambda: draw_stream.pack_frame_blob(fv, scene.joint_palette, pv, meta,
                                            morph_k=gs.morph_k, joint_cap=jc),
        reps,
    )
    t["camera_us"] = median_us(lambda: renderer._proj_view(scene), reps)

    def full():
        s = make_scene(1.02)
        f = draw_stream.frame_view(s)
        draw_stream.pack_frame_blob(f, s.joint_palette, renderer._proj_view(s),
                                    meta, morph_k=gs.morph_k, joint_cap=jc)

    t["full_prologue_us"] = median_us(full, reps)
    t["draws"] = scene.draw_count
    t["scene_source"] = type(sb).__name__
    t["host_library"] = native.status()["path"]  # "native" or "numpy"
    print(json.dumps(t), flush=True)
    return t


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200,
         device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
