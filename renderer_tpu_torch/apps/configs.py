"""The benchmark-configuration matrix of BASELINE.json (`configs`), runnable
end to end on the port: the rows, names, cameras and RenderConfigs of the
JAX package's apps/configs.py, each rendered with overflow_policy "off".

Each row renders one warm-up frame, then times its frame loop: on the card
with CUDA events around the whole loop (nothing in the loop waits for the
device), on the CPU with time.perf_counter. After the loop it reads the last
frame's stats (`frame_stats`, and `dropped_pairs` / `dropped_rows`, the
binning work the frame dropped). `results.json` is written first, then one
PNG a row.

Rows 2-6 render the sandbox assets (Sponza and Smol Ame) from the `sandbox`
scene source (default: apps.sandbox.Sandbox on `device`); row 10 renders
testbox.glb. Where the assets are absent, each such row prints one
`# <row> unavailable (...)` line and is skipped. Rows 2-4 also need the
source's `sponza` and `smol_ame` glTF scenes; rows 5, 5b and 6 only its
`build_scene(t)`.

Run: python -m renderer_tpu_torch.apps.configs [outdir] [frames] [device]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

import renderer_tpu_torch as rt
from renderer_tpu_torch.assets import demo_scenes, png, proxy
from renderer_tpu_torch.assets.gltf_loader import GltfLoadingError
from renderer_tpu_torch.core import math3d
from renderer_tpu_torch.interop import resolve_device

FLY_BATCH = 16  # row 6's frames a render_frames_device call


def loop_ms(device, run, n: int) -> float:
    """Milliseconds per call of run(i), i = 0..n-1, one after the other: on
    the card CUDA events around the whole loop, with no host sync inside
    it; on the CPU time.perf_counter."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            run(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for i in range(n):
        run(i)
    return (time.perf_counter() - t0) * 1e3 / n


def timed_frames(renderer, scene_at, mode: int, frames: int):
    """A warm-up frame of scene_at(0), then `frames` timed frames of
    scene_at(i + 1). Returns (the last device image, ms a frame)."""
    out = [renderer.render_frame_device(scene_at(0), mode)]

    def run(i):
        out[0] = renderer.render_frame_device(scene_at(i + 1), mode)

    ms = loop_ms(renderer.device, run, frames)
    return out[0], ms


def timed_batches(renderer, scenes, reps: int):
    """A warm-up render_frames_device call (on the card it captures the
    frame's CUDA graph), then `reps` timed calls. Returns (the last
    batch's first device image, ms a frame)."""
    out = [renderer.render_frames_device(scenes, debug_mode=0)[0]]

    def run(_):
        out[0] = renderer.render_frames_device(scenes, debug_mode=0)[0]

    ms = loop_ms(renderer.device, run, reps) / len(scenes)
    return out[0][0], ms


def fixed(scene):
    """The scene_at of timed_frames for a scene that does not change."""
    return lambda _i: scene


def _aimed(scene, eye, target):
    scene.camera.position, scene.camera.orientation = math3d.look_at(
        np.asarray(eye, np.float32), np.asarray(target, np.float32),
        np.array([0, 1, 0], np.float32))
    return scene


def _renderer(registry, device, base: dict, config: dict):
    return rt.Renderer(registry, rt.RenderConfig(**{**base, **config}),
                       overflow_policy="off", device=device)


def triangle_row(device="cuda", **config):
    """Row 1: the single hardcoded triangle at 800×600 (renderer, scene)."""
    from renderer_tpu_torch.apps import triangle

    registry, meshes, material = triangle.build_triangle_assets()
    renderer = _renderer(registry, device, dict(width=800, height=600), config)
    return renderer, triangle.build_scene(meshes, material)


def stress_row(device="cuda", n_meshes: int = 32, tris_per_mesh: int = 32768,
               **config):
    """Row 7: the >1M-triangle stress field through the whole pipeline
    (renderer, scene). About 607k pairs and 604k tile-rows for this camera
    (tiny triangles: the ragged expansion equals the bbox one here); 1<<20
    keeps 1.7× headroom on both axes."""
    registry, scene = demo_scenes.stress_scene(n_meshes, tris_per_mesh)
    renderer = _renderer(registry, device, dict(
        width=1920, height=1080, max_triangles=1 << 21, pair_capacity=1 << 20,
        row_capacity=1 << 20), config)
    return renderer, scene


def overdraw_row(device="cuda", n_layers: int = 8000, n_meshes: int = 32,
                 tris_per_mesh: int = 32768, **config):
    """Row 8, the pair-capacity stress: the stress field PLUS an
    `n_layers`-layer screen-spanning overdraw stack (pairs ≈ layers · 2 ·
    covered tiles), at row 7's camera (renderer, scene). The bbox
    expansion is ~4.3M pairs; the ragged expansion needs about 1.75M pairs
    and 759k tile-rows (the quads' row windows shed the tiles outside the
    stack); 1<<21 / 1<<20 keep ~20% / 38% headroom."""
    registry, builder = rt.MaterialRegistry(), rt.VertexLibraryBuilder()
    omesh, omat, otransforms = proxy.make_overdraw_stack(
        builder, registry, n_layers=n_layers)
    scene = demo_scenes.stress_field_scene(builder, registry, n_meshes, tris_per_mesh)
    builder.build()
    renderer = _renderer(registry, device, dict(
        width=1920, height=1080, max_triangles=1 << 21, pair_capacity=1 << 21,
        row_capacity=1 << 20), config)
    scene.queue_instanced(omesh, omat, otransforms)
    return renderer, scene


def morph_weights(t: float) -> np.ndarray:
    """Row 9's two blend-shape weights at time t."""
    return np.array([0.5 + 0.5 * np.sin(2.0 * t), 0.5 + 0.5 * np.cos(1.3 * t)],
                    np.float32)


def morph_row(device="cuda", n: int = 48, **config):
    """Row 9: the blend-shape sheet (n × n cells) driven by per-frame
    weights at 640×480 (renderer, scene_at(t)). Each frame re-queues the
    sheet with new weights; the delta-bank tap runs in the vertex stage on
    the device."""
    registry, builder = rt.MaterialRegistry(), rt.VertexLibraryBuilder()
    mesh, material = proxy.make_morph_sheet(builder, registry, n=n)
    builder.build()
    renderer = _renderer(registry, device, dict(width=640, height=480), config)

    def scene_at(t: float):
        scene = _aimed(rt.Scene(world_space=rt.GLTF), (0.0, 2.2, 2.6),
                       (0.0, 0.0, 0.0))
        scene.queue_mesh(mesh, material, None, math3d.IDENTITY,
                         morph_weights=morph_weights(t))
        return scene

    return renderer, scene_at


def flythrough_batch(source, device="cuda", k: int = FLY_BATCH, **config):
    """Row 6's batch: `k` frames of the source's scene (game time 1 + i/30
    s, the orbit camera at a quarter of the game time) on a renderer of its
    own at 1920×1080, 4×MSAA (renderer, scenes)."""
    from renderer_tpu_torch.apps.sandbox import orbit_camera

    renderer = _renderer(source.registry, device,
                         dict(width=1920, height=1080, msaa_samples=4), config)
    scenes = []
    for i in range(k):
        t = 1.0 + i / 30.0
        scene = source.build_scene(t)
        scene.camera.position, scene.camera.orientation = orbit_camera(0.25 * t)
        scenes.append(scene)
    return renderer, scenes


def _load_sandbox(device):
    """(Sandbox with Smol Ame, None), or (None, why) when its assets are
    absent."""
    from renderer_tpu_torch.apps.sandbox import Sandbox

    try:
        return Sandbox(with_smol_ame=True, device=device), None
    except (OSError, GltfLoadingError) as e:
        return None, f"{type(e).__name__}: {e}"


def _skip(name: str, why: str) -> None:
    print(f"# {name} unavailable ({why}); skipping", flush=True)


def run_all(outdir: str = "configs_out", frames: int = 10,
            save_images: bool = True, sandbox=None, device="cuda") -> list[dict]:
    """Renders and times every row (module docstring) and returns their
    results: config, ms_per_frame, fps, the last frame's frame_stats and
    its dropped_pairs / dropped_rows. `sandbox` is the scene source of rows
    2-6; save_images=False writes results.json only."""
    device = resolve_device(device)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    results, pending = [], []  # pending: (name, device image), read at the end

    def record(name, renderer, img, ms):
        stats = renderer.frame_stats()
        pending.append((name, img))
        results.append({
            "config": name, "ms_per_frame": ms, "fps": 1000.0 / ms,
            "dropped_pairs": sum(stats[k] for k in (
                "overflow_opaque", "overflow_masked", "overflow_blended",
                "overflow_ui")),
            "dropped_rows": stats["row_overflow"], "frame_stats": stats})
        print({k: v for k, v in results[-1].items() if k != "frame_stats"},
              flush=True)

    # 1. triangle: single hardcoded triangle, 800×600, flat color
    renderer, scene = triangle_row(device)
    record("triangle-800x600-flat", renderer,
           *timed_frames(renderer, fixed(scene), 1, frames))

    # 2-6. the sandbox assets (Sponza + Smol Ame)
    why = None
    if sandbox is None:
        sandbox, why = _load_sandbox(device)
    sponza = getattr(sandbox, "sponza", None)
    char = getattr(sandbox, "smol_ame", None)

    # 2. static Sponza, fixed camera, base-color (albedo) @ 1280×720
    # 3. the G-buffer sweep: draw-id / normals / rough-metal / emissive / AO
    gbuffer = ((2, "draw-id"), (3, "normals"), (4, "rough-metal"),
               (5, "emissive"), (6, "occlusion"))
    if sponza is None:
        for name in ["sponza-albedo-720p"] + [f"sponza-gbuffer-{n}" for _, n in gbuffer]:
            _skip(name, why or "the scene source has no sponza")
    else:
        renderer = _renderer(sandbox.registry, device,
                             dict(width=1280, height=720), {})
        scene = rt.Scene(world_space=rt.GLTF)
        scene.camera.position = np.array([0.0, 1.6, 0.0], np.float32)
        scene.camera.orientation = math3d.quat_from_axis_angle([0, 1, 0], 1.56)
        sponza.queue(scene, math3d.IDENTITY)
        record("sponza-albedo-720p", renderer,
               *timed_frames(renderer, fixed(scene), 1, frames))
        for mode, name in gbuffer:
            record(f"sponza-gbuffer-{name}", renderer,
                   *timed_frames(renderer, fixed(scene), mode, max(frames // 2, 3)))

    # 4. skinned animation: per-frame bone transforms + skinned vertex pass
    if char is None or not char.animations:
        for t in (0.0, 0.75):
            _skip(f"skinned-anim-t{t}", why or "the scene source has no smol_ame")
    else:
        renderer = _renderer(sandbox.registry, device,
                             dict(width=640, height=480), {})
        anim = char.animations[0]
        for t in (0.0, 0.75):
            scene = _aimed(rt.Scene(world_space=rt.GLTF), (0.0, 0.6, 1.6),
                           (0.0, 0.5, 0.0))
            char.queue_animated(scene, math3d.IDENTITY, [(t, anim)])
            record(f"skinned-anim-t{t}", renderer,
                   *timed_frames(renderer, fixed(scene), 0, max(frames // 2, 3)))

    # 5. full sandbox: Sponza + animated character, lit, 1920×1080, 4×MSAA
    # 5b. the fast_sampler opt-in at the same configuration
    # 6. the flythrough: FLY_BATCH frames (camera orbit + animation) a
    #    render_frames_device call, on the card one CUDA graph replayed
    #    once a frame
    fly_name = f"sandbox-flythrough-batch{FLY_BATCH}-1080p-msaa4"
    if sandbox is None:
        for name in ("sandbox-lit-1080p-msaa4",
                     "sandbox-lit-1080p-msaa4-fastsampler", fly_name):
            _skip(name, why)
    else:
        scene = sandbox.build_scene(1.0)
        cfg = rt.RenderConfig(width=1920, height=1080, msaa_samples=4)
        for name, config in (("sandbox-lit-1080p-msaa4", cfg),
                             ("sandbox-lit-1080p-msaa4-fastsampler",
                              cfg.fast_sampler())):
            renderer = rt.Renderer(sandbox.registry, config,
                                   overflow_policy="off", device=device)
            record(name, renderer, *timed_frames(renderer, fixed(scene), 0, frames))
        renderer, scenes = flythrough_batch(sandbox, device)
        record(fly_name, renderer,
               *timed_batches(renderer, scenes, max(frames // 4, 2)))

    # 7. capacity stress: >1M triangles through the full pipeline
    renderer, scene = stress_row(device)
    record("stress-1M-tris-1080p", renderer,
           *timed_frames(renderer, fixed(scene), 0, max(frames // 2, 3)))
    del renderer, scene

    # 8. pair-capacity stress: the field plus the 8000-layer overdraw stack
    renderer, scene = overdraw_row(device)
    record("stress-4Mpairs-1080p", renderer,
           *timed_frames(renderer, fixed(scene), 0, max(frames // 3, 2)))
    del renderer, scene

    # 9. morph-target animation: new weights every frame
    renderer, scene_at = morph_row(device)
    record("morph-sheet-480p-normals", renderer, *timed_frames(
        renderer, lambda i: scene_at(0.4 * i), 3, max(frames // 2, 3)))

    # 10. real geometry end to end: testbox.glb, one box and a 90-instance
    # field at Sponza-like triangle count
    from renderer_tpu_torch.apps import testbox

    try:
        treg, _tlib, tgltf = testbox.load_testbox(device=device)
    except (OSError, GltfLoadingError) as e:
        for name in ("testbox-real-geometry-800x608", "testbox-field-276k-1080p-msaa4"):
            _skip(name, f"{type(e).__name__}: {e}")
    else:
        renderer = _renderer(treg, device, dict(width=800, height=608), {})
        record("testbox-real-geometry-800x608", renderer, *timed_frames(
            renderer, fixed(testbox.build_single(tgltf)), 0, frames))
        renderer = _renderer(treg, device,
                             dict(width=1920, height=1080, msaa_samples=4), {})
        record("testbox-field-276k-1080p-msaa4", renderer, *timed_frames(
            renderer, fixed(testbox.build_field(tgltf)), 0, max(frames // 2, 3)))

    # the numbers first, then the images
    (out / "results.json").write_text(json.dumps(results, indent=2))
    if save_images:
        for name, img in pending:
            png.write_png(out / f"{name}.png", img.cpu().numpy())
    return results


if __name__ == "__main__":
    run_all(sys.argv[1] if len(sys.argv) > 1 else "configs_out",
            frames=int(sys.argv[2]) if len(sys.argv) > 2 else 10,
            device=sys.argv[3] if len(sys.argv) > 3 else "cuda")
