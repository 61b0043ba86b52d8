"""Sandbox demo — parity with the reference's full demo app
(reference: examples/sandbox/src/main.rs): Sponza at the origin plus the
animated Smol Ame model (scale 0.7, rotated -π/2 about Y, at (3, 0, -0.5)),
GLTF world space, camera starting at (0, 1.6, 0) with yaw 1.56.

Assets are read from $RENDERER_TPU_ASSETS, laid out as the reference
checkout's examples/sandbox/src (default: assets/sandbox under the
repository root). Frames and BC7 decodes run on the card unless
`device="cpu"` is passed.

    python -m renderer_tpu_torch.apps.sandbox [out.png] [debug_mode] [time]
    python -m renderer_tpu_torch.apps.sandbox flythrough [frames] [out_dir] \
        [width] [height] [msaa] [debug_mode]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from copy import copy
from pathlib import Path

import numpy as np
import torch

import renderer_tpu_torch as rt
from renderer_tpu_torch.assets import ntex, png, proxy
from renderer_tpu_torch.assets.gltf_loader import load_gltf
from renderer_tpu_torch.core import math3d

ASSET_ROOT = Path(os.environ.get(
    "RENDERER_TPU_ASSETS",
    Path(__file__).resolve().parents[2] / "assets" / "sandbox"))
SPONZA = ASSET_ROOT / "sponza/glTF/Sponza.gltf"
SMOL_AME = ASSET_ROOT / "smol-ame-by-seafoam/smol-ame.gltf"


class Sandbox:
    """Loads real assets when the .bin geometry buffers exist; otherwise
    reconstructs the workload via assets/proxy.py (the reference checkout
    ships the glTF JSON + all .ntex textures but not the LFS .bin buffers)."""

    def __init__(self, with_smol_ame: bool = True, device="cuda"):
        self.registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        self.proxy_geometry = not (SPONZA.parent / "Sponza.bin").exists()
        if self.proxy_geometry:
            print("# sponza .bin buffers missing; using proxy geometry with "
                  "real materials/textures", file=sys.stderr)
            self.sponza = proxy.load_gltf_proxy(SPONZA, builder, self.registry,
                                                device=device)
            self.smol_ame = None
            if with_smol_ame:
                ame_ntex = SMOL_AME.parent / "terrariumtexsketchfab.ntex"
                _, mips = ntex.decode_file(ame_ntex, device=device)
                tex = rt.Texture(
                    mips, rt.TextureKind.SRGB_COLOR, "terrariumtexsketchfab",
                    blocks_loader=lambda p=ame_ntex: ntex.read_blocks_file(p)[1],
                )
                self.smol_ame = proxy.make_skinned_character(
                    builder, self.registry, textures=[tex])
        else:
            self.sponza = load_gltf(SPONZA, builder, self.registry, device=device)
            self.smol_ame = (load_gltf(SMOL_AME, builder, self.registry, device=device)
                             if with_smol_ame else None)
        self.library = builder.build()
        # constants of the demo scene, hoisted out of the per-frame rebuild
        # (the reference's main loop keeps these outside the loop too,
        # main.rs:549-583)
        self._cam_position = np.array([0.0, 1.6, 0.0], np.float32)
        self._cam_orientation = math3d.quat_mul(
            math3d.quat_from_axis_angle([0, 1, 0], 1.56),
            math3d.quat_from_axis_angle([1, 0, 0], 0.0),
        )
        self._ame_transform = math3d.trs(
            translation=np.array([3.0, 0.0, -0.5], np.float32),
            rotation=math3d.quat_from_axis_angle([0, 1, 0], -np.pi / 2),
            scale=np.array([0.7, 0.7, 0.7], np.float32),
        )

    def build_scene(self, game_time: float = 0.0,
                    scene: rt.Scene | None = None) -> rt.Scene:
        """main.rs:549-583: camera pose, Sponza at identity, Smol Ame with
        all animations playing at game_time % end_time. Pass the previous
        frame's `scene` to re-queue into it (Scene.clear — the reference's
        per-frame reset of one long-lived Scene)."""
        if scene is None:
            scene = rt.Scene(world_space=rt.GLTF)
        else:
            scene.clear()
        scene.camera.position = self._cam_position
        scene.camera.orientation = self._cam_orientation
        self.sponza.queue(scene, math3d.IDENTITY)
        if self.smol_ame is not None:
            playing = [(game_time % a.end_time, a) for a in self.smol_ame.animations]
            self.smol_ame.queue_animated(scene, self._ame_transform, playing)
        return scene


def orbit_camera(ang: float):
    """The canonical demo orbit: an ELLIPSE around the atrium (x radius 5,
    z radius 2), eye height 1.8, always facing the atrium center. Returns
    (position, orientation) for Scene.camera."""
    eye = np.array([5.0 * np.cos(ang), 1.8, 2.0 * np.sin(ang)], np.float32)
    target = np.array([0.0, 1.5, 0.0], np.float32)
    return math3d.look_at(eye, target, np.array([0, 1, 0], np.float32))


def build_bench(for_bench: bool = False, device="cuda"):
    """Bench entry: full sandbox assets at 1920×1080 with the reference's
    4×MSAA (main.rs:114-117). Returns (sandbox, renderer, name); the bench
    rebuilds the scene per frame (camera + animation). for_bench=True turns
    the per-frame overflow check off (the bench checks the stats after
    timing)."""
    sandbox = Sandbox(device=device)
    config = rt.RenderConfig(width=1920, height=1080, msaa_samples=4)
    renderer = rt.Renderer(sandbox.registry, config,
                           overflow_policy="off" if for_bench else "auto",
                           device=device)
    name = "sponza+ame-1080p-msaa4"
    if sandbox.proxy_geometry:
        name += "-proxygeom"
    return sandbox, renderer, name


_DEBUG_KEYS = {f"Num{n}": n for n in range(8)}
# key_down / key_up effects on the (dx, dy, dz) movement axes: W/S along z,
# A/D along x, Q/X along y (main.rs:371-396)
_MOVE_KEYS = {"W": (2, 1.0), "S": (2, -1.0), "A": (0, 1.0), "D": (0, -1.0),
              "Q": (1, 1.0), "X": (1, -1.0)}


def run_loop(
    frames: int = 240,
    target_fps: float = 60.0,
    width: int = 1920,
    height: int = 1080,
    msaa: int = 4,
    debug_mode: int = 0,
    dump_path: str | None = None,
    show_hud: bool = True,
    immediate_present: bool = False,
    trace_path: str | None = None,
    events=None,
    sandbox=None,
    device="cuda",
):
    """Headless flying-camera demo loop — the sandbox main loop parity
    (main.rs:325-640): fixed-timestep game time with variable-dt fallback
    when a frame runs >20% over budget, frame pacing to the target rate,
    per-frame scene requeue + animation evaluation, and the interactive
    "Performance stats" window (main.rs:527-543) built through the widget
    layer every frame and rendered through the in-frame UI pass.

    `events` drives the reference event loop headlessly: events[i] is the
    list of SDL-shaped tuples (see renderer_tpu_torch.ui.io.Platform)
    delivered on frame i. Keybind semantics follow main.rs:341-457 — debug
    keys Num0-7 switch the render mode, WASD/QX move and LShift sprints (all
    gated on !want_capture_keyboard), left click toggles mouse-look (gated on
    !want_capture_mouse; sets ConfigFlags::NO_MOUSE), ("mouse_motion_rel",
    xrel, yrel) turns the camera while mouse-looking, Escape exits
    mouse-look, and 'I' keyup toggles immediate present. Without events the
    camera flies the orbit (the interactive WASD camera's role in a
    headless run). Returns a stats dict (including the final frame as
    "image").

    `sandbox` reuses an already-loaded scene source (anything with
    `.registry` and `.build_scene(game_time, scene=)`) instead of loading
    the demo assets. Frames run on `device`: the card unless the caller
    asks for the CPU."""
    from renderer_tpu_torch.engine.profiling import Profiler
    from renderer_tpu_torch.engine.stats import log_memory_usage
    from renderer_tpu_torch.overlay.hud import build_hud_drawlist
    from renderer_tpu_torch.overlay.perf_window import performance_stats_window
    from renderer_tpu_torch.ui import Platform, UiContext, UiIo

    assert frames > 0, "run_loop needs at least one frame"
    if sandbox is None:
        sandbox = Sandbox(device=device)
    # trace_path: also retain per-event spans and write Chrome trace-event
    # JSON at the end (the reference's profile-with-tracing output,
    # main.rs:30-36)
    profiler = Profiler(enabled=True, trace_events=200_000 if trace_path else 0)
    config = rt.RenderConfig(width=width, height=height, msaa_samples=msaa)
    # overflow_policy "off": no per-frame device→host stats read; the loop
    # checks the collected stats once at the end instead
    renderer = rt.Renderer(sandbox.registry, config, profiler=profiler,
                           overflow_policy="off", device=device)
    log_memory_usage("assets loaded", renderer.device)

    def sync():
        if renderer.device.type == "cuda":
            torch.cuda.synchronize(renderer.device)

    interactive = events is not None
    ctx, io, platform = UiContext(), UiIo(), Platform()
    capture_every_frame = False
    frame_spans: list = []
    # interactive camera state (main.rs:94-117 initial pose)
    cam_pos = np.array([0.0, 1.6, 0.0], np.float32)
    cam_yaw, cam_pitch = 1.56, 0.0
    move = [0.0, 0.0, 0.0]  # dx, dy, dz
    yaw_once = pitch_once = 0.0
    sprinting = mouse_look = False
    debug_value = int(debug_mode)

    budget = 1.0 / target_fps
    game_time = 0.0
    frame_times = []
    img = None
    scene = None
    prev = time.perf_counter()
    for i in range(frames):
        # -- event handling (main.rs:341-457): every event reaches the UI
        # first; game handling is gated on the PREVIOUS frame's capture
        # flags — the reference's exact handshake (main.rs:348-349)
        frame_events = events[i] if interactive and i < len(events) else ()
        for ev in frame_events:
            platform.handle_event(io, ev)
            handle_mouse = not io.want_capture_mouse
            handle_kb = not io.want_capture_keyboard
            kind, args = ev[0], ev[1:]
            if kind == "key_down" and handle_kb:
                sc = args[0]
                if sc in _DEBUG_KEYS:
                    debug_value = _DEBUG_KEYS[sc]
                elif sc in _MOVE_KEYS:
                    axis, v = _MOVE_KEYS[sc]
                    move[axis] = v
                elif sc == "LShift":
                    sprinting = True
                elif sc == "Escape" and mouse_look:
                    mouse_look = False
                    io.config_no_mouse = False
            elif kind == "key_up" and handle_kb:
                sc = args[0]
                if sc == "I":
                    immediate_present = not immediate_present
                elif sc in _MOVE_KEYS:
                    # releasing a key stops only the direction it set
                    axis, v = _MOVE_KEYS[sc]
                    if move[axis] * v > 0:
                        move[axis] = 0.0
                elif sc == "LShift":
                    sprinting = False
            elif (kind == "mouse_button_down" and args[0] == "left"
                  and handle_mouse):
                mouse_look = not mouse_look
                io.config_no_mouse = mouse_look  # NO_MOUSE (main.rs:425)
            elif kind == "mouse_motion_rel" and mouse_look:
                yaw_once -= args[0] / 750.0
                pitch_once += args[1] / 750.0

        # -- game update (main.rs:486-521): movement with the frame's dt
        # (real frame time when over budget OR immediate-present — the
        # reference's too_slow covers both, main.rs:494-500)
        dt = (frame_times[-1]
              if frame_times and (immediate_present
                                  or frame_times[-1] > 1.2 * budget)
              else budget)
        if interactive:
            cam_yaw += yaw_once
            cam_pitch = float(np.clip(cam_pitch + pitch_once, -np.pi / 2, np.pi / 2))
            yaw_once = pitch_once = 0.0
            orient = math3d.quat_mul(
                math3d.quat_from_axis_angle([0, 1, 0], cam_yaw),
                math3d.quat_from_axis_angle([1, 0, 0], cam_pitch),
            )
            if any(move):
                ctl = np.array(move, np.float32)
                ctl /= np.linalg.norm(ctl)
                speed = 10.0 if sprinting else 5.0
                cam_pos = cam_pos + (math3d.quat_to_mat3(orient) @ ctl) * speed * dt
            pos = cam_pos
        else:
            # flying camera: circle the atrium, always facing its center
            pos, orient = orbit_camera(2.0 * np.pi * (i / max(frames, 1)))

        scene = sandbox.build_scene(game_time, scene=scene)
        scene.camera.position = pos
        scene.camera.orientation = orient
        ui = None
        if show_hud:
            # the interactive "Performance stats" window (main.rs:527-543),
            # built with real widgets and rendered THROUGH the raster
            # pipeline (the reference's ImGui pass; imgui_support.rs:107-169)
            # plus a one-line fps status. Only host-side data — no device
            # reads.
            platform.prepare_frame(io, window_size=(width, height),
                                   now=time.perf_counter())
            io.new_frame()
            uif = ctx.new_frame(io, sandbox.registry)
            if capture_every_frame or not frame_spans:
                frame_spans = [copy(s) for s in profiler.report()]
            startup_spans = getattr(profiler, "sections", {}).get(
                "startup (first frame incl. compile)", [])
            capture_every_frame = performance_stats_window(
                uif, capture_every_frame, frame_spans, startup_spans)
            ui = uif.end_frame()
            fps_now = 1.0 / max(frame_times[-1], 1e-6) if frame_times else 0.0
            status = build_hud_drawlist(
                sandbox.registry, None,
                [f"{width}x{height} msaa{msaa}  {fps_now:.0f} fps "
                 f"(paced {target_fps:.0f})"],
                max_width=width, show_memory=False, device=renderer.device)
            status.extend(ui)
            ui = status
        elif interactive:
            # no HUD, but queued UI events must still be promoted+cleared
            # every frame (UiIo accumulates otherwise) — there is no UI to
            # capture input, so the want_* flags stay False
            platform.prepare_frame(io, window_size=(width, height),
                                   now=time.perf_counter())
            io.new_frame()
        img = renderer.render_frame_device(scene, debug_mode=debug_value, ui=ui)
        if i == 0:
            sync()
            profiler.snapshot("startup (first frame incl. compile)")

        now = time.perf_counter()
        frame_time = now - prev
        frame_times.append(frame_time)
        # fixed timestep unless >20% over budget; with immediate present the
        # reference forces too_slow=true so game time runs at REAL time
        # (main.rs:486-521, 494-500)
        if immediate_present or frame_time > 1.2 * budget:
            game_time += frame_time
        else:
            game_time += budget
        # frame pacing (main.rs:628-639): sleep the REMAINDER of the budget
        # after this frame's work; immediate_present skips pacing
        if not immediate_present:
            sleep_for = budget - (time.perf_counter() - prev)
            if sleep_for > 0:
                time.sleep(sleep_for)
        prev = time.perf_counter()

    sync()
    out = img.cpu().numpy()
    ft = np.array(frame_times[3:]) if len(frame_times) > 6 else np.array(frame_times)
    stats = {
        "frames": frames,
        # render throughput (frame time excludes the pacing sleep)
        "render_fps": float(1.0 / ft.mean()),
        "p99_ms": float(np.percentile(ft, 99) * 1e3),
        "frame_ms": [t * 1e3 for t in frame_times],
        "paced_to": target_fps,
        "debug_mode": debug_value,
        "immediate_present": immediate_present,
        "image": out,
    }
    if interactive:
        stats.update({
            "cam_position": [float(v) for v in cam_pos],
            "cam_yaw": cam_yaw,
            "cam_pitch": cam_pitch,
            "mouse_look": mouse_look,
            "want_capture_mouse": io.want_capture_mouse,
            "want_capture_keyboard": io.want_capture_keyboard,
        })
    frame_stats = renderer.frame_stats()  # end-of-run device stats check
    if frame_stats:
        dropped = sum(v for k, v in frame_stats.items() if "overflow" in k)
        if dropped:
            print(f"run_loop WARNING: last frame dropped {dropped} bin pairs "
                  f"(raise RenderConfig.pair_capacity): {frame_stats}")
        stats["frame_stats"] = frame_stats
    if dump_path:
        # the HUD is already IN the frame (rendered through the UI pass)
        png.write_png(dump_path, out)
    if trace_path:
        n = profiler.export_chrome_trace(trace_path)
        print(f"wrote {n} trace events to {trace_path}")
    print("run_loop:", {k: v for k, v in stats.items() if k != "image"})
    return stats


def flythrough(
    frames: int = 16,
    out_dir: str | None = None,
    width: int = 1280,
    height: int = 720,
    msaa: int = 4,
    debug_mode: int = 0,
    sandbox=None,
    device="cuda",
):
    """Offline flythrough: render `frames` camera-path frames in ONE
    Renderer.render_frames_device call (on the card one CUDA graph of the
    frame, replayed once a frame) and write numbered PNGs to `out_dir`
    (default: flythrough/ under the system's temporary directory). The
    offline counterpart of run_loop (no UI pass; the HUD rides the
    interactive path). Overflow policy "sync": the returned batch is always
    complete — any dropped work re-renders at grown capacity. Frame i looks
    from the orbit camera at angle 2πi/frames, at game time i/60 s.

    `sandbox` is any scene source with `.registry` and `.build_scene(t)`
    (default: the demo assets, loaded on `device`). Returns a dict: the
    frames read back in one copy ("images", u8 [K, H, W, 3]), their stats
    rows ("stats", on the device), the scenes and the renderer.

    Run: python -m renderer_tpu_torch.apps.sandbox flythrough [frames] [out_dir] ..."""
    if sandbox is None:
        sandbox = Sandbox(device=device)
    config = rt.RenderConfig(width=int(width), height=int(height),
                             msaa_samples=int(msaa))
    renderer = rt.Renderer(sandbox.registry, config, overflow_policy="sync",
                           device=device)
    frames = int(frames)
    scenes = []
    for i in range(frames):
        pos, orient = orbit_camera(2.0 * np.pi * (i / max(frames, 1)))
        scene = sandbox.build_scene(i / 60.0)
        scene.camera.position = pos
        scene.camera.orientation = orient
        scenes.append(scene)
    imgs, stats = renderer.render_frames_device(scenes, debug_mode=int(debug_mode))
    out = imgs.cpu().numpy()  # ONE readback for the whole batch
    out_dir = Path(out_dir or Path(tempfile.gettempdir()) / "flythrough")
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(frames):
        png.write_png(out_dir / f"{i:04d}.png", out[i])
    print(f"wrote {frames} frames to {out_dir} "
          f"({out.shape[2]}x{out.shape[1]}, one render_frames_device call)")
    return {"images": out, "stats": stats, "scenes": scenes, "renderer": renderer}


def main(out_path: str = "sandbox.png", debug_mode: int = 0,
         game_time: float = 1.0, device="cuda"):
    sandbox = Sandbox(device=device)
    renderer = rt.Renderer(sandbox.registry, rt.RenderConfig(width=1280, height=720),
                           device=device)
    scene = sandbox.build_scene(float(game_time))
    img = renderer.render_frame(scene, debug_mode=int(debug_mode))
    png.write_png(out_path, img)
    print(f"wrote {out_path} ({img.shape[1]}x{img.shape[0]}), "
          f"{scene.draw_count} draws")
    return img


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "flythrough":
        flythrough(*sys.argv[2:])
    else:
        main(*sys.argv[1:])
