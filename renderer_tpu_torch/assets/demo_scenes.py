"""Deterministic scenes the port is checked and timed on.

- `triangle_scene` / `alpha_layers_scene`: the scenes of the golden images
  in tests/golden/goldens.npz (the JAX package's apps/triangle.py and
  tests/test_golden.py build the same draws).
- `patch_ring_scene`: six procedural patches cycling textured-opaque,
  masked (alpha-to-coverage) and blended materials — the mini-sandbox
  golden's scene (tests/test_sandbox_golden.py) without its skinned
  character and HUD.
- `mini_sandbox_scene`: the whole mini-sandbox golden scene
  (tests/golden/sandbox-golden.npz) — the ring plus the skinned character
  playing both its animations — and `mini_sandbox_ui`, its HUD or its
  "Performance stats" window.
- `patch_wall_scene`: the same materials on 48 larger patches in staggered
  walls — the all-classes scene at Sponza scale.
- `stress_scene`: the >1M-triangle stress field of the JAX package's
  apps/configs.py stress row.

Each builder returns (registry, scene) (`mini_sandbox_scene` a
MiniSandbox); meshes are built and frozen.
"""

from __future__ import annotations

import numpy as np

from renderer_tpu_torch.assets import proxy
from renderer_tpu_torch.core import camera as camera_mod
from renderer_tpu_torch.core import math3d
from renderer_tpu_torch.engine.profiling import Profiler, Span
from renderer_tpu_torch.geometry.vertex_library import VertexLibraryBuilder
from renderer_tpu_torch.materials.registry import (
    AlphaMode,
    MaterialRegistry,
    PbrMaterialParameters,
    Texture,
    TextureKind,
)
from renderer_tpu_torch.scene.scene import Scene


def triangle_scene():
    """Two copies of one hardcoded triangle, the second scaled by
    (2, 0.5, 1), one green material (reference examples/triangle)."""
    builder = VertexLibraryBuilder()
    positions = np.array([[-0.5, 0.5, 0.8], [0.5, 0.5, 0.8], [-0.1, -0.5, 0.8]],
                         np.float32)
    uvs = np.array([[0.0, 1.0], [1.0, 1.0], [0.5, 0.0]], np.float32)
    normals = np.eye(3, dtype=np.float32)
    tangents = np.array([[0, 1, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0]], np.float32)
    indices = np.array([0, 1, 2], np.uint32)
    mesh1 = builder.add_mesh(positions, uvs, normals, tangents, indices)
    mesh2 = builder.add_mesh(positions, uvs, normals, tangents, indices)
    builder.build()
    registry = MaterialRegistry()
    material = registry.create_material(
        "triangle material",
        PbrMaterialParameters(base_color_factor=(0.2, 0.8, 0.2, 1.0)),
    )
    scene = Scene()
    scene.queue_mesh(mesh1, material, None, math3d.IDENTITY)
    scene.queue_mesh(mesh2, material, None,
                     math3d.trs(scale=np.array([2.0, 0.5, 1.0])))
    return registry, scene


def _quad(builder, z, half=0.6):
    positions = np.array(
        [[-half, half, z], [half, half, z], [-half, -half, z], [half, -half, z]],
        np.float32,
    )
    uvs = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
    normals = np.tile([0, 0, -1.0], (4, 1)).astype(np.float32)
    tangents = np.tile([1, 0, 0, 1.0], (4, 1)).astype(np.float32)
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint32)
    return builder.add_mesh(positions, uvs, normals, tangents, indices)


def alpha_layers_scene():
    """A red opaque quad, a half-transparent blue blended quad in front of
    it, and an alpha-cutoff quad that fails its cutoff (the golden
    `alpha-layers` case)."""
    registry = MaterialRegistry()
    builder = VertexLibraryBuilder()
    far = _quad(builder, 2.0)
    near = _quad(builder, 1.5, half=0.3)
    builder.build()
    red = registry.create_material(
        "red", PbrMaterialParameters(base_color_factor=(1, 0, 0, 1)))
    blue = registry.create_material(
        "blue", PbrMaterialParameters(base_color_factor=(0, 0, 1, 0.5),
                                      alpha_mode=AlphaMode.BLENDED))
    ghost = registry.create_material(
        "ghost", PbrMaterialParameters(base_color_factor=(1, 1, 1, 0.3),
                                       alpha_cutoff=0.5,
                                       alpha_mode=AlphaMode.ALPHA_TO_COVERAGE))
    scene = Scene()
    scene.queue_mesh(far, red, None, math3d.IDENTITY)
    scene.queue_mesh(near, blue, None, math3d.IDENTITY)
    scene.queue_mesh(near, ghost, None,
                     math3d.trs(translation=np.array([0.4, 0, 0.1], np.float32)))
    return registry, scene


def checker_texture() -> Texture:
    """64×64 sRGB checker with a full mip chain."""
    base = np.zeros((64, 64, 4), np.uint8)
    base[..., 3] = 255
    yy, xx = np.mgrid[0:64, 0:64]
    checker = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
    base[..., 0] = 40 + 200 * checker
    base[..., 1] = 120
    base[..., 2] = 240 - 200 * checker
    mips = [base]
    m = base
    while m.shape[0] > 1:
        m = m[::2, ::2]
        mips.append(m)
    return Texture(mips, TextureKind.SRGB_COLOR, "checker")


def _patch_materials(registry):
    """Textured-opaque, masked (a2c) and blended materials of the
    mini-sandbox golden."""
    tex = checker_texture()
    return [
        registry.create_material(
            "tex-opaque", PbrMaterialParameters(base_color=tex)),
        registry.create_material(
            "masked",
            PbrMaterialParameters(
                base_color=tex, alpha_cutoff=0.4,
                base_color_factor=(1, 1, 1, 0.9),
                alpha_mode=AlphaMode.ALPHA_TO_COVERAGE,
            ),
        ),
        registry.create_material(
            "blended",
            PbrMaterialParameters(
                base_color_factor=(0.2, 0.9, 0.4, 0.45),
                alpha_mode=AlphaMode.BLENDED,
            ),
        ),
    ]


def _patches(builder, n, vertex_count, index_count):
    meshes = []
    for i in range(n):
        p, uv, nrm, t, idx = proxy._patch_geometry(
            vertex_count, index_count, [-0.8, -0.5, -0.2], [0.8, 0.5, 0.2],
            seed=100 + i)
        meshes.append(builder.add_mesh(p, uv, nrm, t, idx))
    return meshes


def _sandbox_camera(scene):
    scene.camera.position = np.array([0.0, 0.9, 2.6], np.float32)
    scene.camera.orientation = math3d.quat_from_axis_angle([0, 1, 0], np.pi)


def patch_ring_scene():
    """The mini-sandbox golden's static draws: six procedural patches in a
    ring cycling textured-opaque, masked (a2c) and blended materials."""
    registry = MaterialRegistry()
    builder = VertexLibraryBuilder()
    meshes = _patches(builder, 6, 400, 1200)
    mats = _patch_materials(registry)
    builder.build()
    scene = Scene(world_space=camera_mod.GLTF)
    _sandbox_camera(scene)
    for i, mesh in enumerate(meshes):
        ang = 2 * np.pi * i / len(meshes)
        tr = math3d.trs(
            translation=np.array(
                [1.2 * np.cos(ang), 0.6 + 0.1 * i, 1.2 * np.sin(ang)], np.float32),
            rotation=math3d.quat_from_axis_angle([0, 1, 0], ang),
        )
        scene.queue_mesh(mesh, mats[i % 3], None, tr)
    return registry, scene


class MiniSandbox:
    """The mini-sandbox golden's scene (tests/test_sandbox_golden.py): the
    six-patch ring of `patch_ring_scene` and the procedural skinned
    character (proxy.make_skinned_character) at the origin. `queue(t)`
    re-queues the scene with the character playing both its animations at
    game time t, so each call evaluates the animation and skins anew;
    `build_scene(t)` queues them into a new Scene (the apps' scene-source
    interface, with `.registry`)."""

    def __init__(self) -> None:
        self.registry = MaterialRegistry()
        builder = VertexLibraryBuilder()
        self._meshes = _patches(builder, 6, 400, 1200)
        self._mats = _patch_materials(self.registry)
        self.character = proxy.make_skinned_character(builder, self.registry)
        builder.build()
        self.scene = Scene(world_space=camera_mod.GLTF)
        _sandbox_camera(self.scene)

    def queue(self, game_time: float) -> Scene:
        return self.build_scene(game_time, self.scene)

    def build_scene(self, game_time: float = 0.0,
                    scene: Scene | None = None) -> Scene:
        """The scene-source interface of apps/sandbox.py (`run_loop`,
        `flythrough`): the draws queued at `game_time` into `scene`
        (cleared first) or into a new Scene at the golden's camera."""
        if scene is None:
            scene = Scene(world_space=camera_mod.GLTF)
            _sandbox_camera(scene)
        else:
            scene.clear()
        for i, mesh in enumerate(self._meshes):
            ang = 2 * np.pi * i / len(self._meshes)
            tr = math3d.trs(
                translation=np.array(
                    [1.2 * np.cos(ang), 0.6 + 0.1 * i, 1.2 * np.sin(ang)],
                    np.float32),
                rotation=math3d.quat_from_axis_angle([0, 1, 0], ang),
            )
            scene.queue_mesh(mesh, self._mats[i % 3], None, tr)
        playing = [(game_time % a.end_time, a) for a in self.character.animations]
        self.character.queue_animated(scene, math3d.IDENTITY, playing)
        return scene


def mini_sandbox_scene(game_time: float = 0.4) -> MiniSandbox:
    """The mini-sandbox golden's scene queued at `game_time` (the golden
    images are rendered at 0.4 s)."""
    sandbox = MiniSandbox()
    sandbox.queue(game_time)
    return sandbox


def sandbox_spans():
    """The golden's deterministic span timings: (frame tree, startup
    section), new Span objects on each call."""
    return ([Span("frame", 0, 1.0e-3, 1), Span("raster", 1, 0.8e-3, 1),
             Span("post", 1, 0.05e-3, 1)], [Span("load", 0, 0.5, 1)])


def perf_window_frame(ctx, io, registry, frame_spans, startup_spans,
                      pos=(4.0, 4.0), size=(150.0, 88.0)):
    """One UiContext frame of the interactive "Performance stats" window
    (overlay/perf_window.py), expanded at the fixed rect pos/size. Returns
    the frame's DrawList."""
    from renderer_tpu_torch.overlay.perf_window import performance_stats_window

    io.new_frame()
    ui = ctx.new_frame(io, registry)
    performance_stats_window(ui, False, frame_spans, startup_spans)
    dl = ui.end_frame()
    st = ctx.windows["Performance stats"]
    st.collapsed = False
    st.pos = tuple(pos)
    st.size = tuple(size)
    return dl


def mini_sandbox_ui(registry, kind: str):
    """The golden's overlay DrawList with deterministic spans: "hud" — the
    flat span-tree HUD (one collapsed section, one expanded with low/high
    %-of-frame tints); "perfwin" — the interactive "Performance stats"
    window after two UiContext frames, so the Condition::Appearing state
    settles before the golden frame. Both fit the golden's 160×96 frame."""
    from renderer_tpu_torch.overlay.hud import build_hud_drawlist
    from renderer_tpu_torch.ui import UiContext, UiIo

    if kind == "perfwin":
        ctx, io = UiContext(), UiIo()
        dl = None
        for _ in range(2):
            dl = perf_window_frame(ctx, io, registry, *sandbox_spans())
        return dl
    if kind != "hud":
        raise ValueError(f"kind must be 'hud' or 'perfwin', got {kind!r}")
    frame_spans, startup_spans = sandbox_spans()
    prof = Profiler(enabled=True)
    prof.sections = {"startup": startup_spans}
    prof._spans = {(s.depth, s.name): s for s in frame_spans}
    prof._order = list(prof._spans)
    return build_hud_drawlist(registry, prof, ["mini sandbox"],
                              collapsed={"startup"}, max_width=160,
                              show_memory=False)


class SandboxFrames:
    """A frame loop over the mini-sandbox with its interactive overlay, as
    an app would run it: each `next()` advances game time by 1/60 s,
    re-queues the scene (animation + skinning) and rebuilds the
    "Performance stats" window (expanded at the reference's 640×480)
    through one UiContext from the spans `profiler` took in the previous
    frame — pass it to the Renderer. The first frame shows the golden's
    deterministic spans; the first rendered frame's spans become the
    window's startup section."""

    POS, SIZE = (40.0, 40.0), (640.0, 480.0)

    def __init__(self):
        from renderer_tpu_torch.ui import UiContext, UiIo

        self.sandbox = MiniSandbox()
        self.registry = self.sandbox.registry
        self.profiler = Profiler(enabled=True)
        self.ctx, self.io = UiContext(), UiIo()
        self.game_time = 0.0
        self.frames = 0
        self.startup = []
        # one settling UiContext frame: the window's Condition::Appearing
        # state (collapsed) is overridden before the first drawn frame
        perf_window_frame(self.ctx, self.io, self.registry, [], [],
                          self.POS, self.SIZE)

    def next(self, game_time: float | None = None):
        """(scene, DrawList) of the next frame, at `game_time` (by default
        the previous frame's plus 1/60 s)."""
        spans = self.profiler.report()
        if self.frames == 0:
            spans, self.startup = sandbox_spans()
        elif self.frames == 1:
            self.startup = spans
        self.profiler.reset()
        self.game_time = self.game_time + 1.0 / 60.0 if game_time is None else game_time
        self.frames += 1
        scene = self.sandbox.queue(self.game_time)
        dl = perf_window_frame(self.ctx, self.io, self.registry, spans,
                               self.startup, self.POS, self.SIZE)
        return scene, dl


def patch_wall_scene(n_patches: int = 48, grid: int = 56):
    """An all-classes scene at Sponza scale: `n_patches` procedural patches
    of 2·grid² triangles (48 × 6272 = 301,056 by default, Sponza's ~300k)
    in three staggered walls of 8×2 panels,
    one behind the other, so a pixel sees up to about three surfaces;
    materials cycle textured-opaque, masked (a2c) and blended."""
    registry = MaterialRegistry()
    builder = VertexLibraryBuilder()
    meshes = _patches(builder, n_patches, (grid + 1) ** 2, 6 * grid * grid)
    mats = _patch_materials(registry)
    builder.build()
    scene = Scene(world_space=camera_mod.GLTF)
    _sandbox_camera(scene)
    for i, mesh in enumerate(meshes):
        wall, slot = divmod(i, 16)
        row, col = divmod(slot, 8)
        tr = math3d.trs(
            translation=np.array(
                [(col - 3.5) * 1.1 + 0.45 * wall, 0.9 + (row - 0.5) * 0.9,
                 -0.7 * wall], np.float32),
            rotation=math3d.quat_from_axis_angle([0, 1, 0], np.pi),
        )
        scene.queue_mesh(mesh, mats[i % 3], None, tr)
    return registry, scene


def stress_field_scene(builder, registry, n_meshes: int = 32,
                       tris_per_mesh: int = 32768) -> Scene:
    """The stress field (proxy.make_stress_field, added to `builder`) in a
    new Scene, seen from above at an angle, as the JAX package's
    stress-1M-tris-1080p and stress-4Mpairs-1080p rows frame it."""
    meshes, material = proxy.make_stress_field(
        builder, registry, n_meshes=n_meshes, tris_per_mesh=tris_per_mesh)
    scene = Scene(world_space=camera_mod.GLTF)
    eye = np.array([0.0, 14.0, 26.0], np.float32)
    pos, orient = math3d.look_at(eye, np.array([0.0, 0.0, 0.0], np.float32),
                                 np.array([0, 1, 0], np.float32))
    scene.camera.position, scene.camera.orientation = pos, orient
    for m in meshes:
        scene.queue_mesh(m, material, None, math3d.IDENTITY)
    return scene


def stress_scene(n_meshes: int = 32, tris_per_mesh: int = 32768):
    """The stress field of stress_field_scene on a library of its own."""
    registry = MaterialRegistry()
    builder = VertexLibraryBuilder()
    scene = stress_field_scene(builder, registry, n_meshes, tris_per_mesh)
    builder.build()
    return registry, scene
