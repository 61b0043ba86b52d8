"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same scenes built with either package's classes, and the host inputs of a
frame as numpy arrays, so the JAX package and the port see identical data.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

# The suite runs in several pytest-xdist workers that share a few cores.
# torch's default of one OpenMP thread per core oversubscribes them, and its
# many small CPU ops then slow down by orders of magnitude; one thread each.
torch.set_num_threads(1)

W, H = 160, 96

SCENES = ("triangle", "alpha-layers", "sandbox-static")


def _mods(root: str):
    class M:
        pass

    m = M()
    pkg = importlib.import_module(root)
    for name in ("Scene", "VertexLibraryBuilder", "MaterialRegistry",
                 "PbrMaterialParameters", "AlphaMode", "Texture", "TextureKind",
                 "RenderConfig", "GLTF"):
        setattr(m, name, getattr(pkg, name))
    m.math3d = importlib.import_module(f"{root}.core.math3d")
    m.proxy = importlib.import_module(f"{root}.assets.proxy")
    return m


def _quad(m, builder, z, half=0.6):
    positions = np.array(
        [[-half, half, z], [half, half, z], [-half, -half, z], [half, -half, z]],
        np.float32,
    )
    uvs = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
    normals = np.tile([0, 0, -1.0], (4, 1)).astype(np.float32)
    tangents = np.tile([1, 0, 0, 1.0], (4, 1)).astype(np.float32)
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint32)
    return builder.add_mesh(positions, uvs, normals, tangents, indices)


def build_scene(root: str, name: str):
    """(registry, scene, config) of scene `name` built with package `root`
    ("renderer_tpu" or "renderer_tpu_torch"). "sandbox-static" is the
    mini-sandbox golden's six patches (tests/test_sandbox_golden.py)
    without the skinned character and the HUD, at 4×MSAA; "strip-quads"
    the three alpha classes on quads for the shade-strip checks."""
    m = _mods(root)
    registry = m.MaterialRegistry()
    builder = m.VertexLibraryBuilder()
    if name == "triangle":
        positions = np.array([[-0.5, 0.5, 0.8], [0.5, 0.5, 0.8],
                              [-0.1, -0.5, 0.8]], np.float32)
        uvs = np.array([[0.0, 1.0], [1.0, 1.0], [0.5, 0.0]], np.float32)
        normals = np.eye(3, dtype=np.float32)
        tangents = np.array([[0, 1, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0]], np.float32)
        idx = np.array([0, 1, 2], np.uint32)
        mesh1 = builder.add_mesh(positions, uvs, normals, tangents, idx)
        mesh2 = builder.add_mesh(positions, uvs, normals, tangents, idx)
        builder.build()
        mat = registry.create_material(
            "triangle material",
            m.PbrMaterialParameters(base_color_factor=(0.2, 0.8, 0.2, 1.0)))
        scene = m.Scene()
        scene.queue_mesh(mesh1, mat, None, m.math3d.IDENTITY)
        scene.queue_mesh(mesh2, mat, None,
                         m.math3d.trs(scale=np.array([2.0, 0.5, 1.0])))
        return registry, scene, m.RenderConfig(width=W, height=H)
    if name == "alpha-layers":
        far = _quad(m, builder, 2.0)
        near = _quad(m, builder, 1.5, half=0.3)
        builder.build()
        red = registry.create_material(
            "red", m.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1)))
        blue = registry.create_material(
            "blue", m.PbrMaterialParameters(base_color_factor=(0, 0, 1, 0.5),
                                            alpha_mode=m.AlphaMode.BLENDED))
        ghost = registry.create_material(
            "ghost", m.PbrMaterialParameters(
                base_color_factor=(1, 1, 1, 0.3), alpha_cutoff=0.5,
                alpha_mode=m.AlphaMode.ALPHA_TO_COVERAGE))
        scene = m.Scene()
        scene.queue_mesh(far, red, None, m.math3d.IDENTITY)
        scene.queue_mesh(near, blue, None, m.math3d.IDENTITY)
        scene.queue_mesh(near, ghost, None, m.math3d.trs(
            translation=np.array([0.4, 0, 0.1], np.float32)))
        return registry, scene, m.RenderConfig(width=W, height=H)
    if name == "strip-quads":
        # tests/test_engine.py::test_shade_strips_bit_equal's scene, 128×64
        # (its 128×96 cut by two tile rows): every stacked shade call site
        # (solid candidates, the masked alpha test, blended layers)
        back = _quad(m, builder, 2.0, half=2.0)
        masked = _quad(m, builder, 1.5, half=0.5)
        blended = _quad(m, builder, 1.0, half=0.4)
        builder.build()
        mats = [
            registry.create_material("bg", m.PbrMaterialParameters(
                base_color_factor=(0.8, 0.2, 0.1, 1))),
            registry.create_material("mask", m.PbrMaterialParameters(
                base_color_factor=(0.2, 0.9, 0.3, 0.6), alpha_cutoff=0.5,
                alpha_mode=m.AlphaMode.ALPHA_TO_COVERAGE)),
            registry.create_material("blend", m.PbrMaterialParameters(
                base_color_factor=(0.1, 0.4, 0.9, 0.5),
                alpha_mode=m.AlphaMode.BLENDED)),
        ]
        scene = m.Scene()
        for mesh, mat in zip((back, masked, blended), mats):
            scene.queue_mesh(mesh, mat, None, m.math3d.IDENTITY)
        return registry, scene, m.RenderConfig(width=128, height=64, tile_h=16,
                                               msaa_samples=4, shade_strip_elems=0)
    assert name == "sandbox-static", name
    base = np.zeros((64, 64, 4), np.uint8)
    base[..., 3] = 255
    yy, xx = np.mgrid[0:64, 0:64]
    checker = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
    base[..., 0] = 40 + 200 * checker
    base[..., 1] = 120
    base[..., 2] = 240 - 200 * checker
    mips = [base]
    while mips[-1].shape[0] > 1:
        mips.append(mips[-1][::2, ::2])
    tex = m.Texture(mips, m.TextureKind.SRGB_COLOR, "checker")
    meshes = []
    for i in range(6):
        p, uv, n, t, idx = m.proxy._patch_geometry(
            400, 1200, [-0.8, -0.5, -0.2], [0.8, 0.5, 0.2], seed=100 + i)
        meshes.append(builder.add_mesh(p, uv, n, t, idx))
    mats = [
        registry.create_material(
            "tex-opaque", m.PbrMaterialParameters(base_color=tex)),
        registry.create_material("masked", m.PbrMaterialParameters(
            base_color=tex, alpha_cutoff=0.4, base_color_factor=(1, 1, 1, 0.9),
            alpha_mode=m.AlphaMode.ALPHA_TO_COVERAGE)),
        registry.create_material("blended", m.PbrMaterialParameters(
            base_color_factor=(0.2, 0.9, 0.4, 0.45),
            alpha_mode=m.AlphaMode.BLENDED)),
    ]
    builder.build()
    scene = m.Scene(world_space=m.GLTF)
    scene.camera.position = np.array([0.0, 0.9, 2.6], np.float32)
    scene.camera.orientation = m.math3d.quat_from_axis_angle([0, 1, 0], np.pi)
    for i, mesh in enumerate(meshes):
        ang = 2 * np.pi * i / len(meshes)
        tr = m.math3d.trs(
            translation=np.array([1.2 * np.cos(ang), 0.6 + 0.1 * i,
                                  1.2 * np.sin(ang)], np.float32),
            rotation=m.math3d.quat_from_axis_angle([0, 1, 0], ang),
        )
        scene.queue_mesh(mesh, mats[i % 3], None, tr)
    return registry, scene, m.RenderConfig(width=W, height=H, msaa_samples=4)


def host_inputs(name: str, debug_mode: int = 0):
    """Everything the JAX package's Renderer hands its frame function for
    scene `name`, as numpy: (geom dict, materials dict, frame blob, static
    kwargs of render_frame, config)."""
    import renderer_tpu as rt
    from renderer_tpu.scene import draw_stream

    registry, scene, config = build_scene("renderer_tpu", name)
    r = rt.Renderer(registry, config, overflow_policy="off")
    fv = draw_stream.frame_view(scene)
    gs, geom_dev = r._geometry(scene, fv.order, fv.geom_key)
    blob = r._frame_arrays(scene, fv, gs, debug_mode)["blob"]
    geom = {k: np.asarray(v) for k, v in geom_dev.items()}
    mats = {k: np.asarray(v) for k, v in r._materials().items()}
    static = dict(
        skin_start=gs.skin_start,
        has_masked=gs.num_masked_tris > 0,
        has_blended=gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris,
        morph_k=gs.morph_k, joint_cap=r._joint_cap(scene),
    )
    return geom, mats, np.asarray(blob), static, config



def degenerate_triangles(device):
    """Point and collinear triangles through the port's vertex stage, as
    triangle_setup sees them: (clip [V, 4], tri_v [T, 3] i32, num_tris,
    width, height, degenerate columns, control columns).

    Columns: the zero index padding of proxy._patch_geometry in the
    "sandbox-static" scene at W×H (48 point triangles, 8 a patch; column
    792 has vertices [400, 400, 400], and 16 of them turn valid in the JAX
    package's jitted frame, whose XLA contracts setup's cross products into
    FMAs); then, appended, hand-made triangles whose
    screen positions are exact in f32: a point, a repeated vertex, and
    collinear triples (horizontal, vertical, diagonal, the diagonal at
    w = 2 and reversed). The control columns are valid triangles of the
    same vertices, so the test sees setup accept what it should."""
    from renderer_tpu_torch import Renderer
    from renderer_tpu_torch.raster import vertex_stage
    from renderer_tpu_torch.scene import draw_stream

    registry, scene, cfg = build_scene("renderer_tpu_torch", "sandbox-static")
    r = Renderer(registry, cfg, overflow_policy="off", device=device)
    fv = draw_stream.frame_view(scene)
    gs, geom = r._geometry(scene, fv.order, fv.geom_key)
    frame = draw_stream.unpack_frame(r._frame_arrays(scene, fv, gs),
                                     morph_k=gs.morph_k, joint_cap=r._joint_cap(scene))
    clip = vertex_stage.run_vertex_stage(geom, frame, gs.skin_start)["clip"]
    tri_v = geom["tri_v"][: gs.num_tris]
    live = tri_v.cpu().numpy()
    points = np.flatnonzero((live[:, 0] == live[:, 1]) & (live[:, 1] == live[:, 2]))

    # hand-made vertices at pixel (40 | 80 | 120, 24 | 48 | 72) of W×H
    def v(x, y, w=1.0):
        return [x * w, y * w, 0.5 * w, w]

    made = np.array([
        v(-0.5, 0.5), v(-0.5, 0.5), v(-0.5, 0.5),   # a point
        v(-0.5, 0.5), v(-0.5, 0.5), v(0.5, -0.5),   # a repeated vertex
        v(-0.5, 0.0), v(0.0, 0.0), v(0.5, 0.0),     # horizontal
        v(0.0, -0.5), v(0.0, 0.0), v(0.0, 0.5),     # vertical
        v(-0.5, -0.5), v(0.0, 0.0), v(0.5, 0.5),    # diagonal
        v(-0.5, -0.5, 2.0), v(0.0, 0.0, 2.0), v(0.5, 0.5, 2.0),  # at w = 2
        v(0.5, 0.5), v(0.0, 0.0), v(-0.5, -0.5),    # diagonal, reversed
        v(-0.5, -0.5), v(-0.5, 0.5), v(0.5, -0.5),  # control, front-facing
        v(0.5, -0.5), v(-0.5, 0.5), v(0.5, 0.5),    # control, front-facing
    ], np.float32)
    base = clip.shape[0]
    clip = torch.cat([clip, torch.from_numpy(made).to(clip.device)])
    n_made = made.shape[0] // 3
    made_v = torch.arange(base, base + 3 * n_made, dtype=torch.int32,
                          device=clip.device).reshape(n_made, 3)
    tri_v = torch.cat([tri_v, made_v])
    n = gs.num_tris
    degenerate = np.concatenate([points, np.arange(n, n + n_made - 2)])
    control = np.array([n + n_made - 2, n + n_made - 1])
    return clip, tri_v, tri_v.shape[0], cfg.width, cfg.height, degenerate, control


def cpu_renderer(registry, config, **kw):
    """The port's Renderer on the CPU (its default device is the card)."""
    from renderer_tpu_torch import Renderer

    return Renderer(registry, config, device="cpu", **kw)
