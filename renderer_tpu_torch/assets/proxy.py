"""Proxy geometry for glTF files whose binary buffers are unavailable, and
procedural geometry for the benchmark scenes.

The reference checkout ships Sponza.gltf / smol-ame.gltf with all textures
(.ntex) but not the .bin geometry buffers (LFS objects). `load_gltf_proxy`
reconstructs such a scene with the *exact* draw structure from the glTF
JSON — per-primitive vertex and index counts from the accessors, placed
inside the real per-primitive POSITION min/max AABBs, with the real nodes,
materials and textures — substituting a procedurally deformed surface patch
for the lost vertex data. Triangle count, draw count, material/texture
binding pattern and spatial distribution match the real scene; only the
surface shapes differ.

Also: the >1M-triangle stress field, the screen-spanning overdraw stack
(the pair-count stress axis), a morph-target sheet, and a procedural
skinned character (for the missing Smol Ame geometry) so the
skeletal-animation path runs with real joint palettes and keyframes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from renderer_tpu_torch.assets import gltf_loader
from renderer_tpu_torch.core import math3d
from renderer_tpu_torch.geometry.vertex_library import VertexLibraryBuilder
from renderer_tpu_torch.materials.registry import (
    MaterialRegistry,
    PbrMaterialParameters,
    Texture,
    TextureKind,
)


def _patch_geometry(vertex_count: int, index_count: int, aabb_min, aabb_max, seed: int):
    """A deformed grid patch with exactly vertex_count vertices and
    index_count indices, filling the AABB. Grid topology keeps the triangle
    stream spatially coherent like a real mesh."""
    rng = np.random.default_rng(seed)
    tri_count = index_count // 3
    # grid of (gw+1)x(gh+1) vertices gives 2*gw*gh triangles
    gw = max(int(np.sqrt(max(tri_count // 2, 1))), 1)
    gh = max(tri_count // (2 * gw), 1)
    while (gw + 1) * (gh + 1) > vertex_count and gh > 1:
        gh -= 1
    nx, ny = gw + 1, gh + 1

    u = np.linspace(0, 1, nx, dtype=np.float32)
    v = np.linspace(0, 1, ny, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)  # [ny,nx]
    lo = np.asarray(aabb_min, np.float32)
    hi = np.asarray(aabb_max, np.float32)
    size = hi - lo
    # Fold the patch through the box along its two largest extents; ripple
    # the third axis so the surface is non-planar.
    order = np.argsort(-size)
    a, b, c = order[0], order[1], order[2]
    phase = rng.uniform(0, 2 * np.pi, 3)
    pos = np.zeros((ny, nx, 3), np.float32)
    pos[..., a] = lo[a] + uu * size[a]
    pos[..., b] = lo[b] + vv * size[b]
    ripple = 0.5 + 0.5 * np.sin(2 * np.pi * (2 * uu + 3 * vv) + phase[0])
    pos[..., c] = lo[c] + ripple * size[c]

    # analytic normal of the ripple surface (approximate via gradients)
    dz_du = np.gradient(pos[..., c], axis=1)
    dz_dv = np.gradient(pos[..., c], axis=0)
    du = np.zeros_like(pos)
    du[..., a] = size[a] / max(nx - 1, 1)
    du[..., c] = dz_du
    dv = np.zeros_like(pos)
    dv[..., b] = size[b] / max(ny - 1, 1)
    dv[..., c] = dz_dv
    n = np.cross(du.reshape(-1, 3), dv.reshape(-1, 3))
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)

    t = du.reshape(-1, 3)
    t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-9)
    tangents = np.concatenate([t, np.full((t.shape[0], 1), 1.0, np.float32)], axis=1)

    positions = pos.reshape(-1, 3)
    uvs = np.stack([uu * 4.0, vv * 4.0], axis=-1).reshape(-1, 2).astype(np.float32)

    # pad vertices up to the exact accessor count (duplicates of vertex 0)
    pad = vertex_count - positions.shape[0]
    if pad > 0:
        positions = np.vstack([positions, np.repeat(positions[:1], pad, 0)])
        n = np.vstack([n, np.repeat(n[:1], pad, 0)])
        tangents = np.vstack([tangents, np.repeat(tangents[:1], pad, 0)])
        uvs = np.vstack([uvs, np.repeat(uvs[:1], pad, 0)])

    # grid triangulation, then pad/trim to the exact index count
    i0 = np.arange(gh)[:, None] * nx + np.arange(gw)[None, :]
    quads = np.stack(
        [i0, i0 + nx, i0 + 1, i0 + 1, i0 + nx, i0 + nx + 1], axis=-1
    ).reshape(-1, 3)
    indices = quads.reshape(-1)[:index_count].astype(np.uint32)
    if indices.size < index_count:
        padding = np.zeros(index_count - indices.size, np.uint32)
        indices = np.concatenate([indices, padding])
    return positions.astype(np.float32), uvs, n.astype(np.float32), tangents.astype(np.float32), indices


def load_gltf_proxy(
    path: str | Path, builder: VertexLibraryBuilder, registry: MaterialRegistry,
    *, device="cuda",
) -> gltf_loader.Gltf:
    """Like gltf_loader.load_gltf but substituting procedural geometry for
    missing buffer data. Nodes, textures (lazy ntex, decoded on `device` —
    the card unless the caller asks for the CPU), materials and the draw
    structure are loaded for real."""
    path = Path(path)
    gltf = json.loads(path.read_bytes())
    resource_dir = path.parent
    out = gltf_loader.Gltf()

    out.root_nodes = list(gltf["scenes"][gltf.get("scene", 0)].get("nodes") or [])
    gltf_loader._parse_nodes(gltf, out)
    gltf_loader._flatten_transforms(out)

    kinds = gltf_loader._texture_kinds(gltf)
    image_wrap = gltf_loader._image_wrap_modes(gltf)
    for i, image in enumerate(gltf.get("images", [])):
        tex = gltf_loader.ntex_texture(
            (resource_dir / image["uri"]).with_suffix(".ntex"),
            kinds.get(i, TextureKind.LINEAR_COLOR), image_wrap.get(i, (0, 0)),
            device, name=image["uri"])
        registry.register_texture(tex)
        out.textures.append(tex)

    for mat in gltf.get("materials", []):
        params = gltf_loader._material_params(gltf, mat, out.textures,
                                              check_tex_coord=False)
        out.materials.append(
            registry.create_material(mat.get("name", "unnamed material"), params))

    # proxy meshes from accessor metadata
    accessors = gltf["accessors"]
    for mi, mesh in enumerate(gltf.get("meshes", [])):
        primitives = []
        for pi, prim in enumerate(mesh.get("primitives", [])):
            pos_acc = accessors[prim["attributes"]["POSITION"]]
            idx_acc = accessors[prim["indices"]]
            positions, uvs, normals, tangents, indices = _patch_geometry(
                pos_acc["count"], idx_acc["count"],
                pos_acc.get("min", [-1, -1, -1]), pos_acc.get("max", [1, 1, 1]),
                seed=mi * 1000 + pi,
            )
            lib_mesh = builder.add_mesh(positions, uvs, normals, tangents, indices)
            primitives.append((lib_mesh, out.materials[prim["material"]]))
        out.meshes.append(primitives)
    return out


def make_overdraw_stack(
    builder: VertexLibraryBuilder,
    registry,
    extent: float = 40.0,
    y0: float = 3.0,
    n_layers: int = 8000,
    dy: float = 0.002,
):
    """A stack of `n_layers` screen-spanning quads: the PAIR-scale stress
    axis (VERDICT r2 #1). Each quad's two triangles cover most of the tile
    grid, so (tile, triangle) pairs ≈ n_layers · 2 · n_tiles — millions of
    pairs from a few thousand triangles, exercising the binning expansion /
    sort / scatter and the raster kernels' bin streams at a scale the
    triangle-count axis (make_stress_field) cannot reach cheaply. Returns
    (mesh, material, transforms [n_layers, 4, 4] for queue_instanced)."""
    h = extent / 2
    positions = np.array(
        [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32
    )
    normals = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tangents = np.zeros((4, 4), np.float32)
    tangents[:, 0] = 1.0
    tangents[:, 3] = 1.0
    # CCW from above (GLTF world, camera above looking down)
    indices = np.array([0, 2, 1, 0, 3, 2], np.uint32)
    mesh = builder.add_mesh(positions, uvs, normals, tangents, indices)
    material = registry.create_material(
        "overdraw-stack",
        PbrMaterialParameters(base_color_factor=(0.6, 0.65, 0.7, 1.0)),
    )
    transforms = np.tile(np.eye(4, dtype=np.float32), (n_layers, 1, 1))
    transforms[:, 1, 3] = y0 + dy * np.arange(n_layers, dtype=np.float32)
    return mesh, material, transforms


def make_stress_field(
    builder: VertexLibraryBuilder,
    registry,
    n_meshes: int = 32,
    tris_per_mesh: int = 32768,
    extent: float = 40.0,
    seed: int = 7,
):
    """A >1M-triangle stress workload: n_meshes ripple patches tiled over a
    square field — the capacity axis (SURVEY §5.7) exercised well beyond
    Sponza scale (binning pair counts in the millions, triangle stream at
    the max_triangles bucket). Returns (meshes, material)."""
    from renderer_tpu_torch.materials.registry import PbrMaterialParameters

    material = registry.create_material(
        "stress-field",
        PbrMaterialParameters(base_color_factor=(0.7, 0.7, 0.75, 1.0)),
    )
    # round DOWN to a SQUARE-grid-exact count (2·g²): _patch_geometry
    # zero-pads the index stream past its grid's triangles, which would
    # silently count degenerate (0,0,0) triangles toward the stress total; a
    # square grid is a fixed point of its gw/gh derivation, so the requested
    # count is delivered exactly (32768 = 2·128² stays 32768)
    g = max(int(np.sqrt(max(tris_per_mesh // 2, 1))), 1)
    gw = gh = g
    tris_per_mesh = 2 * g * g
    side = int(np.ceil(np.sqrt(n_meshes)))
    cell = extent / side
    meshes = []
    for i in range(n_meshes):
        gx, gz = i % side, i // side
        lo = (gx * cell - extent / 2, 0.0, gz * cell - extent / 2)
        hi = (lo[0] + cell, 2.0, lo[2] + cell)
        # exact grid verts for 2·gw·gh triangles
        vcount = (gw + 1) * (gh + 1)
        p, uv, n, t, idx = _patch_geometry(
            vcount, tris_per_mesh * 3, lo, hi, seed + i
        )
        meshes.append(builder.add_mesh(p, uv, n, t, idx))
    return meshes, material


def make_skinned_character(
    builder: VertexLibraryBuilder,
    registry: MaterialRegistry,
    *,
    n_joints: int = 8,
    segments: int = 24,
    radial: int = 12,
    height: float = 1.0,
    textures: list[Texture] | None = None,
) -> gltf_loader.Gltf:
    """A procedurally skinned, animated tube character (stand-in for the
    missing Smol Ame geometry): a vertical cylinder bound to a chain of
    n_joints bones with a looping sway animation. Exercises the exact same
    runtime path as a real skinned glTF: joints/weights attributes, inverse
    bind matrices, keyframed TRS channels, joint palettes."""
    out = gltf_loader.Gltf()

    # cylinder mesh with 4-bone skinning
    zs = np.linspace(0.0, height, segments, dtype=np.float32)
    angles = np.linspace(0, 2 * np.pi, radial, endpoint=False, dtype=np.float32)
    radius = 0.15 * (1.0 + 0.3 * np.sin(np.linspace(0, np.pi, segments)))
    positions, normals, uvs, joints, weights = [], [], [], [], []
    for si, z in enumerate(zs):
        for ai, ang in enumerate(angles):
            r = radius[si]
            positions.append([r * np.cos(ang), z, r * np.sin(ang)])
            normals.append([np.cos(ang), 0.0, np.sin(ang)])
            uvs.append([ai / radial, si / (segments - 1)])
            # bind to the two nearest bones along the chain
            f = z / height * (n_joints - 1)
            j0 = int(np.floor(f))
            j1 = min(j0 + 1, n_joints - 1)
            w1 = f - j0
            joints.append([j0, j1, 0, 0])
            weights.append([1.0 - w1, w1, 0.0, 0.0])
    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    uvs = np.asarray(uvs, np.float32)
    tangents = np.zeros((positions.shape[0], 4), np.float32)
    tangents[:, 1] = 1.0
    tangents[:, 3] = 1.0

    indices = []
    for si in range(segments - 1):
        for ai in range(radial):
            a = si * radial + ai
            b = si * radial + (ai + 1) % radial
            c = (si + 1) * radial + ai
            d = (si + 1) * radial + (ai + 1) % radial
            indices += [a, c, b, b, c, d]
    indices = np.asarray(indices, np.uint32)

    mesh = builder.add_mesh(
        positions, uvs, normals, tangents, indices,
        joints=np.asarray(joints, np.int32), weights=np.asarray(weights, np.float32),
    )
    params = PbrMaterialParameters(
        base_color=(textures[0] if textures else None),
        base_color_factor=(0.9, 0.6, 0.7, 1.0),
        roughness_factor=0.8,
    )
    material = registry.create_material("proxy-character", params)
    out.materials = [material]
    out.meshes = [[(mesh, material)]]

    # node hierarchy: node 0 = mesh+skin root; nodes 1..n_joints = bone chain
    seg_h = height / (n_joints - 1)
    out.nodes.append(gltf_loader.Node("root", mesh=0, skin=0, children=[1],
                                      transform=math3d.IDENTITY))
    for j in range(n_joints):
        local = math3d.trs(translation=np.array([0, 0 if j == 0 else seg_h, 0], np.float32))
        out.nodes.append(
            gltf_loader.Node(
                f"bone{j}", mesh=None, skin=None,
                children=[j + 2] if j < n_joints - 1 else [],
                transform=local,
            )
        )
    out.root_nodes = [0]
    # flatten parents (loader parity)
    parents = [0]
    while parents:
        p = parents.pop()
        for c in out.nodes[p].children:
            out.nodes[c].transform = out.nodes[p].transform @ out.nodes[c].transform
            parents.append(c)

    ibms = []
    for j in range(n_joints):
        bind = math3d.trs(translation=np.array([0, j * seg_h, 0], np.float32))
        ibms.append(math3d.affine_inverse(bind))
    out.skins = [gltf_loader.Skin(
        [gltf_loader.Joint(node_index=j + 1, inverse_bind_matrix=ibms[j])
         for j in range(n_joints)]
    )]

    # Sway animation: each bone rotates about Z with a phase offset. Every
    # animated bone also gets a constant translation channel carrying its
    # LOCAL offset — required because animation evaluation starts from the
    # parent-flattened node transform (reference quirk, lib.rs:199-230):
    # channels provide local TRS, overriding the flattened decomposition.
    duration = 2.0
    times = np.linspace(0, duration, 16, dtype=np.float32)
    channels: list[list | None] = [None] * len(out.nodes)
    for j in range(n_joints):
        quats = np.stack(
            [
                math3d.quat_from_axis_angle(
                    [0, 0, 1], 0.35 * np.sin(2 * np.pi * t / duration + 0.5 * j)
                )
                for t in times
            ]
        )
        local_t = np.tile(
            np.array([0.0, 0.0 if j == 0 else seg_h, 0.0], np.float32), (len(times), 1)
        )
        channels[j + 1] = [
            gltf_loader.AnimationChannel("LINEAR", "rotation", times, quats),
            gltf_loader.AnimationChannel("LINEAR", "translation", times, local_t),
        ]
    # Second animation, "bob": vertical bounce on every other bone plus a
    # breathing scale on the last bone, layered ON TOP of "sway" (the demo
    # plays ALL animations, main.rs:565-571 — the real Smol Ame layers
    # several; playing ≥2 exercises the decompose-accumulate path of
    # lib.rs:199-230 every frame).
    bob_duration = 3.0
    bob_times = np.linspace(0, bob_duration, 12, dtype=np.float32)
    bob_channels: list[list | None] = [None] * len(out.nodes)
    for j in range(1, n_joints, 2):
        local_y = 0.0 if j == 0 else seg_h
        tr = np.stack(
            [
                np.array(
                    [0.0, local_y + 0.03 * np.sin(2 * np.pi * t / bob_duration),
                     0.0], np.float32,
                )
                for t in bob_times
            ]
        )
        bob_channels[j + 1] = [
            gltf_loader.AnimationChannel("LINEAR", "translation", bob_times, tr),
        ]
    breathe = np.stack(
        [
            np.array(
                [1.0, 1.0 + 0.15 * np.sin(2 * np.pi * t / bob_duration), 1.0],
                np.float32,
            )
            for t in bob_times
        ]
    )
    last = n_joints  # node index of the last bone
    if bob_channels[last] is None:
        bob_channels[last] = []
    bob_channels[last].append(
        gltf_loader.AnimationChannel("LINEAR", "scale", bob_times, breathe)
    )
    out.animations = [
        gltf_loader.Animation("sway", 0.0, float(duration), channels),
        gltf_loader.Animation("bob", 0.0, float(bob_duration), bob_channels),
    ]
    return out


def make_morph_sheet(
    builder: VertexLibraryBuilder,
    registry,
    n: int = 48,
    extent: float = 2.0,
):
    """A subdivided sheet with two morph targets — the demo workload for
    blend-shape animation (a capability the reference never implemented;
    its weights evaluation is a todo!(), gltf/src/lib.rs:229):

    - target 0: a standing wave (y = a·sin(2πx/e)·cos(2πz/e)) with the
      matching analytic normal deltas,
    - target 1: a radial gaussian bulge, position deltas only (the vertex
      stage renormalizes n + Σ w·Δn, so a missing Δn tilts nothing).

    Returns (mesh, material); animate with
    scene.queue_mesh(..., morph_weights=[w0(t), w1(t)]).
    """
    h = extent / 2.0
    xs = np.linspace(-h, h, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    positions = np.stack([gx, np.zeros_like(gx), gz], -1).reshape(-1, 3)
    uvs = np.stack(
        [(gx + h) / extent, (gz + h) / extent], -1
    ).reshape(-1, 2).astype(np.float32)
    normals = np.tile(np.array([0, 1, 0], np.float32), (positions.shape[0], 1))
    tangents = np.zeros((positions.shape[0], 4), np.float32)
    tangents[:, 0] = 1.0
    tangents[:, 3] = 1.0

    # two CCW-from-above triangles per cell (the overdraw-stack winding)
    ii = np.arange(n, dtype=np.uint32)
    a = (ii[:, None] * (n + 1) + ii[None, :]).reshape(-1)  # (i, j)
    b = a + (n + 1)  # (i+1, j)
    c = b + 1        # (i+1, j+1)
    d = a + 1        # (i, j+1)
    indices = np.stack([a, c, b, a, d, c], -1).reshape(-1).astype(np.uint32)

    x, z = positions[:, 0], positions[:, 2]
    k = 2.0 * np.pi / extent
    amp = 0.35
    wave_y = amp * np.sin(k * x) * np.cos(k * z)
    d0 = np.zeros_like(positions)
    d0[:, 1] = wave_y
    # normal of y = f(x, z) is normalize(-df/dx, 1, -df/dz); the delta is
    # (normal - base) since the stage computes normalize(n + Σ w·Δn)
    dfdx = amp * k * np.cos(k * x) * np.cos(k * z)
    dfdz = -amp * k * np.sin(k * x) * np.sin(k * z)
    wn = np.stack([-dfdx, np.ones_like(dfdx), -dfdz], -1)
    wn /= np.linalg.norm(wn, axis=-1, keepdims=True)
    dn0 = (wn - normals).astype(np.float32)

    r2 = (x * x + z * z) / (h * h)
    d1 = np.zeros_like(positions)
    d1[:, 1] = 0.5 * np.exp(-4.0 * r2)

    mesh = builder.add_mesh(
        positions, uvs, normals, tangents, indices,
        morph_targets=[(d0.astype(np.float32), dn0),
                       (d1.astype(np.float32), None)],
    )
    material = registry.create_material(
        "morph-sheet",
        PbrMaterialParameters(base_color_factor=(0.85, 0.55, 0.25, 1.0)),
    )
    return mesh, material
