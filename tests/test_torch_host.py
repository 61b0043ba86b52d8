"""The port's host-side copies (renderer_tpu_torch: draw-stream packing,
registry, atlas) against the JAX package's, on the same scenes built with
each package's own classes. These are numpy on both sides with the same
arithmetic, so every array must be BIT-equal."""

import numpy as np
import pytest

from tests.torch_parity import SCENES, build_scene


def _prepare(root, name):
    import importlib

    ds = importlib.import_module(f"{root}.scene.draw_stream")
    atlas = importlib.import_module(f"{root}.materials.atlas")
    registry, scene, config = build_scene(root, name)
    fv = ds.frame_view(scene)
    gs = ds.build_geometry(scene.materialize(fv.order), config.max_triangles)
    proj, view = scene.camera.proj_view(float(config.width),
                                        float(config.height), scene.world_space)
    blob = ds.pack_frame_blob(
        fv, scene.joint_palette, proj @ view,
        (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris, 3),
        morph_k=gs.morph_k, joint_cap=8,
    )
    return registry, fv, gs, blob, atlas.build_atlas(registry)


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", SCENES)
def test_host_copies_bit_equal(name):
    reg_j, fv_j, gs_j, blob_j, at_j = _prepare("renderer_tpu", name)
    reg_t, fv_t, gs_t, blob_t, at_t = _prepare("renderer_tpu_torch", name)

    assert np.array_equal(fv_j.order, fv_t.order)
    assert _bit_equal(fv_j.pdf, fv_t.pdf) and _bit_equal(fv_j.pdi, fv_t.pdi)
    for field in ("positions", "uvs", "normals", "tangents", "joints",
                  "weights", "morph_pos", "morph_nrm", "morph_row0",
                  "morph_step", "exp_src", "exp_draw", "tri_v"):
        assert _bit_equal(getattr(gs_j, field), getattr(gs_t, field)), field
    for field in ("num_tris", "num_opaque_tris", "num_masked_tris",
                  "skin_start", "num_expanded", "morph_k"):
        assert getattr(gs_j, field) == getattr(gs_t, field), field
    assert _bit_equal(blob_j, blob_t)
    for field in ("base_color_factor", "emissive_occlusion",
                  "alpha_rgh_mtl_normal", "tex_indices", "alpha_mode"):
        assert _bit_equal(getattr(reg_j, field), getattr(reg_t, field)), field
    for field in ("data", "table", "srgb", "flat", "wrap"):
        assert _bit_equal(getattr(at_j, field), getattr(at_t, field)), field


def _mixed_scene(root):
    """tests/test_draw_capacity.py's mixed scene (four small quads, the
    fourth material blended, 300 draws at random) and tests/test_triangle_e2e.py's
    instance-merge scene (two draws of one mesh and material, then the
    other mesh), built with package `root`."""
    import importlib

    from tests.torch_parity import _mods, _quad

    m = _mods(root)
    math3d = importlib.import_module(f"{root}.core.math3d")
    registry, builder = m.MaterialRegistry(), m.VertexLibraryBuilder()
    meshes = [_quad(m, builder, 1.4 + 0.1 * i, half=0.05) for i in range(4)]
    builder.build()
    mats = [registry.create_material(f"m{i}", m.PbrMaterialParameters(
        base_color_factor=(1, 1, 1, 1),
        alpha_mode=m.AlphaMode.BLENDED if i == 3 else m.AlphaMode.OPAQUE))
        for i in range(4)]
    rng = np.random.default_rng(7)
    mixed = m.Scene()
    for _ in range(300):
        i, j = int(rng.integers(4)), int(rng.integers(4))
        t = math3d.trs(translation=rng.normal(size=3).astype(np.float32) * 0.1)
        mixed.queue_mesh(meshes[i], mats[j], None, t)
    merge = m.Scene()
    merge.queue_mesh(meshes[0], mats[0], None, math3d.IDENTITY)
    merge.queue_mesh(meshes[0], mats[0], None,
                     math3d.trs(translation=np.array([1, 0, 0.0])))
    merge.queue_mesh(meshes[1], mats[0], None, math3d.IDENTITY)
    return {"mixed": mixed, "instance-merge": merge}


@pytest.mark.parametrize("name", ["mixed", "instance-merge"])
def test_draw_stream_introspection_equals_jax(name):
    """sorted_draws, geometry_key, build_frame_arrays and pack_frame_arrays
    of the port against the JAX package's: arrays bit-equal, draws and keys
    equal (library ids, a per-process counter, taken by first appearance)."""
    import importlib

    out = {}
    for root in ("renderer_tpu", "renderer_tpu_torch"):
        ds = importlib.import_module(f"{root}.scene.draw_stream")
        scene = _mixed_scene(root)[name]
        draws = ds.sorted_draws(scene)
        libs = {}
        key = tuple((libs.setdefault(lib, len(libs)), *rest)
                    for lib, *rest in ds.geometry_key(draws))
        fv = ds.frame_view(scene)
        packed = ds.pack_frame_arrays(fv, scene.joint_palette,
                                      np.eye(4, dtype=np.float32), (6, 4, 0, 2))
        out[root] = (
            [(d.mesh.mesh_id, d.material.id, d.joints_offset, d.transform.tobytes())
             for d in draws],
            key, {k: np.array(v) for k, v in ds.build_frame_arrays(scene).items()},
            packed)
    (jd, jk, ja, jp), (td, tk, ta, tp) = out["renderer_tpu"], out["renderer_tpu_torch"]
    assert td == jd and tk == jk
    assert ta.keys() == ja.keys() and tp.keys() == jp.keys()
    for k in ja:
        assert _bit_equal(ja[k], ta[k]), k
    for k in jp:
        assert _bit_equal(jp[k], tp[k]), k
    if name == "instance-merge":
        assert ta["debug_id"][0] == ta["debug_id"][1] != ta["debug_id"][2]


def test_top_level_exports_equal_jax():
    import renderer_tpu as jrt
    import renderer_tpu_torch as trt
    from renderer_tpu_torch.assets import gltf_loader

    assert trt.__version__ == jrt.__version__ == "0.1.0"
    assert trt.load_gltf is gltf_loader.load_gltf
    assert set(jrt.__all__) == set(trt.__all__)
