"""Rank bodies of the port's mesh tests (tests/test_torch_mesh*.py and the
card twin in tests/test_torch_cuda_kernels.py). Spawned processes import
this module, so it imports torch and the port only.

Scenes, at 128×128 with 16-row tiles (tests/test_multichip.py's shape):
- "triangle": the triangle app's scene, frames in debug modes 3 and 1;
- "skinned": tests/fixtures/strided.gltf (two skins, morph weights) with
  both animations playing, frames at game times 0.7 and 1.3.
"""

from __future__ import annotations

import numpy as np
import torch

W = H = 128
# (mesh, interleave): sp over 4 ranks, sp over 2 (the world is two meshes of
# two, each rendering the same frame), dp=2 × sp=2
CASES = [(m, inter) for m in ("sp4", "sp2", "dp2sp2") for inter in (False, True)]


def config(rt):
    return rt.RenderConfig(width=W, height=H, tile_h=16, tile_w=128).validate()


def build_frames(rt, name: str, **renderer_kw):
    """(renderer, scenes, debug modes) of scene `name` built with package
    `rt` (renderer_tpu or renderer_tpu_torch)."""
    import importlib

    math3d = importlib.import_module(f"{rt.__name__}.core.math3d")
    registry = rt.MaterialRegistry()
    if name == "triangle":
        tri = importlib.import_module(
            "apps.triangle" if rt.__name__ == "renderer_tpu" else f"{rt.__name__}.apps.triangle")
        registry, meshes, material = tri.build_triangle_assets()
        scenes = [tri.build_scene(meshes, material) for _ in range(2)]
        modes = (3, 1)
    elif name == "skinned":
        from tests.make_loader_fixture import GLTF_PATH

        loader = importlib.import_module(f"{rt.__name__}.assets.gltf_loader")
        builder = rt.VertexLibraryBuilder()
        kw = {"device": "cpu"} if rt.__name__ != "renderer_tpu" else {}
        gltf = loader.load_gltf(GLTF_PATH, builder, registry, **kw)
        builder.build()
        scenes = []
        for t in (0.7, 1.3):
            scene = rt.Scene(world_space=rt.GLTF)
            pos, orient = math3d.look_at(np.array([0.3, 1.2, 4.0], np.float32),
                                         np.array([0.3, 0.5, 0.0], np.float32),
                                         np.array([0.0, 1.0, 0.0], np.float32))
            scene.camera.position = pos
            scene.camera.orientation = orient
            gltf.queue_animated(scene, math3d.IDENTITY,
                                [(t % a.end_time, a) for a in gltf.animations])
            scenes.append(scene)
        modes = (0, 0)
    else:
        raise ValueError(name)
    renderer = rt.Renderer(registry, config(rt), **renderer_kw)
    return renderer, scenes, modes


def device_inputs(renderer, scenes, modes):
    """(gs, geom, [frame dicts], materials, joint_cap) through the renderer's
    own preparation (the port's mesh.frame_inputs)."""
    from renderer_tpu_torch.parallel.mesh import frame_inputs

    outs = [frame_inputs(renderer, s, m) for s, m in zip(scenes, modes)]
    gs, geom, _f, mats, jc = outs[0]
    assert all(o[4] == jc for o in outs)
    return gs, geom, [o[2] for o in outs], mats, jc


def run_cases(rank: int, name: str, device_type: str) -> dict:
    """Every case of CASES on this rank. Returns {case: (image, stats)} as
    numpy arrays, the hand-made stats combine, and this rank's kernel
    launch counts."""
    import renderer_tpu_torch as trt
    from renderer_tpu_torch.parallel import mesh as pmesh
    from renderer_tpu_torch.raster import pipeline

    device = torch.device(device_type)
    mesh4 = pmesh.make_mesh(4)
    mesh2 = pmesh.make_mesh(2)
    mesh22 = pmesh.make_mesh_2d(2, 2)
    renderer, scenes, modes = build_frames(trt, name, device=device)
    gs, geom, frames, mats, jc = device_inputs(renderer, scenes, modes)
    cfg = renderer.config
    kw = dict(joint_cap=jc, morph_k=gs.morph_k)
    before = pipeline.launch_counts()
    out = {}
    for inter in (False, True):
        for case, mesh in (("sp4", mesh4), ("sp2", mesh2)):
            out[(case, inter)] = pmesh.render_frame_sharded(
                geom, frames[0], mats, config=cfg, mesh=mesh, interleave=inter, **kw)
        batch = {"blob": torch.stack([f["blob"] for f in frames])}
        # the interleaved batch also runs per-shard binning buckets
        bcfg = pmesh.per_shard_config(cfg, 2) if inter else cfg
        out[("dp2sp2", inter)] = pmesh.render_frames_batched(
            geom, batch, mats, config=bcfg, mesh=mesh22, interleave=inter, **kw)
    after = pipeline.launch_counts()
    n = pipeline.N_STATS
    hand = (torch.arange(n, dtype=torch.int32) * (rank + 1) + (rank % 2) * 100).to(device)
    combined = pmesh._combine_shard_stats(hand, mesh4.groups["sp"])
    return {
        "cases": {k: (img.cpu().numpy(), st.cpu().numpy()) for k, (img, st) in out.items()},
        "combined": combined.cpu().numpy(),
        "launches": {k: after[k] - before[k] for k in after},
    }


def singles(name: str) -> list:
    """The port's single-device frames (CPU) of scene `name`:
    [(image, stats)] per frame."""
    import renderer_tpu_torch as trt
    from renderer_tpu_torch.raster import pipeline

    renderer, scenes, modes = build_frames(trt, name, device="cpu")
    gs, geom, frames, mats, jc = device_inputs(renderer, scenes, modes)
    out = []
    for f in frames:
        img, st = pipeline.render_frame(geom, f, mats, config=renderer.config,
                                        skin_start=gs.skin_start, morph_k=gs.morph_k,
                                        joint_cap=jc)
        out.append((img.numpy(), st.numpy()))
    return out


def expected_combine(n_stats: int, world: int = 4) -> np.ndarray:
    """_combine_shard_stats of run_cases' hand-made vectors, by hand."""
    vecs = [np.arange(n_stats, dtype=np.int64) * (r + 1) + (r % 2) * 100 for r in range(world)]
    summed, peak = sum(vecs), np.max(vecs, axis=0)
    return np.concatenate([summed[:9], peak[9:13], summed[13:]]).astype(np.int32)


def agreement(a: np.ndarray, b: np.ndarray) -> float:
    return float((a == b).all(axis=-1).mean())
