"""A scene as plain numpy data, and its construction through either side's
API: the port's public one (`renderer_tpu_torch`) or the reference's copies
(`benchmark.reference.api`). Both sides are handed the same arrays."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from benchmark.scenes.geometry import look_at


@dataclass
class SceneDesc:
    """meshes: (positions, uvs, normals, tangents, indices) each; textures:
    (mips, kind) each, kind "srgb" or "linear"; materials: (name, params,
    texture index or None), params the PbrMaterialParameters keywords
    besides the texture, `alpha_mode` as "opaque", "mask" or "blend";
    draws: (mesh index, material index, 4×4 transform) each."""

    meshes: list
    textures: list
    materials: list
    draws: list
    camera: dict = field(default_factory=dict)


ALPHA_MODES = {"opaque": "OPAQUE", "mask": "ALPHA_TO_COVERAGE", "blend": "BLENDED"}


def build(desc: SceneDesc, api):
    """(registry, meshes, materials) of `desc` through `api`."""
    builder = api.VertexLibraryBuilder()
    meshes = [builder.add_mesh(*m) for m in desc.meshes]
    builder.build()
    registry = api.MaterialRegistry()
    kinds = {"srgb": api.TextureKind.SRGB_COLOR, "linear": api.TextureKind.LINEAR_COLOR}
    textures = [api.Texture([np.array(m) for m in mips], kinds[kind], f"texture{i}")
                for i, (mips, kind) in enumerate(desc.textures)]
    materials = []
    for name, params, tex in desc.materials:
        kw = dict(params)
        kw["alpha_mode"] = getattr(api.AlphaMode, ALPHA_MODES[kw.get("alpha_mode", "opaque")])
        if tex is not None:
            kw["base_color"] = textures[tex]
        materials.append(registry.create_material(name, api.PbrMaterialParameters(**kw)))
    return registry, meshes, materials


def queue(scene, desc: SceneDesc, meshes, materials, pose) -> None:
    """Queue every draw of `desc` into `scene` (cleared first) and place
    its camera at `pose` (position, orientation)."""
    scene.clear()
    for mesh, mat, transform in desc.draws:
        scene.queue_mesh(meshes[mesh], materials[mat], None, transform)
    scene.camera.position, scene.camera.orientation = pose


def camera_pose(cam: dict, phase: float, t: float):
    """The camera at path time `t` seconds: an orbit around `target` at
    `radius` and `height`, its angle `center_rad` + `amplitude_rad` ·
    sin(2π t / `period_s` + phase) (a sway), or 2π t / `period_s` + phase
    when `amplitude_rad` is null (a full orbit)."""
    w = 2.0 * math.pi * t / cam["period_s"] + phase
    angle = w if cam["amplitude_rad"] is None else (
        cam["center_rad"] + cam["amplitude_rad"] * math.sin(w))
    target = np.asarray(cam["target"], np.float64)
    eye = target + np.array([cam["radius"] * math.sin(angle), cam["height"],
                             cam["radius"] * math.cos(angle)])
    return look_at(eye.astype(np.float32), target.astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))
