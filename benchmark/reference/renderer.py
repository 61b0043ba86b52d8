# The host half of the reference: what renderer_tpu_torch/engine/renderer.py
# (commit 5822f29) derives from a registry and a scene before it runs a frame
# (`_geometry`, `_materials` on the host atlas path, `_frame_arrays`,
# `_proj_view`, `_joint_cap`), restated over the frozen copies in this
# package. Part of the benchmark's yardstick; do not edit.
"""The plain reference renderer: one frame of a scene built with this
package's copies of the registry, vertex library and scene, rendered by
`frame.render_frame` on any torch device."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import frame as frame_mod
from benchmark.reference.materials.atlas import build_atlas
from benchmark.reference.scene import draw_stream

GEOM_KEYS = ("positions", "uvs", "normals", "tangents", "joints", "weights",
             "exp_src", "exp_draw", "tri_v", "morph_pos", "morph_nrm",
             "morph_row0", "morph_step")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def _up(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


class PlainRenderer:
    """Renders frames of scenes that queue one draw list, keeping the
    geometry and the materials it derived from them on `device`."""

    def __init__(self, registry, config, device) -> None:
        self.registry = registry
        self.config = config.validate()
        self.device = torch.device(device)
        self._geom = None
        self._mats = None

    def _geometry(self, scene, fv):
        if self._geom is None or self._geom[0] != fv.geom_key:
            gs = draw_stream.build_geometry(scene.materialize(fv.order),
                                            self.config.max_triangles)
            dev = {k: _up(getattr(gs, k), self.device) for k in GEOM_KEYS}
            self._geom = (fv.geom_key, gs, dev)
        return self._geom[1], self._geom[2]

    def materials(self) -> dict:
        if self._mats is None:
            reg, at = self.registry, build_atlas(self.registry)
            self._mats = {
                "base_color_factor": _up(reg.base_color_factor, self.device),
                "emissive_occlusion": _up(reg.emissive_occlusion, self.device),
                "alpha_rgh_mtl_normal": _up(reg.alpha_rgh_mtl_normal, self.device),
                "tex_indices": _up(reg.tex_indices, self.device),
                # RGBA8 packed in u32; torch keeps the bits as i32
                "atlas": _up(at.data.view(np.int32), self.device),
                "atlas_table": _up(at.table, self.device),
                "atlas_srgb": _up(at.srgb, self.device),
            }
            if at.wrap.any():
                self._mats["atlas_wrap"] = _up(at.wrap, self.device)
        return self._mats

    def render(self, scene, probe: dict | None = None):
        """(u8 image [H, W, 3], stats i32 [N_STATS]) of one frame of
        `scene`; `probe`, when a dict, receives the frame's intermediates
        and the inputs it was given ("geom", "materials", "blob")."""
        cfg = self.config
        fv = draw_stream.frame_view(scene)
        gs, geom = self._geometry(scene, fv)
        joint_cap = _next_pow2(max(scene._joint_cursor, 8))
        proj, view = scene.camera.proj_view(float(cfg.width), float(cfg.height),
                                            scene.world_space)
        blob = draw_stream.pack_frame_blob(
            fv, scene.joint_palette, proj @ view,
            (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris, 0),
            morph_k=gs.morph_k, joint_cap=joint_cap)
        blob = torch.from_numpy(blob).to(self.device)
        mats = self.materials()
        if probe is not None:
            probe.update(geom=geom, materials=mats, blob=blob)
        return frame_mod.render_frame(
            geom, {"blob": blob}, mats, config=cfg, skin_start=gs.skin_start,
            has_masked=gs.num_masked_tris > 0,
            has_blended=gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris,
            morph_k=gs.morph_k, joint_cap=joint_cap, probe=probe)
