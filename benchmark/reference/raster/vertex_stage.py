# Frozen copy of renderer_tpu_torch/raster/vertex_stage.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Vertex stage: skinning + model transform + reverse-Z projection, batched
over the expanded (draw, vertex) stream.

Parity: renderer/shaders/glsl/main.vert (static + skinned variants).
- Skinned position: model_matrix @ (Σ weight_i · joints[joint_i + offset])
  (main.vert:78-84). Skinning is only computed for the skinned suffix of the
  expanded stream (draws sort static-first, scene.rs:35-41), so static scenes
  pay nothing.
- Normals use the per-draw inverse-transpose matrix, tangents the model 3x3;
  *neither* includes the skin matrix — a reference quirk kept for parity
  (main.vert:86-92). Tangents are Gram-Schmidt orthogonalized against the
  normal here, then interpolated (main.vert:91).

Every contraction is written out as f32 products and sums in a fixed
order (`_dot`), with no library GEMM: each output element's bits then depend
on its own inputs alone, never on the batch, so a vertex transformed in a
mesh rank's slice of the stream equals the same vertex transformed with the
whole stream. On the card a batched product's kernel, and with it the
order of its sums, changes with the batch size, so a library GEMM gives a
rank's slice other clip bits than the whole stream, and the mesh's frames
other pixels. Clip positions decide the
integer tile spans binning derives from them, so they are in full f32 (no
TF32), the counterpart of the JAX stage's Precision.HIGHEST.
"""

from __future__ import annotations

import torch


def _dot(terms):
    """Σ a·b over (a, b) pairs, summed left to right: one f32 rounding per
    product and per sum, the same on every device and at every batch."""
    (a, b), *rest = terms
    out = a * b
    for a, b in rest:
        out = out + a * b
    return out


def _normalize(v):
    """v / |v| along the last axis (of 3)."""
    ss = _dot([(v[..., i:i + 1], v[..., i:i + 1]) for i in range(3)])
    return v * torch.reciprocal(torch.sqrt(torch.clamp(ss, min=1e-20)))


def _linear(m, p):
    """[..., 3, 3] (or the first three columns of [..., 3, 4]) applied to
    [..., 3] vectors."""
    return _dot([(m[..., :, j], p[..., j:j + 1]) for j in range(3)])


def _apply_affine(m, p):
    """[..., 3, 4] affine applied to [..., 3] points."""
    return _linear(m, p) + m[..., 3]


def _skinned_model(geom, frame, src, drw, model):
    """Per-vertex model @ Σ w·joint matrix ([V, 3, 4])."""
    jidx = geom["joints"][src] + frame["joints_offset"][drw][:, None]  # [V,4]
    jmats = frame["joint_palette"][jidx]  # [V,4,3,4]
    w = geom["weights"][src]  # [V,4]
    skin = _dot([(w[:, j, None, None], jmats[:, j]) for j in range(4)])  # [V,3,4]
    # model[:, :, :3] @ skin, plus model's translation in the last column
    out = _dot([(model[:, :, j:j + 1], skin[:, j:j + 1, :]) for j in range(3)])
    return torch.cat([out[:, :, :3], (out[:, :, 3] + model[:, :, 3])[:, :, None]], dim=2)


def run_vertex_stage(geom: dict, frame: dict, skin_start: int | None,
                     morph_k: int = 0) -> dict:
    """geom: device tensors from GeometryStream; frame: unpacked per-frame
    tensors (scene.draw_stream.unpack_frame). Vertices at index ≥ skin_start
    are skinned; None skins every vertex and selects by the per-draw
    `skinned` flag.

    morph_k: number of morph-target weight columns. Morph deltas apply
    BEFORE skinning and the model transform (glTF spec order). Unmorphed
    vertices address the bank's zero row, so the tap is a no-op for them.

    Returns per-expanded-vertex tensors: clip [VE,4], uv [VE,2],
    normal [VE,3], tangent [VE,4], draw [VE] i32.
    """
    src = geom["exp_src"].long()
    drw = geom["exp_draw"]
    drl = drw.long()
    ve = src.shape[0]

    pos = geom["positions"][src]  # [VE,3]
    nrm_base = geom["normals"][src]  # [VE,3]
    if morph_k:
        row0 = geom["morph_row0"][src].long()
        step = geom["morph_step"][src].long()
        w = frame["morph_weights"][drl]  # [VE, K]
        for k in range(morph_k):
            tap = row0 + k * step
            pos = pos + w[:, k : k + 1] * geom["morph_pos"][tap]
            # morphed normal = normalize(n + Σ w·dn) — the trailing
            # _normalize below performs the normalization
            nrm_base = nrm_base + w[:, k : k + 1] * geom["morph_nrm"][tap]
    model = frame["transforms"][drl]  # [VE,3,4]

    if skin_start is None:
        skinned_model = _skinned_model(geom, frame, src, drl, model)
        is_skinned = (frame["skinned"][drl] > 0)[:, None, None]
        world = _apply_affine(torch.where(is_skinned, skinned_model, model), pos)
    elif skin_start < ve:
        skinned_model = _skinned_model(geom, frame, src[skin_start:],
                                       drl[skin_start:], model[skin_start:])
        world = torch.cat(
            [_apply_affine(model[:skin_start], pos[:skin_start]),
             _apply_affine(skinned_model, pos[skin_start:])],
            dim=0,
        )
    else:
        world = _apply_affine(model, pos)

    pv = frame["proj_view"]  # [4,4] = projection @ view
    clip = _dot([(world[:, j:j + 1], pv[:, j]) for j in range(3)]) + pv[:, 3]  # [VE,4]

    normal = _normalize(_linear(frame["normal_mats"][drl], nrm_base))
    tang4 = geom["tangents"][src]
    tang = _normalize(_linear(model, tang4[:, :3]))
    # Gram-Schmidt: ensure 90° between normal and tangent (main.vert:91).
    tn = _dot([(tang[:, i:i + 1], normal[:, i:i + 1]) for i in range(3)])
    tang = _normalize(tang - tn * normal)
    tangent = torch.cat([tang, tang4[:, 3:4]], dim=1)

    return {
        "clip": clip,
        "uv": geom["uvs"][src],
        "normal": normal,
        "tangent": tangent,
        "draw": drw,
    }
