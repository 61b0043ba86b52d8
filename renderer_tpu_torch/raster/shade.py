"""Deferred shading: visibility buffer → HDR color.

Replaces the fragment shader (reference: renderer/shaders/glsl/main.frag) as a
dense [..., H, W] tensor pass: each covered pixel gathers its triangle's three
vertices, reconstructs perspective-correct barycentrics, interpolates
attributes, samples material textures, and evaluates the lighting / debug
mode. Every pixel is shaded exactly once — shading cost is independent of
overdraw, and all texture fetches across the frame batch into a handful of
large gathers.

Parity notes:
- Interpolated normals/tangents are NOT renormalized per pixel (the reference
  fragment shader uses the raw interpolated varyings, main.frag:64-67).
- Normal mapping: bitangent = tangent.w · cross(normal, tangent.xyz);
  n = TBN @ normalize(normal_tex · [scale, scale, 1]) (main.frag:64-67).
- Lit mode (main.frag:78-88): emissive override if ‖emissive‖ > 0, else
  brightness = 0.3·occlusion + 2.0·max(0, n·normalize(-1,1,1)).
- Debug modes 1-6 (main.frag:89-107); draw-id color hash
  fract(sin(d·k)·43758.5453123) evaluated per draw (main.vert:67-77).
- Texture sampling: bilinear from the packed RGBA8 atlas (materials/atlas.py,
  stored as int32 here, so the top byte needs `& 0xFF` after the arithmetic
  shift) with per-pixel per-axis texel-space mip selection from analytic UV
  screen derivatives (the reference sampler is repeat anisotropic trilinear,
  descriptors.rs:90-105). sRGB decode runs per tap before the filter
  weights by default (`srgb_per_tap`, the hardware order); the
  fast_sampler() option decodes the filtered value instead.

`shade_stack` and `alpha_stack` are the stage's entry points. They dispatch
on the tensors' device: CPU tensors run the plain versions
(shade_interpolated / base_alpha over interpolants), CUDA tensors launch the
hand-written kernels S1 and S2 (csrc/shade.cu), which repeat the plain
versions op for op. The plain versions write their short sums out as
explicit adds, and multiply by the same f32 constants the kernels use, so
that on the card both round alike.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.materials.atlas import MAX_MIPS

#: the launch counters in profiling.COUNTERS of S1 ("shade") and S2
#: ("alpha"); the plain versions do not count
LAUNCHES = ("shade", "alpha")
profiling.register_launches(LAUNCHES)

# f32 constants the plain versions multiply by, as the kernels do
# (csrc/shade_common.cuh): exact f32 values, so a product rounds alike on
# every device
_INV_12_92 = float(np.float32(1) / np.float32(12.92))
_INV_1_055 = float(np.float32(1) / np.float32(1.055))
_INV_SQRT3 = float(np.float32(1) / np.sqrt(np.float32(3)))


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """x[..., 0] + x[..., 1] + x[..., 2] added left to right in f32 and
    rounded once to x's type (torch.sum's f32 accumulation of a bf16
    tensor), in the kernels' order."""
    f = x.to(torch.float32)
    return (f[..., 0] + f[..., 1] + f[..., 2]).to(x.dtype)


def _dot3(w: list, rows: torch.Tensor) -> torch.Tensor:
    """w[0]·rows[..., 0, :] + w[1]·rows[..., 1, :] + w[2]·rows[..., 2, :]
    (w: three [...] weights, rows [..., 3, K]) added left to right — the
    barycentric interpolation the kernels do, in place of an einsum whose
    order the library picks."""
    return (w[0][..., None] * rows[..., 0, :] + w[1][..., None] * rows[..., 1, :]
            + w[2][..., None] * rows[..., 2, :])


def _rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] along dim 0 (idx in range), gathered one column at a time:
    a 1-D gather per column is several times faster on the GPU than
    PyTorch's row gather (measured on an H100: 0.17 ms against 1.26 ms for
    2M 16-byte rows), with the same values."""
    idx = idx.long()
    if arr.ndim == 1:
        return arr.take(idx)
    cols = arr.reshape(arr.shape[0], -1).t().contiguous()
    out = torch.stack([col.take(idx) for col in cols], dim=-1)
    return out.reshape(*idx.shape, *arr.shape[1:])


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] along dim 0 with the JAX gather's index semantics (negative
    indices wrap once, then clamp into range) — background and degenerate
    pixels compute indices that are never used but must not fault."""
    n = arr.shape[0]
    idx = idx.long()
    return _rows(arr, torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1))


def _srgb_decode(c):
    lo = c * _INV_12_92
    hi = torch.pow((c + 0.055) * _INV_1_055, 2.4)
    return torch.where(c <= 0.04045, lo, hi)


def make_sampler(materials: dict, uv, lod_base, trilinear: bool = True,
                 duv_dx=None, duv_dy=None, aniso: int = 1,
                 srgb_per_tap: bool = False, compute_dtype=torch.float32):
    """Returns sample(slot) -> [..., H, W, 4] linear RGBA: repeat-wrap
    bilinear / trilinear (two-mip blend) / anisotropic (N trilinear taps
    along the major UV screen-derivative axis) atlas fetch. The mip level
    comes from per-axis texel-space screen derivatives (duv · texture size);
    lod_base is only the fallback when no derivatives are supplied.

    compute_dtype=torch.bfloat16 runs the filter arithmetic (tap blending,
    sRGB decode) at bf16; texel addressing (uv→texel, mip LOD) always stays
    f32."""
    atlas = materials["atlas"]  # [AH,AW] i32 (u32 bits)
    table = materials["atlas_table"]  # [T,M,4] i32
    srgb = materials["atlas_srgb"]  # [T] i32
    # per-texture per-axis address mode ([T,2] i32, TextureWrap values),
    # absent when every texture repeats
    wrap_table = materials.get("atlas_wrap")
    aw = atlas.shape[1]
    atlas_flat = atlas.reshape(-1)
    table_flat = table.reshape(-1, 4)
    # constants are made on the device (fills, arange), never copied from
    # the host: a CUDA graph capture of the frame allows no such copy
    inv255 = torch.full((), 1.0 / 255.0, dtype=compute_dtype, device=atlas.device)
    # byte shifts of R, G, B, A in a packed texel, and the channels the sRGB
    # decode applies to (alpha is stored linear)
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=atlas.device)
    rgb_lanes = torch.arange(4, device=atlas.device) < 3

    def apply_wrap(uvq, wm):  # uvq [...,2] f32; wm [...,2] i32 or None
        rep = uvq - torch.floor(uvq)  # REPEAT
        if wm is None:
            return rep
        half = uvq * 0.5  # MIRRORED_REPEAT: period-2 triangle wave
        mir = 1.0 - torch.abs(2.0 * (half - torch.floor(half)) - 1.0)
        return torch.where(wm == 1, torch.clamp(uvq, 0.0, 1.0),  # CLAMP_TO_EDGE
                           torch.where(wm == 2, mir, rep))

    def sample_mip(slot, lod, uvq, wm):  # slot,lod [...] i32; uvq [...,2]
        # address-mode transform maps into [0,1]; the bilinear taps then
        # reach at most 1 texel outside the rect, where the atlas border
        # texel was written for this texture's own mode (materials/atlas.py)
        uvf = apply_wrap(uvq, wm)
        rect = _take(table_flat, slot * MAX_MIPS + lod)  # [...,4]
        x0, y0 = rect[..., 0], rect[..., 1]
        w = rect[..., 2].to(torch.float32)
        h = rect[..., 3].to(torch.float32)
        uf = uvf[..., 0] * w - 0.5
        vf = uvf[..., 1] * h - 0.5
        iu = torch.floor(uf)
        iv = torch.floor(vf)
        fu = (uf - iu)[..., None].to(compute_dtype)
        fv = (vf - iv)[..., None].to(compute_dtype)
        iu = _f32_to_i32(iu)
        iv = _f32_to_i32(iv)

        decoded = (_take(srgb, slot) > 0)[..., None] & rgb_lanes

        def decode(c):  # sRGB → linear on RGB; alpha is stored linear
            return torch.where(decoded, _srgb_decode(c), c)

        def tap(dx, dy):
            xx = x0 + iu + dx  # border texel at -1 and w exists (wrap pad)
            yy = y0 + iv + dy
            t = _take(atlas_flat, yy * aw + xx)
            # arithmetic shift of the i32 bits, so the top byte needs & 0xFF
            c = ((t[..., None] >> shifts) & 0xFF).to(compute_dtype) * inv255
            # exact mode: decode BEFORE the filter weights (hardware order)
            return decode(c) if srgb_per_tap else c

        t00, t10, t01, t11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
        c = (
            t00 * (1 - fu) * (1 - fv)
            + t10 * fu * (1 - fv)
            + t01 * (1 - fu) * fv
            + t11 * fu * fv
        )
        if srgb_per_tap:
            return c
        # fast mode: decode the FILTERED value (4x fewer pow() evaluations)
        return decode(c)

    def sample_filtered(slot, lodf, uvq, wm):
        lodf = torch.clamp(lodf, 0.0, MAX_MIPS - 1.0)
        if not trilinear:
            return sample_mip(slot, _f32_to_i32(torch.round(lodf)), uvq, wm)
        l0 = torch.floor(lodf)
        frac = (lodf - l0)[..., None].to(compute_dtype)
        l0 = _f32_to_i32(l0)
        l1 = torch.clamp(l0 + 1, max=MAX_MIPS - 1)
        return (sample_mip(slot, l0, uvq, wm) * (1.0 - frac)
                + sample_mip(slot, l1, uvq, wm) * frac)

    def sample(slot):  # slot [...] i32
        wm = None if wrap_table is None else _take(wrap_table, slot)  # [...,2]
        sizes = _take(table[:, 0], slot)  # [...,4] mip-0 rect
        if duv_dx is None:
            # no analytic derivatives available: approximate texel-space
            # footprint with the max-dimension size (flat-shade paths only)
            size0 = torch.maximum(sizes[..., 2], sizes[..., 3]).to(torch.float32)
            return sample_filtered(
                slot, lod_base + torch.log2(torch.clamp(size0, min=1.0)), uv, wm)
        # Per-axis texel-space derivatives: scale the UV derivative by the
        # texture's (w, h) BEFORE the length reduction, so non-square
        # textures get the correct LOD on both axes.
        wh = sizes[..., 2:4].to(torch.float32)  # [...,2]
        qx, qy = duv_dx * wh, duv_dy * wh
        lx = torch.sqrt(qx[..., 0] * qx[..., 0] + qx[..., 1] * qx[..., 1])
        ly = torch.sqrt(qy[..., 0] * qy[..., 0] + qy[..., 1] * qy[..., 1])
        rho_max = torch.clamp(torch.maximum(lx, ly), min=1e-8)
        if aniso <= 1:
            return sample_filtered(slot, torch.log2(rho_max), uv, wm)
        # anisotropy: lod from the MINOR footprint axis (clamped so the
        # major/minor ratio never exceeds the tap count), N trilinear taps
        # spread along the major axis.
        inv = float(np.float32(1) / np.float32(aniso))  # the kernels' 1.0f / aniso
        rho_min = torch.maximum(torch.minimum(lx, ly), rho_max * inv)
        lodf = torch.log2(rho_min)
        major = torch.where((lx >= ly)[..., None], duv_dx, duv_dy)  # [...,2]
        acc = None
        for i in range(aniso):
            t = (i + 0.5) / aniso - 0.5
            s = sample_filtered(slot, lodf, uv + major * t, wm)
            acc = s if acc is None else acc + s
        return acc * torch.full((), 1.0 / aniso, dtype=compute_dtype, device=acc.device)

    return sample


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 → i32 for texel and mip coordinates: NaN (degenerate pixels) maps
    to 0 as XLA's conversion does; finite values are in range here."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), -(2**30), 2**30).to(torch.int32)


def draw_debug_colors(debug_id: torch.Tensor) -> torch.Tensor:
    """Per-draw hashed debug color (main.vert:67-77): d = 1 + draw_id,
    channel = fract(sin(d·k)·43758.5453123)."""
    d = 1.0 + debug_id.to(torch.float32)

    def rnd(x):
        return torch.remainder(torch.sin(x) * 43758.5453123, 1.0)

    return torch.stack(
        [rnd(d * 641.65433), rnd(d * 1864.251623), rnd(d * 182362.365)], dim=-1
    )


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def interpolants(
    trid: torch.Tensor,  # [..., H,W] i32, -1 = background
    geom: dict,
    vstage: dict,
    *,
    width: int,
    height: int,
    row0=0,  # scalar, or [h, 1] per-row offset to the GLOBAL pixel row
) -> dict:
    """Per-pixel interpolation context for a visibility buffer: gathers the
    triangle's vertices, reconstructs perspective-correct barycentrics, and
    interpolates uv plus the analytic UV screen derivative (for mip
    selection). Reused by the main shade, the masked-alpha test, and
    per-layer blended shading. Leading-dim polymorphic: the pipeline stacks
    all shade candidates into one [C,H,W] call."""
    h, w = trid.shape[-2:]
    dev = trid.device
    covered = trid >= 0
    t = torch.where(covered, trid, torch.zeros_like(trid)).long()

    vid = _rows(geom["tri_v"], t).long()  # [...,H,W,3]
    clip = _rows(vstage["clip"], vid)  # [...,H,W,3,4]

    # Homogeneous (2DH) barycentrics — matches the raster kernels' edge
    # planes exactly and stays valid for triangles crossing w = 0: with
    # pixel-scaled u_i = (X, Y, w), perspective-correct weights are
    # g_i(p) = (u_j × u_k) · (px, py, 1), normalized.
    X = (clip[..., 0] * 0.5 + clip[..., 3] * 0.5) * width
    Y = (clip[..., 1] * 0.5 + clip[..., 3] * 0.5) * height
    Wh = clip[..., 3]

    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5 + row0

    def edge_g(j, k):
        a = Y[..., j] * Wh[..., k] - Wh[..., j] * Y[..., k]
        b = Wh[..., j] * X[..., k] - X[..., j] * Wh[..., k]
        cc = X[..., j] * Y[..., k] - Y[..., j] * X[..., k]
        return a, b, a * px + b * py + cc

    a0, b0, g0 = edge_g(1, 2)
    a1, b1, g1 = edge_g(2, 0)
    a2, b2, g2 = edge_g(0, 1)
    gsum = g0 + g1 + g2
    inv_gsum = torch.reciprocal(
        torch.where(torch.abs(gsum) > 1e-20, gsum, torch.ones_like(gsum)))
    lp = [g0 * inv_gsum, g1 * inv_gsum, g2 * inv_gsum]

    def interp(attr):  # attr [VE,K] -> [...,H,W,K]
        return _dot3(lp, _rows(attr, vid))

    uv_verts = _rows(vstage["uv"], vid)  # [...,H,W,3,2]
    uv = _dot3(lp, uv_verts)
    draw = _rows(vstage["draw"], vid[..., 0])  # [...,H,W]

    # Analytic UV screen derivatives for mip selection:
    # d(f)/dx = Σ A_i (f_i − f) / Σ g_i (A_i = ∂g_i/∂px).
    duv = uv_verts - uv[..., None, :]  # [...,H,W,3,2]
    duv_dx = _dot3([a0 * inv_gsum, a1 * inv_gsum, a2 * inv_gsum], duv)  # [...,H,W,2]
    duv_dy = _dot3([b0 * inv_gsum, b1 * inv_gsum, b2 * inv_gsum], duv)
    deriv = torch.maximum(
        torch.amax(torch.abs(duv_dx), dim=-1), torch.amax(torch.abs(duv_dy), dim=-1)
    )
    lod_base = torch.log2(torch.clamp(deriv, min=1e-8))

    return {
        "covered": covered,
        "interp": interp,
        "uv": uv,
        "draw": draw,
        "lod_base": lod_base,
        "duv_dx": duv_dx,
        "duv_dy": duv_dy,
    }


def base_alpha(it: dict, frame: dict, materials: dict,
               trilinear: bool = True, aniso: int = 1,
               srgb_per_tap: bool = False,
               compute_dtype=torch.float32):
    """Base-color alpha × factor alpha, for the alpha-cutoff test
    (main.frag:42,59-62). Returns (alpha [...,H,W] f32, cutoff [...,H,W] f32)."""
    mat = _rows(frame["material_id"], it["draw"])
    sampler = make_sampler(materials, it["uv"], it["lod_base"], trilinear,
                           it["duv_dx"], it["duv_dy"], aniso, srgb_per_tap,
                           compute_dtype)
    tex_idx = _rows(materials["tex_indices"][:, 0], mat)
    a = sampler(tex_idx)[..., 3].to(torch.float32) \
        * _rows(materials["base_color_factor"][:, 3], mat)
    cutoff = _rows(materials["alpha_rgh_mtl_normal"][:, 0], mat)
    return a, cutoff


def shade_interpolated(it: dict, vstage: dict, frame: dict, materials: dict,
                       trilinear: bool = True, aniso: int = 1,
                       srgb_per_tap: bool = False,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """Full fragment shading (main.frag) on an interpolation context.

    compute_dtype=torch.bfloat16 evaluates texture filtering and the
    lighting arithmetic at bf16 (RenderConfig.bf16_shading): geometry
    interpolation, depth and edges stay f32; the returned color is f32 for
    compositing."""
    dt = compute_dtype
    covered = it["covered"]
    interp = it["interp"]
    uv = it["uv"]
    draw = it["draw"].long()

    normal = interp(vstage["normal"]).to(dt)
    tangent4 = interp(vstage["tangent"]).to(dt)
    tangent, tan_w = tangent4[..., :3], tangent4[..., 3]

    mat = _rows(frame["material_id"], draw)
    base_factor = _rows(materials["base_color_factor"], mat).to(dt)  # [...,4]
    emis_occ = _rows(materials["emissive_occlusion"], mat).to(dt)
    arm = _rows(materials["alpha_rgh_mtl_normal"], mat).to(dt)
    tex_idx = _rows(materials["tex_indices"], mat)  # [...,5] i32

    sampler = make_sampler(materials, uv, it["lod_base"], trilinear,
                           it["duv_dx"], it["duv_dy"], aniso, srgb_per_tap,
                           dt)

    def sample(slot_col):
        return sampler(tex_idx[..., slot_col])

    base_color = sample(0) * base_factor
    mr_tex = sample(1)
    normal_tex = sample(2)[..., :3] * 2.0 - 1.0
    occ_tex = sample(3)
    emissive = sample(4)[..., :3] * emis_occ[..., :3]

    occ_strength = emis_occ[..., 3]
    rough = mr_tex[..., 1] * arm[..., 1]
    metal = mr_tex[..., 2] * arm[..., 2]
    normal_scale = arm[..., 3]
    occlusion = 1.0 + occ_strength * (occ_tex[..., 0] - 1.0)

    # TBN normal mapping (main.frag:64-67).
    bitangent = tan_w[..., None] * _cross(normal, tangent)
    nt = normal_tex * torch.stack(
        [normal_scale, normal_scale, torch.ones_like(normal_scale)], dim=-1
    )
    nt = nt * torch.reciprocal(
        torch.sqrt(torch.clamp(_sum3(nt * nt), min=1e-20))
    )[..., None]
    shading_normal = (
        tangent * nt[..., 0:1] + bitangent * nt[..., 1:2] + normal * nt[..., 2:3]
    )

    # Lit mode (main.frag:78-88). sun_dir = (-1, 1, 1) / sqrt(3) filled on
    # the device, not copied from the host (see make_sampler)
    sun_dir = torch.cat([torch.full((1,), -_INV_SQRT3, device=normal.device),
                         torch.full((2,), _INV_SQRT3, device=normal.device)])
    sun_dot = torch.clamp(_sum3(shading_normal * sun_dir.to(dt)), min=0.0)
    brightness = 0.3 * occlusion + sun_dot * 2.0
    emissive_len = torch.sqrt(_sum3(emissive * emissive))
    has_emissive = (emissive_len > 0.0)[..., None]
    lit_rgb = torch.where(has_emissive, emissive,
                          brightness[..., None] * base_color[..., :3])
    lit = torch.cat(
        [lit_rgb,
         torch.where(has_emissive, torch.ones_like(base_color[..., 3:4]),
                     base_color[..., 3:4])],
        dim=-1,
    )

    debug_rgb = draw_debug_colors(_rows(frame["debug_id"], draw)).to(dt)

    def rgba(rgb):
        return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)

    mode = frame["debug_mode"]
    candidates = [
        lit,  # 0 (and default)
        base_color,  # 1
        rgba(debug_rgb),  # 2
        rgba(shading_normal),  # 3
        rgba(torch.stack([torch.zeros_like(rough), rough, metal], dim=-1)),  # 4
        rgba(emissive),  # 5
        rgba(occlusion[..., None].expand(*occlusion.shape, 3)),  # 6
    ]
    color = candidates[0]
    for i in range(1, len(candidates)):
        color = torch.where(mode == i, candidates[i], color)

    color = torch.where(covered[..., None], color, torch.zeros_like(color))
    return color.to(torch.float32)


def shade(
    trid: torch.Tensor,  # [H,W] i32, -1 = background
    geom: dict,
    vstage: dict,
    frame: dict,
    materials: dict,
    *,
    width: int,
    height: int,
    row0=0,
    trilinear: bool = True,
    aniso: int = 1,
    srgb_per_tap: bool = False,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Returns linear HDR [H,W,4] f32. Background pixels are the clear color
    (0,0,0,0) (render_passes.rs:192-197). Goes through shade_stack (S1 on
    the card); a scalar row0 becomes a [H, 1] fill on the device."""
    if not isinstance(row0, torch.Tensor):
        row0 = torch.full((trid.shape[-2], 1), float(row0), device=trid.device)
    return shade_stack(trid.contiguous(), row0, geom, vstage, frame, materials,
                       width=width, height=height, trilinear=trilinear,
                       aniso=aniso, srgb_per_tap=srgb_per_tap,
                       compute_dtype=compute_dtype)


# -- the stage's entry points: plain versions and kernels S1, S2 -----------

def shade_stack_plain(tid, row0, geom, vs, frame, materials, *, width: int,
                      height: int, trilinear: bool = True, aniso: int = 1,
                      srgb_per_tap: bool = False, compute_dtype=torch.float32):
    """Plain version of S1: shade_interpolated over interpolants."""
    it = interpolants(tid, geom, vs, width=width, height=height, row0=row0)
    return shade_interpolated(it, vs, frame, materials, trilinear, aniso,
                              srgb_per_tap, compute_dtype)


def alpha_stack_plain(tid, row0, geom, vs, frame, materials, *, width: int,
                      height: int, trilinear: bool = True, aniso: int = 1,
                      srgb_per_tap: bool = False, compute_dtype=torch.float32):
    """Plain version of S2: base_alpha over interpolants at the covered
    elements (tid >= 0), +0.0 alpha and cutoff at the others, whose values
    no later step reads (the masked merge uses a candidate's values only
    where a live slot, whose id is >= 0, matches it)."""
    it = interpolants(tid, geom, vs, width=width, height=height, row0=row0)
    alpha, cutoff = base_alpha(it, frame, materials, trilinear, aniso, srgb_per_tap,
                               compute_dtype)
    covered = tid >= 0
    return torch.where(covered, alpha, 0.0), torch.where(covered, cutoff, 0.0)


def check_tensor(name: str, t: torch.Tensor, dtype, shape: tuple | None = None,
                 device=None, contiguous: bool = True, align: int = 4) -> None:
    """Raises ValueError unless `t` has `dtype`, the `shape` (None entries
    match any size), lies on `device`, is contiguous when asked and its
    data is `align`-byte aligned (16 for the kernels' 16-byte loads)."""
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise ValueError(f"{name} must be a {dtype} tensor, got "
                         f"{getattr(t, 'dtype', type(t))}")
    if shape is not None and (t.ndim != len(shape) or any(
            want is not None and got != want for got, want in zip(t.shape, shape))):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def atlas_fields(materials: dict, dev) -> dict:
    """The atlas part of a kernel's argument structure, checked."""
    atlas, table, srgb = materials["atlas"], materials["atlas_table"], materials["atlas_srgb"]
    check_tensor("atlas", atlas, torch.int32, (None, None), dev)
    check_tensor("atlas_table", table, torch.int32, (None, MAX_MIPS, 4), dev, align=16)
    n_tex = table.shape[0]
    check_tensor("atlas_srgb", srgb, torch.int32, (n_tex,), dev)
    wrap = materials.get("atlas_wrap")
    if wrap is not None:
        check_tensor("atlas_wrap", wrap, torch.int32, (n_tex, 2), dev)
    return dict(atlas=atlas.data_ptr(), table=table.data_ptr(), srgb=srgb.data_ptr(),
                wrap=0 if wrap is None else wrap.data_ptr(), n_atlas=atlas.numel(),
                n_tex=n_tex, atlas_w=atlas.shape[1])


def stack_shape(tid: torch.Tensor, row0, name: str = "tid") -> tuple:
    """(C, h, w) of a contiguous [..., h, w] i32 stack of triangle ids, with
    row0 checked as the [h, 1] (or [h]) f32 per-row offset on its device
    that the kernels read."""
    if tid.ndim < 2:
        raise ValueError(f"{name} must be [..., h, w], got {tuple(tid.shape)}")
    h, w = tid.shape[-2:]
    check_tensor(name, tid, torch.int32)
    if not isinstance(row0, torch.Tensor) or row0.numel() != h:
        raise ValueError(f"row0 must be a [{h}, 1] f32 tensor on the device")
    check_tensor("row0", row0, torch.float32, None, tid.device)
    return tid.numel() // max(h * w, 1), h, w


def _launch_scene(which: str, tid, row0, geom, vs, frame, materials, *, width,
                  height, trilinear, aniso, srgb_per_tap, compute_dtype):
    """Checks the inputs, allocates the outputs and launches S1
    (which="shade") or S2 ("alpha")."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}: the kernels take f32 or bf16")
    dev = tid.device
    c, h, w = stack_shape(tid, row0)
    tri_v = geom["tri_v"]
    check_tensor("tri_v", tri_v, torch.int32, (None, 3), dev)
    n_v = vs["clip"].shape[0]
    for name, k, align in (("clip", 4, 16), ("uv", 2, 4), ("normal", 3, 4),
                           ("tangent", 4, 4)):
        check_tensor(name, vs[name], torch.float32, (n_v, k), dev, align=align)
    check_tensor("draw", vs["draw"], torch.int32, (n_v,), dev)
    mat_id, dbg_id, mode = frame["material_id"], frame["debug_id"], frame["debug_mode"]
    for name, t in (("material_id", mat_id), ("debug_id", dbg_id)):
        check_tensor(name, t, torch.int32, (mat_id.shape[0],), dev, contiguous=False)
    check_tensor("debug_mode", mode, torch.int32, None, dev, contiguous=False)
    if mode.numel() != 1:
        raise ValueError("debug_mode must be one value")
    n_m = materials["tex_indices"].shape[0]
    check_tensor("tex_indices", materials["tex_indices"], torch.int32, (n_m, 5), dev)
    for name in ("base_color_factor", "emissive_occlusion", "alpha_rgh_mtl_normal"):
        check_tensor(name, materials[name], torch.float32, (n_m, 4), dev, align=16)
    if which == "shade":
        out = torch.empty((*tid.shape, 4), dtype=torch.float32, device=dev)
        result, out2 = out, 0
    else:
        out = torch.empty(tid.shape, dtype=torch.float32, device=dev)
        cutoff = torch.empty_like(out)
        result, out2 = (out, cutoff), cutoff.data_ptr()
    args = kernels.ShadeArgs(
        tid=tid.data_ptr(), row0=row0.data_ptr(), tri_v=tri_v.data_ptr(),
        clip=vs["clip"].data_ptr(), uv=vs["uv"].data_ptr(),
        normal=vs["normal"].data_ptr(), tangent=vs["tangent"].data_ptr(),
        draw=vs["draw"].data_ptr(), material_id=mat_id.data_ptr(),
        debug_id=dbg_id.data_ptr(), debug_mode=mode.data_ptr(),
        tex_indices=materials["tex_indices"].data_ptr(),
        base_color_factor=materials["base_color_factor"].data_ptr(),
        emissive_occlusion=materials["emissive_occlusion"].data_ptr(),
        arm=materials["alpha_rgh_mtl_normal"].data_ptr(), out=out.data_ptr(),
        out2=out2, n_cand=c, n_tris=tri_v.shape[0], n_verts=n_v,
        n_draws=mat_id.shape[0], mat_stride=mat_id.stride(0),
        dbg_stride=dbg_id.stride(0), n_mats=n_m, h=h, w=w, width=width,
        height=height, trilinear=int(bool(trilinear)), aniso=int(aniso),
        srgb_per_tap=int(bool(srgb_per_tap)),
        bf16=int(compute_dtype == torch.bfloat16), **atlas_fields(materials, dev))
    lib = kernels.load()
    fn = lib.rt_shade_stack if which == "shade" else lib.rt_alpha_stack
    with torch.cuda.device(dev):
        err = fn(ctypes.addressof(args), kernels.current_stream())
    kernels.check_launch(f"{which}_stack", err)
    profiling.count(which)
    return result


def _dispatch(which: str, plain, tid, row0, geom, vs, frame, materials, **kw):
    if tid.device.type == "cpu":
        return plain(tid, row0, geom, vs, frame, materials, **kw)
    if tid.device.type != "cuda":
        raise ValueError(f"{which}_stack: unsupported device {tid.device}")
    return _launch_scene(which, tid, row0, geom, vs, frame, materials, **kw)


def shade_stack(tid, row0, geom, vs, frame, materials, *, width: int,
                height: int, trilinear: bool = True, aniso: int = 1,
                srgb_per_tap: bool = False, compute_dtype=torch.float32):
    """Full deferred shade of a candidate stack: tid [..., h, w] i32 (< 0 is
    background), row0 [h, 1] f32 (the offset of each local row to its
    global pixel row) → linear HDR [..., h, w, 4] f32, background (0,0,0,0).
    CPU tensors run shade_stack_plain; CUDA tensors launch S1
    (csrc/shade.cu), which replaces the JAX package's XLA-fused
    shade_interpolated (renderer_tpu/raster/shade.py:329) in render_shard:
    persistent blocks that shade only the covered elements, bound by issue
    slots and texel gathers."""
    kw = dict(width=width, height=height, trilinear=trilinear, aniso=aniso,
              srgb_per_tap=srgb_per_tap, compute_dtype=compute_dtype)
    return _dispatch("shade", shade_stack_plain, tid, row0, geom, vs, frame,
                     materials, **kw)


def alpha_stack(tid, row0, geom, vs, frame, materials, *, width: int,
                height: int, trilinear: bool = True, aniso: int = 1,
                srgb_per_tap: bool = False, compute_dtype=torch.float32):
    """Masked alpha test inputs of a candidate stack: (alpha, cutoff), each
    [..., h, w] f32, base_alpha's at the covered elements (tid >= 0) and
    +0.0 at the others. CPU tensors run alpha_stack_plain; CUDA tensors
    launch S2 (csrc/shade.cu), which replaces the JAX package's XLA-fused
    base_alpha (renderer_tpu/raster/shade.py:312): persistent blocks that
    sample only the covered elements, as S1 does."""
    kw = dict(width=width, height=height, trilinear=trilinear, aniso=aniso,
              srgb_per_tap=srgb_per_tap, compute_dtype=compute_dtype)
    return _dispatch("alpha", alpha_stack_plain, tid, row0, geom, vs, frame,
                     materials, **kw)
