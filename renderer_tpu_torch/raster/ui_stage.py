"""UI pass device stages: raster + shade of the DrawList through the same
layer machinery as blended scene geometry.

Pipeline-state parity with the reference's ImGui pipeline
(pipeline_parameters.rs IMGUI): blended src-alpha/one-minus, double-sided,
depth test/write OFF, drawn LAST in the geometry pass into the HDR target —
i.e. BEFORE tonemap (renderer.rs:433-441 pipeline order, render pass
Geometry). Fragment behavior parity with imgui.frag: clip-rect discard on
screen coordinates (:28-33), tex_kind 1 = alpha-from-R font, 2 = RGBA
modulate, else discard (:34-44).

Triangles are already 2D screen-space; kernel K2 in "blended" mode (constant
depth 0.5 over a floor of 0, so every fragment passes GE and the chain is
submission order) captures up to ui_layers fragments per pixel; each
captured layer is shaded once per pixel with 2D-affine barycentrics (w = 1 →
no perspective) and composited in order. UI coverage is evaluated at pixel
centers by default and the same composite is applied to every MSAA sample;
`RenderConfig.ui_msaa` evaluates coverage at the MSAA sample positions with
per-sample accept chains, shading at pixel centers either way.

`shade_composite_ui` (the pipeline's call) shades every captured layer and
composites it into the HDR samples in place; `shade_ui_layer` returns the
layers' shades. Both dispatch on the tensors' device: CPU tensors run the
plain version, CUDA tensors launch a hand-written kernel (csrc/shade.cu:
the fused S3 and S3).
"""

from __future__ import annotations

import ctypes

import torch

from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.raster import binning, layers, setup
from renderer_tpu_torch.raster.shade import (
    _dot3,
    _rows,
    atlas_fields,
    check_tensor,
    make_sampler,
    stack_shape,
)

TEX_KIND_FONT = 1
TEX_KIND_RGBA = 2

#: the launch counters in profiling.COUNTERS of S3 (shade_ui_layer) and of
#: the fused S3 (shade_composite_ui); the plain versions do not count
LAUNCHES = ("ui_shade", "ui_composite")
profiling.register_launches(LAUNCHES)
#: csrc/shade.cu UI_QUEUE: the fused S3's queued elements a round
UI_QUEUE = 1024


def bin_ui(ui: dict, *, config, local_tiles_y: int, tile_row_offset: int,
           n_samples: int, row_stride: int = 1):
    """Pixel-space UI triangles (packed DrawList tensors) → clip space →
    double-sided setup → single-class bins at ui_pair_capacity. Returns
    (binned, starts, counts, overflow scalar) — binning.bin_triangles."""
    cfg = config
    pos = ui["pos"]
    x = pos[:, 0] * (2.0 / cfg.width) - 1.0
    y = pos[:, 1] * (2.0 / cfg.height) - 1.0
    clip = torch.stack([x, y, torch.full_like(x, 0.5), torch.ones_like(x)], dim=-1)
    tri_data = setup.triangle_setup(
        clip, ui["tris"], ui["counts"][0], cfg.width, cfg.height,
        double_sided=True,
        bbox_pad=(0.5 if n_samples > 1 else 0.0),
    )
    return binning.bin_triangles(
        tri_data, 0, None,
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        pair_capacity=cfg.ui_pair_capacity,
        tile_row_lo=tile_row_offset, local_tiles_y=local_tiles_y,
        row_stride=row_stride,
    )


def rasterize_ui(
    ui: dict,
    *,
    config,
    local_tiles_y: int,
    tile_row_offset: int,
    sample_positions: tuple = ((0.5, 0.5),),
    row_stride: int = 1,
):
    """Bin + layer-rasterize the UI triangles (packed DrawList tensors).
    `sample_positions` — in-pixel coverage evaluation points: pixel centers
    by default, the MSAA sample positions under RenderConfig.ui_msaa.
    Returns (layer tids [S, K, Hp, Wp] i32, overflow scalar, aux counts
    [S, Hp, Wp]); the K2 launch counts under "ui"."""
    cfg = config
    pad_h = local_tiles_y * cfg.tile_h
    n_s = len(sample_positions)
    binned, starts, counts, overflow = bin_ui(
        ui, config=cfg, local_tiles_y=local_tiles_y,
        tile_row_offset=tile_row_offset, n_samples=n_s, row_stride=row_stride)
    # constant z = 0.5 vs floor 0.0 → every covered fragment passes GE and
    # the accept chain is pure submission (painter's) order
    floor = torch.zeros((n_s, pad_h, cfg.padded_width), dtype=torch.float32,
                        device=binned.device)
    _lz, lt, aux = layers.rasterize_layers(
        binned, starts, counts, floor,
        mode="blended", n_layers=cfg.ui_layers,
        tile_row_offset=tile_row_offset,
        padded_height=pad_h, padded_width=cfg.padded_width,
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        sample_positions=tuple(sample_positions), row_stride=row_stride,
        launch_key="ui",
    )
    return lt, overflow, aux


def shade_ui_layer_plain(lt: torch.Tensor, ui: dict, materials: dict, *,
                         row0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of S3 (shade_ui_layer)."""
    h, w = lt.shape[-2:]
    dev = lt.device
    covered = lt >= 0
    t = torch.where(covered, lt, torch.zeros_like(lt))

    vid = _rows(ui["tris"], t)  # [...,H,W,3]
    p = _rows(ui["pos"], vid)  # [...,H,W,3,2]
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5 + row0

    # 2D affine barycentrics (w = 1): g_i = cross2(p_j - pt, p_k - pt);
    # the shared denominator's sign cancels, so both windings interpolate
    # correctly (the pipeline is double-sided).
    def g(j, k):
        ax = p[..., j, 0] - px
        ay = p[..., j, 1] - py
        bx = p[..., k, 0] - px
        by = p[..., k, 1] - py
        return ax * by - ay * bx

    g0, g1, g2 = g(1, 2), g(2, 0), g(0, 1)
    s = g0 + g1 + g2
    inv_s = torch.reciprocal(torch.where(torch.abs(s) > 1e-12, s, torch.ones_like(s)))
    lam = [g0 * inv_s, g1 * inv_s, g2 * inv_s]

    uvv = _rows(ui["uv"], vid)  # [...,H,W,3,2]
    uv = _dot3(lam, uvv)
    col = _dot3(lam, _rows(ui["col"], vid))

    # analytic UV derivatives of the affine map (∂lam_i/∂x = a_i / s with
    # a_i from the edge vectors; Σ a_i = 0)
    a = [(p[..., 1, 1] - p[..., 2, 1]) * inv_s, (p[..., 2, 1] - p[..., 0, 1]) * inv_s,
         (p[..., 0, 1] - p[..., 1, 1]) * inv_s]
    b = [(p[..., 2, 0] - p[..., 1, 0]) * inv_s, (p[..., 0, 0] - p[..., 2, 0]) * inv_s,
         (p[..., 1, 0] - p[..., 0, 0]) * inv_s]
    duv_dx = _dot3(a, uvv)
    duv_dy = _dot3(b, uvv)

    cmd = _rows(ui["tri_cmd"], t)  # [...,H,W]
    crect = _rows(ui["clip"], cmd)  # [...,H,W,4]
    # clip-rect discard on screen coords (imgui.frag:28-33)
    in_clip = (
        (crect[..., 0] < px) & (crect[..., 2] >= px)
        & (crect[..., 1] < py) & (crect[..., 3] >= py)
    )
    kind = _rows(ui["tex_kind"], cmd)
    slot = _rows(ui["tex_slot"], cmd)

    sampler = make_sampler(materials, uv, torch.zeros_like(s), True,
                           duv_dx, duv_dy, aniso=1)
    tex = sampler(slot)

    # tex_kind 1: rgb = vertex color, alpha = vertex alpha · tex.r (R8 font);
    # tex_kind 2: full modulate; anything else discards (imgui.frag:34-44)
    rgb = torch.where((kind == TEX_KIND_RGBA)[..., None],
                      col[..., :3] * tex[..., :3], col[..., :3])
    alpha = torch.where(kind == TEX_KIND_FONT, col[..., 3] * tex[..., 0],
                        col[..., 3] * tex[..., 3])
    live = covered & in_clip & ((kind == TEX_KIND_FONT) | (kind == TEX_KIND_RGBA))
    return rgb, torch.where(live, alpha, torch.zeros_like(alpha))


def shade_ui_layer(
    lt: torch.Tensor,  # [..., Hp, Wp] i32 layer tids (-1 empty)
    ui: dict,
    materials: dict,
    *,
    config,
    row0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """imgui.frag for captured layers at pixel centers. Returns
    (rgb [..., H, W, 3], alpha [..., H, W]) ready for src-alpha compositing
    (rgb unmasked at every element, alpha 0 where the layer is not live).
    Leading-dim polymorphic: every captured UI layer (and MSAA sample set
    under ui_msaa) in one stacked call. CPU tensors run
    shade_ui_layer_plain; CUDA tensors launch S3 (csrc/shade.cu ui_kernel),
    one element a thread on the fused S3's sampler, which replaces the JAX
    package's XLA-fused shade_ui_layer (renderer_tpu/raster/ui_stage.py:89)
    and is bound by its texel gathers and FP32 arithmetic. The pipeline
    calls shade_composite_ui instead."""
    if lt.device.type == "cpu":
        return shade_ui_layer_plain(lt, ui, materials, row0=row0)
    if lt.device.type != "cuda":
        raise ValueError(f"shade_ui_layer: unsupported device {lt.device}")
    rgb = torch.empty((*lt.shape, 3), dtype=torch.float32, device=lt.device)
    alpha = torch.empty(lt.shape, dtype=torch.float32, device=lt.device)
    args = _ui_args(lt, ui, materials, row0, rgb=rgb.data_ptr(), alpha=alpha.data_ptr())
    lib = kernels.load()
    with torch.cuda.device(lt.device):
        err = lib.rt_shade_ui(ctypes.addressof(args), kernels.current_stream())
    kernels.check_launch("shade_ui_layer", err)
    profiling.count("ui_shade")
    return rgb, alpha


def _ui_args(lt, ui, materials, row0, **fields):
    """The kernels' UiArgs for a stack of layer ids `lt` on the card (every
    input checked), with `fields` set besides."""
    dev = lt.device
    n_cand, h, w = stack_shape(lt, row0, "lt")
    n_t, n_v, n_c = ui["tris"].shape[0], ui["pos"].shape[0], ui["clip"].shape[0]
    if min(n_t, n_v, n_c) < 1:
        raise ValueError(f"UI shade: {n_t} triangles, {n_v} vertices, {n_c} commands")
    check_tensor("tris", ui["tris"], torch.int32, (n_t, 3), dev)
    check_tensor("tri_cmd", ui["tri_cmd"], torch.int32, (n_t,), dev)
    for name, k in (("pos", 2), ("uv", 2), ("col", 4)):
        check_tensor(name, ui[name], torch.float32, (n_v, k), dev)
    check_tensor("clip", ui["clip"], torch.float32, (n_c, 4), dev, align=16)
    for name in ("tex_kind", "tex_slot"):
        check_tensor(name, ui[name], torch.int32, (n_c,), dev)
    return kernels.UiArgs(
        lt=lt.data_ptr(), row0=row0.data_ptr(), tris=ui["tris"].data_ptr(),
        pos=ui["pos"].data_ptr(), uv=ui["uv"].data_ptr(), col=ui["col"].data_ptr(),
        tri_cmd=ui["tri_cmd"].data_ptr(), cliprect=ui["clip"].data_ptr(),
        tex_kind=ui["tex_kind"].data_ptr(), tex_slot=ui["tex_slot"].data_ptr(),
        n_cand=n_cand, n_tris=n_t, n_verts=n_v, n_cmds=n_c,
        h=h, w=w, **atlas_fields(materials, dev), **fields)


def _composite(hdr: list, rgb: torch.Tensor, alpha: torch.Tensor) -> None:
    """The pipeline's src-alpha composite of the UI layers, in layer order,
    into `hdr` in place: [K, H, W] shades into every sample, or [S, K, H, W]
    into sample s alone (ui_msaa)."""
    out = list(hdr)
    for k in range(alpha.shape[-3]):
        for s in range(len(out)):
            a_k = (alpha[k] if alpha.dim() == 3 else alpha[s, k])[..., None]
            rgb_k = rgb[k] if rgb.dim() == 4 else rgb[s, k]
            out[s] = out[s] * (1.0 - a_k) + rgb_k * a_k
    for t, o in zip(hdr, out):
        t.copy_(o)


def shade_composite_ui_plain(hdr: list, lt: torch.Tensor, ui: dict, materials: dict, *,
                             row0) -> None:
    """Plain version of the fused S3 (shade_composite_ui): shade_ui_layer_plain,
    then the composite loop, op for op."""
    rgb, alpha = shade_ui_layer_plain(lt, ui, materials, row0=row0)
    _composite(hdr, rgb, alpha)


def shade_composite_ui(
    hdr: list,  # S tensors [Hp, Wp, 3] f32: the samples' HDR buffers, updated in place
    lt: torch.Tensor,  # [K, Hp, Wp] or, under ui_msaa, [S, K, Hp, Wp] i32 layer tids
    ui: dict,
    materials: dict,
    *,
    config,
    row0,
) -> None:
    """imgui.frag for every captured UI layer at pixel centers, composited
    src-alpha over the HDR samples in layer order: `hdr[s] = hdr[s] · (1 −
    a_k) + rgb_k · a_k`, every layer k into every sample s ([K, Hp, Wp]
    layers) or layer (s, k) into sample s ([S, K, Hp, Wp], ui_msaa). CPU
    tensors run shade_composite_ui_plain; CUDA tensors launch the fused S3
    (csrc/shade.cu ui_composite_kernel), which replaces the JAX package's
    XLA-fused shade_ui_layer and composite (renderer_tpu/raster/
    ui_stage.py:89, pipeline.py:513-528): it reads each HDR sample once
    and stores only the values whose bits change."""
    if lt.device.type == "cpu":
        return shade_composite_ui_plain(hdr, lt, ui, materials, row0=row0)
    if lt.device.type != "cuda":
        raise ValueError(f"shade_composite_ui: unsupported device {lt.device}")
    per_sample = lt.dim() == 4
    n_s = len(hdr)
    if lt.dim() not in (3, 4) or not 1 <= n_s <= kernels.MAX_HDR or (
            per_sample and lt.shape[0] != n_s):
        raise ValueError(f"shade_composite_ui: layers {tuple(lt.shape)} over {n_s} samples")
    planes, h, w = stack_shape(lt, row0, "lt")
    if planes > UI_QUEUE:
        raise ValueError(f"shade_composite_ui: {planes} layer planes (at most {UI_QUEUE})")
    for s, t in enumerate(hdr):
        check_tensor(f"hdr[{s}]", t, torch.float32, (h, w, 3), lt.device)
    if len({t.data_ptr() for t in hdr}) != n_s:
        raise ValueError("shade_composite_ui: two HDR samples share their storage")
    ptrs = [t.data_ptr() for t in hdr] + [0] * (kernels.MAX_HDR - n_s)
    args = _ui_args(lt, ui, materials, row0, n_samples=n_s,
                    n_layers=lt.shape[-3], per_sample=int(per_sample),
                    round_px=min(256, UI_QUEUE // planes),
                    **{f"hdr{i}": p for i, p in enumerate(ptrs)})
    lib = kernels.load()
    with torch.cuda.device(lt.device):
        err = lib.rt_shade_composite_ui(ctypes.addressof(args), kernels.current_stream())
    kernels.check_launch("shade_composite_ui", err)
    profiling.count("ui_composite")
