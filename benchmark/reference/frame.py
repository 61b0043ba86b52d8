# Frozen copy of renderer_tpu_torch/raster/pipeline.py (STAT_NAMES,
# render_shard, render_frame) at commit 5822f29, on the plain versions of
# every stage: the benchmark's plain reference of one frame. Changed from
# the port: each stage calls its plain version; the UI pass is left out (no
# cell of the benchmark draws one); `probe`, when given, receives the
# frame's intermediates (the work formulas of benchmark/work read them).
# Part of the benchmark's yardstick; do not edit.
"""One frame on the plain path: vertex stage, triangle setup, binning, K1,
the masked and blended layers, the candidates, S1 and S2 shading, the
composite and the tonemap, each the port's plain PyTorch version."""

from __future__ import annotations

import torch

from benchmark.reference.core import constants
from benchmark.reference.core.config import RenderConfig
from benchmark.reference.raster import (
    binning,
    candidates,
    layers,
    post,
    raster_kernel,
    setup,
    shade,
    vertex_stage,
)


# Vulkan standard sample locations (spec "Multisampling" standard sample
# locations table), pixel-relative.
STANDARD_SAMPLE_POSITIONS = {
    1: ((0.5, 0.5),),
    2: ((0.75, 0.75), (0.25, 0.25)),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
    8: ((0.5625, 0.3125), (0.4375, 0.6875), (0.8125, 0.5625),
        (0.3125, 0.1875), (0.1875, 0.8125), (0.0625, 0.4375),
        (0.6875, 0.9375), (0.9375, 0.0625)),
}
MSAA4_POSITIONS = STANDARD_SAMPLE_POSITIONS[4]

# Per-frame device stats vector returned next to the image — the analog of
# the reference's loud resource-exhaustion errors (arena/buffers.rs:126-163).
# Same names and order as the JAX package's pipeline.STAT_NAMES.
STAT_NAMES = (
    "overflow_opaque",
    "overflow_masked",
    "overflow_blended",
    "overflow_ui",
    "masked_saturated_px",
    "blended_saturated_px",
    "ui_saturated_px",
    "shade_clamped_px",
    # (tile, triangle) pairs the ragged expansion requested this frame —
    # the feedback signal for right-sizing pair_capacity
    "total_pairs",
    # peak per-(sample, pixel) layered-capture demand per layered class —
    # the feedback signal for mask_layers / blend_layers / ui_layers
    "masked_demand_max",
    "blended_demand_max",
    "ui_demand_max",
    # peak per-pixel count of DISTINCT solid triangles across the MSAA
    # samples — the demand signal for msaa_shade_candidates
    "shade_demand_max",
    # (triangle, tile-row) expansion demand and its truncation — the
    # feedback pair for row_capacity
    "total_rows",
    "row_overflow",
)
N_STATS = len(STAT_NAMES)


def _pick_strip_rows(c: int, hp: int, wp: int, tile_h: int, budget: int) -> int:
    """Strip height (pixel rows, a whole-tile-row multiple) for striped
    stacked shading: the LARGEST tile-row multiple whose [c, strip, wp]
    element count fits `budget` (RenderConfig.shade_strip_elems; 0 = never
    split). Returns hp when the whole stack fits."""
    if budget <= 0 or c * hp * wp <= budget:
        return hp
    rows = max(budget // (c * tile_h * wp), 1)
    return min(rows * tile_h, hp)


def _shade_striped(stack, row0, strip_h: int, fn):
    """Run fn(tid [c, h, w] i32, row0 [h, 1] per-row y offset) -> tuple or
    tensor of [c, h, w, ...] over strips of `strip_h` pixel rows and
    concatenate the results back to full height. Bounds the live set of the
    stacked deferred-shading gathers to one strip; the per-pixel math is
    identical (shading is a pure per-pixel function of the candidate map
    and its global row)."""
    hp = stack.shape[1]
    if strip_h >= hp:
        return fn(stack, row0)
    # row0 is the offset a strip adds to its LOCAL arange — slicing to rows
    # [b, e) folds the strip base b back in
    outs = [fn(stack[:, b:min(b + strip_h, hp)], row0[b:min(b + strip_h, hp)] + b)
            for b in range(0, hp, strip_h)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(xs, dim=1) for xs in zip(*outs))
    return torch.cat(outs, dim=1)


def render_shard(
    geom: dict,
    frame: dict,
    materials: dict,
    vs: dict,
    *,
    config: RenderConfig,
    has_masked: bool,
    has_blended: bool,
    local_tiles_y: int,
    tile_row_offset: int,  # first global tile row of this band
    out_rows: int,  # rows of the final image this band produces
    row_stride: int = 1,  # stride between the band's global tile rows
    probe: dict | None = None,
):
    """Raster + shade + composite for a horizontal band of the image (the
    whole image on one device). All per-pixel math runs on the padded band;
    the crop to `out_rows`×width happens at the end.

    Returns (u8 image [out_rows, width, 3], stats i32[N_STATS] — see
    STAT_NAMES). `probe`, when a dict, receives the frame's intermediates."""
    cfg = config
    probe = {} if probe is None else probe
    dev = vs["clip"].device
    shade_dt = torch.bfloat16 if cfg.bf16_shading else torch.float32
    pad_h = local_tiles_y * cfg.tile_h
    # per-LOCAL-row offset to the GLOBAL pixel row (py = iota + 0.5 + row0)
    _j = torch.arange(pad_h, dtype=torch.int32, device=dev)
    _gy = ((tile_row_offset + torch.div(_j, cfg.tile_h, rounding_mode="floor")
            * row_stride) * cfg.tile_h + (_j % cfg.tile_h))
    row0 = (_gy - _j).to(torch.float32)[:, None]
    n_opaque = frame["n_opaque"]
    n_masked = frame["n_masked"]
    msaa = cfg.msaa_samples
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    tri_data = setup.triangle_setup_plain(
        vs["clip"], geom["tri_v"], frame["num_tris"], cfg.width, cfg.height,
        bbox_pad=(0.5 if msaa > 1 else 0.0),
    )

    # One stable sort bins every alpha class at once: pairs are keyed by
    # class × tile, each class reads the shared binned buffer through its own
    # starts/counts row.
    bounds = [0, n_opaque]
    if has_masked:
        bounds.append(n_opaque + n_masked)
    if has_blended:
        bounds.append(frame["num_tris"])
    (b_all, s_all, c_all, ov_all, row_overflow, pair_demand,
     row_demand) = binning.bin_triangle_classes_plain(
        tri_data, tuple(bounds),
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        pair_capacity=cfg.pair_capacity, row_capacity=cfg.row_capacity,
        tile_row_lo=tile_row_offset, local_tiles_y=local_tiles_y,
        zbuckets=cfg.opaque_z_buckets, row_stride=row_stride,
    )
    probe.update(tri_data=tri_data, bounds=tuple(bounds), b_all=b_all, s_all=s_all,
                 c_all=c_all, pair_demand=pair_demand, row_demand=row_demand)
    bins_opaque = (b_all, s_all[0], c_all[0])
    ov_opaque = ov_all[0]
    cls_i = 1
    if has_masked:
        bins_masked, ov_masked = (b_all, s_all[cls_i], c_all[cls_i]), ov_all[cls_i]
        cls_i += 1
    else:
        bins_masked, ov_masked = None, zero
    if has_blended:
        bins_blended, ov_blended = (b_all, s_all[cls_i], c_all[cls_i]), ov_all[cls_i]
    else:
        bins_blended, ov_blended = None, zero

    def saturated_px(aux, k):
        """Pixels (inside this band's image area) whose layered capture
        dropped fragments past the K-layer capacity in ANY sample."""
        return torch.sum(torch.any(aux[:, :out_rows, : cfg.width] > k, dim=0)
                         .to(torch.int32))

    def demand_max(aux):
        """Peak per-(sample, pixel) fragment demand inside the image area."""
        return torch.amax(aux[:, :out_rows, : cfg.width])

    shade_kw = dict(width=cfg.width, height=cfg.height, trilinear=cfg.trilinear,
                    aniso=cfg.aniso_samples, srgb_per_tap=cfg.srgb_per_tap,
                    compute_dtype=shade_dt)

    # Shading runs PER DISTINCT TRIANGLE: candidates deduped across
    # samples/layers are shaded once and selected back per slot. Exact
    # whenever a pixel references ≤ n_candidates distinct triangles; the
    # rare remainder falls back to the first candidate and is counted in
    # stats.shade_clamped_px.
    extra = max(cfg.msaa_shade_candidates - 1, 0) if msaa > 1 else 0
    clamp_mask = torch.zeros((pad_h, cfg.padded_width), dtype=torch.bool, device=dev)
    spos = STANDARD_SAMPLE_POSITIONS[msaa]
    raster_kw = dict(tile_row_offset=tile_row_offset, padded_height=pad_h,
                     padded_width=cfg.padded_width, tile_h=cfg.tile_h,
                     tile_w=cfg.tile_w, sample_positions=spos,
                     row_stride=row_stride)

    def clampc(c):  # -2 candidate sentinel → background for interpolation
        return torch.clamp(c, min=-1)

    def striped(cands, fn):
        stack = clampc(cands)
        sh = _pick_strip_rows(stack.shape[0], stack.shape[1], stack.shape[2],
                              cfg.tile_h, cfg.shade_strip_elems)
        return _shade_striped(stack, row0, sh, fn)

    def shade_candidates(cands: torch.Tensor) -> torch.Tensor:
        """Shade all candidate maps [C, H, W] in ONE stacked call, in
        tile-row strips past cfg.shade_strip_elems: [C, H, W, 4]."""
        return striped(cands, lambda tid, r0: shade.shade_stack_plain(
            tid.contiguous(), r0, geom, vs, frame, materials, **shade_kw))

    def slot_stack(lt):  # [S, K, H, W] layers → [S·K, H, W] slots, s-major
        return lt.reshape(lt.shape[0] * lt.shape[1], *lt.shape[2:])

    # -- phase 1: opaque + masked visibility (all samples per kernel pass) ---
    mask_sat = blend_sat = mask_demand = blend_demand = zero
    zs, ts = raster_kernel.rasterize_binned_plain(*bins_opaque, **raster_kw)
    # per-sample solid depth and id [S, H, W], merged into in place (phase 2)
    solid_z, solid_tid = zs.contiguous(), ts.contiguous()
    probe.update(k1_tid=ts)
    if has_masked:
        lz_m, lt_m, aux_m = layers.rasterize_layers_plain(
            *bins_masked, zs, mode="masked", n_layers=cfg.mask_layers, **raster_kw)
        mask_sat = saturated_px(aux_m, cfg.mask_layers)
        mask_demand = demand_max(aux_m)
        probe.update(lt_m=lt_m, lz_m=lz_m, filled_m=(lt_m >= 0).sum())

    # -- phase 2: masked alpha test (alpha deduped per distinct tid) + merge --
    if has_masked:
        slots = slot_stack(lt_m)
        cands = candidates.extract_candidates_plain(
            slots, min(slots.shape[0], cfg.mask_layers + extra))
        alpha, cutoff = striped(cands, lambda tid, r0: shade.alpha_stack_plain(
            tid.contiguous(), r0, geom, vs, frame, materials, **shade_kw))
        probe.update(cands_m=cands, alpha=alpha, cutoff=cutoff,
                     solid_tid_k1=solid_tid.clone())
        candidates.masked_merge_plain(lt_m, lz_m, cands, alpha, cutoff, solid_tid,
                                solid_z, clamp_mask)

    # -- phase 3: blended visibility (floor = merged per-sample solid depth) --
    lt_b = cands_b = shaded_b = None
    if has_blended:
        _, lt_b, aux_b = layers.rasterize_layers_plain(
            *bins_blended, solid_z, mode="blended", n_layers=cfg.blend_layers,
            **raster_kw)
        blend_sat = saturated_px(aux_b, cfg.blend_layers)
        blend_demand = demand_max(aux_b)
        probe.update(lt_b=lt_b, filled_b=(lt_b >= 0).sum())

    # -- phase 4: solid shading, once per distinct candidate -----------------
    # demand signal: distinct REAL solid tids per pixel across samples
    n_c = min(msaa, max(cfg.msaa_shade_candidates, 1))
    if msaa > 1:
        cands_s, distinct = candidates.extract_candidates_plain(solid_tid, n_c, count=True)
        shade_demand = torch.amax(distinct[:out_rows, : cfg.width])
    else:
        cands_s = candidates.extract_candidates_plain(solid_tid, n_c)
        shade_demand = zero
    shaded_s = shade_candidates(cands_s)
    probe.update(solid_tid=solid_tid, cands_s=cands_s, shaded_s=shaded_s,
                 distinct=distinct if msaa > 1 else None)

    # -- phase 5: blended shading (deduped); then each sample's solid select
    # and its blended layers' ordered composite, into the HDR samples -------
    if has_blended:
        slots = slot_stack(lt_b)
        cands_b = candidates.extract_candidates_plain(
            slots, min(slots.shape[0], cfg.blend_layers + extra))
        shaded_b = shade_candidates(cands_b)
    hdr = candidates.resolve_plain(solid_tid, cands_s, shaded_s, clamp_mask, lt_b,
                             cands_b, shaded_b)  # [S, H, W, 3]

    # -- phase 6: UI overlay into the HDR buffer of every sample (the
    # reference's ImGui pipeline position: blended, no depth, last in the
    # geometry pass, BEFORE tonemap — renderer.rs:433-441) ------------------
    ov_ui = ui_sat = ui_demand = zero
    if frame.get("ui") is not None:
        raise ValueError("the reference has no UI pass")
    probe.update(cands_b=cands_b, shaded_b=shaded_b, clamp_mask=clamp_mask, hdr=hdr)

    img = post.tonemap(hdr if msaa > 1 else hdr[0])
    clamped = torch.sum(clamp_mask[:out_rows, : cfg.width].to(torch.int32))
    stats = torch.stack(
        [ov_opaque, ov_masked, ov_blended, ov_ui, mask_sat, blend_sat, ui_sat,
         clamped, pair_demand, mask_demand, blend_demand, ui_demand,
         shade_demand, row_demand, row_overflow]
    ).to(torch.int32)
    return img[:out_rows, : cfg.width], stats


def render_frame(
    geom: dict,
    frame: dict,
    materials: dict,
    *,
    config: RenderConfig,
    skin_start: int,
    has_masked: bool = True,
    has_blended: bool = True,
    morph_k: int = 0,
    joint_cap: int = constants.MAX_JOINT_COUNT,
    probe: dict | None = None,
):
    """Single-device frame: returns (final u8 RGB image [H, W, 3],
    stats i32[N_STATS])."""
    from benchmark.reference.scene.draw_stream import unpack_frame

    frame = unpack_frame(frame, morph_k=morph_k, joint_cap=joint_cap)
    vs = vertex_stage.run_vertex_stage(geom, frame, skin_start, morph_k=morph_k)
    return render_shard(
        geom, frame, materials, vs,
        config=config,
        has_masked=has_masked,
        has_blended=has_blended,
        local_tiles_y=config.tiles_y,
        tile_row_offset=0,
        out_rows=config.height,
        probe=probe,
    )


