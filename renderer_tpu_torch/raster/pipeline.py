"""Frame assembly: the whole GPU column of the reference's frame (vertex
transform+skinning → raster/depth → shading → tonemap, reference:
renderer/src/renderer.rs:359-572 command buffer) as one function over device
tensors.

Pass structure (matching the reference's pipeline iteration order,
renderer.rs:433-441 — opaque, then alpha-to-coverage, then blended — all
sharing one reverse-Z depth buffer):

1. vertex + skinning (vertex_stage)
2. triangle setup + per-tile binning (setup, binning)
3. opaque visibility raster (raster_kernel.rasterize_binned, kernel K1)
4. masked (alpha-cutoff) top-K layer raster (layers, kernel K2) → per-layer
   alpha test → merge the nearest passing fragment into the visibility buffer
5. one deferred full shade of the merged solid visibility buffer (shade)
6. blended ordered-accept layer raster (layers, kernel K2) → per-layer full
   shade → src-alpha composite in acceptance order (pipelines.rs:112-132)
7. UI overlay (ui_stage: kernel K2 in blended mode over the DrawList
   triangles) composited into every sample's HDR buffer
8. ACES tonemap + sRGB encode (post)

MSAA (the reference's default 4×, examples/sandbox/src/main.rs:114-117):
VISIBILITY runs once per sample by evaluating the edge/depth planes at the
Vulkan standard sample positions inside the kernels (the binned buffer is
shared across samples, built with a half-pixel-padded bbox); SHADING runs
once per distinct per-pixel triangle candidate across samples/layers and is
selected back per sample (attributes interpolate at pixel centers, so
shading is a pure function of triangle id). Resolve is AVERAGE after
per-sample tonemap (render_passes.rs:28-42). Alpha-to-coverage gets the
per-sample coverage thresholds a·S > s+0.5.
"""

from __future__ import annotations

import torch

from renderer_tpu_torch.core import constants
from renderer_tpu_torch.core.config import RenderConfig
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.engine.profiling import span
from renderer_tpu_torch.raster import (
    binning,
    candidates,
    layers,
    post,
    raster_kernel,
    setup,
    shade,
    ui_stage,
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
):
    """Raster + shade + composite for a horizontal band of the image (the
    whole image on one device). All per-pixel math runs on the padded band;
    the crop to `out_rows`×width happens at the end.

    Returns (u8 image [out_rows, width, 3], stats i32[N_STATS] — see
    STAT_NAMES)."""
    cfg = config
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

    with span("setup"):
        tri_data = setup.triangle_setup(
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
    with span("binning"):
        (b_all, s_all, c_all, ov_all, row_overflow, pair_demand,
         row_demand) = binning.bin_triangle_classes(
            tri_data, tuple(bounds),
            tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h,
            pair_capacity=cfg.pair_capacity, row_capacity=cfg.row_capacity,
            tile_row_lo=tile_row_offset, local_tiles_y=local_tiles_y,
            zbuckets=cfg.opaque_z_buckets, row_stride=row_stride,
        )
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
        return striped(cands, lambda tid, r0: shade.shade_stack(
            tid.contiguous(), r0, geom, vs, frame, materials, **shade_kw))

    def slot_stack(lt):  # [S, K, H, W] layers → [S·K, H, W] slots, s-major
        return lt.reshape(lt.shape[0] * lt.shape[1], *lt.shape[2:])

    # -- phase 1: opaque + masked visibility (all samples per kernel pass) ---
    mask_sat = blend_sat = mask_demand = blend_demand = zero
    with span("raster.opaque"):
        zs, ts = raster_kernel.rasterize_binned(*bins_opaque, **raster_kw)
        # per-sample solid depth and id [S, H, W], merged into in place (phase 2)
        solid_z, solid_tid = zs.contiguous(), ts.contiguous()
    if has_masked:
        with span("raster.masked"):
            lz_m, lt_m, aux_m = layers.rasterize_layers(
                *bins_masked, zs, mode="masked", n_layers=cfg.mask_layers, **raster_kw)
            mask_sat = saturated_px(aux_m, cfg.mask_layers)
            mask_demand = demand_max(aux_m)

    # -- phase 2: masked alpha test (alpha deduped per distinct tid) + merge --
    if has_masked:
        with span("candidates.masked"):
            slots = slot_stack(lt_m)
            cands = candidates.extract_candidates(
                slots, min(slots.shape[0], cfg.mask_layers + extra))
        with span("shade.alpha"):
            alpha, cutoff = striped(cands, lambda tid, r0: shade.alpha_stack(
                tid.contiguous(), r0, geom, vs, frame, materials, **shade_kw))
        with span("merge"):
            candidates.masked_merge(lt_m, lz_m, cands, alpha, cutoff, solid_tid,
                                    solid_z, clamp_mask)

    # -- phase 3: blended visibility (floor = merged per-sample solid depth) --
    lt_b = cands_b = shaded_b = None
    if has_blended:
        with span("raster.blended"):
            _, lt_b, aux_b = layers.rasterize_layers(
                *bins_blended, solid_z, mode="blended", n_layers=cfg.blend_layers,
                **raster_kw)
            blend_sat = saturated_px(aux_b, cfg.blend_layers)
            blend_demand = demand_max(aux_b)

    # -- phase 4: solid shading, once per distinct candidate -----------------
    # demand signal: distinct REAL solid tids per pixel across samples
    n_c = min(msaa, max(cfg.msaa_shade_candidates, 1))
    with span("candidates.solid"):
        if msaa > 1:
            cands_s, distinct = candidates.extract_candidates(solid_tid, n_c, count=True)
            shade_demand = torch.amax(distinct[:out_rows, : cfg.width])
        else:
            cands_s = candidates.extract_candidates(solid_tid, n_c)
            shade_demand = zero
    with span("shade.solid"):
        shaded_s = shade_candidates(cands_s)

    # -- phase 5: blended shading (deduped); then each sample's solid select
    # and its blended layers' ordered composite, into the HDR samples -------
    if has_blended:
        with span("candidates.blended"):
            slots = slot_stack(lt_b)
            cands_b = candidates.extract_candidates(
                slots, min(slots.shape[0], cfg.blend_layers + extra))
        with span("shade.blended"):
            shaded_b = shade_candidates(cands_b)
    with span("resolve"):
        hdr = candidates.resolve(solid_tid, cands_s, shaded_s, clamp_mask, lt_b,
                                 cands_b, shaded_b)  # [S, H, W, 3]

    # -- phase 6: UI overlay into the HDR buffer of every sample (the
    # reference's ImGui pipeline position: blended, no depth, last in the
    # geometry pass, BEFORE tonemap — renderer.rs:433-441) ------------------
    ov_ui = ui_sat = ui_demand = zero
    ui = frame.get("ui")
    if ui is not None:
        with span("ui"):
            # coverage at pixel centers by default; at the MSAA sample
            # positions under cfg.ui_msaa — shading stays at pixel centers
            # either way
            ui_spos = spos if (cfg.ui_msaa and msaa > 1) else ((0.5, 0.5),)
            lt_ui, ov_ui, aux_ui = ui_stage.rasterize_ui(
                ui, config=cfg, local_tiles_y=local_tiles_y,
                tile_row_offset=tile_row_offset, sample_positions=ui_spos,
                row_stride=row_stride,
            )
            ui_sat = saturated_px(aux_ui, cfg.ui_layers)
            ui_demand = demand_max(aux_ui)
            # ALL layers (and sample sets under ui_msaa) shaded and
            # composited into the samples' HDR buffers in layer order, in
            # one call
            ui_stage.shade_composite_ui(list(hdr), lt_ui[0] if len(ui_spos) == 1 else lt_ui,
                                        ui, materials, config=cfg, row0=row0)

    with span("tonemap"):
        img = post.tonemap(hdr if msaa > 1 else hdr[0])
    with span("stats"):
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
):
    """Single-device frame: returns (final u8 RGB image [H, W, 3],
    stats i32[N_STATS])."""
    from renderer_tpu_torch.scene.draw_stream import unpack_frame

    with span("pipeline"):
        with span("unpack"):
            frame = unpack_frame(frame, morph_k=morph_k, joint_cap=joint_cap)
        with span("vertex"):
            vs = vertex_stage.run_vertex_stage(geom, frame, skin_start, morph_k=morph_k)
        return render_shard(
            geom, frame, materials, vs,
            config=config,
            has_masked=has_masked,
            has_blended=has_blended,
            local_tiles_y=config.tiles_y,
            tile_row_offset=0,
            out_rows=config.height,
        )


def render_frames_scan(
    geom: dict,
    blobs: torch.Tensor,  # [K, blob_len] i32 — K packed frame blobs
    materials: dict,
    *,
    graphs: GraphCache,
    config: RenderConfig,
    skin_start: int,
    has_masked: bool = True,
    has_blended: bool = True,
    morph_k: int = 0,
    joint_cap: int = constants.MAX_JOINT_COUNT,
):
    """Multi-frame rendering: K frames (camera path + animation states
    packed host-side into stacked frame blobs) through the single-frame
    path. Returns (u8 [K, H, W, 3], stats i32 [K, N_STATS]).

    On the card the frame is captured once into a CUDA graph (FrameGraph)
    and replayed K times, one blob after the other, with no host read in
    between: one launch a frame instead of the eager frame's many. `graphs`
    (a Renderer's) keeps the graph across calls. On the CPU each blob goes
    through render_frame."""
    kwargs = dict(config=config, skin_start=skin_start, has_masked=has_masked,
                  has_blended=has_blended, morph_k=morph_k, joint_cap=joint_cap)
    if blobs.device.type == "cpu":
        frames = [render_frame(geom, {"blob": blob}, materials, **kwargs)
                  for blob in blobs]
        return (torch.stack([img for img, _ in frames]),
                torch.stack([stats for _, stats in frames]))
    if blobs.device.type != "cuda":
        raise ValueError(f"render_frames_scan: unsupported device {blobs.device}")
    key = (blobs.device, blobs.shape[1], tuple(sorted(kwargs.items())),
           _identity(geom), _identity(materials))
    graph = graphs.get(key, lambda: FrameGraph(geom, materials, blobs[0], kwargs))
    return graph.run(blobs)


def _identity(tensors: dict) -> tuple:
    """(name, id) of each tensor of a dict: a graph reads its inputs at the
    addresses it was captured with, so another tensor is another graph (the
    graph holds the originals, so their ids cannot be reused meanwhile)."""
    return tuple(sorted((k, id(v)) for k, v in tensors.items()))


#: the hand-written kernels' launch counters (in profiling.COUNTERS): K1's,
#: K2's per mode, the shading kernels S1 ("shade"), S2 ("alpha"), S3
#: ("ui_shade") and the fused S3 ("ui_composite"), the candidate kernels C1
#: ("cand_extract"), C2 ("cand_merge") and C3 ("cand_resolve"), and the
#: front end's F1 ("setup") and F2-F4 (binning.LAUNCHES)
LAUNCH_KEYS = (*raster_kernel.LAUNCHES, *layers.LAUNCHES, *shade.LAUNCHES,
               *ui_stage.LAUNCHES, *candidates.LAUNCHES, *setup.LAUNCHES,
               *binning.LAUNCHES)


def launch_counts() -> dict:
    """The launch counters' values, by key (LAUNCH_KEYS)."""
    return {k: profiling.COUNTERS[k] for k in LAUNCH_KEYS}


def add_launches(delta: dict) -> None:
    profiling.add_counts({k: delta[k] for k in LAUNCH_KEYS})


class CapturedGraph:
    """fn() captured into one CUDA graph, following torch.cuda.graphs: one
    eager run on a side stream first (span setup.capture_warmup), then the
    capture on that stream (setup.capture), then instantiation
    (setup.instantiate). A capture that fails raises; there is no eager
    fallback. `out` is what fn returned at capture: the tensors each replay
    rewrites. The kernel wrappers' launch counters move during capture,
    where nothing launches: the capture's counts (`launches`) are taken
    back and added again on every replay. `manifest` is the graph's
    profiling.Manifest where device tracing is on (`_record`), else None."""

    def __init__(self, fn, device: torch.device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        self.manifest = self._record(fn, side, device)
        with torch.cuda.stream(side), profiling.setup_span("setup.capture_warmup"):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with profiling.setup_span("setup.capture"):
            with torch.cuda.graph(self.graph, stream=side):
                self.out = fn()
        with profiling.setup_span("setup.instantiate"):
            self.graph.instantiate()
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        add_launches({k: -v for k, v in self.launches.items()})

    @staticmethod
    def _record(fn, side, device):
        """With device tracing on, fn() eagerly on the side stream inside a
        torch.profiler session of the tracer's own (span setup.manifest;
        again, up to three times in all, where the trace lost an op): its
        device ops are the graph's manifest. None otherwise. It runs before
        the untraced warm-up, which the capture follows as when untraced
        (an eager run after the capture did not match the replays name for
        name on the H100 at 1080p)."""
        for _ in range(3):
            session = profiling.recording_graph()
            if session is None:
                return None
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), session, \
                    profiling.setup_span("setup.manifest") as root:
                session.root = root.path
                fn()
            torch.cuda.current_stream(device).wait_stream(side)
            if session.manifest is not None:
                return session.manifest
        return None

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


class FrameGraph:
    """render_frame captured into one CUDA graph (CapturedGraph) that reads
    its frame blob from a static buffer; `run` replays it for each blob of
    a batch. While the tracer is on (profiling.tracing), each replay is
    timed by CUDA events (`replay_ms`)."""

    def __init__(self, geom: dict, materials: dict, first_blob: torch.Tensor,
                 kwargs: dict):
        # the graph reads these tensors at their captured addresses: hold them
        self.geom, self.materials = dict(geom), dict(materials)
        self.blob = first_blob.clone()
        self.events: list = []
        self.captured = CapturedGraph(
            lambda: render_frame(self.geom, {"blob": self.blob}, self.materials,
                                 **kwargs),
            first_blob.device)
        self.img, self.stats = self.captured.out

    def run(self, blobs: torch.Tensor):
        """(u8 [K, H, W, 3], stats i32 [K, N_STATS]) of the K blobs, all
        queued on the current stream; nothing waits for the device."""
        k = blobs.shape[0]
        imgs = torch.empty((k, *self.img.shape), dtype=self.img.dtype,
                           device=self.img.device)
        stats = torch.empty((k, *self.stats.shape), dtype=self.stats.dtype,
                            device=self.stats.device)
        timed = profiling.tracing()
        self.events = []
        for i in range(k):
            self.blob.copy_(blobs[i])
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                self.captured.replay()
                end.record()
                self.events.append((start, end))
            else:
                self.captured.replay()
            imgs[i].copy_(self.img)
            stats[i].copy_(self.stats)
        return imgs, stats

    def replay_ms(self) -> list:
        """CUDA-event ms of each replay of the last `run` (waits for them);
        empty where the tracer was off during it."""
        for _, end in self.events:
            end.synchronize()
        return [start.elapsed_time(end) for start, end in self.events]


class GraphCache:
    """At most one FrameGraph, the one of the last key: a graph's private
    memory pool holds a whole frame's intermediates, so a new key (another
    config after a capacity grew, other geometry) drops the old graph before
    the new one is captured."""

    def __init__(self) -> None:
        self.key = None
        self.graph: FrameGraph | None = None

    def get(self, key, make) -> FrameGraph:
        if self.graph is None or self.key != key:
            if self.graph is not None:
                self.key = self.graph = None
                torch.cuda.empty_cache()
            self.graph = make()
            self.key = key
        return self.graph
