"""Renderer: the frame engine gluing scene → device tensors → frame function.

The analog of the reference's Renderer frame loop
(renderer/src/renderer.rs:130-356): `render_frame(scene)` sorts the draws,
builds the per-frame blob (~µs of numpy), uploads it, and runs the frame on
the renderer's device. Geometry and material tensors are cached: a frame
that queues the same meshes reuses device-resident geometry (the analog of
the static vertex library staying in VRAM), so steady-state host→device
traffic is one i32 blob of transforms + camera + joints.

The frames run on the card unless the caller asks for the CPU:
`Renderer(registry, config)` takes device "cuda", where the raster passes
run through the hand-written kernels; `device="cpu"` runs their plain
PyTorch versions. Asking for CUDA where there is none raises — nothing moves
the work to the CPU quietly.
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import torch

from renderer_tpu_torch.core.config import RenderConfig
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.engine.profiling import Profiler, span
from renderer_tpu_torch.interop import resolve_device
from renderer_tpu_torch.materials.atlas import build_atlas
from renderer_tpu_torch.materials.atlas_device import (
    build_atlas_plan_cached,
    realize_atlas,
)
from renderer_tpu_torch.materials.registry import MaterialRegistry
from renderer_tpu_torch.raster import layers, pipeline
from renderer_tpu_torch.scene import draw_stream
from renderer_tpu_torch.scene.scene import Scene

MAX_PAIR_CAPACITY = 1 << 22

# Layered-capture growth ceiling: each extra layer costs one more deferred
# shade/composite pass plus registers per thread in kernel K2, which is
# instantiated up to this count; runaway growth on a pathological stack caps
# loudly.
MAX_LAYERS = layers.MAX_KERNEL_LAYERS

# stats demand entry → RenderConfig field it right-sizes
_LAYER_KNOBS = (
    ("masked_demand_max", "mask_layers"),
    ("blended_demand_max", "blend_layers"),
    ("ui_demand_max", "ui_layers"),
)

_GEOM_KEYS = ("positions", "uvs", "normals", "tangents", "joints", "weights",
              "exp_src", "exp_draw", "tri_v", "morph_pos", "morph_nrm",
              "morph_row0", "morph_step")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


class Renderer:
    def __init__(
        self,
        registry: MaterialRegistry,
        config: RenderConfig | None = None,
        profiler: Profiler | None = None,
        overflow_policy: str = "auto",
        shrink_after: int = 120,
        max_layers: int = MAX_LAYERS,
        device="cuda",
    ) -> None:
        """overflow_policy — what to do when the frame's stats vector reports
        dropped work (bin pair/row capacity exceeded, or a layered capture
        truncated past mask_layers/blend_layers/ui_layers — the reference's
        fixed-function blending is unbounded, pipelines.rs:112-132), the
        analog of the reference's loud arena-OOM errors
        (arena/buffers.rs:126-163):
        - "auto" (default): check the PREVIOUS frame's stats after each
          frame is queued (no stall behind the current frame), log loudly
          and regrow the capacity so subsequent frames are complete;
        - "sync": check THIS frame's stats before returning and re-render at
          the grown capacity — the returned image is always complete;
        - "off": never read stats on the host (stats are still computed and
          available via `frame_stats()`), for timed loops.

        shrink_after — under "auto"/"sync", the binning buckets are also
        shrunk back after this many CONSECUTIVE frames whose demand would fit
        a bucket ≤ half the current one (the binning sort costs
        O(capacity log capacity) regardless of scene size). The same streak
        discipline shrinks grown layer counts back toward their configured
        floor.

        max_layers — ceiling for the layer-count growth (see MAX_LAYERS).

        device — the torch device the frames run on: "cuda" (the default)
        or "cpu"."""
        assert overflow_policy in ("auto", "sync", "off")
        self.device = resolve_device(device)
        self.config = (config or RenderConfig()).validate()
        self.registry = registry
        self.profiler = profiler or Profiler(enabled=False)
        self.overflow_policy = overflow_policy
        self.shrink_after = shrink_after
        self.max_layers = min(max_layers, MAX_LAYERS)
        self._skip_stat_checks = 0  # frames dispatched before a capacity change
        # per-knob (streak length, streak peak demand) for shrink hysteresis
        # (_streak_shrink). The LAYER/shade knobs never shrink below the
        # configured counts; the binning pair/row buckets are demand-governed
        # in BOTH directions (floor = the 1<<14 minimum bucket).
        self._layer_floors = {
            field: getattr(self.config, field) for _, field in _LAYER_KNOBS
        }
        self._shade_floor = self.config.msaa_shade_candidates
        self._streaks = {field: (0, 0) for _, field in _LAYER_KNOBS}
        self._streaks["pair_capacity"] = (0, 0)
        self._streaks["row_capacity"] = (0, 0)
        self._streaks["msaa_shade_candidates"] = (0, 0)
        self._geom_cache: dict = {}
        self._mat_cache: tuple[int, dict] | None = None
        self._last_stats = None  # device i32[N_STATS] of the last frame
        # the captured frame of render_frames_device on the card (one graph)
        self.frame_graphs = pipeline.GraphCache()

    # -- frame stats / overflow recovery --------------------------------------

    @property
    def last_stats(self):
        """Device stats tensor of the most recent frame, with no host sync
        (read it after a timing loop; see pipeline.STAT_NAMES)."""
        return self._last_stats

    def frame_stats(self) -> dict[str, int] | None:
        """Stats of the most recent frame (syncs on it). See
        pipeline.STAT_NAMES."""
        if self._last_stats is None:
            return None
        vals = self._read(self._last_stats)
        return dict(zip(pipeline.STAT_NAMES, (int(v) for v in vals)))

    def _total_overflow(self, stats_host) -> int:
        """Dropped work across every binning bucket: geometry pairs [0:3],
        UI pairs [3], and the ragged row axis (row_overflow)."""
        total = int(np.sum(stats_host[:4]))
        idx = pipeline.STAT_NAMES.index("row_overflow")
        if len(stats_host) > idx:
            total += int(stats_host[idx])
        return total

    def _grow_pair_capacity(self, stats_host) -> bool:
        """Regrow whichever binning bucket overflowed — the geometry
        pair_capacity for scene overflow ([0:3]), ui_pair_capacity for UI
        overflow ([3]), row_capacity for row overflow; each is pow-2 like
        every other capacity bucket. Returns True if any bucket grew."""
        def grown(name, current, overflow, max_cap,
                  unit="(tile, triangle) pairs"):
            needed = current + overflow
            new = current
            while new < needed and new < max_cap:
                new *= 2
            if new == current:
                print(
                    f"[renderer] bin overflow of {overflow} {unit} but "
                    f"{name} is already at the {max_cap} max; work WILL be "
                    "dropped",
                )
                return None
            print(
                f"[renderer] bin overflow: {overflow} {unit} dropped; "
                f"regrowing {name} {current} -> {new}",
            )
            return new

        changed = False
        geo = int(np.sum(stats_host[:3]))
        if geo > 0:
            new = grown("pair_capacity", self.config.pair_capacity, geo,
                        MAX_PAIR_CAPACITY)
            if new is not None:
                self.config = replace(self.config, pair_capacity=new).validate()
                profiling.count("capacity_grows")
                changed = True
        ui = int(stats_host[3])
        if ui > 0:
            new = grown("ui_pair_capacity", self.config.ui_pair_capacity, ui,
                        MAX_PAIR_CAPACITY)
            if new is not None:
                self.config = replace(
                    self.config, ui_pair_capacity=new
                ).validate()
                profiling.count("capacity_grows")
                changed = True
        ridx = pipeline.STAT_NAMES.index("row_overflow")
        rows = int(stats_host[ridx]) if len(stats_host) > ridx else 0
        if rows > 0:
            new = grown("row_capacity", self.config.row_capacity, rows,
                        MAX_PAIR_CAPACITY, unit="(triangle, tile-row) rows")
            if new is not None:
                self.config = replace(self.config, row_capacity=new).validate()
                profiling.count("capacity_grows")
                changed = True
        if changed:
            self._streaks["pair_capacity"] = (0, 0)
            self._streaks["row_capacity"] = (0, 0)
        return changed

    def _streak_shrink(self, field: str, demand: int, bucket, floor: int,
                       what: str) -> None:
        """Shared shrink hysteresis for every demand-fed capacity knob:
        after `shrink_after` CONSECUTIVE frames whose demand fit a smaller
        bucket, shrink `field` to the bucket of the streak's PEAK demand.
        `bucket(d)` maps a demand value to its capacity bucket; `floor` is
        the caller-configured minimum."""
        cur = getattr(self.config, field)
        if max(bucket(demand), floor) >= cur:
            self._streaks[field] = (0, 0)
            return
        streak, peak = self._streaks[field]
        peak = demand if streak == 0 else max(peak, demand)
        streak += 1
        if streak < self.shrink_after:
            self._streaks[field] = (streak, peak)
            return
        # every frame in the streak individually fit under the current
        # capacity with headroom, so the peak's bucket is a strict shrink
        desired = max(bucket(peak), floor)
        if desired < cur:
            print(
                f"[renderer] {field}={cur} oversized for {streak} "
                f"consecutive frames (streak peak {what} {peak}); "
                f"shrinking to {desired}",
            )
            self.config = replace(self.config, **{field: desired}).validate()
            profiling.count("capacity_shrinks")
        self._streaks[field] = (0, 0)

    def _grow_layer_capacity(self, stats_host) -> bool:
        """Grow mask_layers/blend_layers/ui_layers toward the measured peak
        per-pixel fragment demand (stats *_demand_max) when a layered capture
        truncated. Pow-2 buckets; capped LOUDLY at max_layers. The blended
        demand measured under truncation can overcount (dropped fragments
        never write the chain depth), so growth may overshoot by one bucket;
        the shrink streak settles it. Returns True if any count grew."""
        changed = False
        for stat, field in _LAYER_KNOBS:
            idx = pipeline.STAT_NAMES.index(stat)
            if len(stats_host) <= idx:
                return changed
            demand = int(stats_host[idx])
            cur = getattr(self.config, field)
            if demand <= cur:
                continue
            new = min(_next_pow2(demand), self.max_layers)
            if new <= cur:
                print(
                    f"[renderer] {field} saturated (peak demand {demand} "
                    f"fragments/pixel) but already at the {self.max_layers} "
                    "max; deeper stacks will under-blend (counted in "
                    "*_saturated_px)",
                )
                continue
            print(
                f"[renderer] layered capture truncated: peak demand {demand} "
                f"fragments/pixel; regrowing {field} {cur} -> {new}",
            )
            self.config = replace(self.config, **{field: new}).validate()
            profiling.count("capacity_grows")
            self._streaks[field] = (0, 0)
            changed = True
        return changed

    def _maybe_shrink_layers(self, stats_host) -> None:
        """Shrink a grown layer count back toward its configured floor after
        a clean streak (see _streak_shrink)."""
        for stat, field in _LAYER_KNOBS:
            idx = pipeline.STAT_NAMES.index(stat)
            if len(stats_host) <= idx:
                return
            self._streak_shrink(field, int(stats_host[idx]), _next_pow2,
                                self._layer_floors[field],
                                "demand (fragments/pixel)")

    def _grow_shade_candidates(self, stats_host) -> bool:
        """Grow msaa_shade_candidates toward the measured peak count of
        distinct solid triangles per pixel (stats shade_demand_max, bounded
        by msaa_samples)."""
        idx = pipeline.STAT_NAMES.index("shade_demand_max")
        if len(stats_host) <= idx:
            return False
        demand = int(stats_host[idx])
        cur = self.config.msaa_shade_candidates
        cap = self.config.msaa_samples
        if demand <= cur or cur >= cap:
            return False
        new = min(demand, cap)
        print(
            f"[renderer] MSAA shading candidate set saturated: up to {demand} "
            f"distinct triangles/pixel; regrowing msaa_shade_candidates "
            f"{cur} -> {new}",
        )
        self.config = replace(self.config, msaa_shade_candidates=new).validate()
        profiling.count("capacity_grows")
        self._streaks["msaa_shade_candidates"] = (0, 0)
        return True

    def _maybe_shrink_shade_candidates(self, stats_host) -> None:
        """Shrink a grown candidate set back toward the configured floor
        after a clean streak; never while any shading fallback is active
        (shade_clamped_px > 0)."""
        demand_idx = pipeline.STAT_NAMES.index("shade_demand_max")
        clamp_idx = pipeline.STAT_NAMES.index("shade_clamped_px")
        if len(stats_host) <= demand_idx:
            return
        if int(stats_host[clamp_idx]) > 0:
            self._streaks["msaa_shade_candidates"] = (0, 0)
            return
        self._streak_shrink("msaa_shade_candidates",
                            int(stats_host[demand_idx]), lambda d: d,
                            self._shade_floor, "demand")

    def _grow_capacities(self, stats_host) -> bool:
        """All capacity-growth feedback for one checked stats vector.
        Returns True if anything grew."""
        changed = False
        if self._total_overflow(stats_host) > 0:
            changed = self._grow_pair_capacity(stats_host)
        changed = self._grow_layer_capacity(stats_host) or changed
        return self._grow_shade_candidates(stats_host) or changed

    def _maybe_shrink_capacities(self, stats_host) -> None:
        self._maybe_shrink_pair_capacity(stats_host)
        self._maybe_shrink_layers(stats_host)
        self._maybe_shrink_shade_candidates(stats_host)

    def _maybe_shrink_pair_capacity(self, stats_host) -> None:
        """Shrink the binning buckets when the scene has sustainedly needed
        ≤ half of them (with 2× headroom): pair_capacity ← total_pairs and
        row_capacity ← total_rows. Guarded on row_overflow == 0: while rows
        truncate, total_pairs understates the demand."""
        ridx = pipeline.STAT_NAMES.index("row_overflow")
        if len(stats_host) > ridx and int(stats_host[ridx]) > 0:
            self._streaks["pair_capacity"] = (0, 0)
            self._streaks["row_capacity"] = (0, 0)
            return
        for field, stat in (("pair_capacity", "total_pairs"),
                            ("row_capacity", "total_rows")):
            idx = pipeline.STAT_NAMES.index(stat)
            if len(stats_host) <= idx:
                return
            self._streak_shrink(
                field, int(stats_host[idx]),
                lambda d: 1 << max(14, (max(d, 1) * 2 - 1).bit_length()),
                0, stat,
            )

    # -- device tensor preparation ------------------------------------------

    #: distinct draw-list shapes kept resident (host stream + device
    #: geometry tensors each), LRU-bounded so an app cycling scenes can't
    #: grow device memory without bound
    GEOM_CACHE_MAX = 8

    def _geometry(self, scene: Scene, order, geom_key: bytes):
        cached = self._geom_cache.pop(geom_key, None)  # re-insert = LRU touch
        if cached is None:
            draws = scene.materialize(order)
            gs = draw_stream.build_geometry(draws, self.config.max_triangles)
            dev = {k: self._to_device(getattr(gs, k)) for k in _GEOM_KEYS}
            cached = (gs, dev)
        self._geom_cache[geom_key] = cached
        while len(self._geom_cache) > self.GEOM_CACHE_MAX:
            # oldest entry first (dict preserves insertion order); dropping
            # the reference frees its device tensors
            self._geom_cache.pop(next(iter(self._geom_cache)))
        return cached

    def _use_device_atlas(self) -> bool:
        """Decode BC7 on the device (upload blocks, not decoded texels —
        materials/atlas_device.py) on the card; the host path is the CPU
        default and the oracle. Override with RENDERER_TPU_ATLAS=device|host."""
        mode = os.environ.get("RENDERER_TPU_ATLAS", "")
        if mode in ("device", "host"):
            return mode == "device"
        return self.device.type == "cuda"

    def _atlas(self):
        """(atlas on the device, table, srgb, wrap) of the registry's
        textures: BC7 blocks decoded on the device where that uploads
        less, else the host-decoded atlas."""
        reg = self.registry
        if self._use_device_atlas():
            plan = build_atlas_plan_cached(reg)
            decoded_bytes = 0 if plan is None else plan.shape[0] * plan.shape[1] * 4
            if plan is None:
                # a reserved BC7 block: only the host decode gives it the
                # reference's opaque black (a choice, not a fallback)
                print("[renderer] reserved BC7 block in a texture; using "
                      "the host atlas path")
            elif plan.upload_bytes < decoded_bytes:
                profiling.count("uploads")
                profiling.count("upload_bytes", plan.upload_bytes)
                return realize_atlas(plan, self.device), plan.table, plan.srgb, plan.wrap
            else:
                # mostly non-BC7 textures: the compressed plan would ship
                # more bytes than the decoded atlas, so the host path is
                # the cheaper upload (a choice, not a fallback)
                print(f"[renderer] device atlas plan ({plan.upload_bytes} B) "
                      f"not smaller than the decoded atlas ({decoded_bytes} "
                      "B); using the host path")
        at = build_atlas(reg)
        # RGBA8 packed in u32; torch keeps the bits as i32
        return self._to_device(at.data.view(np.int32)), at.table, at.srgb, at.wrap

    def _materials(self):
        reg = self.registry
        if self._mat_cache is not None and self._mat_cache[0] == reg.version:
            return self._mat_cache[1]

        up = self._to_device
        with profiling.setup_span("setup.atlas"):
            atlas, table, srgb, wrap = self._atlas()
        dev = {
            "base_color_factor": up(reg.base_color_factor),
            "emissive_occlusion": up(reg.emissive_occlusion),
            "alpha_rgh_mtl_normal": up(reg.alpha_rgh_mtl_normal),
            "tex_indices": up(reg.tex_indices),
            "atlas": atlas,
            "atlas_table": up(table),
            "atlas_srgb": up(srgb),
        }
        if wrap.any():
            # per-texture sampler address modes, attached only when some
            # texture is non-repeat
            dev["atlas_wrap"] = up(wrap)
        self._mat_cache = (reg.version, dev)
        return dev

    def _joint_cap(self, scene: Scene) -> int:
        """Pow-2 joint-palette bucket for the frame blob, sized from the
        scene's exact joint cursor; consumers that unpack a blob this
        renderer packed must pass the same value."""
        return _next_pow2(max(scene._joint_cursor, 8))

    def _frame_arrays(self, scene: Scene, fv, gs, debug_mode: int = 0) -> dict:
        blob = draw_stream.pack_frame_blob(
            fv, scene.joint_palette, self._proj_view(scene),
            (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris, debug_mode),
            morph_k=gs.morph_k, joint_cap=self._joint_cap(scene),
        )
        return {"blob": self._upload(blob)}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A per-frame host array on the renderer's device, copied from
        pinned host memory on the card (the copy does not wait for the
        device)."""
        host = torch.from_numpy(np.ascontiguousarray(a))
        profiling.count("uploads")
        profiling.count("upload_bytes", host.nbytes)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array of set-up (geometry, materials) on the device."""
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # a memory-mapped cache entry
            a = a.copy()
        profiling.count("uploads")
        profiling.count("upload_bytes", a.nbytes)
        return torch.from_numpy(a).to(self.device)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor read back to the host (waits for it)."""
        profiling.count("reads")
        profiling.count("read_bytes", t.nbytes)
        return t.cpu().numpy()

    # -- frame loop ----------------------------------------------------------

    def _dispatch(self, scene: Scene, debug_mode: int, ui=None):
        with span("prologue.draws"):
            fv = draw_stream.frame_view(scene)
        with span("prologue.geometry"):
            gs, geom_dev = self._geometry(scene, fv.order, fv.geom_key)
        with span("prologue.blob"):
            frame = self._frame_arrays(scene, fv, gs, debug_mode)
            if ui is not None:
                packed_ui = ui.pack() if hasattr(ui, "pack") else ui
                frame["ui"] = {k: self._upload(v) for k, v in packed_ui.items()}
        with span("prologue.materials"):
            mats = self._materials()
        img, stats = pipeline.render_frame(
            geom_dev, frame, mats,
            config=self.config, skin_start=gs.skin_start,
            has_masked=gs.num_masked_tris > 0,
            has_blended=gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris,
            morph_k=gs.morph_k, joint_cap=self._joint_cap(scene),
        )
        return img, stats

    def render_frame_device(self, scene: Scene, debug_mode: int = 0,
                            ui=None) -> torch.Tensor:
        """One frame, returned as a device u8 [H,W,3] tensor (no host copy).
        `ui` — optional renderer_tpu_torch.ui.DrawList (or its packed dict):
        the overlay rendered through the raster pipeline's UI pass."""
        with self.profiler.span("frame", frame=True):
            prev_stats = self._last_stats
            img, stats = self._dispatch(scene, debug_mode, ui)
            self._last_stats = stats
            if self.overflow_policy == "sync":
                # loop: regrow until the frame reports no dropped/truncated
                # work (or every growable capacity is at its max)
                with span("overflow"):
                    for _ in range(8):
                        host = self._read(stats)
                        if not self._grow_capacities(host):
                            self._maybe_shrink_capacities(host)
                            break
                        img, stats = self._dispatch(scene, debug_mode, ui)
                        self._last_stats = stats
            elif self.overflow_policy == "auto" and prev_stats is not None:
                # one-frame-delayed check: the previous frame is queued ahead
                # of this one, so reading its stats waits only for it. A
                # frame rendered BEFORE a capacity grow still reports the old
                # overflow — acting on it would double-grow from one event.
                if self._skip_stat_checks > 0:
                    self._skip_stat_checks -= 1
                else:
                    with span("overflow"):
                        host = self._read(prev_stats)
                        if self._grow_capacities(host):
                            self._skip_stat_checks = 1
                        else:
                            self._maybe_shrink_capacities(host)
        return img

    def render_frames_device(self, scenes, debug_mode: int = 0):
        """Multi-frame rendering: all `scenes` (a camera path / animation
        timeline sharing one draw list) in one pipeline.render_frames_scan
        call — on the card one CUDA graph of the frame, replayed once a
        scene — returning (u8 device images [K, H, W, 3], stats [K,
        N_STATS]). The offline/flythrough throughput mode (no UI pass).

        The overflow policy applies to the MAX over all K frames' stats rows
        (no frame's dropped work can hide behind a clean final frame), read
        in one host read: "sync" re-renders the whole batch at grown
        capacity until clean, "auto" grows for the next call, "off" reads
        nothing and leaves verification to the caller via the returned
        stats."""
        if not scenes:
            raise ValueError("render_frames_device: need at least one scene")
        with self.profiler.span("batch", frame=True):
            return self._batch(scenes, debug_mode)

    def _batch(self, scenes, debug_mode: int):
        with span("prologue.draws"):
            fvs = [draw_stream.frame_view(s) for s in scenes]
        if any(fv.geom_key != fvs[0].geom_key for fv in fvs[1:]):
            raise ValueError(
                "render_frames_device: all scenes must queue the same draw "
                "list (geometry stream is shared across the batch)")
        with span("prologue.geometry"):
            gs, geom_dev = self._geometry(scenes[0], fvs[0].order, fvs[0].geom_key)
        with span("prologue.blobs"):
            # one blob layout for the whole batch: the widest scene's bucket
            joint_cap = max(self._joint_cap(s) for s in scenes)
            blobs = self._upload(np.stack([
                draw_stream.pack_frame_blob(
                    fv, scene.joint_palette, self._proj_view(scene),
                    (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris,
                     debug_mode),
                    morph_k=gs.morph_k, joint_cap=joint_cap,
                )
                for fv, scene in zip(fvs, scenes)
            ]))
        with span("prologue.materials"):
            mats = self._materials()

        def dispatch():
            with span("replay"):
                return pipeline.render_frames_scan(
                    geom_dev, blobs, mats,
                    config=self.config, skin_start=gs.skin_start,
                    has_masked=gs.num_masked_tris > 0,
                    has_blended=gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris,
                    morph_k=gs.morph_k, joint_cap=joint_cap,
                    graphs=self.frame_graphs,
                )

        imgs, stats = dispatch()
        if self.overflow_policy != "off":
            with span("overflow"):
                for _ in range(8):
                    host = self._read(torch.amax(stats, dim=0))
                    if not self._grow_capacities(host):
                        self._maybe_shrink_capacities(host)
                        break
                    if self.overflow_policy != "sync":
                        # grown for the next call; this batch stays as it
                        # is, and its stats rows still report the OLD
                        # capacity's overflow, so the next
                        # render_frame_device's delayed check must not grow
                        # AGAIN from the same event
                        self._skip_stat_checks = 1
                        break
                    imgs, stats = dispatch()
        self._last_stats = stats[-1]
        return imgs, stats

    def _proj_view(self, scene: Scene) -> np.ndarray:
        proj, view = scene.camera.proj_view(
            float(self.config.width), float(self.config.height),
            scene.world_space,
        )
        return proj @ view

    def render_frame(self, scene: Scene, debug_mode: int = 0,
                     ui=None) -> np.ndarray:
        """One frame, copied back to the host (the 'present' boundary)."""
        img = self.render_frame_device(scene, debug_mode, ui)
        with self.profiler.span("present"):
            return self._read(img)
