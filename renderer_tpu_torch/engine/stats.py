"""Observability: device memory accounting and per-stage device timings.

Parity targets:
- VRAM atomics + startup logging (reference: renderer/src/lib.rs:75-93,
  examples/sandbox/src/main.rs:119-127 print_memory_usage,
  physical_device.rs:109-119 memory-budget query) → `memory_usage()` /
  `log_memory_usage()` over `torch.cuda.memory_stats`.
- The `Bytes` pretty-printer (lib.rs:103-128).
- Per-stage µs timings (the profile-with-tracing span tree,
  main.rs:704-847) → `device_stage_timings()` runs the frame stage by
  stage on inputs made once and returns a table; `fused_frame_ms()` is
  the whole frame as render_frames_scan replays it.

On the card a stage is timed by CUDA events around each of `iters` runs
and the median is reported: replays of the stage captured as a CUDA graph
and queued behind a spin kernel (its device time), or eager runs as the
host issues them (host-paced). On the CPU, by time.perf_counter around
each run.
"""

from __future__ import annotations

import statistics
import time
from contextlib import contextmanager

import torch

from renderer_tpu_torch.engine.profiling import Profiler


def format_bytes(n: int) -> str:
    """Bytes pretty-printer (lib.rs:103-128 prints the largest binary unit)."""
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if value < 1024.0 or unit == "TiB":
            return f"{value:.2f} {unit}" if unit != "B" else f"{int(value)} B"
        value /= 1024.0
    return f"{value:.2f} TiB"


def memory_usage(device) -> dict:
    """Device memory of the caching allocator on `device` (the renderer's
    device; the VK_EXT_memory_budget analog): bytes in use, the peak, and
    the card's total. A CPU device has no such accounting and reports 0s."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return {"in_use": 0, "peak": 0, "limit": 0}
    if dev.type != "cuda":
        raise ValueError(f"memory_usage: unsupported device {dev}")
    stats = torch.cuda.memory_stats(dev)
    return {
        "in_use": stats.get("allocated_bytes.all.current", 0),
        "peak": stats.get("allocated_bytes.all.peak", 0),
        "limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def log_memory_usage(tag: str, device) -> str:
    u = memory_usage(device)
    line = (
        f"[{tag}] device memory in use: {format_bytes(u['in_use'])}, "
        f"peak: {format_bytes(u['peak'])}, limit: {format_bytes(u['limit'])}"
    )
    print(line)
    return line


def _shade_dt(cfg):
    return torch.bfloat16 if cfg.bf16_shading else torch.float32


# the spin that holds the stream while a stage's replays are enqueued:
# ~0.1 s at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 200_000_000


@contextmanager
def held_stream(cycles: int):
    """Holds the current stream with a spin kernel of `cycles` while the
    body enqueues work behind it, so events recorded in the body time the
    device's work without the host's launch gaps. Raises when the spin had
    ended before the body returned (the times would then be host-paced)."""
    torch.cuda._sleep(cycles)
    spun = torch.cuda.Event()
    spun.record()
    yield
    if spun.query():
        raise RuntimeError("held_stream: the spin kernel ended before the work "
                           "was enqueued")


def _time_call(fn, *args, iters: int, device, paced: str) -> float:
    """Median ms of one run of fn(*args) over `iters` runs on inputs made
    once. On the card, paced="device": fn captured into a CUDA graph whose
    replays are enqueued behind a spin kernel (held_stream), CUDA events
    around each replay, so the time is the device's alone; paced="host":
    CUDA events around each eager run after one warm-up run, as the host
    issues them, its gaps between launches included. On the CPU,
    time.perf_counter around each run at either pace."""
    from renderer_tpu_torch.raster.pipeline import CapturedGraph

    dev = torch.device(device)
    if dev.type == "cuda" and paced == "device":
        graph = CapturedGraph(lambda: fn(*args), dev)
        graph.replay()  # the first replay uploads the graph
        torch.cuda.synchronize(dev)
        times = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        with held_stream(SPIN_CYCLES):
            for start, end in times:
                start.record()
                graph.replay()
                end.record()
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) for s, e in times)
    fn(*args)
    times = []
    if dev.type == "cuda":
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            times.append((start, end))
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) for s, e in times)
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fused_frame_ms(renderer, scene, iters: int = 16) -> float:
    """Per-frame ms of the production frame as the flythrough mode runs it:
    `iters` copies of `scene` through renderer.render_frames_device, and
    the median CUDA-event time of one replay of its graph (a Profiler is
    attached around the batch, so FrameGraph.run times each replay). On
    the CPU, the batch's perf_counter time over `iters`."""
    if renderer.device.type == "cpu":
        t0 = time.perf_counter()
        renderer.render_frames_device([scene] * iters)
        return (time.perf_counter() - t0) * 1e3 / iters
    with Profiler().span("timed batch"):
        renderer.render_frames_device([scene] * iters)
    return statistics.median(renderer.frame_graphs.graph.replay_ms())


def device_stage_timings(renderer, scene, iters: int = 10, paced: str = "device",
                         frame_binning: bool = False) -> dict[str, float]:
    """Runs the frame pipeline stage by stage (each stage on inputs made
    once) and returns {stage: ms}. Covers every pass the production frame
    runs for this scene — opaque, masked layer raster + alpha test, blended
    layer raster + shade — at one sample (as the JAX package's table does:
    the single-sample stages run on sample 0's visibility, and the deferred
    shade on the default sampler arguments), plus the fused full frame at
    the renderer's real MSAA config (fused_frame_ms). The stage sum differs
    from the full frame, which shades MSAA candidates in strips. With
    `frame_binning`, a row after "binning (opaque)" times the frame's own
    binning call (every alpha class, the configured z-buckets and row
    capacity, on the setup with the frame's bbox pad), which the JAX
    package's table does not have.

    `paced` ("device" or "host") says how a stage is timed on the card
    (_time_call): its device time, from a captured graph's replays queued
    behind a spin, or the eager run as the host issues it. The fused frame
    is a graph replay at either pace."""
    if paced not in ("device", "host"):
        raise ValueError(f"device_stage_timings: paced={paced!r}")
    from functools import partial

    from renderer_tpu_torch.raster import (binning, layers, post, raster_kernel,
                                           setup, shade, vertex_stage)
    from renderer_tpu_torch.scene import draw_stream

    cfg = renderer.config
    dev = renderer.device
    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    packed = renderer._frame_arrays(scene, fv, gs)
    frame = draw_stream.unpack_frame(packed, morph_k=gs.morph_k,
                                     joint_cap=renderer._joint_cap(scene))
    mats = renderer._materials()

    def timed(fn, *args):
        return _time_call(fn, *args, iters=iters, device=dev, paced=paced)

    timings: dict[str, float] = {}

    vs_fn = partial(vertex_stage.run_vertex_stage, skin_start=gs.skin_start,
                    morph_k=gs.morph_k)
    timings["vertex+skinning"] = timed(vs_fn, geom, frame)
    vs = vs_fn(geom, frame)

    setup_fn = partial(setup.triangle_setup, width=cfg.width, height=cfg.height)
    timings["triangle setup"] = timed(setup_fn, vs["clip"], geom["tri_v"],
                                      frame["num_tris"])
    td = setup_fn(vs["clip"], geom["tri_v"], frame["num_tris"])

    bin_fn = partial(
        binning.bin_triangles,
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, pair_capacity=cfg.pair_capacity,
    )
    timings["binning (opaque)"] = timed(bin_fn, td, 0, frame["n_opaque"])
    b, s, c, _ = bin_fn(td, 0, frame["n_opaque"])
    if frame_binning:
        # the frame's own front end (pipeline.render_shard): setup with the
        # MSAA bbox pad, then every alpha class in one binning call
        pad = 0.5 if cfg.msaa_samples > 1 else 0.0
        td_frame = setup_fn(vs["clip"], geom["tri_v"], frame["num_tris"], bbox_pad=pad)
        n_om = frame["n_opaque"] + frame["n_masked"]
        frame_bin_fn = partial(
            binning.bin_triangle_classes, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h, pair_capacity=cfg.pair_capacity,
            row_capacity=cfg.row_capacity, zbuckets=cfg.opaque_z_buckets)
        timings[f"binning (frame: all classes, {cfg.opaque_z_buckets} z-buckets, "
                f"bbox_pad {pad})"] = timed(
            lambda td_, b0, b1, b2: frame_bin_fn(td_, (0, b0, b1, b2)),
            td_frame, frame["n_opaque"], n_om, frame["num_tris"])

    raster_fn = partial(
        raster_kernel.rasterize_binned,
        padded_height=cfg.padded_height, padded_width=cfg.padded_width,
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
    )
    timings["raster (opaque)"] = timed(raster_fn, b, s, c)
    depth, trid = raster_fn(b, s, c)
    depth1, trid = depth, trid[0]  # [1, Hp, Wp] single-sample stage timings

    # the stage's entry points (shade.shade_stack / alpha_stack: kernels S1
    # and S2 on the card) on the image area of one map, at global row 0
    row0 = torch.zeros((cfg.height, 1), dtype=torch.float32, device=dev)
    shade_kw = dict(width=cfg.width, height=cfg.height, trilinear=cfg.trilinear,
                    aniso=cfg.aniso_samples, srgb_per_tap=cfg.srgb_per_tap,
                    compute_dtype=_shade_dt(cfg))

    def crop(t):
        return t[: cfg.height, : cfg.width].contiguous()

    n_masked = gs.num_masked_tris
    n_blended = gs.num_tris - gs.num_opaque_tris - gs.num_masked_tris
    layer_fn = partial(
        layers.rasterize_layers,
        padded_height=cfg.padded_height, padded_width=cfg.padded_width,
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
    )

    if n_masked:
        bm = bin_fn(td, frame["n_opaque"], frame["n_opaque"] + frame["n_masked"])[:3]
        timings["raster (masked layers)"] = timed(
            partial(layer_fn, mode="masked", n_layers=cfg.mask_layers), *bm, depth1)
        _lz, lt, _aux = layer_fn(*bm, depth1, mode="masked", n_layers=cfg.mask_layers)
        lt = lt[0]  # single-sample: [K, Hp, Wp]

        def alpha_fn(lt_, geom_, vs_, frame_, mats_):
            return shade.alpha_stack(crop(lt_[0]), row0, geom_, vs_, frame_,
                                     mats_, **shade_kw)

        timings["masked alpha test (per layer)"] = timed(
            alpha_fn, lt, geom, vs, frame, mats)

    if n_blended:
        bb = bin_fn(td, frame["n_opaque"] + frame["n_masked"], frame["num_tris"])[:3]
        timings["raster (blended layers)"] = timed(
            partial(layer_fn, mode="blended", n_layers=cfg.blend_layers), *bb, depth1)
        _lzb, ltb, _auxb = layer_fn(*bb, depth1, mode="blended",
                                    n_layers=cfg.blend_layers)
        ltb = ltb[0]

        def blend_fn(ltb_, geom_, vs_, frame_, mats_):
            return shade.shade_stack(crop(ltb_[0]), row0, geom_, vs_, frame_,
                                     mats_, **shade_kw)

        timings["blended shade (per layer)"] = timed(
            blend_fn, ltb, geom, vs, frame, mats)

    def shade_fn(trid_, geom_, vs_, frame_, mats_):
        hdr = shade.shade_stack(crop(trid_), row0, geom_, vs_, frame_, mats_,
                                **shade_kw)
        return post.tonemap(hdr[..., :3])

    timings["deferred shade + tonemap"] = timed(shade_fn, trid, geom, vs, frame, mats)

    # the production frame, every stage above in one captured graph at the
    # renderer's real msaa/layer config (msaa runs visibility per sample +
    # candidate-deduped shading, raster/pipeline.py)
    timings[f"FULL FRAME (fused, msaa{cfg.msaa_samples})"] = fused_frame_ms(
        renderer, scene, iters=iters)
    return timings


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (first card), to stand beside every number taken on it."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
