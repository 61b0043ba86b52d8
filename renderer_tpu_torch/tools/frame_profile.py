"""Where a frame's device time goes, on the card: one frame of the
mini-sandbox (scene C of chip_smoke.py: 1920×1080, 4×MSAA, the skinned
character and the "Performance stats" window) under torch.profiler, and the
UI pass alone timed with CUDA events.

    python -m renderer_tpu_torch.tools.frame_profile

Prints one JSON object: the CUDA-event time of the profiled frame and of
the next, unprofiled one; the summed device time of the profiled frame's
kernels and copies (device-side events only) and their count; the device
idle share (1 − busy / unprofiled frame); the ten PyTorch ops with the most
device time; the device time and share of the hand-written shading kernels
S1-S3 and the fused S3 (csrc/shade.cu), of K1/K2 and of the candidate
kernels C1-C3 (csrc/candidates.cu) and the front end's F1-F4
(csrc/frontend.cu); and the UI pass of the
frame's own DrawList, piece by piece (`ui_pass_ms`): its raster (bin + K2's
UI launch) and the fused S3 (shade and composite, the pipeline's call).
S2's entry gives `covered_share`, the covered elements (tid >= 0) over
the elements of the stacks the frame gave it, the share S2 shades (None
where the frame makes no S2 call).
The profiled frame's traffic comes with them (`traffic`: its host→device
uploads and bytes, device→host reads and bytes, and capacity grows and
shrinks, from profiling.COUNTERS; a steady frame grows and shrinks
nothing). Needs CUDA; without it, it exits with an error. `profile_frame`
profiles any renderer's frame the same way (chip_smoke.py phase 12 runs it
on scenes B and C, and `ui_pass_ms` on C).
"""

from __future__ import annotations

import json
import sys

import torch

import renderer_tpu_torch as trt
from renderer_tpu_torch.assets import demo_scenes
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.engine.stats import SPIN_CYCLES, card_line, held_stream
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.raster import ui_stage
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS
from renderer_tpu_torch.tools.shade_check import recorded_shading

W, H = 1920, 1080


def _event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _queued_ms(fn, reps: int = 5) -> float:
    """Device ms of fn() averaged over `reps` calls enqueued behind a spin
    kernel (engine.stats.held_stream): the device's time, not the host's
    launch gaps."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with held_stream(SPIN_CYCLES):
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


#: (namespace, function) of the hand-written kernels' device functions
KERNEL_NAMES = {"S1": ("rs", "shade_kernel"), "S2": ("rs", "alpha_kernel"),
                "S3": ("rs", "ui_kernel"), "S3C": ("rs", "ui_composite_kernel"),
                "K1": ("rt", "binned_kernel"), "K2": ("rt", "layer_kernel"),
                "C1": ("rc", "extract_kernel"), "C2": ("rc", "merge_kernel"),
                "C3": ("rc", "resolve_kernel"), "F1": ("rf", "setup_kernel"),
                "F2 spans": ("rf", "spans_kernel"), "F2 rows": ("rf", "rows_kernel"),
                "F3": ("rf", "pairs_kernel"), "F4 scan": ("rf", "scan_kernel"),
                "F4 scatter": ("rf", "scatter_kernel")}


def _is_kernel(key: str, ns: str, fn: str) -> bool:
    """Whether a profiler key names ns::fn, demangled or mangled."""
    return f"{ns}::{fn}" in key or f"{len(ns)}{ns}{len(fn)}{fn}" in key


def profile_frame(renderer, scene, ui=None) -> dict:
    """One render_frame_device call under torch.profiler: its CUDA-event ms,
    the summed device time of its kernels and copies (device-side events
    only) and their count, the ten PyTorch ops with the most device time,
    each hand-written kernel's device ms, launches and share of the busy
    time (S2's with its covered share), and the frame's traffic
    (profiling.TRAFFIC counters)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = {k: profiling.COUNTERS[k] for k in profiling.TRAFFIC}
    with recorded_shading(kinds=("S2",)) as s2_calls, \
            torch.profiler.profile(activities=acts) as prof:
        e0.record()
        renderer.render_frame_device(scene, 0, ui=ui)
        e1.record()
        torch.cuda.synchronize()
    traffic = {k: profiling.COUNTERS[k] - v for k, v in before.items()}
    # device-side events (kernels, copies) carry the device time once; a
    # PyTorch op's own entry repeats its kernels' time
    # the program's spans (record_function ranges, profiling.prefix()) are
    # left out: their device-side copies span kernels counted already
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and not e.key.startswith(profiling.prefix())]
    kernels = [e for e in rows if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted((e for e in rows if e.device_type != cuda),
                 key=lambda e: -e.self_device_time_total)[:10]
    own = {}
    for name, (ns, fn) in KERNEL_NAMES.items():
        hits = [e for e in kernels if _is_kernel(e.key, ns, fn)]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        own[name] = {"device_ms": ms, "launches": sum(e.count for e in hits),
                     "share": ms / busy_ms if busy_ms else 0.0}
    tids = [args[0] for _, args, _ in s2_calls]
    own["S2"]["covered_share"] = (sum(int((t >= 0).sum()) for t in tids)
                                  / sum(t.numel() for t in tids)) if tids else None
    return {
        "profiled_frame_ms": e0.elapsed_time(e1), "device_busy_ms": busy_ms,
        "kernels_and_copies": sum(e.count for e in kernels),
        "top_ops_device_ms": [[e.key, e.self_device_time_total / 1e3, e.count]
                              for e in top],
        "own_kernels": own,
        "traffic": traffic,
    }


def ui_pass_ms(renderer, dl) -> dict:
    """The UI pass of DrawList `dl` at `renderer`'s config (pixel centres,
    the HDR samples of its MSAA), each piece's ms (mean of 5, CUDA events):
    "raster" (bin + K2's UI launch; host-paced: queued behind the spin
    kernel it outlasted it on the card), and "fused" (the fused S3,
    ui_stage.shade_composite_ui, into copies of the samples; device ms
    queued behind a spin kernel)."""
    dev = renderer.device
    cfg = renderer.config
    ui = from_numpy_arrays(dl.pack(), device=dev)
    mats = renderer._materials()
    row0 = torch.zeros((cfg.padded_height, 1), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    hdr = [torch.rand((cfg.padded_height, cfg.padded_width, 3), device=dev, generator=gen)
           for _ in range(cfg.msaa_samples)]

    def raster():
        return ui_stage.rasterize_ui(ui, config=cfg, local_tiles_y=cfg.tiles_y,
                                     tile_row_offset=0,
                                     sample_positions=STANDARD_SAMPLE_POSITIONS[1])[0][0]

    lt = raster()
    work = [t.clone() for t in hdr]
    return {
        "raster": _event_ms(raster),
        "fused": _queued_ms(lambda: ui_stage.shade_composite_ui(
            work, lt, ui, mats, config=cfg, row0=row0)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    card = card_line()
    frames = demo_scenes.SandboxFrames()
    r = trt.Renderer(frames.registry, trt.RenderConfig(width=W, height=H, msaa_samples=4),
                     profiler=frames.profiler, overflow_policy="sync", device=dev)
    for _ in range(3):  # grow the capacities, build the kernels, warm up
        sc, dl = frames.next()
        r.render_frame_device(sc, 0, ui=dl)
    torch.cuda.synchronize()

    sc, dl = frames.next()
    prof = profile_frame(r, sc, dl)
    sc, dl = frames.next()
    frame_ms = _event_ms(lambda: r.render_frame_device(sc, 0, ui=dl), reps=1)
    prof["frame_ms"] = frame_ms
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / frame_ms

    ui_ms = ui_pass_ms(r, dl)
    cfg = r.config
    print(json.dumps({
        "card": card, **prof,
        "ui_triangles": int(dl.pack()["counts"][0]),
        "ui_pass_ms": ui_ms,
        "config": {"mask_layers": cfg.mask_layers, "blend_layers": cfg.blend_layers,
                   "ui_layers": cfg.ui_layers,
                   "msaa_shade_candidates": cfg.msaa_shade_candidates},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
