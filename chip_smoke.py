"""Smoke run of the PyTorch/CUDA port (renderer_tpu_torch) on one NVIDIA GPU.

Builds the hand-written CUDA kernels from renderer_tpu_torch/csrc, drives the
port's main path — Renderer.render_frame at 1920×1080 — on three scenes,
checks every kernel against its plain PyTorch version, checks the card's
frames against the golden images, and times frames and kernels with CUDA
events.

    python3 chip_smoke.py

Scenes:
- A: the >1M-triangle stress field (32 patches × 32768 triangles, opaque,
  1×MSAA, max_triangles 1<<21, pair and row capacity 1<<20);
- B: all three alpha classes at Sponza scale — 48 procedural patches of
  6272 triangles (301,056) in staggered walls, cycling textured-opaque,
  masked (a2c) and blended materials, 4×MSAA, rendered under
  overflow_policy="sync" so the bin capacities and layer counts grow to
  the scene's demand;
- C: the mini-sandbox (demo_scenes.MiniSandbox: the six-patch ring in all
  three alpha classes and the skinned character playing both animations)
  at 4×MSAA with the default exact sampler, under "sync", with the
  "Performance stats" window as its UI overlay. Every frame advances game
  time (the animation is evaluated and the character skinned anew) and
  rebuilds the window through UiContext from the renderer's own profiler
  spans, so K2 also runs its UI launch (launch counter "ui").

Phase 4 holds each kernel against its plain version on the scenes' own
bins (bit-equal): K1 on scene B (S=4) and scene A (S=1), K2 in both modes
on scene B at K=4 and at the layer counts the frame grew to, and K2's UI
launch on scene C's UI bins at S=1 (the frame's) and at S=4 (the bins and
sample positions of RenderConfig.ui_msaa). Its rows carry
the kernel's time (ten launches as the host issues them, see `cuda_ms`;
`ms_queued`: the same launches queued behind a spin kernel, see
`queued_ms`), the plain version's, the bound (see `bound`), the
launches a frame and `tests_kept`, the share of (pair, footprint) blocks
that the kernels' exact footprint rejection keeps, counted by its plain
version (raster_kernel.footprint_keep). Phase 5 renders the golden images
of tests/golden/goldens.npz and every key of tests/golden/sandbox-golden.npz
on the card.

Phase 7 ("assets") runs the asset path on the card: the BC7 decoder against
Pillow's decode stored in tests/golden/torch-bc7-vectors.npz (the card's
machine has no Pillow), the same mip chain written as an .ntex file and
decoded through ntex.decode_file, realize_atlas against build_atlas (on that
registry and on scenes A-C's), the loader fixture tests/fixtures/strided.gltf
loaded on the card and rendered against tests/golden/loader-fixture-golden.npz,
and the sandbox app's run_loop at 1920×1080, 4×MSAA with its HUD over a
scene source that queues the fixture with its animations playing. It times
the BC7 decode and realize_atlas on a synthetic registry of 24 BC7 textures
of 1024×1024 (full mip chains, random blocks of every mode), the fixture's
load, and run_loop's frames (its first frame, which uploads the atlas and
the geometry, apart from the later ones). These are smoke figures of a small
fixture, not the startup or frame rate of a real scene.

Phase 8 ("frames") runs the multi-frame path on the card: the sandbox
app's flythrough over the mini-sandbox without its UI (demo_scenes.MiniSandbox
as the scene source, the orbit camera, game time advancing 1/60 s a frame
so the character re-skins) at 1920×1080, 4×MSAA, overflow policy "sync",
K = FLY_FRAMES frames through Renderer.render_frames_device — one CUDA graph
of the frame, captured once and replayed once a frame. Each frame's image
and stats row must be bit-equal to render_frame_device of the same scene on
the same renderer (the eager path), with no overflow, and K1 and K2 in both
scene modes launched at least K times. It prints the graph's capture and
instantiation seconds, the median CUDA-event ms of a replayed frame against
the eager frame's (with the eager frame's host prologue and queueing time,
from the renderer's profiler spans), and the per-stage table of
engine.stats.device_stage_timings on scene B at both of its paces: device
time (each stage a captured graph, replays queued behind a spin kernel) and
host-paced (eager runs as the host issues them).

Phase 9 ("tools") runs the configuration matrix and the frame tools on the
card: apps.configs.run_all (rows 1, 7, 8 and 9; the rows that need the
sandbox assets or testbox.glb, absent from the repository, print their skip
line), every row's ms a frame, fps, pair and tile-row demand, with no
dropped work; K1 on row 8's own bins (the stress field under an 8000-layer
overdraw stack), bit-equal to its plain version, with its times, bound and
tests_kept; tools.frame_capture of the mini-sandbox at 1280×720, every dump
decoded back equal to the array written and the capture's direct K1 and K2
launches bit-equal to their plain versions; tools.binning_scaling at pair
capacities 1M-8M; tools.prologue_probe, and tools.startup_probe run twice as
a process of its own, cold (the kernels built into an empty directory) and
warm.

Phase 10 runs what the JAX package does beyond the frame: the host C++
library (tools/native.py, built with g++ in phase 2; the run fails if it
took the numpy path), the mini-sandbox's frame_view and queue_animated on
the library against their numpy plain versions at NATIVE_TIMES (the draw
stream bit-equal; the joint palettes within PALETTE_DRIFT, the reference's
own last-bit drift between its library and its numpy path) and
tools.prologue_probe on each; tools.make_ntex on a 1024×1024 PNG written by
the port's encoder, as sRGB and as linear, each decoded on the card and on
the CPU (bit-equal) with its PSNR held to tests/test_make_ntex.py's floor
and the encode's Mblocks/s on the host; and the mesh (parallel/mesh.py):
four ranks spawned on the one card over gloo with CUDA tensors, at
1920×1024, render scene A's stress field at sp=2 (contiguous and
interleaved) and the mini-sandbox at dp=2 × sp=2 (1×MSAA, game times
MESH_TIMES), each against the single-device pipeline.render_frame on the
same inputs: stats equal and every pixel equal (the vertex stage gives a
rank's slice of the vertex stream the whole stream's bits), each rank on
the host library. The ranks' K1/K2 launches go into the kernels line as
"10 mesh". Ranks sharing one card time nothing useful: the wall-clock is a
smoke figure.

Phase 11 runs the JPEG path, on a machine without Pillow: (a) every vector
of tests/golden/torch-jpeg-vectors.npz (Pillow's decodes, written by
`python -m tests.test_torch_jpeg regen`) decoded by assets/jpeg.py equal to
Pillow's pixels (arithmetic-coded and lossless files among them), or to
the SHA-256 of Pillow's decode for the two 512×512 4:2:0 images (baseline
and progressive), whose median host ms and Mpixel/s it prints; (b) a GLB
assembled here (jpeg_glb: GLB_PATCHES proxy patches, three materials —
opaque, alpha-to-coverage, blended — on the 512×512 baseline JPEG
embedded in its BIN chunk) loaded onto the card by load_gltf,
rendered at 1920×1080, 4×MSAA under "sync" with zero overflow (its K1/K2
launches go into the kernels line as "11 glb"), and again at GLB_SMALL on
the card and on the CPU, which must agree to the golden tolerance; (c)
tools.make_ntex's CLI on that JPEG and on a PNG of the port's decode of
it: the two .ntex files must be byte-equal, and the card's BC7 decode of
them equal to the CPU's; (d) a YCCK (Adobe transform 2), a 4:1:1, an
arithmetic-coded progressive (DAC, restarts) and a lossless JPEG of the
vectors file (tests/torch_jpeg_writer.py's, as Pillow cannot write them)
each embedded in that GLB and loaded by load_gltf onto the card, mip 0
equal to Pillow's stored decode.

Phase 12 ("shading") holds the deferred-shading kernels (csrc/shade.cu)
against their plain versions on the real frames: renderers for scenes A, B
and C are built afresh, and every call one 1920×1080 frame of each makes to
shade.shade_stack (S1), shade.alpha_stack (S2) and
ui_stage.shade_composite_ui (the fused S3: the UI shade and its composite
into the HDR samples, in place) — every candidate stack and strip, with its
own row0, and the fused S3's samples as it found them — is recorded and
run again through the kernel and through its plain version: ≤ 2^-12
absolute, ≥ 99.9% of values within 2^-18, NaN where the plain version has
NaN, cutoffs equal (the differing counts are printed). S3
(ui_stage.shade_ui_layer, which the pipeline no longer calls) runs on the
fused S3's layers. S3 and the fused S3 must be bit-equal (0 values
differing), on C and on C under RenderConfig.ui_msaa (checked, not
timed). Each (kernel, scene) gives one row of the kernels line for all of
that frame's calls of the kernel: ms as issued and queued, the plain
version's ms (its comparison run), a bound counted from the code
(shade_work: FP32 operations of the channels each sample uses and texel
taps of the pixels each kernel shades at 67 TFLOP/s — for the fused S3
its live elements alone —, each input and output byte of the frame's calls
once at 3.35 TB/s — for the fused S3 the HDR samples read once and written
where their bits change), and the kernel's
registers, spills, local and shared bytes and the blocks an SM that the
host computed for its launches (kernel_resources). The candidate kernels
C1-C3 (csrc/candidates.cu: candidates.extract_candidates, masked_merge,
resolve) get the same on each scene: every call of the frame recorded
(tools/candidate_check, the tensors C2 and C3 update in place copied as
the call found them), run again through the kernel and the plain version
(0 values may differ in bits; NaN where NaN), and one row a kernel with
ms issued and queued, plain ms, a bound from the bytes the calls' data
needs (candidate_work) and the registers, stack, spills and static
shared bytes of the instantiations they ran (for C2 also its launch:
tile pixels, the dynamic shared bytes of its ring of staged slot ids,
blocks an SM, grid; kernels.merge_info). The front end's kernels F1-F4
(csrc/frontend.cu: setup.triangle_setup, and binning.bin_triangle_classes
with its two cumsums and stable sort between the kernels) get the same:
every setup and binning call of the frame (C's UI pass adds one of each)
recorded (tools/frontend_probe), run again through the kernels and the
plain versions (0 values may differ in bits, NaN included), each step
timed queued behind a spin (frontend_probe.step_ms) beside its bound
(frontend_probe.frontend_work), the launch floor printed on a line of its
own (frontend_probe.launch_floor_ms: an empty kernel timed as a step, with
one block, F2 spans' grid, a thread a triangle, a thread a binned column,
F1's grid and F4 scatter's grid), each kernel's time over its floor
(frontend_probe.OVER_FLOOR), the whole call timed as issued;
one row a
kernel with the frame's calls summed, the plain version's ms that of the
whole function. It times scene C's UI
pass piece by piece (tools.frame_profile.ui_pass_ms: its raster and the
fused S3), then replays frames A, B and C
as CUDA graphs (engine.stats.fused_frame_ms; the multi-frame path has no UI
pass) beside phase 6's eager frames, and profiles one eager frame of B and
C with torch.profiler (tools.frame_profile.profile_frame): kernel count
and device-busy ms beside those of the candidate loops as torch ops
(TORCH_LOOPS_PROFILE), top ops, the device
share of S1-S3, the fused S3, K1/K2 and C1-C3, and the frame's traffic
(uploads, reads, capacity changes).

Phase 13 ("bench") runs the port's bench (tools/bench.run, in this
process) at 1920×1080: the default scene (here the triangle: the Sponza
assets are not in the repository) over BENCH_FRAMES["default"] frames,
the mini-sandbox with its "Performance stats" window over
BENCH_FRAMES["mini-sandbox"], and the patch wall (scene B) replayed as a
CUDA graph over BENCH_FRAMES["patch-wall"]. Each JSON line is printed
beside the card's name and power limit; the phase fails on a drop,
on overflow_checked false or on a missing key. The mini-sandbox's last
timed frame must be bit-equal to Renderer.render_frame of its scene and
DrawList, and each replayed frame to render_frame_device of its scene
(phase 8's rule). Its launches go into the kernels line as "13 bench",
and every kernel of the main path (S3 alone is off it) must have
launched there. It prints the bench's eager mini-sandbox frame_ms beside
phase 6's eager frame C. It runs after phase 11 and before phase 12:
after phase 12's torch.profiler window the process's eager frames issue
more slowly on the host (on an NVIDIA H100 80GB HBM3 at 700 W: frame C
86.5 → 101.9 ms, the bench's mini-sandbox frame_ms 92.3 → 167.2 ms),
which the bench would measure.

Each phase prints one line; any failure raises (exit code ≠ 0). The line
before the last is a JSON object with one entry per kernel (with its
launches in each phase); the last line is {"ok": true, "device": {...}}.
Without CUDA the script fails before printing either.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

import renderer_tpu_torch as trt
from renderer_tpu_torch import kernels
from renderer_tpu_torch.apps import configs
from renderer_tpu_torch.apps.sandbox import flythrough, run_loop
from renderer_tpu_torch.assets import demo_scenes, jpeg, ntex, png, proxy
from renderer_tpu_torch.assets.gltf_loader import load_gltf, ntex_texture
from renderer_tpu_torch.core import math3d
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.engine import stats as engine_stats
from renderer_tpu_torch.engine.profiling import Profiler
from renderer_tpu_torch.engine.stats import card_line
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.materials import atlas_device, bc7
from renderer_tpu_torch.materials.atlas import build_atlas
from renderer_tpu_torch.raster import (
    binning,
    candidates,
    layers,
    pipeline,
    raster_kernel,
    setup,
    shade,
    ui_stage,
    vertex_stage,
)
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS, STAT_NAMES
from renderer_tpu_torch.scene import draw_stream
from renderer_tpu_torch.tools import (
    binning_scaling,
    candidate_check,
    frame_capture,
    frame_profile,
    frontend_probe,
    make_ntex,
    native,
    prologue_probe,
)
from renderer_tpu_torch.tools.shade_check import compare, recorded_shading, run_shading

W, H = 1920, 1080
# phase 6's timed frames a scene (B and C, ~7-8 s a frame, are cut to 6 to
# keep the script near half its time limit)
FRAMES = {"A": 20, "B": 6, "C": 6}
GOLDEN = "tests/golden/goldens.npz"
SANDBOX_GOLDEN = "tests/golden/sandbox-golden.npz"
BC7_VECTORS = "tests/golden/torch-bc7-vectors.npz"
CHAIN_W, CHAIN_H, CHAIN_MIPS = 37, 29, 5  # the vectors' mip chain
FIXTURE = Path("tests/fixtures/strided.gltf")
FIXTURE_GOLDEN = "tests/golden/loader-fixture-golden.npz"
RUN_LOOP_FRAMES = 4
FLY_FRAMES = 4  # phase 8's batch
STAGE_ITERS = 3  # phase 8's runs a stage (and replays of the fused frame)
# Renderer._dispatch's spans before the frame is queued: the host prologue
HOST_PROLOGUE = ("prologue.draws", "prologue.geometry", "prologue.blob", "prologue.materials")
TIMED_TEXTURES, TIMED_SIDE = 24, 1024  # the registry that times the decode
BYTES_PER_S = 3.35e12  # H100 SXM HBM3 data sheet
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's 1.98 GHz boost clock
OVERFLOW_STATS = ("overflow_opaque", "overflow_masked", "overflow_blended",
                  "overflow_ui", "row_overflow")
CONFIG_FRAMES = 3  # phase 9's run_all frames (rows 7-9 time 3, 2 and 3)
CONFIG_ROWS = ("triangle-800x600-flat", "stress-1M-tris-1080p",
               "stress-4Mpairs-1080p", "morph-sheet-480p-normals")
# the demand the JAX package's apps/configs.py comments give for rows 7 and 8
# (apps/configs.py:158-160,189-193): (pairs, tile-rows)
JAX_DEMAND = {"stress-1M-tris-1080p": (607_000, 604_000),
              "stress-4Mpairs-1080p": (1_750_000, 759_000)}
CAPTURE_W, CAPTURE_H = 1280, 720
BINNING_REPS = 5
MESH_W, MESH_H = 1920, 1024  # the JAX package's multichip shape (32 tile rows)
MESH_TIMES = (0.4, 1.0)  # the mini-sandbox's dp=2 batch
NATIVE_TIMES = (0.4, 1.0, 1.02, 1.5)
# the joint palettes' last-bit drift between the library and the numpy
# path: one f32 ULP at the palettes' magnitude (< 2), as in the JAX package
PALETTE_DRIFT = 2.0 ** -22
NTEX_SIDE = 1024
PSNR_FLOOR = 28.0  # tests/test_make_ntex.py's
JPEG_VECTORS = "tests/golden/torch-jpeg-vectors.npz"
JPEG_BIG = ("big-baseline-420", "big-progressive-420")  # the 512×512 vectors
JPEG_REPS = 3  # decodes timed a large vector (the median is printed)
GLB_PATCHES, GLB_GRID = 12, 24  # phase 11's GLB: patches of 2·24² triangles
GLB_SMALL = (160, 96)  # its card-against-CPU frame
REPLAYS = 4  # phase 12's graph replays a scene
FLOPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores (data sheet)
# pipeline.launch_counts' keys → this script's counter names
PIPELINE_KEYS = {"k1": "k1", "masked": "k2_masked", "blended": "k2_blended",
                 "ui": "k2_ui", "shade": "s1", "alpha": "s2", "ui_shade": "s3",
                 "ui_composite": "s3c", "cand_extract": "c1", "cand_merge": "c2",
                 "cand_resolve": "c3", "setup": "f1", "bin_spans": "f2_spans",
                 "bin_rows": "f2_rows", "bin_pairs": "f3", "bin_scan": "f4_scan",
                 "bin_scatter": "f4_scatter"}
# the shading kernels: (entry point, what it replaces in the JAX package)
SHADE_KERNELS = {
    "s1": ("S1 shade_stack", "renderer_tpu/raster/shade.py:329"),
    "s2": ("S2 alpha_stack", "renderer_tpu/raster/shade.py:312"),
    "s3": ("S3 shade_ui_layer", "renderer_tpu/raster/ui_stage.py:89"),
    "s3c": ("S3 fused shade_composite_ui (UI shade + composite)",
            "renderer_tpu/raster/ui_stage.py:89"),
}
# phase 11's JPEG layouts that Pillow reads but does not write, decoded
# through load_gltf (the vectors file's "written-*" entries)
JPEG_LAYOUTS = ("written-ycck", "written-411", "arith-420-progressive-dac-restart",
                "lossless-rgb-p4-pt2-restart23")
# phase 13's bench runs: frames a pass (3 passes) of each scene
BENCH_FRAMES = {"default": 30, "mini-sandbox": 30, "patch-wall": 8}
# the main path's kernels (S3 alone, shade_ui_layer, is off it)
MAIN_PATH_KERNELS = ("k1", "k2_masked", "k2_blended", "k2_ui", "s1", "s2", "s3c",
                     "c1", "c2", "c3", "f1", "f2_spans", "f2_rows", "f3", "f4_scan",
                     "f4_scatter")
FRONTEND = ("f1", "f2_spans", "f2_rows", "f3", "f4_scan", "f4_scatter")
# the candidate kernels: (entry point, what it replaces in the JAX package,
# the device function's name in csrc/candidates.cu)
CANDIDATE_KERNELS = {
    "c1": ("C1 extract_candidates", "renderer_tpu/raster/pipeline.py:118", "extract_kernel"),
    "c2": ("C2 masked_merge", "renderer_tpu/raster/pipeline.py:407-439", "merge_kernel"),
    "c3": ("C3 resolve (solid select + blended composite)",
           "renderer_tpu/raster/pipeline.py:452-490", "resolve_kernel"),
}
# the front end's kernels, by step of tools/frontend_probe: (counter, what
# it replaces in the JAX package, XLA-fused there, no Pallas kernel)
FRONTEND_KERNELS = {
    "F1 setup": ("f1", "renderer_tpu/raster/setup.py:57 (XLA-fused; no Pallas)"),
    "F2 spans": ("f2_spans", "renderer_tpu/raster/binning.py:66 (XLA-fused; no Pallas)"),
    "F2 rows": ("f2_rows", "renderer_tpu/raster/binning.py:234-278 (XLA-fused; no Pallas)"),
    "F3 pairs": ("f3", "renderer_tpu/raster/binning.py:279-343,352-354 "
                       "(XLA-fused; no Pallas)"),
    "F4 scan": ("f4_scan", "renderer_tpu/raster/binning.py:356-362,387-394 "
                           "(XLA-fused; no Pallas)"),
    "F4 scatter": ("f4_scatter", "renderer_tpu/raster/binning.py:344,364-380 "
                                 "(XLA-fused; no Pallas)"),
}
# the profiled eager frames B and C when the candidate loops ran as torch
# ops, before kernels C1-C3 (this script's phase 12 on an NVIDIA H100 80GB
# HBM3 at 700 W): kernels and copies, device-busy ms
TORCH_LOOPS_PROFILE = {"B": (9065, 52.50), "C": (9649, 50.66)}


def scene_a():
    registry, scene = demo_scenes.stress_scene()
    cfg = trt.RenderConfig(width=W, height=H, max_triangles=1 << 21,
                           pair_capacity=1 << 20, row_capacity=1 << 20)
    return registry, scene, cfg, "off"


def scene_b():
    registry, scene = demo_scenes.patch_wall_scene()
    cfg = trt.RenderConfig(width=W, height=H, msaa_samples=4)
    return registry, scene, cfg, "sync"


def scene_c():
    frames = demo_scenes.SandboxFrames()
    cfg = trt.RenderConfig(width=W, height=H, msaa_samples=4)
    return frames, cfg, "sync"


def counters():
    return {PIPELINE_KEYS[k]: v for k, v in pipeline.launch_counts().items()}


def reset_counters():
    pipeline.add_launches({k: -v for k, v in pipeline.launch_counts().items()})


def render_checked(renderer, scene, name, ui=None):
    before = counters()
    img = renderer.render_frame(scene, 0, ui=ui)
    stats = renderer.frame_stats()
    after = counters()
    moved = {k: after[k] - before[k] for k in after}
    bad = {k: stats[k] for k in OVERFLOW_STATS if stats[k]}
    if bad:
        raise RuntimeError(f"scene {name}: overflow stats {bad}")
    if img.shape != (H, W, 3) or img.dtype != np.uint8 or img.std() < 5.0:
        raise RuntimeError(f"scene {name}: bad image {img.shape} {img.dtype} "
                           f"std {img.std():.2f}")
    return img, stats, moved


def scene_bins(renderer, scene, name):
    """The bins the renderer's frame feeds the kernels (same stages and
    config as pipeline.render_shard phase 2)."""
    cfg = renderer.config
    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    frame = draw_stream.unpack_frame(
        renderer._frame_arrays(scene, fv, gs), morph_k=gs.morph_k,
        joint_cap=renderer._joint_cap(scene))
    vs = vertex_stage.run_vertex_stage(geom, frame, gs.skin_start, morph_k=gs.morph_k)
    td = setup.triangle_setup(vs["clip"], geom["tri_v"], frame["num_tris"],
                              cfg.width, cfg.height,
                              bbox_pad=0.5 if cfg.msaa_samples > 1 else 0.0)
    n_o, n_m = gs.num_opaque_tris, gs.num_masked_tris
    b, s, c, ov, row_ov, _, _ = binning.bin_triangle_classes(
        td, (0, n_o, n_o + n_m, gs.num_tris), tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y, tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        pair_capacity=cfg.pair_capacity, row_capacity=cfg.row_capacity,
        zbuckets=cfg.opaque_z_buckets)
    if int(ov.sum()) or int(row_ov):
        raise RuntimeError(f"scene {name} bins overflowed")
    return b, s, c


def footprint(n_s: int, n_layers: int | None = None):
    """(footprint columns, samples a block) of the kernel instantiation that
    serves n_s samples (K1) or n_s samples and n_layers layers (K2): the
    dispatch in csrc/raster_kernel.cu and csrc/layers.cu. A footprint is
    8P columns x 4 rows, P pixels a thread."""
    if n_layers is None:
        return 8, n_s
    kc = 1 << (n_layers - 1).bit_length()
    tests = 8 if kc <= 2 else (4 if kc <= 8 else 2)
    ts = min(n_s, tests)
    return 8 * min(4, max(1, tests // ts)), ts


def bound(pairs: int, n_s: int, cfg, n_bytes: int, keep):
    """(bound_ms, bound_by, dense_ms) of one launch, at 67 TFLOP/s FP32 and
    3.35 TB/s (H100 SXM data sheet). A (pair, sample) test is 20 FP32
    operations (five planes of 2 multiplies and 2 adds, no FMA). bound_ms
    counts what these inputs need: the tests of the (pair, footprint)
    blocks the rejection keeps plus its corner tests (four planes a block),
    against the bytes moved; dense_ms, every pair tested at every sample of
    its tile."""
    dense = pairs * cfg.tile_h * cfg.tile_w * n_s
    kept = float(keep.float().mean()) if keep.numel() else 0.0
    ops = dense * kept * 20 + keep.numel() * 16
    ops_ms, bytes_ms = ops / 67e12 * 1e3, n_bytes / 3.35e12 * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, dense * 20 / 67e12 * 1e3


def kernel_row(name, source, replaces, counter, main_launches, run, plain,
               keep, pairs, n_s, cfg, n_bytes, scene):
    """One entry of the kernels line: `run` launches the kernel and `plain`
    runs its plain version on the same inputs; `keep` is footprint_keep of
    the kernel's bins and footprint; `counter` names its launch count."""
    bound_ms, bound_by, dense_ms = bound(pairs, n_s, cfg, n_bytes, keep)
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=main_launches[counter], max_abs_err=max_abs_err(run(), plain()),
        ms=cuda_ms(run, 10), ms_queued=queued_ms(run, 10),
        plain_ms=cuda_ms(plain, 1), bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, launches_per_frame=None,
        tests_kept=float(keep.float().mean()) if keep.numel() else 0.0,
        scene=scene, counter=counter, pairs=pairs, n_s=n_s, dense_ms=dense_ms)


def scene_rows(scene, renderer, sc, layer_counts, main_launches):
    """Phase-4 rows on one scene's bins: K1 at the scene's sample count,
    then K2 in each mode at each of layer_counts[mode] over K1's depth."""
    cfg = renderer.config
    b, s, c = scene_bins(renderer, sc, scene)
    spos = STANDARD_SAMPLE_POSITIONS[cfg.msaa_samples]
    n_s, px = len(spos), cfg.padded_height * cfg.padded_width
    kw = dict(padded_height=cfg.padded_height, padded_width=cfg.padded_width,
              tile_h=cfg.tile_h, tile_w=cfg.tile_w, sample_positions=spos)
    pairs = [int(n.sum()) for n in c]

    def keep(cls, zfloor, fp):
        return raster_kernel.footprint_keep(
            b, s[cls], c[cls], zfloor, fp_w=fp[0], fp_h=4,
            samples_per_block=fp[1], **kw)

    floor = raster_kernel.rasterize_binned(b, s[0], c[0], **kw)[0]
    rows = [kernel_row(
        f"K1 rasterize_binned (opaque visibility, scene {scene}, S={n_s})",
        "renderer_tpu_torch/csrc/raster_kernel.cu",
        "renderer_tpu/raster/raster_kernel.py:300", "k1", main_launches,
        lambda: raster_kernel.rasterize_binned(b, s[0], c[0], **kw),
        lambda: raster_kernel.rasterize_binned_plain(b, s[0], c[0], **kw),
        keep(0, None, footprint(n_s)), pairs[0], n_s, cfg,
        pairs[0] * binning.B_ROWS * 4 + n_s * px * 8, scene)]
    for cls, mode in ((1, "masked"), (2, "blended")):
        for k in layer_counts[mode]:
            lkw = dict(kw, mode=mode, n_layers=k)
            rows.append(kernel_row(
                f"K2 rasterize_layers ({mode}, scene {scene}, S={n_s}, K={k})",
                "renderer_tpu_torch/csrc/layers.cu",
                "renderer_tpu/raster/layers.py:228", f"k2_{mode}", main_launches,
                lambda: layers.rasterize_layers(b, s[cls], c[cls], floor, **lkw),
                lambda: layers.rasterize_layers_plain(b, s[cls], c[cls], floor, **lkw),
                keep(cls, floor, footprint(n_s, k)), pairs[cls], n_s, cfg,
                pairs[cls] * binning.B_ROWS * 4 + n_s * px * (8 + 8 * k), scene))
    return rows


def ui_rows(renderer, dl, main_launches):
    """Phase-4 rows of K2's UI launch on scene C's UI (DrawList `dl`) over
    the UI pass's zero floor: S=1 (pixel centers, the frame's launch) and
    S=4 (RenderConfig.ui_msaa's bins and sample positions), both at the
    frame's ui_layers."""
    cfg = renderer.config
    ui = from_numpy_arrays(dl.pack(), device=renderer.device)
    k = cfg.ui_layers
    px = cfg.padded_height * cfg.padded_width
    rows = []
    for spos in (STANDARD_SAMPLE_POSITIONS[1], STANDARD_SAMPLE_POSITIONS[4]):
        n_s = len(spos)
        b, s, c, ov = ui_stage.bin_ui(ui, config=cfg, local_tiles_y=cfg.tiles_y,
                                      tile_row_offset=0, n_samples=n_s)
        if int(ov):
            raise RuntimeError("scene C UI bins overflowed")
        floor = torch.zeros((n_s, cfg.padded_height, cfg.padded_width),
                            dtype=torch.float32, device=b.device)
        kw = dict(padded_height=cfg.padded_height, padded_width=cfg.padded_width,
                  tile_h=cfg.tile_h, tile_w=cfg.tile_w, sample_positions=spos)
        lkw = dict(kw, mode="blended", n_layers=k)
        fp = footprint(n_s, k)
        keep = raster_kernel.footprint_keep(b, s, c, floor, fp_w=fp[0], fp_h=4,
                                            samples_per_block=fp[1], **kw)
        pairs = int(c.sum())
        rows.append(kernel_row(
            f"K2 rasterize_layers (blended, UI pass, scene C, S={n_s}, K={k})",
            "renderer_tpu_torch/csrc/layers.cu",
            "renderer_tpu/raster/layers.py:228", "k2_ui", main_launches,
            lambda: layers.rasterize_layers(b, s, c, floor, launch_key="ui", **lkw),
            lambda: layers.rasterize_layers_plain(b, s, c, floor, **lkw),
            keep, pairs, n_s, cfg, pairs * binning.B_ROWS * 4 + n_s * px * (8 + 8 * k),
            "C"))
    return rows


def golden_checks(dev):
    """Phase 5: the golden images on the card at 160×96 — goldens.npz's
    triangle-msaa4 and alpha-layers, and every key of sandbox-golden.npz
    (the mini-sandbox at game time 0.4 s with its HUD or its "Performance
    stats" window), plus the bound on the default vs fast_sampler() drift."""
    goldens = np.load(GOLDEN)
    reg_t, sc_t = demo_scenes.triangle_scene()
    reg_l, sc_l = demo_scenes.alpha_layers_scene()
    cases = {
        "triangle-msaa4": (trt.Renderer(reg_t, trt.RenderConfig(
            width=160, height=96, msaa_samples=4), device=dev), sc_t, 3),
        "alpha-layers": (trt.Renderer(reg_l, trt.RenderConfig(
            width=160, height=96), device=dev), sc_l, 1),
    }
    for key, (r, sc, mode) in cases.items():
        check_golden(key, r.render_frame(sc, mode), goldens[key])

    sandbox_goldens = np.load(SANDBOX_GOLDEN)
    images = {}
    for key, msaa, fast, kind in (
            ("mini-sandbox-msaa4", 4, False, "hud"),
            ("mini-sandbox-perfwin", 4, False, "perfwin"),
            ("mini-sandbox-fast-msaa4", 4, True, "hud"),
            ("mini-sandbox-exact", 1, False, "hud"),
            (None, 1, True, "hud")):
        sandbox = demo_scenes.mini_sandbox_scene(0.4)
        ui = demo_scenes.mini_sandbox_ui(sandbox.registry, kind)
        cfg = trt.RenderConfig(width=160, height=96, msaa_samples=msaa)
        r = trt.Renderer(sandbox.registry, cfg.fast_sampler() if fast else cfg,
                         device=dev)
        img = r.render_frame(sandbox.scene, 0, ui=ui)
        stats = r.frame_stats()
        bad = {k: stats[k] for k in OVERFLOW_STATS if stats[k]}
        if bad:
            raise RuntimeError(f"golden {key}: overflow stats {bad}")
        if key is not None:
            check_golden(key, img, sandbox_goldens[key])
        images[key] = img
    drift = float(np.abs(images["mini-sandbox-exact"].astype(int)
                         - images[None].astype(int)).mean())
    if drift >= 8.0:
        raise RuntimeError(f"default vs fast sampler mean drift {drift:.2f}")
    print(f"golden: default vs fast sampler mean drift {drift:.3f} (< 8)", flush=True)


def check_golden(key, img, expected):
    diff = np.abs(img.astype(int) - expected.astype(int)).max(axis=-1)
    bad = float((diff > 2).mean())
    if bad >= 0.005:
        raise RuntimeError(f"golden {key}: {bad:.2%} of pixels drifted")
    print(f"golden: {key} drifted px {bad:.4%} (max diff {diff.max()})", flush=True)


def write_ntex(path: Path, w: int, h: int, vk_format: int, mips) -> Path:
    """An .ntex container: the 1024-byte header, then the packed BC7 mips."""
    header = bytearray(1024)
    header[:len(ntex.MAGIC)] = ntex.MAGIC
    struct.pack_into("<8I", header, 992, w, h, 1, len(mips), vk_format, 4, 4, 16)
    path.write_bytes(bytes(header) + b"".join(np.ascontiguousarray(m).tobytes()
                                              for m in mips))
    return path


def random_bc7_blocks(rng, n: int) -> np.ndarray:
    """n random BC7 blocks of random modes 0-7 (any bits after the prefix)."""
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    mode = rng.integers(0, 8, n)
    blocks[:, 0] = ((1 << mode) | (blocks[:, 0].astype(np.int64) << (mode + 1))) & 0xFF
    return blocks


def bc7_texture(mips_blocks, h: int, w: int, kind: str, wrap, name: str):
    """A lazy texture of in-memory BC7 mips (down to 1×1): the blocks feed
    the device plan, and build_atlas decodes them on the CPU."""
    shapes = [(max(h >> m, 1), max(w >> m, 1)) for m in range(len(mips_blocks))]

    def load():
        return [bc7.blocks_to_image(bc7.decode_blocks(b, device="cpu"), mw, mh).numpy()
                for b, (mh, mw) in zip(mips_blocks, shapes)]

    return trt.Texture(None, kind, name, loader=load, shape=(h, w),
                       fingerprint=f"chip-smoke:{name}", wrap_s=wrap[0],
                       wrap_t=wrap[1], blocks_loader=lambda: mips_blocks)


def check_device_atlas(name, registry, dev) -> bool:
    """realize_atlas on the card equals build_atlas's data bit for bit;
    returns whether the renderer's rule (the plan ships fewer bytes than
    the decoded atlas) takes the device path for this registry."""
    plan = atlas_device.build_atlas_plan(registry)
    got = atlas_device.realize_atlas(plan, dev).cpu().numpy().view(np.uint32)
    want = build_atlas(registry).data
    if got.shape != want.shape or not np.array_equal(got, want):
        raise RuntimeError(f"assets: device atlas of {name} differs from build_atlas")
    return plan.upload_bytes < plan.shape[0] * plan.shape[1] * 4


class FixtureSource:
    """run_loop's scene source: the loader fixture with every animation
    playing at the loop's game time, queued four times at half size in a
    ring of radius 0.6 around the orbit's centre, each copy facing out, so
    the orbiting camera sees one copy's front faces from every side."""

    def __init__(self, registry, gltf):
        self.registry, self.gltf = registry, gltf
        half = math3d.trs(scale=np.full(3, 0.5, np.float32))
        out = math3d.trs(translation=np.array([0.0, 1.0, 0.6], np.float32))
        self.ring = [math3d.trs(rotation=math3d.quat_from_axis_angle(
            [0, 1, 0], k * np.pi / 2)) @ out @ half for k in range(4)]

    def build_scene(self, game_time: float, scene=None):
        if scene is None:
            scene = trt.Scene(world_space=trt.GLTF)
        else:
            scene.clear()
        playing = [(game_time % a.end_time, a) for a in self.gltf.animations]
        for transform in self.ring:
            self.gltf.queue_animated(scene, transform, playing)
        return scene


def load_fixture(dev):
    registry, builder = trt.MaterialRegistry(), trt.VertexLibraryBuilder()
    t0 = time.perf_counter()
    gltf = load_gltf(FIXTURE, builder, registry, device=dev)
    builder.build()
    return registry, gltf, (time.perf_counter() - t0) * 1e3


def asset_checks(dev, registries, card) -> dict:
    """Phase 7: the asset path on the card (module docstring). Returns the
    numbers of the assets line."""
    z = np.load(BC7_VECTORS)
    got = bc7.decode_blocks(z["blocks"], device=dev).cpu().numpy().view(np.uint32)
    if not np.array_equal(got, z["texels"]):
        raise RuntimeError(f"assets: BC7 decode differs from Pillow's on "
                           f"{int((got != z['texels']).any(axis=1).sum())} blocks")
    shapes = [(CHAIN_H >> m, CHAIN_W >> m) for m in range(CHAIN_MIPS)]
    chain = [z[f"chain{i}_blocks"] for i in range(CHAIN_MIPS)]
    for i, (mh, mw) in enumerate(shapes):
        img = bc7.blocks_to_image(bc7.decode_blocks(chain[i], device=dev), mw, mh)
        if not np.array_equal(img.cpu().numpy(), z[f"chain{i}_rgba"]):
            raise RuntimeError(f"assets: BC7 chain mip {i} differs from Pillow's")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.environ["RENDERER_TPU_CACHE"] = str(tmp / "cache")
        try:
            out = _asset_checks_in(tmp, dev, z, chain, shapes, registries)
        finally:
            del os.environ["RENDERER_TPU_CACHE"]
    print(f"assets: BC7 {out['bc7_blocks']} blocks at {out['bc7_mblocks_per_s']:.1f} "
          f"Mblocks/s ({out['bc7_ms']:.3f} ms, {out['bc7_share_of_bound']:.4%} of its "
          f"bytes bound {out['bc7_bound_ms']:.4f} ms) | realize_atlas "
          f"{out['realize_atlas_ms']:.2f} ms ({out['realize_atlas_shape']} atlas) | "
          f"fixture load {out['fixture_load_ms']:.2f} ms | run_loop render_fps "
          f"{out['render_fps']:.4f} p99 {out['p99_ms']:.1f} ms, first frame "
          f"{out['run_loop_first_frame_ms']:.1f} ms, later frames "
          f"{[round(t, 1) for t in out['run_loop_later_frames_ms']]} ms | {card}",
          flush=True)
    return out


def _asset_checks_in(tmp: Path, dev, z, chain, shapes, registries) -> dict:
    # the chain as an .ntex file, decoded on the card through the disk cache
    path = write_ntex(tmp / "chain.ntex", CHAIN_W, CHAIN_H, ntex.VK_FORMAT_BC7_SRGB, chain)
    for attempt in ("cold", "warm"):
        header, mips = ntex.decode_file(path, device=dev)
        if header.mip_levels != CHAIN_MIPS or not all(
                np.array_equal(m, z[f"chain{i}_rgba"]) for i, m in enumerate(mips)):
            raise RuntimeError(f"assets: ntex.decode_file ({attempt}) differs from Pillow's")

    # realize_atlas against build_atlas: on the chain's registry (with
    # wrap modes, a normal map and a raw texture) and on scenes A-C's
    rng = np.random.default_rng(7)
    reg = trt.MaterialRegistry()
    reg.register_texture(ntex_texture(path, trt.TextureKind.SRGB_COLOR, device="cpu"))
    picks = z["blocks"][rng.permutation(len(z["blocks"]))]
    reg.register_texture(bc7_texture(
        [picks[:64], picks[64:80], picks[80:84], picks[84:86], picks[86:87],
         picks[87:88], picks[88:89]], 16, 64, trt.TextureKind.LINEAR_COLOR, (1, 2), "b"))
    reg.register_texture(bc7_texture([picks[89:90], picks[90:91], picks[91:92]], 4, 4,
                                     trt.TextureKind.NORMAL_MAP, (2, 0), "c"))
    raw = [rng.integers(0, 256, (24, 24, 4), dtype=np.uint8)]
    while raw[-1].shape[0] > 1:
        raw.append(np.ascontiguousarray(raw[-1][::2, ::2]))
    reg.register_texture(trt.Texture(raw, trt.TextureKind.SRGB_COLOR, "raw", wrap_s=1))
    paths = {"chain": check_device_atlas("the chain registry", reg, dev)}
    for name, r in registries.items():
        paths[name] = check_device_atlas(f"scene {name}", r, dev)

    # times on a registry of 24 BC7 textures of 1024×1024 with full chains
    big = trt.MaterialRegistry()
    side = TIMED_SIDE
    for t in range(TIMED_TEXTURES):
        mips = [random_bc7_blocks(rng, max(1, (side >> m) // 4) ** 2)
                for m in range(side.bit_length())]
        big.register_texture(bc7_texture(mips, side, side, trt.TextureKind.SRGB_COLOR,
                                         (0, 0), f"big{t}"))
    plan = atlas_device.build_atlas_plan(big)
    realize_ms = cuda_ms(lambda: atlas_device.realize_atlas(plan, dev), 3)
    words = bc7.words_from_bytes(plan.blocks.view(np.uint8).reshape(-1, 16), dev)
    n = words.shape[0]
    bc7_ms = cuda_ms(lambda: bc7.decode_words(words), 3)
    bound_ms = n * (16 + 64) / BYTES_PER_S * 1e3
    del words

    # the fixture: loaded on the card, its golden frame, then run_loop
    loads = [load_fixture(dev) for _ in range(3)]
    registry, gltf, _ = loads[-1]
    scene = trt.Scene(world_space=trt.GLTF)
    scene.camera.position, scene.camera.orientation = math3d.look_at(
        np.array([0.3, 1.2, 4.0], np.float32), np.array([0.3, 0.5, 0.0], np.float32),
        np.array([0.0, 1.0, 0.0], np.float32))
    gltf.queue_animated(scene, math3d.IDENTITY,
                        [(0.7 % a.end_time, a) for a in gltf.animations])
    r = trt.Renderer(registry, trt.RenderConfig(width=160, height=96, msaa_samples=4),
                     device=dev)
    reset_counters()
    img = r.render_frame(scene, 0)
    moved = counters()
    stats = r.frame_stats()
    bad = {k: stats[k] for k in OVERFLOW_STATS if stats[k]}
    if bad or moved["k1"] < 1 or moved["k2_masked"] < 1:
        raise RuntimeError(f"assets: fixture frame overflow {bad}, launches {moved}")
    check_golden("loader-fixture", img, np.load(FIXTURE_GOLDEN)["loader-fixture"])

    registry, gltf, _ = load_fixture(dev)
    reset_counters()
    loop = run_loop(frames=RUN_LOOP_FRAMES, width=W, height=H, msaa=4, show_hud=True,
                    sandbox=FixtureSource(registry, gltf), device=dev)
    torch.cuda.synchronize()
    loop_launches = counters()
    fs = loop["frame_stats"]
    bad = {k: fs[k] for k in OVERFLOW_STATS if fs[k]}
    missing = [k for k in ("k1", "k2_masked", "k2_ui", "s1", "s2", "s3c")
               if loop_launches[k] < 1]
    if bad or missing or fs["masked_demand_max"] < 1:
        raise RuntimeError(f"assets: run_loop overflow {bad}, not launched {missing}, "
                           f"masked demand {fs['masked_demand_max']}")
    if loop["image"].shape != (H, W, 3) or loop["image"].std() < 1.0:
        raise RuntimeError(f"assets: run_loop image {loop['image'].shape} "
                           f"std {loop['image'].std():.2f}")
    frame_ms = loop["frame_ms"]
    return {
        "bc7_blocks": n, "bc7_ms": bc7_ms, "bc7_mblocks_per_s": n / bc7_ms / 1e3,
        "bc7_bound_ms": bound_ms, "bc7_share_of_bound": bound_ms / bc7_ms,
        "realize_atlas_ms": realize_ms, "realize_atlas_shape": list(plan.shape),
        "realize_atlas_upload_bytes": plan.upload_bytes,
        "device_atlas_path": paths,
        "fixture_load_ms": statistics.median(ms for _, _, ms in loads),
        "fixture_load_ms_runs": [ms for _, _, ms in loads],
        "render_fps": loop["render_fps"], "p99_ms": loop["p99_ms"],
        "run_loop_first_frame_ms": frame_ms[0],
        "run_loop_later_frames_ms": frame_ms[1:],
        "run_loop_frames": RUN_LOOP_FRAMES, "run_loop_launches": loop_launches,
    }


def frames_checks(dev, rb, sc_b, card) -> dict:
    """Phase 8: the flythrough through render_frames_device on the card
    against the eager path, then the per-stage timings of scene B (module
    docstring). Returns the numbers of the frames line."""
    with tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        t0 = time.perf_counter()
        fly = flythrough(frames=FLY_FRAMES, out_dir=tmp, width=W, height=H, msaa=4,
                         sandbox=demo_scenes.MiniSandbox(), device=dev)
        torch.cuda.synchronize()
        fly_s = time.perf_counter() - t0
        launches = counters()
        written = sorted(os.listdir(tmp))
    r, scenes, imgs = fly["renderer"], fly["scenes"], fly["images"]
    stats = fly["stats"].cpu().numpy()
    graph = r.frame_graphs.graph
    cap = graph.captured
    capture_s, instantiate_s = (next(x.seconds for x in reversed(profiling.setup_spans())
                                     if x.name == name)
                                for name in ("setup.capture", "setup.instantiate"))
    # the replays are timed while the tracer is on: a profiler attached
    r.profiler = Profiler(enabled=True)
    r.render_frames_device(scenes)
    replay_ms = graph.replay_ms()
    if len(written) != FLY_FRAMES or imgs.shape != (FLY_FRAMES, H, W, 3):
        raise RuntimeError(f"frames: flythrough wrote {written}, images {imgs.shape}")
    missing = {k: launches[k] for k in ("k1", "k2_masked", "k2_blended", "s1", "s2")
               if launches[k] < FLY_FRAMES}
    if missing or min(cap.launches[m] for m in ("k1", "masked", "blended", "shade",
                                                 "alpha")) < 1:
        raise RuntimeError(f"frames: launches {launches}, a graph replay "
                           f"{cap.launches}")
    bad = {k: stats[:, STAT_NAMES.index(k)].tolist() for k in OVERFLOW_STATS
           if stats[:, STAT_NAMES.index(k)].any()}
    if bad:
        raise RuntimeError(f"frames: overflow stats {bad}")

    # the eager path: the same scenes on the same renderer, at the config
    # the batch settled on
    config = r.config
    eager_ms, mismatched, prologue_ms, queue_ms = [], [], [], []
    r.profiler = Profiler(enabled=True)  # the host prologue's spans
    for k, sc in enumerate(scenes):
        r.profiler.reset()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        img = r.render_frame_device(sc)
        e1.record()
        torch.cuda.synchronize()
        eager_ms.append(e0.elapsed_time(e1))
        spans = {s.name: s.total_s * 1e3 for s in r.profiler.report()}
        prologue_ms.append(sum(spans[n] for n in HOST_PROLOGUE))
        queue_ms.append(spans["pipeline"])
        row = r._last_stats.cpu().numpy()
        if not (np.array_equal(img.cpu().numpy(), imgs[k]) and np.array_equal(row, stats[k])):
            mismatched.append(k)
    if r.config != config:
        raise RuntimeError("frames: the eager frames grew the renderer's config")
    eager_reproducible = None
    if mismatched:
        # the graph is held to the golden tolerance only when the eager
        # path itself differs between two frames of one scene
        first = r.render_frame(scenes[mismatched[0]])
        again = r.render_frame(scenes[mismatched[0]])
        eager_reproducible = bool(np.array_equal(first, again))
        if eager_reproducible:
            raise RuntimeError(f"frames: graph frames {mismatched} differ from the "
                               "eager path, which is reproducible")
        for k in mismatched:
            check_golden(f"flythrough frame {k} (graph vs eager)", imgs[k],
                         r.render_frame(scenes[k]))
    out = {
        "frames": FLY_FRAMES, "flythrough_s": fly_s,
        "capture_s": capture_s, "instantiate_s": instantiate_s,
        "replay_ms": replay_ms, "replay_median_ms": statistics.median(replay_ms),
        "eager_ms": eager_ms, "eager_median_ms": statistics.median(eager_ms),
        "host_prologue_ms": prologue_ms, "host_queue_frame_ms": queue_ms,
        "bit_equal_to_eager": not mismatched, "mismatched_frames": mismatched,
        "eager_reproducible": eager_reproducible, "launches": launches,
        "graph_launches_a_replay": cap.launches,
        "mask_layers": config.mask_layers, "blend_layers": config.blend_layers,
        "msaa_shade_candidates": config.msaa_shade_candidates,
    }
    print(f"frames: flythrough {FLY_FRAMES} frames 1920x1080 msaa4 'sync' in "
          f"{fly_s:.1f} s | graph capture {capture_s:.2f} s, instantiate "
          f"{instantiate_s:.2f} s | replayed frame median "
          f"{out['replay_median_ms']:.2f} ms {[round(t, 2) for t in replay_ms]} vs "
          f"eager render_frame_device median {out['eager_median_ms']:.2f} ms "
          f"{[round(t, 2) for t in eager_ms]} (CUDA events; host prologue median "
          f"{statistics.median(prologue_ms):.2f} ms, queueing the eager frame "
          f"{statistics.median(queue_ms):.1f} ms) | bit-equal to eager "
          f"{not mismatched} (eager reproducible {eager_reproducible}) | launches "
          f"{launches} | {card}", flush=True)
    del fly, r, graph, cap
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    stages = {paced: engine_stats.device_stage_timings(rb, sc_b, iters=STAGE_ITERS,
                                                        paced=paced, frame_binning=True)
              for paced in ("device", "host")}
    out["stage_timings_ms"] = stages["device"]
    out["stage_timings_host_paced_ms"] = stages["host"]
    out["stage_timings_s"] = time.perf_counter() - t0
    print(f"frames: per-stage timings of scene B (engine.stats.device_stage_timings, "
          f"median of {STAGE_ITERS} runs, CUDA events; device: graph replays queued "
          f"behind a spin, host-paced: eager runs) | {card}", flush=True)
    print("frames: | stage | device ms | host-paced ms |", flush=True)
    for name, ms in stages["device"].items():
        print(f"frames: | {name} | {ms:.3f} | {stages['host'][name]:.3f} |", flush=True)
    return out


def print_kernel_row(row, card) -> None:
    dense = row["pairs"] * 32 * 128 * row["n_s"]  # (pair, sample) tests of 32×128 tiles
    print(f"kernel: {row['name']}: exact vs plain (max_abs_err {row['max_abs_err']}) "
          f"| {row['ms']:.3f} ms (queued {row['ms_queued']:.3f}) vs plain "
          f"{row['plain_ms']:.1f} ms | bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; dense tests "
          f"{row['dense_ms']:.3f} ms), tests_kept {row['tests_kept']:.4f}, share "
          f"{row['bound_ms'] / row['ms']:.1%} ({row['bound_ms'] / row['ms_queued']:.1%} "
          f"queued) | "
          f"{row['pairs']} bin pairs, {dense / row['ms'] / 1e6:.1f} G dense "
          f"(pair, sample) tests/s | {card}", flush=True)


def config_matrix(dev, tmp: Path, card) -> tuple[list, dict]:
    """Phase 9a: apps.configs.run_all on the card (module docstring).
    Returns its results and the kernel launches of the run."""
    reset_counters()
    results = configs.run_all(str(tmp), frames=CONFIG_FRAMES, device=dev)
    torch.cuda.synchronize()
    launches = counters()
    names = [r["config"] for r in results]
    if names != list(CONFIG_ROWS):
        raise RuntimeError(f"tools: run_all rendered {names}, not {CONFIG_ROWS}")
    if launches["k1"] < 1:
        raise RuntimeError(f"tools: run_all launched no K1: {launches}")
    saved = json.loads((tmp / "results.json").read_text())
    if [r["config"] for r in saved] != names:
        raise RuntimeError("tools: results.json differs from run_all's rows")
    for r in results:
        fs = r["frame_stats"]
        if r["dropped_pairs"] or r["dropped_rows"] or any(fs[k] for k in OVERFLOW_STATS):
            raise RuntimeError(f"tools: {r['config']} dropped work: {fs}")
        img = png.decode_png((tmp / f"{r['config']}.png").read_bytes())
        if img[..., :3].std() < 1.0:
            raise RuntimeError(f"tools: {r['config']}'s PNG is blank")
        jax = JAX_DEMAND.get(r["config"])
        print(f"tools: configs {r['config']}: {r['ms_per_frame']:.2f} ms/frame, "
              f"{r['fps']:.2f} fps | total_pairs {fs['total_pairs']} total_rows "
              f"{fs['total_rows']}" + (f" (the JAX package's comments: about "
              f"{jax[0]} pairs, {jax[1]} tile-rows)" if jax else "")
              + f" | {card}", flush=True)
    return results, launches


def overdraw_k1_row(dev, launches, card) -> tuple[dict, dict]:
    """Phase 9b: K1 on row 8's own bins against its plain version, timed
    and bounded as phase 4's rows. Returns the row and the launches of one
    row-8 frame."""
    renderer, scene = configs.overdraw_row(dev)
    reset_counters()
    renderer.render_frame_device(scene)
    torch.cuda.synchronize()
    per_frame = counters()
    cfg = renderer.config
    b, s, c = scene_bins(renderer, scene, "8")
    kw = dict(padded_height=cfg.padded_height, padded_width=cfg.padded_width,
              tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    pairs = int(c[0].sum())
    keep = raster_kernel.footprint_keep(b, s[0], c[0], None, fp_w=8, fp_h=4,
                                        samples_per_block=1, **kw)
    row = kernel_row(
        "K1 rasterize_binned (opaque visibility, configs row 8 "
        "stress-4Mpairs-1080p, S=1)",
        "renderer_tpu_torch/csrc/raster_kernel.cu",
        "renderer_tpu/raster/raster_kernel.py:300", "k1", launches,
        lambda: raster_kernel.rasterize_binned(b, s[0], c[0], **kw),
        lambda: raster_kernel.rasterize_binned_plain(b, s[0], c[0], **kw),
        keep, pairs, 1, cfg, pairs * binning.B_ROWS * 4 + cfg.padded_height
        * cfg.padded_width * 8, "8")
    counts = c[0].cpu().float()
    row["bin_pairs_max"], row["bin_pairs_median"] = int(counts.max()), float(counts.median())
    del keep
    print_kernel_row(row, card)
    return row, per_frame


def capture_checks(dev, tmp: Path, card) -> tuple[dict, dict]:
    """Phase 9c: tools.frame_capture of the mini-sandbox at 1280×720.
    Returns the summary line's numbers and the capture's launches."""
    cfg = trt.RenderConfig(width=CAPTURE_W, height=CAPTURE_H)
    reset_counters()
    summary = frame_capture.capture(tmp, "sandbox", 1.0, config=cfg,
                                    sandbox=demo_scenes.MiniSandbox(), device=dev)
    torch.cuda.synchronize()
    launches = counters()
    missing = [k for k in ("k1", "k2_masked", "k2_blended") if launches[k] < 1]
    if missing:
        raise RuntimeError(f"tools: capture launched no {missing}: {launches}")
    dumps, buffers = summary.pop("dumps"), summary.pop("buffers")
    if sorted(dumps) != list(frame_capture.DUMPS):
        raise RuntimeError(f"tools: capture wrote {sorted(dumps)}")
    for name, arr in dumps.items():
        decoded = png.decode_png((tmp / name).read_bytes())
        back = decoded[..., 0] if arr.ndim == 2 else decoded[..., :3]
        if not np.array_equal(back, arr):
            raise RuntimeError(f"tools: capture's {name} does not decode to its array")
    written = json.loads((tmp / "capture.json").read_text())
    # the frame's total_pairs is the re-run's ragged pair demand; the
    # binned pairs are that demand less the pairs binning's per-pair tile
    # extent test drops (the same in the JAX package)
    stats, demand = written["stats"], [int(d) for d in buffers["demand"]]
    binned = sum(written["pairs_per_class"])
    if (written != summary or [stats["total_pairs"], stats["total_rows"]] != demand
            or not 0 < binned <= demand[0]):
        raise RuntimeError(f"tools: capture.json {written}, re-run demand {demand}")
    cfg_kw = dict(padded_height=cfg.padded_height, padded_width=cfg.padded_width,
                  tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    b, s, c = buffers["bins"]
    max_abs_err(buffers["k1"], raster_kernel.rasterize_binned_plain(b, s[0], c[0], **cfg_kw))
    zs = buffers["k1"][0]
    for mode in ("masked", "blended"):
        cls, n_layers, got = buffers[mode]
        max_abs_err(got, layers.rasterize_layers_plain(
            b, s[cls], c[cls], zs, mode=mode, n_layers=n_layers, **cfg_kw))
    print(f"tools: frame_capture mini-sandbox {CAPTURE_W}x{CAPTURE_H}: 6 dumps decode to "
          f"their arrays; direct K1 and K2 (masked, blended) launches bit-equal to their "
          f"plain versions | total_pairs {stats['total_pairs']} = the re-run's demand, "
          f"binned {binned} after {demand[0] - binned} pairs the extent test dropped "
          f"| pairs_per_class {written['pairs_per_class']} busiest tile "
          f"{written['busiest_tile']} ({written['busiest_tile_pairs']} pairs) | launches "
          f"{launches} | {card}", flush=True)
    return written, launches


def startup(mode: str) -> dict:
    """tools.startup_probe in a process of its own; its JSON line."""
    out = subprocess.run([sys.executable, "-m", "renderer_tpu_torch.tools.startup_probe",
                          mode], capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parent)
    if out.returncode != 0:
        raise RuntimeError(f"tools: startup_probe {mode} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def tools_checks(dev, card) -> tuple[dict, dict, dict]:
    """Phase 9 (module docstring). Returns the tools line's numbers, the
    row-8 K1 kernel row and the launches of each phase-9 path."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "configs").mkdir()
        (tmp / "capture").mkdir()
        results, config_launches = config_matrix(dev, tmp / "configs", card)
        k1_row, row8_frame = overdraw_k1_row(dev, config_launches, card)
        torch.cuda.empty_cache()
        capture, capture_launches = capture_checks(dev, tmp / "capture", card)
    torch.cuda.empty_cache()

    curve = binning_scaling.scaling(BINNING_REPS, dev)
    for r in curve:
        fill = r["actual_pairs"] / (binning_scaling.FILL * r["pair_capacity"])
        if r["overflow"] or abs(fill - 1.0) > 0.25:
            raise RuntimeError(f"tools: binning_scaling row off its 60% target: {r}")
        print(f"tools: binning_scaling capacity {r['pair_capacity']}: {r['actual_pairs']} "
              f"pairs ({r['triangles']} triangles) | binning {r['binning_ms']:.3f} ms device, "
              f"{r['binning_host_paced_ms']:.3f} ms host-paced | sort alone "
              f"{r['sort_ms']:.3f} ms ({r['sort_share']:.1%}) | {card}", flush=True)
    torch.cuda.empty_cache()

    prologue = prologue_probe.main(reps=200, sandbox=demo_scenes.MiniSandbox(), device=dev)
    starts = {mode: startup(mode) for mode in ("cold", "warm")}
    if not starts["cold"]["nvcc_s"] or starts["warm"]["nvcc_s"] != 0.0:
        raise RuntimeError(f"tools: startup cold/warm builds {starts}")
    for mode, st in starts.items():
        print(f"tools: startup {mode}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items() if k.endswith("_s")) + f" | {card}",
            flush=True)
    print(f"tools: prologue_probe (the mini-sandbox's {prologue['draws']} draws, median of "
          f"200): full prologue {prologue['full_prologue_us']:.1f} us, build_scene "
          f"{prologue['build_scene_us']:.1f} us | {card}", flush=True)
    seconds = time.perf_counter() - t0
    print(f"tools: phase 9 took {seconds:.1f} s", flush=True)
    out = {"configs": results, "capture": capture, "binning_scaling": curve,
           "prologue": prologue, "startup": starts, "seconds": seconds}
    return out, k1_row, {"9 configs": config_launches, "9 configs row 8 frame": row8_frame,
                         "9 capture": capture_launches}


def alpha_classes(gs) -> dict:
    """The alpha classes a geometry stream holds, as Renderer._dispatch
    passes them."""
    return {"has_masked": gs.num_masked_tris > 0,
            "has_blended": gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris}


def mesh_scenes(dev, configs=None) -> dict:
    """Phase 10's scenes at MESH_W×MESH_H on `dev`: name -> (renderer,
    scenes, debug modes). A: the stress field (one frame); C: the
    mini-sandbox at two game times (a dp=2 batch), at 1×MSAA. `configs`
    (name -> RenderConfig) replaces the default configs."""
    reg_a, sc_a = demo_scenes.stress_scene()
    cfg_a = trt.RenderConfig(width=MESH_W, height=MESH_H, max_triangles=1 << 21,
                             pair_capacity=1 << 20, row_capacity=1 << 20)
    sandbox = demo_scenes.MiniSandbox()
    cfg_c = trt.RenderConfig(width=MESH_W, height=MESH_H)
    configs = configs or {"A": cfg_a, "C": cfg_c}
    return {
        "A": (trt.Renderer(reg_a, configs["A"], overflow_policy="off", device=dev),
              [sc_a], (0,)),
        "C": (trt.Renderer(sandbox.registry, configs["C"], overflow_policy="off",
                           device=dev),
              [sandbox.build_scene(t) for t in MESH_TIMES], (0, 0)),
    }


def mesh_rank(rank: int, configs: dict, device_type: str) -> dict:
    """Phase 10's rank body, in a process of its own on the one card
    (gloo, CUDA tensors): scene A at sp=2 (the world is two meshes of two
    ranks), contiguous and interleaved, then the mini-sandbox at dp=2 ×
    sp=2. Returns each run's image and stats (numpy), the seconds, and this
    rank's kernel launches (counted around the mesh calls only)."""
    from renderer_tpu_torch.parallel import mesh as pmesh
    from renderer_tpu_torch.raster import pipeline

    dev = torch.device(device_type)
    mesh2 = pmesh.make_mesh(2)
    mesh22 = pmesh.make_mesh_2d(2, 2)
    scenes = mesh_scenes(dev, configs)
    inputs = {name: pmesh.frame_inputs(r, scs[0], modes[0]) + (r.config,)
              for name, (r, scs, modes) in scenes.items()}
    r_c, scs_c, modes_c = scenes["C"]
    blobs = torch.stack([pmesh.frame_inputs(r_c, sc, m)[2]["blob"]
                         for sc, m in zip(scs_c, modes_c)])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    before = pipeline.launch_counts()
    t0 = time.perf_counter()
    runs = {}
    gs, geom, frame, mats, jc, cfg = inputs["A"]
    for inter in (False, True):
        runs[f"A sp2 {'interleaved' if inter else 'contiguous'}"] = pmesh.render_frame_sharded(
            geom, frame, mats, config=cfg, mesh=mesh2, interleave=inter,
            morph_k=gs.morph_k, joint_cap=jc, **alpha_classes(gs))
    gs, geom, _frame, mats, jc, cfg = inputs["C"]
    runs["C dp2xsp2"] = pmesh.render_frames_batched(
        geom, {"blob": blobs}, mats, config=cfg, mesh=mesh22, morph_k=gs.morph_k,
        joint_cap=jc, **alpha_classes(gs))
    sync()
    seconds = time.perf_counter() - t0
    after = pipeline.launch_counts()
    return {"runs": {k: (img.cpu().numpy(), st.cpu().numpy()) for k, (img, st) in runs.items()},
            "seconds": seconds, "native": native.status()["path"],
            "launches": {k: after[k] - before[k] for k in after}}


def native_checks(dev, card) -> dict:
    """Phase 10, the host library: the mini-sandbox's frame_view and
    queue_animated on the library and on their numpy plain versions, and
    tools.prologue_probe on each."""
    status = native.status()
    if status["path"] != "native":
        raise RuntimeError(f"native: the card's run took the numpy path: {status}")
    sandbox = demo_scenes.MiniSandbox()
    palette_drift = 0
    for t in NATIVE_TIMES:
        snaps = []
        for ctx in (contextlib.nullcontext, native.plain):
            sandbox.character.invalidate_caches()
            with ctx():
                scene = sandbox.build_scene(t)
                fv = draw_stream.frame_view(scene)
            n = scene.draw_count
            snaps.append([scene._keys[:n].copy(), scene._transforms[:n].copy(),
                          scene._material_id[:n].copy(), scene._joints_offset[:n].copy(),
                          scene._skinned[:n].copy(), scene._morph_weights[:n].copy(),
                          fv.order.astype(np.int64), fv.sorted_keys.copy(), fv.pdf.copy(),
                          fv.pdi.copy(), scene.joint_palette.copy()])
        (*lib_exact, lib_pal), (*plain_exact, plain_pal) = snaps
        if not all(np.array_equal(a, b) for a, b in zip(lib_exact, plain_exact)):
            raise RuntimeError(f"native: frame_view / queue_animated differ from the "
                               f"numpy path at game time {t}")
        # the joint palettes: the reference's own last-bit drift between its
        # library and its numpy path (tests/test_torch_native.py pins it)
        diff = np.abs(lib_pal - plain_pal).max()
        if diff > PALETTE_DRIFT:
            raise RuntimeError(f"native: joint palettes differ by {diff} at {t}")
        palette_drift += int(np.count_nonzero(lib_pal != plain_pal))
    probes = {"native": prologue_probe.main(reps=200, sandbox=demo_scenes.MiniSandbox(),
                                            device=dev)}
    with native.plain():
        probes["numpy"] = prologue_probe.main(reps=200, sandbox=demo_scenes.MiniSandbox(),
                                              device=dev)
    if probes["native"]["host_library"] != "native" or probes["numpy"]["host_library"] != "numpy":
        raise RuntimeError(f"native: prologue_probe paths {probes}")
    print(f"native: {status['library']} built in {status['build_seconds']:.1f} s | "
          f"mini-sandbox frame_view + queue_animated at {len(NATIVE_TIMES)} game times: "
          f"draw stream bit-equal to the numpy path, {palette_drift} joint-palette floats "
          f"of {len(NATIVE_TIMES) * lib_pal.size} off by <= {PALETTE_DRIFT} | "
          f"prologue_probe median of 200: full prologue native "
          f"{probes['native']['full_prologue_us']:.1f} us vs numpy "
          f"{probes['numpy']['full_prologue_us']:.1f} us, build_scene "
          f"{probes['native']['build_scene_us']:.1f} vs {probes['numpy']['build_scene_us']:.1f}"
          f" us | {card}", flush=True)
    return {"build_s": status["build_seconds"], "palette_floats_drifted": palette_drift,
            "prologue": probes}


def ntex_checks(dev, tmp: Path, card) -> dict:
    """Phase 10, make_ntex: a NTEX_SIDE² synthetic PNG (written by the
    port's encoder) compiled by the CLI as sRGB and as linear (two files,
    by make-ntex's name rule), each decoded on the card and on the CPU
    (bit-equal), PSNR of mip 0 against the source."""
    rng = np.random.default_rng(7)
    x, y = np.meshgrid(np.linspace(0, 255, NTEX_SIDE), np.linspace(0, 255, NTEX_SIDE))
    img = np.stack([x, y, (x + y) / 2, np.full_like(x, 255)], -1)
    img[..., :3] += rng.normal(0, 8, img[..., :3].shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    paths = [tmp / "synthetic.png", tmp / "synthetic_rough.png"]  # sRGB, linear
    for path in paths:
        png.write_png(path, img)
    t0 = time.perf_counter()
    if make_ntex.main(["--silent", *map(str, paths)]) != 0:
        raise RuntimeError("make_ntex: the CLI failed")
    seconds = time.perf_counter() - t0
    blocks, psnr = 0, {}
    for path, fmt in zip(paths, (ntex.VK_FORMAT_BC7_SRGB, ntex.VK_FORMAT_BC7_UNORM)):
        data = path.with_suffix(".ntex").read_bytes()
        header, on_card = ntex.decode(data, device=dev)
        _, on_cpu = ntex.decode(data, device="cpu")
        if header.vk_format != fmt or len(on_card) != len(on_cpu):
            raise RuntimeError(f"make_ntex: {path.name}: format {header.vk_format}")
        if not all(np.array_equal(a, b) for a, b in zip(on_card, on_cpu)):
            raise RuntimeError(f"make_ntex: {path.name}: card and CPU BC7 decodes differ")
        blocks += (len(data) - 1024) // 16
        err = (on_card[0][..., :3].astype(np.float64) - img[..., :3]) ** 2
        psnr[path.name] = float(10 * np.log10(255 ** 2 / max(err.mean(), 1e-9)))
        if psnr[path.name] < PSNR_FLOOR:
            raise RuntimeError(f"make_ntex: {path.name}: PSNR {psnr[path.name]:.2f} dB")
    rate = blocks / seconds / 1e6
    print(f"make_ntex: {NTEX_SIDE}x{NTEX_SIDE} PNG as sRGB and linear: {blocks} BC7 blocks "
          f"(all mips) in {seconds:.1f} s = {rate:.4f} Mblocks/s on the host "
          f"({os.cpu_count()} cores, threads over files and mips) | card decode = CPU "
          f"decode, bit-equal | PSNR mip 0 {psnr} (floor {PSNR_FLOOR}) | {card}", flush=True)
    return {"blocks": blocks, "encode_s": seconds, "mblocks_per_s": rate, "psnr_db": psnr}


def mesh_checks(dev, tmp: Path, card) -> tuple[dict, dict]:
    """Phase 10, the mesh: four ranks on the one card over gloo
    (mesh_rank), each run against the single-device pipeline.render_frame
    of the same scene on the same inputs. Returns the numbers and the
    ranks' summed launches."""
    from renderer_tpu_torch.parallel import mesh as pmesh

    scenes = mesh_scenes(dev)
    singles = {}
    for name, (r, scs, modes) in scenes.items():
        frames = []
        for sc, m in zip(scs, modes):
            gs, geom, frame, mats, jc = pmesh.frame_inputs(r, sc, m)
            img, st = pipeline.render_frame(
                geom, frame, mats, config=r.config, skin_start=gs.skin_start,
                morph_k=gs.morph_k, joint_cap=jc, **alpha_classes(gs))
            frames.append((img.cpu().numpy(), st.cpu().numpy()))
        singles[name] = frames
    configs = {name: r.config for name, (r, _s, _m) in scenes.items()}
    del scenes
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = pmesh.spawn(mesh_rank, 4, configs, dev.type, store_dir=tmp, threads=2,
                       timeout=300)
    wall = time.perf_counter() - t0
    result = {"wall_s": wall, "rank_s": [o["seconds"] for o in outs], "runs": {}}
    for run in outs[0]["runs"]:
        imgs, stats = outs[0]["runs"][run]
        for o in outs[1:]:
            if not all(np.array_equal(a, b) for a, b in zip(o["runs"][run], (imgs, stats))):
                raise RuntimeError(f"mesh: {run}: the ranks' frames differ")
        want = singles[run[0]]
        got = [(imgs[b], stats[b]) for b in range(len(want))] if imgs.ndim == 4 else [(imgs, stats)]
        differing = []
        for (gi, gst), (wi, wst) in zip(got, want):
            if not np.array_equal(gst, wst):
                raise RuntimeError(f"mesh: {run}: stats {gst.tolist()} vs single {wst.tolist()}")
            if gi.shape != wi.shape or (wst[:4] != 0).any():
                raise RuntimeError(f"mesh: {run}: shape {gi.shape} stats {wst.tolist()}")
            differing.append(int((gi != wi).any(axis=-1).sum()))
        # bit-equal to one device: every vertex-stage contraction is written
        # out in a fixed order (raster/vertex_stage.py), so a rank's slice of
        # the vertex stream gives the whole stream's bits
        if max(differing) != 0:
            raise RuntimeError(f"mesh: {run}: {differing} pixels differ from one device")
        result["runs"][run] = {"pixels_differing": differing,
                               "total_pairs": [int(st[STAT_NAMES.index("total_pairs")])
                                               for _, st in got]}
    launches = dict.fromkeys(PIPELINE_KEYS.values(), 0)
    for o in outs:
        for k, v in o["launches"].items():
            launches[PIPELINE_KEYS[k]] += v
    if min(launches["k1"], launches["k2_masked"], launches["k2_blended"]) < 4:
        raise RuntimeError(f"mesh: the ranks' launches {[o['launches'] for o in outs]}")
    result["rank_host_library"] = [o["native"] for o in outs]
    if set(result["rank_host_library"]) != {"native"}:
        raise RuntimeError(f"mesh: the ranks' host library paths {result['rank_host_library']}")
    result["launches_by_rank"] = [o["launches"] for o in outs]
    print(f"mesh: 4 ranks on one card over gloo (CUDA tensors), {MESH_W}x{MESH_H}: "
          + " | ".join(f"{k}: stats = single, {v['pixels_differing']} px differ, "
                       f"total_pairs {v['total_pairs']}" for k, v in result["runs"].items())
          + f" | ranks' host library {result['rank_host_library']}"
          + f" | launches by rank {result['launches_by_rank']} | wall {wall:.1f} s, in-rank "
          f"{[round(s, 2) for s in result['rank_s']]} s (smoke, ranks share one card) "
          f"| {card}", flush=True)
    return result, launches


def phase10(dev, card) -> tuple[dict, dict]:
    """Phase 10 (module docstring): the host library, make_ntex and the mesh."""
    t0 = time.perf_counter()
    out = {"native": native_checks(dev, card)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "ntex").mkdir()
        out["make_ntex"] = ntex_checks(dev, tmp / "ntex", card)
        out["mesh"], launches = mesh_checks(dev, tmp, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 10 took {out['seconds']:.1f} s", flush=True)
    return out, launches


def jpeg_glb(image: bytes) -> bytes:
    """A GLB written here without Pillow (the layout of
    tests/make_loader_fixture.py's build()): GLB_PATCHES proxy patches in a
    ring around the sandbox camera's target, one node and one mesh each,
    cycling three materials that all take `image` (a JPEG) as their base
    colour —
    opaque, MASK (alpha-to-coverage, cutoff 0.4) and BLEND — and the JPEG
    embedded as a bufferView of the BIN chunk."""
    blob, views, accessors = bytearray(), [], []

    def view(data: bytes) -> int:
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def accessor(arr: np.ndarray, ctype: int, atype: str, minmax: bool = False) -> int:
        a = {"bufferView": view(arr.tobytes()), "componentType": ctype,
             "type": atype, "count": int(arr.shape[0])}
        if minmax:
            a["min"], a["max"] = arr.min(0).tolist(), arr.max(0).tolist()
        accessors.append(a)
        return len(accessors) - 1

    meshes, nodes = [], []
    for i in range(GLB_PATCHES):
        p, uv, n, t, idx = proxy._patch_geometry(
            (GLB_GRID + 1) ** 2, 6 * GLB_GRID ** 2, [-0.8, -0.5, -0.2], [0.8, 0.5, 0.2],
            seed=300 + i)
        attrs = {"POSITION": accessor(p, 5126, "VEC3", minmax=True),
                 "NORMAL": accessor(n, 5126, "VEC3"), "TANGENT": accessor(t, 5126, "VEC4"),
                 "TEXCOORD_0": accessor(uv, 5126, "VEC2")}
        meshes.append({"primitives": [{"attributes": attrs,
                                       "indices": accessor(idx, 5125, "SCALAR"),
                                       "material": i % 3}]})
        ang = 2 * np.pi * i / GLB_PATCHES
        q = math3d.quat_from_axis_angle([0, 1, 0], ang)
        nodes.append({"mesh": i, "rotation": [float(x) for x in q],
                      "translation": [1.6 * np.cos(ang), 0.4 + 0.08 * i, 1.6 * np.sin(ang)]})
    image_view = view(image)
    blob.extend(b"\0" * (-len(blob) % 4))
    tex = {"baseColorTexture": {"index": 0}}
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": list(range(GLB_PATCHES))}], "nodes": nodes, "meshes": meshes,
        "materials": [
            {"name": "jpeg-opaque", "pbrMetallicRoughness": dict(tex)},
            {"name": "jpeg-masked", "alphaMode": "MASK", "alphaCutoff": 0.4,
             "pbrMetallicRoughness": dict(tex, baseColorFactor=[1, 1, 1, 0.9])},
            {"name": "jpeg-blended", "alphaMode": "BLEND",
             "pbrMetallicRoughness": dict(tex, baseColorFactor=[1, 1, 1, 0.45])}],
        "textures": [{"source": 0, "sampler": 0}],
        "samplers": [{"wrapS": 10497, "wrapT": 10497}],
        "images": [{"bufferView": image_view, "mimeType": "image/jpeg"}],
        "buffers": [{"byteLength": len(blob)}], "bufferViews": views, "accessors": accessors,
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body


def jpeg_decode_checks(z, card) -> dict:
    """Phase 11 (a): every vector of JPEG_VECTORS decoded on the host equal
    to Pillow's decode (its pixels, or its SHA-256 for the two 512×512
    images), with the median host time of JPEG_REPS decodes of each large
    one."""
    names = [k[:-len("_jpeg")] for k in z.files if k.endswith("_jpeg")]
    out = {"vectors": len(names), "big": {}}
    for name in names:
        data = z[f"{name}_jpeg"].tobytes()
        times = []
        for _ in range(JPEG_REPS if name in JPEG_BIG else 1):
            t0 = time.perf_counter()
            got = jpeg.decode_jpeg(data)
            times.append((time.perf_counter() - t0) * 1e3)
        if name in JPEG_BIG:
            digest = hashlib.sha256(got.tobytes()).hexdigest()
            if digest != str(z[f"{name}_sha256"]):
                raise RuntimeError(f"jpeg: {name} decodes to another image than Pillow's")
            ms = statistics.median(times)
            out["big"][name] = {"ms": ms, "mpixel_per_s": got.shape[0] * got.shape[1] / ms / 1e3,
                                "jpeg_bytes": len(data), "ms_all": times}
        elif not np.array_equal(got, z[f"{name}_rgba"]):
            raise RuntimeError(f"jpeg: {name}: {int((got != z[f'{name}_rgba']).sum())} "
                               f"values differ from Pillow's decode")
    print(f"jpeg: {len(names)} vectors decode equal to Pillow's | "
          + " | ".join(f"{k} ({v['jpeg_bytes']} bytes) {v['ms']:.1f} ms = "
                       f"{v['mpixel_per_s']:.3f} Mpixel/s on the host"
                       for k, v in out["big"].items()) + f" | {card}", flush=True)
    return out


def glb_checks(dev, tmp: Path, data: bytes, card) -> tuple[dict, dict]:
    """Phase 11 (b): jpeg_glb(data) loaded onto the card and rendered at
    1920×1080, 4×MSAA (overflow stats 0; K1 and K2 in both scene modes
    launched), then at GLB_SMALL on the card and on the CPU, which must
    agree to the golden tolerance. Returns the numbers and the launches of
    the 1080p frame."""
    path = tmp / "jpeg.glb"
    path.write_bytes(jpeg_glb(data))
    registry, builder = trt.MaterialRegistry(), trt.VertexLibraryBuilder()
    t0 = time.perf_counter()
    gltf = load_gltf(path, builder, registry, device=dev)
    builder.build()
    load_ms = (time.perf_counter() - t0) * 1e3
    tex = gltf.textures[0]
    if tex.mips[0].shape != (512, 512, 4) or len(gltf.materials) != 3:
        raise RuntimeError(f"glb: texture {tex.mips[0].shape}, {len(gltf.materials)} materials")
    scene = trt.Scene(world_space=trt.GLTF)
    scene.camera.position = np.array([0.0, 0.9, 2.6], np.float32)
    scene.camera.orientation = math3d.quat_from_axis_angle([0, 1, 0], np.pi)
    if not gltf.queue(scene, math3d.IDENTITY):
        raise RuntimeError("glb: the scene did not queue")
    r = trt.Renderer(registry, trt.RenderConfig(width=W, height=H, msaa_samples=4),
                     overflow_policy="sync", device=dev)
    reset_counters()
    t0 = time.perf_counter()
    img, stats, moved = render_checked(r, scene, "GLB")
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = counters()
    if min(moved["k1"], moved["k2_masked"], moved["k2_blended"]) < 1:
        raise RuntimeError(f"glb: the 1080p frame's launches {moved}")
    # the small frames take the capacities the 1080p frame grew to, so
    # "sync" renders each once
    small_cfg = replace(r.config, width=GLB_SMALL[0], height=GLB_SMALL[1])
    frames, small_s = {}, {}
    for where in (dev, torch.device("cpu")):
        small = trt.Renderer(registry, small_cfg, overflow_policy="sync", device=where)
        t0 = time.perf_counter()
        frames[where.type] = small.render_frame(scene, 0)
        small_s[where.type] = time.perf_counter() - t0
        bad = {k: v for k, v in small.frame_stats().items() if k in OVERFLOW_STATS and v}
        if bad:
            raise RuntimeError(f"glb: {where.type} {GLB_SMALL} overflow stats {bad}")
    diff = np.abs(frames["cuda"].astype(int) - frames["cpu"].astype(int)).max(axis=-1)
    drifted = float((diff > 2).mean())
    if drifted >= 0.005 or frames["cuda"].std() < 5.0:
        raise RuntimeError(f"glb: card and CPU frames: {drifted:.2%} of pixels drifted")
    out = {"load_ms": load_ms, "frame_s": frame_s, "launches": moved,
           "total_pairs": stats["total_pairs"], "mask_layers": r.config.mask_layers,
           "blend_layers": r.config.blend_layers, "small_drifted": drifted,
           "small_max_diff": int(diff.max()), "small_s": small_s}
    print(f"glb: {GLB_PATCHES} patches, 3 materials on one embedded 512x512 JPEG: "
          f"load_gltf {load_ms:.1f} ms | 1080p 4xMSAA first frame {frame_s:.2f} s, overflow "
          f"0, launches {moved}, total_pairs {stats['total_pairs']} | {GLB_SMALL[0]}x"
          f"{GLB_SMALL[1]} card vs CPU: {drifted:.4%} of pixels > 2 (max {diff.max()}; "
          f"card {small_s['cuda']:.2f} s, CPU {small_s['cpu']:.2f} s) | {card}", flush=True)
    return out, launches


def jpeg_layout_checks(dev, tmp: Path, z, card) -> dict:
    """Phase 11 (d): each JPEG_LAYOUTS vector (YCCK under Adobe transform 2,
    4:1:1, arithmetic-coded, lossless; tests/torch_jpeg_writer.py's files,
    which Pillow reads but does not write) embedded in jpeg_glb's GLB and
    loaded by load_gltf onto the card: the texture's mip 0 equal to
    Pillow's decode stored beside it."""
    out = {}
    for name in JPEG_LAYOUTS:
        path = tmp / f"{name}.glb"
        path.write_bytes(jpeg_glb(z[f"{name}_jpeg"].tobytes()))
        registry, builder = trt.MaterialRegistry(), trt.VertexLibraryBuilder()
        t0 = time.perf_counter()
        gltf = load_gltf(path, builder, registry, device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        got, want = np.asarray(gltf.textures[0].mips[0]), z[f"{name}_rgba"]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError(f"jpeg: {name} through load_gltf differs from Pillow's decode")
        out[name] = {"shape": list(got.shape), "load_ms": ms}
    loads = ", ".join(f"{k} {v['load_ms']:.1f} ms" for k, v in out.items())
    print(f"jpeg: {', '.join(JPEG_LAYOUTS)} in a GLB through load_gltf on the card: mip 0 "
          f"equal to Pillow's decode (load {loads}) | {card}", flush=True)
    return out


def jpeg_ntex_checks(dev, tmp: Path, data: bytes, card) -> dict:
    """Phase 11 (c): make_ntex's CLI on the JPEG and on a PNG of the port's
    decode of it (png.py's encoder) writes the same .ntex bytes; the card's
    BC7 decode of the file equals the CPU's."""
    paths = [tmp / "bricks.jpg", tmp / "bricks_png.png"]
    paths[0].write_bytes(data)
    png.write_png(paths[1], jpeg.decode_jpeg(data))
    t0 = time.perf_counter()
    if make_ntex.main(["--silent", "--assume-color", *map(str, paths)]) != 0:
        raise RuntimeError("make_ntex: the CLI failed on the JPEG")
    seconds = time.perf_counter() - t0
    ntex_jpg, ntex_png = (p.with_suffix(".ntex").read_bytes() for p in paths)
    if ntex_jpg != ntex_png:
        raise RuntimeError("make_ntex: the JPEG's .ntex differs from its PNG's")
    header, on_card = ntex.decode(ntex_jpg, device=dev)
    _, on_cpu = ntex.decode(ntex_jpg, device="cpu")
    if not all(np.array_equal(a, b) for a, b in zip(on_card, on_cpu, strict=True)):
        raise RuntimeError("make_ntex: card and CPU BC7 decodes of the JPEG's .ntex differ")
    blocks = (len(ntex_jpg) - 1024) // 16
    print(f"make_ntex: 512x512 JPEG and its PNG: .ntex bytes equal ({len(ntex_jpg)} bytes, "
          f"{header.mip_levels} mips, {blocks} blocks each) in {seconds:.1f} s | card decode = "
          f"CPU decode | {card}", flush=True)
    return {"ntex_bytes": len(ntex_jpg), "blocks": blocks, "encode_s": seconds}


def phase11(dev, card) -> tuple[dict, dict]:
    """Phase 11 (module docstring): JPEG decode, a GLB with an embedded
    JPEG on the card, make_ntex on a JPEG."""
    t0 = time.perf_counter()
    z = np.load(JPEG_VECTORS)
    out = {"decode": jpeg_decode_checks(z, card)}
    data = z[f"{JPEG_BIG[0]}_jpeg"].tobytes()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out["glb"], launches = glb_checks(dev, tmp, data, card)
        out["layouts"] = jpeg_layout_checks(dev, tmp, z, card)
        out["make_ntex"] = jpeg_ntex_checks(dev, tmp, data, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11 took {out['seconds']:.1f} s", flush=True)
    return out, launches


def sampler_work(n: int, n_srgb: int, trilinear: bool, aniso: int,
                 per_tap: bool, channels: int = 4, decoded: int = 3) -> tuple[int, int]:
    """(FP32 operations, texel taps) of one make_sampler sample of
    `channels` channels at n pixels, n_srgb of them on sRGB textures with
    `decoded` of those channels decoded, counted from
    csrc/shade_common.cuh's `sample`, which filters only the channels its
    caller uses:
    - a sample: 17 for the footprint and LOD, 5 for the choice of mips and
      their blend weights (2 without trilinear), and (aniso + 1) a channel
      to accumulate and scale its taps;
    - an anisotropic tap: 4 for its uv, 4 for the address modes, 3 a
      channel for the two-mip blend (none without trilinear);
    - a mip: 10 for the texel coordinates and bilinear weights, 11 a
      channel for the bilinear blend, and 4 texel reads whatever the
      channels;
    - a decode after the filter (not per tap): 13 a decoded channel a mip
      (5 + a pow counted as 8); a per-tap decode reads a table.
    Each multiply and add is an instruction of its own: the kernels are
    built with --fmad=false."""
    mips = 2 if trilinear else 1
    tap = 8 + (3 * channels if trilinear else 0) + mips * (10 + 11 * channels)
    ops = n * (17 + (5 if trilinear else 2) + (aniso + 1) * channels + aniso * tap)
    if not per_tap:
        ops += n_srgb * aniso * mips * decoded * 13
    return ops, n * aniso * mips * 4


#: the channels of each sample S1 takes in a debug mode (csrc/shade.cu
#: shade_one); every other mode is lit: base colour RGBA, emissive RGB,
#: occlusion R, normal RGB
S1_CHANNELS = {1: (4,), 2: (), 3: (3,), 4: (2,), 5: (3,), 6: (1,)}
S1_LIT_CHANNELS = (4, 3, 1, 3)


#: the DrawList tensors the UI kernels read
UI_INPUTS = ("tris", "pos", "uv", "col", "tri_cmd", "clip", "tex_kind", "tex_slot")


def ui_live(lt: torch.Tensor, ui: dict, row0) -> tuple[torch.Tensor, torch.Tensor]:
    """(live, kind) of every (layer, pixel) of `lt` as shade_ui_layer
    computes them: covered, inside its command's clip rect and of
    tex_kind 1 or 2; kind is the command's tex_kind."""
    h, w = lt.shape[-2:]
    t = lt.clamp(min=0, max=ui["tri_cmd"].shape[0] - 1).long()
    cmd = ui["tri_cmd"][t].long().clamp(0, ui["clip"].shape[0] - 1)
    cr = ui["clip"][cmd]
    px = torch.arange(w, dtype=torch.float32, device=lt.device) + 0.5
    py = (torch.arange(h, dtype=torch.float32, device=lt.device)[:, None] + 0.5
          + row0.reshape(h, 1))
    in_clip = (cr[..., 0] < px) & (cr[..., 2] >= px) & (cr[..., 1] < py) & (cr[..., 3] >= py)
    kind = ui["tex_kind"][cmd]
    return (lt >= 0) & in_clip & ((kind == 1) | (kind == 2)), kind


def shade_work(counter, args, kw, outs, tensors: dict) -> tuple[int, int]:
    """(FP32 operations, texel taps) one recorded call needs, counted from
    csrc/shade.cu on this call's data: S1 shades covered (candidate,
    pixel)s only (115 operations of perspective interpolation, then the
    samples of its debug mode with the channels each uses, S1_CHANNELS —
    lit: base colour 4, emissive 3, occlusion 1, normal 3, so 11 — and 60
    of lighting when lit); S2 covered (candidate, pixel)s only too
    (interpolation and one sample of one channel, alpha), as
    benchmark/work/shade.py counts it; S3 every (layer, pixel) (70 of
    affine interpolation and the clip test, one trilinear sample of four
    channels, decoded after the filter). Adds the call's input tensors to
    `tensors` (address → bytes; the recorded calls hold them, so each is
    counted once) and its outputs under their own keys.

    The fused S3 counts its live (layer, pixel)s alone (ui_live), the only
    ones whose shade the composite sees: 70 of interpolation and the clip
    test, the sample of the channels each uses (a font layer R, an RGBA
    one RGBA; decoded after the filter where the texture is sRGB) and 10 a
    sample it composites into (1 − a, then 2 multiplies and an add a
    channel). Its bytes are the layer ids, row0 and the DrawList's
    tensors (UI_INPUTS) once by address, the HDR samples read once, and
    written only where `outs` (the call's result) differs from them in
    bits, as the kernel stores them; texels count as taps."""
    if counter == "s3c":
        hdr, lt, ui, mats = args
        live, kind = ui_live(lt, ui, kw["row0"])
        for t in (lt, kw["row0"], *(ui[k] for k in UI_INPUTS)):
            tensors[t.data_ptr()] = t.numel() * t.element_size()
        for i, (t, new) in enumerate(zip(hdr, outs, strict=True)):
            changed = int((t.view(torch.int32) != new.view(torch.int32)).sum())
            tensors[("hdr", len(tensors), i)] = (t.numel() + changed) * t.element_size()
        n_live = int(live.sum())
        n_srgb = mats["atlas_srgb"].shape[0]
        t = lt.clamp(min=0, max=ui["tri_cmd"].shape[0] - 1).long()
        slot = ui["tex_slot"][ui["tri_cmd"][t].long().clamp(0, ui["clip"].shape[0] - 1)]
        srgb = mats["atlas_srgb"][slot.long().clamp(0, n_srgb - 1)] > 0
        ops = n_live * (70 + 10 * (len(hdr) if lt.dim() == 3 else 1))
        taps = 0
        for k, channels, decoded in ((1, 1, 1), (2, 4, 3)):
            mask = live & (kind == k)
            o, tp = sampler_work(int(mask.sum()), int((mask & srgb).sum()), True, 1, False,
                                 channels, decoded)
            ops, taps = ops + o, taps + tp
        return ops, taps
    for a in (*args, *kw.values()):
        for t in (a.values() if isinstance(a, dict) else [a]):
            if isinstance(t, torch.Tensor):
                tensors[t.data_ptr()] = t.numel() * t.element_size()
    for i, t in enumerate(outs):
        tensors[("out", len(tensors), i)] = t.numel() * t.element_size()
    if counter == "s3":
        lt, ui, mats = args
        srgb = mats["atlas_srgb"][ui["tex_slot"].long().clamp(0, mats["atlas_srgb"].shape[0] - 1)]
        slot_srgb = srgb[ui["tri_cmd"][lt.clamp(min=0).long()].long()] > 0
        ops, taps = sampler_work(lt.numel(), int(slot_srgb.sum()), True, 1, False)
        return ops + lt.numel() * 70, taps
    tid = args[0]
    n = int((tid >= 0).sum())
    if counter == "s1":
        mode = int(args[4]["debug_mode"])
        lit = mode not in S1_CHANNELS
        channels = S1_LIT_CHANNELS if lit else S1_CHANNELS[mode]
    else:
        lit, channels = False, (1,)
    ops, taps = n * (115 + (60 if lit else 0)), 0
    for c in channels:
        o, t = sampler_work(n, 0, kw["trilinear"], kw["aniso"], kw["srgb_per_tap"], c)
        ops, taps = ops + o, taps + t
    return ops, taps


def kernel_resources(counter: str, kw: dict) -> dict:
    """Registers, spills, local and shared bytes and the host-computed
    blocks an SM of the kernel instantiation a phase-12 row ran
    (kernels.shade_info and the build's ptxas report)."""
    bf16 = kw.get("compute_dtype") == torch.bfloat16
    per_tap = bool(kw.get("srgb_per_tap", False))
    info = kernels.shade_info(counter, bf16, per_tap)
    name = {"s1": f"shade_kernelILb{int(bf16)}ELb{int(per_tap)}E",
            "s2": f"alpha_kernelILb{int(bf16)}E", "s3": "ui_kernel",
            "s3c": "ui_composite_kernel"}[counter]
    ptx = [v for k, v in kernels.ptxas_report().items() if name in k]
    if len(ptx) != 1:
        raise RuntimeError(f"build.log: {len(ptx)} ptxas reports for {name}")
    return dict(info, spill_stores=ptx[0]["spill_stores"], spill_loads=ptx[0]["spill_loads"])


def frame_shading_calls(renderer, sc, ui) -> dict:
    """Every shading call one frame of `sc` makes (after a frame that grows
    the capacities), by kind: {kind: [(args, kwargs)]}. The pipeline calls
    the fused S3 (S3C); S3 (shade_ui_layer) is called on the same layers
    as each fused call, since its row is held to its plain version too."""
    renderer.render_frame_device(sc, 0, ui=ui)  # grows the capacities
    with recorded_shading() as calls:
        renderer.render_frame_device(sc, 0, ui=ui)
    torch.cuda.synchronize()
    calls += [("S3", args[1:], kw) for kind, args, kw in calls if kind == "S3C"]
    return {kind: [(a, k) for c, a, k in calls if c == kind]
            for kind in sorted({c for c, _, _ in calls})}


def timed_shading(kind: str, mine: list):
    """A function that runs the recorded calls `mine` through their kernel,
    as phase 12 times them; the fused S3 updates copies of its HDR samples
    made once, here, so that no copy is timed."""
    if kind == "S3C":
        work = [([t.clone() for t in args[0]], args[1:], kw) for args, kw in mine]

        def run_fused():
            for hdr, rest, kw in work:
                ui_stage.shade_composite_ui(hdr, *rest, **kw)
        return run_fused

    def run():
        for args, kw in mine:
            run_shading(kind, args, kw, plain=False)
    return run


def ui_msaa_checks(frames_c, cfg_c, pol_c, dev, card) -> dict:
    """Phase 12 on scene C under RenderConfig.ui_msaa (the UI's coverage at
    the MSAA sample positions, layers [S, K, H, W]): the fused S3 and S3
    on the frame's UI layers, each bit-equal to its plain version."""
    r = trt.Renderer(frames_c.registry, replace(cfg_c, ui_msaa=True),
                     profiler=frames_c.profiler, overflow_policy=pol_c, device=dev)
    sc, ui = frames_c.next()
    out = {}
    for kind, mine in frame_shading_calls(r, sc, ui).items():
        if kind not in ("S3", "S3C"):
            continue
        counts = [compare(run_shading(kind, a, k, plain=False),
                          run_shading(kind, a, k, plain=True)) for a, k in mine]
        out[kind] = {"calls": len(mine), "shapes": [list(a[1 if kind == "S3C" else 0].shape)
                                                    for a, _ in mine],
                     **{c: sum(x[c] for x in counts) for c in ("values", "differing", "nan")}}
        if out[kind]["differing"]:
            raise RuntimeError(f"{kind} under ui_msaa: {out[kind]} differ from the plain version")
    if set(out) != {"S3", "S3C"}:
        raise RuntimeError(f"ui_msaa: the frame made no UI shade call: {sorted(out)}")
    print(f"shading: scene C under ui_msaa, {W}x{H}: "
          + " | ".join(f"{k} {v['shapes']}: {v['differing']} of {v['values']} values differ "
                       f"in bits" for k, v in out.items()) + f" | {card}", flush=True)
    del r
    return out


def shading_rows(scene, renderer, sc, ui, main_launches, card) -> list:
    """Phase 12 on one scene: records one frame's shading calls, holds each
    against its plain version (timed: plain_ms is that run's CUDA-event ms),
    and returns one kernels-line row a kernel with the frame's calls timed
    together."""
    rows = []
    for kind, mine in frame_shading_calls(renderer, sc, ui).items():
        counter = kind.lower()
        checks, plain_ms, work, tensors = [], 0.0, [0, 0], {}
        for args, kw in mine:
            got = run_shading(kind, args, kw, plain=False)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            want = run_shading(kind, args, kw, plain=True)
            e1.record()
            torch.cuda.synchronize()
            plain_ms += e0.elapsed_time(e1)
            checks.append(compare(got, want))
            if counter == "s2" and not torch.equal(got[1], want[1]):
                raise RuntimeError(f"S2 cutoffs differ on scene {scene}")
            if counter in ("s3", "s3c") and checks[-1]["differing"]:
                raise RuntimeError(f"{kind} on scene {scene}: {checks[-1]['differing']} "
                                   f"values differ in bits from the plain version")
            work = [x + y for x, y in zip(work, shade_work(counter, args, kw, got, tensors))]
            del got, want
        run = timed_shading(kind, mine)

        (ops, taps), n_bytes = work, sum(tensors.values())
        res = kernel_resources(counter, mine[0][1])
        ops_ms, bytes_ms = ops / FLOPS_PER_S * 1e3, n_bytes / BYTES_PER_S * 1e3
        entry, replaces = SHADE_KERNELS[counter]
        counts = {k: sum(c[k] for c in checks) for k in ("values", "differing",
                                                         "over_fine", "nan")}
        row = dict(
            name=f"{entry} (scene {scene}, {W}x{H}, the frame's {len(mine)} calls, "
                 f"shapes {[tuple(a[1 if kind == 'S3C' else 0].shape) for a, _ in mine]})",
            route="cuda", source="renderer_tpu_torch/csrc/shade.cu", replaces=replaces,
            launches=main_launches[counter],
            max_abs_err=max(c["max_abs_err"] for c in checks), **counts,
            # a row's 10 runs enqueue up to 140 launches, each through the
            # wrapper's checks: the longer spin of engine.stats (~0.1 s)
            ms=cuda_ms(run, 10), ms_queued=queued_ms(run, 10, engine_stats.SPIN_CYCLES),
            plain_ms=plain_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=None, launches_per_frame=None, operations=ops, bytes=n_bytes,
            texel_taps=taps, resources=res, scene=scene, counter=counter)
        row["share"] = row["bound_ms"] / row["ms"]
        covered = ""
        if counter == "s2":  # the share of the elements S2 was given that it shades
            tids = [a[0] for a, _ in mine]
            row["s2_covered_share"] = (sum(int((t >= 0).sum()) for t in tids)
                                       / sum(t.numel() for t in tids))
            covered = f", s2_covered_share {row['s2_covered_share']:.4f}"
        print(f"kernel: {row['name']}: vs plain max_abs_err {row['max_abs_err']:.3e}, "
              f"{counts['differing']} of {counts['values']} values differ in bits, "
              f"{counts['over_fine']} by more than 2^-18, {counts['nan']} NaN | "
              f"{row['ms']:.3f} ms (queued {row['ms_queued']:.3f}) vs plain "
              f"{plain_ms:.1f} ms | bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{ops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB, {taps / 1e9:.3f} G texel "
              f"taps{covered}), share {row['share']:.1%} ({row['bound_ms'] / row['ms_queued']:.1%} "
              f"queued) | {res['registers']} registers, spills {res['spill_stores']} B "
              f"stored / {res['spill_loads']} B loaded, {res['local_bytes']} B local, "
              f"{res['shared_bytes']} B shared a block, {res['blocks_per_sm']} blocks an "
              f"SM of {res['sms']} | {card}", flush=True)
        rows.append(row)
    return rows


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _last_match(tid: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Index of the last candidate equal to tid ([..., h, w] against
    [n, h, w]), -1 where none is (`_select`)."""
    idx = torch.full(tid.shape, -1, dtype=torch.int64, device=tid.device)
    for j in range(cands.shape[0]):
        idx = torch.where(tid == cands[j], j, idx)
    return idx


def _distinct_refs(idx: torch.Tensor, n: int) -> int:
    """Distinct (candidate, pixel) pairs that the [..., h, w] indices `idx`
    (< 0: none) reference."""
    flat = idx.reshape(-1, *idx.shape[-2:])
    return sum(int((flat == j).any(0).sum()) for j in range(n))


def candidate_work(kind: str, args: tuple, kw: dict) -> tuple[int, int]:
    """(operations, bytes) one recorded candidate call needs on its data.
    Bytes: each value the function must read, once, and each value it
    must write, once (csrc/candidates.cu reads no more):
    - C1: a pixel's slots up to the one that fills its candidate list (all
      of them when it never fills, or when counting), the candidates (and
      the count) written;
    - C2: the masked ids and the candidates in full; alpha and cutoff of
      each (candidate, pixel) a live layer matches; a sample's solid id
      and depth (the depth read, both written) where a layer passes; the
      clamp mask written where a live layer matches no candidate;
    - C3: the solid ids, both candidate lists and the blended ids in full;
      the rgb of each (candidate, pixel) a covered sample selects and the
      rgba of each one a blended layer selects (candidate 0 where it
      matches none); the HDR samples written; the clamp mask as in C2.
    Operations: at most the compares and arithmetic the kernel makes (C1
    a compare with -1 and one with each candidate a slot, and, counting,
    each earlier slot; C2 a match and three compares a slot; C3 a match a
    solid sample and a match and ten f32 operations a blended layer), an
    upper count, below the bytes' time on every call of these scenes."""
    if kind == "C1":
        slots, n = args
        n_slots, h, w = slots.shape
        count = kw.get("count", False)
        ops = h * w * n_slots * (n + 1 + ((n_slots - 1) // 2 if count else 0))
        if count:
            reads = n_slots * h * w
        else:
            cands = candidates.extract_candidates(slots, n)
            hit = slots == cands[n - 1]
            filled = hit.any(0) & (cands[n - 1] != -2)
            reads = int(torch.where(filled, hit.int().argmax(0) + 1, n_slots).sum())
        return ops, 4 * reads + (n + int(count)) * h * w * 4
    if kind == "C2":
        lt, lz, cands, alpha, cutoff, solid_tid, solid_z, clamp = args
        n_s, k, h, w = lt.shape
        n = cands.shape[0]
        idx = _last_match(lt, cands)
        live = lt >= 0
        matched = live & (idx >= 0)
        pix = torch.arange(h * w, device=lt.device)
        sel = idx.clamp(min=0).reshape(n_s * k, h * w)
        a = alpha.reshape(n, h * w)[sel, pix].reshape(lt.shape)
        co = cutoff.reshape(n, h * w)[sel, pix].reshape(lt.shape)
        floor = torch.tensor([(s + 0.5) / n_s if n_s > 1 else 0.0 for s in range(n_s)],
                             dtype=torch.float32, device=lt.device).reshape(n_s, 1, 1, 1)
        moved = (matched & (a > co) & (a > floor)).any(1)
        clamped = (live & (idx < 0)).any((0, 1))
        n_bytes = (_nbytes(lt, cands) + 8 * _distinct_refs(torch.where(matched, idx, -1), n)
                   + 12 * int(moved.sum()) + int(clamped.sum()))
        return h * w * n_s * k * (n + 3), n_bytes
    solid_tid, cands_s, shaded_s, clamp, *blended = (*args, *kw.values())
    lt_b, cands_b, shaded_b = (blended + [None] * 3)[:3]
    n_s, h, w = solid_tid.shape
    idx_s = _last_match(solid_tid, cands_s).clamp(min=0)
    covered = solid_tid >= 0
    clamped = (covered & (_last_match(solid_tid, cands_s) < 0)).any(0)
    n_bytes = (_nbytes(solid_tid, cands_s, lt_b, cands_b) + n_s * h * w * 12
               + 12 * _distinct_refs(torch.where(covered, idx_s, -1), cands_s.shape[0]))
    ops = h * w * n_s * cands_s.shape[0]
    if lt_b is not None:
        idx_b = _last_match(lt_b, cands_b)
        clamped |= ((lt_b >= 0) & (idx_b < 0)).any((0, 1))
        n_bytes += 16 * _distinct_refs(idx_b.clamp(min=0), cands_b.shape[0])
        ops += h * w * n_s * lt_b.shape[1] * (cands_b.shape[0] + 10)
    return ops, n_bytes + int(clamped.sum())


def candidate_resources(fn: str, ncs: set) -> dict:
    """Registers (the most), stack and spill bytes (summed) of the
    instantiations `ncs` of csrc/candidates.cu's `fn` (the build's ptxas
    report)."""
    report = kernels.ptxas_report()
    got = [v for k, v in report.items() if any(f"{len(fn)}{fn}ILi{nc}E" in k for nc in ncs)]
    if len(got) != len(ncs):
        raise RuntimeError(f"build.log: {len(got)} ptxas reports for {fn} {sorted(ncs)}")
    return dict(registers=max(v["registers"] for v in got),
                shared=max(v["shared"] for v in got),
                **{key: sum(v[key] for v in got)
                   for key in ("stack", "spill_stores", "spill_loads")})


def _bucket(n: int) -> int:
    """csrc/candidates.cu's instantiation for n candidates (RC_DISPATCH)."""
    return next(nc for nc in (1, 2, 4, 8, 16, 24) if n <= nc)


def candidate_rows(scene, renderer, sc, ui, main_launches, card) -> list:
    """Phase 12's candidate kernels on one scene: records one frame's calls
    of C1-C3, runs each through the kernel and the plain version (0 values
    may differ; plain_ms is that run's CUDA-event ms), and returns one
    kernels-line row a kernel with the frame's calls timed together."""
    with candidate_check.recorded_candidates() as calls:
        renderer.render_frame_device(sc, 0, ui=ui)
    torch.cuda.synchronize()
    rows = []
    for counter, (entry, replaces, fn) in CANDIDATE_KERNELS.items():
        kind = counter.upper()
        mine = [(a, k) for c, a, k in calls if c == kind]
        if not mine:
            continue
        counts = {"values": 0, "differing": 0, "nan": 0, "max_abs_err": 0.0}
        plain_ms, ops, n_bytes, ncs = 0.0, 0, 0, set()
        for args, kw in mine:
            got = candidate_check.run_candidates(kind, args, kw, plain=False)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            want = candidate_check.run_candidates(kind, args, kw, plain=True)
            e1.record()
            torch.cuda.synchronize()
            plain_ms += e0.elapsed_time(e1)
            for key, v in candidate_check.compare(got, want).items():
                counts[key] = max(counts[key], v) if key == "max_abs_err" else counts[key] + v
            o, b = candidate_work(kind, args, kw)
            ops, n_bytes = ops + o, n_bytes + b
            if kind == "C3":
                blended = kw.get("cands_b", args[5] if len(args) > 5 else None)
                ncs.add(0 if blended is None else _bucket(blended.shape[0]))
            else:
                ncs.add(_bucket(args[1] if kind == "C1" else args[2].shape[0]))
            del got, want
        if counts["differing"]:
            raise RuntimeError(f"{kind} on scene {scene}: {counts['differing']} of "
                               f"{counts['values']} values differ from the plain version")
        # the in-place tensors copied once, so that no copy is timed (a
        # repeated merge or resolve stores the same values)
        name, _, inplace = candidate_check.ENTRY_POINTS[kind]
        work = [(tuple(a.clone() if i in inplace else a for i, a in enumerate(args)), kw)
                for args, kw in mine]
        entry_fn = getattr(candidates, name)

        def run(work=work, entry_fn=entry_fn):
            for args, kw in work:
                entry_fn(*args, **kw)

        res = candidate_resources(fn, ncs)
        if kind == "C2":  # its tile, ring of staged ids and blocks an SM
            lt, cands = mine[0][0][0], mine[0][0][2]
            res["launch"] = kernels.merge_info(lt.shape[0], lt.shape[1], cands.shape[0],
                                               lt.shape[2] * lt.shape[3])
        ops_ms, bytes_ms = ops / FLOPS_PER_S * 1e3, n_bytes / BYTES_PER_S * 1e3
        shapes = [tuple(a[0].shape) for a, _ in mine]
        row = dict(
            name=f"{entry} (scene {scene}, {W}x{H}, the frame's {len(mine)} calls, "
                 f"first inputs {shapes})",
            route="cuda", source="renderer_tpu_torch/csrc/candidates.cu", replaces=replaces,
            launches=main_launches[counter], **counts,
            ms=cuda_ms(run, 10), ms_queued=queued_ms(run, 10), plain_ms=plain_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=None, launches_per_frame=None, operations=ops, bytes=n_bytes,
            resources=res, scene=scene, counter=counter)
        row["share"] = row["bound_ms"] / row["ms"]
        print(f"kernel: {row['name']}: {counts['differing']} of {counts['values']} values "
              f"differ in bits from the plain version ({counts['nan']} NaN; max_abs_err "
              f"{counts['max_abs_err']:.3e}) | "
              f"{row['ms']:.4f} ms (queued {row['ms_queued']:.4f}) vs plain "
              f"{plain_ms:.2f} ms | bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{n_bytes / 1e6:.1f} MB, at most {ops / 1e9:.2f} G operations), share "
              f"{row['share']:.1%} ({row['bound_ms'] / row['ms_queued']:.1%} queued) | "
              f"{res['registers']} registers, {res['stack']} B stack, spills "
              f"{res['spill_stores']} B stored / {res['spill_loads']} B loaded, "
              f"{res['shared']} B static shared (instantiations {sorted(ncs)})"
              + (f", launch {res['launch']}" if "launch" in res else "")
              + f" | {card}", flush=True)
        rows.append(row)
    return rows


def frontend_rows(scene, renderer, sc, ui, main_launches, card, floors: list) -> list:
    """Phase 12's front-end kernels on one scene: records one frame's
    setup and binning calls (tools/frontend_probe), holds F1-F4 to the
    plain versions bit for bit on each, times each step queued, the launch
    floor (frontend_probe.launch_floor_ms, appended to `floors`) and each
    call as issued, and returns one kernels-line row a kernel with the
    frame's calls summed."""
    calls = frontend_probe.frame_calls(renderer, sc, ui)
    report = kernels.ptxas_report()
    steps: dict[str, dict] = {}
    plain_ms = {"F1": 0.0, "BIN": 0.0}
    for i, (kind, args, kw) in enumerate(calls):
        what = f"scene {scene}{' UI pass' if i >= 2 else ''} {kind}"
        got = frontend_probe.run_frontend(kind, args, kw, plain=False)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        want = frontend_probe.run_frontend(kind, args, kw, plain=True)
        e1.record()
        torch.cuda.synchronize()
        plain = e0.elapsed_time(e1)
        plain_ms[kind] += plain
        diff = frontend_probe.compare(got, want)
        if diff["differing"]:
            raise RuntimeError(f"{what}: {diff['differing']} of {diff['values']} values "
                               "differ in bits from the plain version")
        work = frontend_probe.frontend_work(kind, args, kw, want)
        queued = frontend_probe.step_ms(kind, args, kw)
        floor = frontend_probe.launch_floor_ms(kind, args, kw)
        floors.append({"scene": scene, "call": what, **floor})
        print(f"launch floor: {what}: an empty kernel queued as a step, " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in floor.items()) + f" | {card}", flush=True)
        issued = cuda_ms(lambda: frontend_probe.run_frontend(kind, args, kw, False), 10)
        over = {k: queued[k] - floor[f] for k, f in frontend_probe.OVER_FLOOR.items()
                if k in queued}
        floors[-1]["over_floor_ms"] = over
        print(f"frontend: {what}: {diff['values']} values bit-equal ({diff['nan']} NaN) | "
              f"issued {issued:.4f} ms, steps queued {sum(queued.values()):.4f} ms, plain "
              f"{plain:.3f} ms | " + ", ".join(
                  f"{k} {v:.4f} ms (bound {work[k] / BYTES_PER_S * 1e3:.4f})"
                  for k, v in queued.items()) + " | " + ", ".join(
                  f"{k} {v:.4f} ms over {frontend_probe.OVER_FLOOR[k]} floor"
                  for k, v in over.items()) + f" | {card}", flush=True)
        for k, v in queued.items():
            acc = steps.setdefault(k, {"ms": 0.0, "bytes": 0, "kind": kind, "calls": 0})
            acc["ms"] += v
            acc["bytes"] += work[k]
            acc["calls"] += 1
        del got, want
    rows = []
    for step, (counter, replaces) in FRONTEND_KERNELS.items():
        acc = steps[step]
        res = frontend_probe.resources(report, step)
        bound_ms = acc["bytes"] / BYTES_PER_S * 1e3
        row = dict(
            name=f"{step} (scene {scene}, {W}x{H}, the frame's {acc['calls']} calls)",
            route="cuda", source="renderer_tpu_torch/csrc/frontend.cu", replaces=replaces,
            launches=main_launches[counter], max_abs_err=0.0, ms=acc["ms"],
            ms_queued=acc["ms"], plain_ms=plain_ms[acc["kind"]], bound_ms=bound_ms,
            bound_by="bytes", library_ms=None, launches_per_frame=None,
            bytes=acc["bytes"], resources=res,
            plain_of=("triangle_setup_plain" if acc["kind"] == "F1"
                      else "bin_triangle_classes_plain (the whole binning call)"),
            scene=scene, counter=counter)
        row["share"] = bound_ms / acc["ms"]
        print(f"kernel: {row['name']}: bit-equal | {acc['ms']:.4f} ms queued vs plain "
              f"{row['plain_ms']:.3f} ms ({row['plain_of']}) | bound {bound_ms:.4f} ms "
              f"(bytes: {acc['bytes'] / 1e6:.2f} MB), share {row['share']:.1%} | "
              f"{res['registers']} registers, {res['stack']} B stack, spills "
              f"{res['spill_stores']} B stored / {res['spill_loads']} B loaded, "
              f"{res['shared']} B static shared | {card}", flush=True)
        rows.append(row)
    for step in binning.STEPS:
        if step[1] is None:
            acc = steps[step[0]]
            print(f"frontend: library step {step[0]} (scene {scene}, {acc['calls']} calls): "
                  f"{acc['ms']:.4f} ms queued, bound {acc['bytes'] / BYTES_PER_S * 1e3:.4f} "
                  f"ms | {card}", flush=True)
    return rows


def phase12(dev, card, main_launches, frame_ms) -> tuple[list, dict]:
    """Phase 12 (module docstring): the shading kernels against their plain
    versions on scenes A, B and C, the frames replayed as graphs, and one
    profiled frame of B and C."""
    t0 = time.perf_counter()
    reg_a, sc_a, cfg_a, pol_a = scene_a()
    reg_b, sc_b, cfg_b, pol_b = scene_b()
    frames_c, cfg_c, pol_c = scene_c()
    ra = trt.Renderer(reg_a, cfg_a, overflow_policy=pol_a, device=dev)
    rb = trt.Renderer(reg_b, cfg_b, overflow_policy=pol_b, device=dev)
    rc = trt.Renderer(frames_c.registry, cfg_c, profiler=frames_c.profiler,
                      overflow_policy=pol_c, device=dev)
    sc_c, ui_c = frames_c.next()
    rows, floors = [], []
    for name, r, sc, ui in (("A", ra, sc_a, None), ("B", rb, sc_b, None),
                            ("C", rc, sc_c, ui_c)):
        rows += shading_rows(name, r, sc, ui, main_launches, card)
        rows += candidate_rows(name, r, sc, ui, main_launches, card)
        rows += frontend_rows(name, r, sc, ui, main_launches, card, floors)
    ui_msaa = ui_msaa_checks(frames_c, cfg_c, pol_c, dev, card)
    reset_counters()  # the tool's own launches (S3 among them)
    ui_pass = frame_profile.ui_pass_ms(rc, ui_c)
    ui_pass_launches = counters()
    print(f"shading: scene C's UI pass: raster {ui_pass['raster']:.3f} ms (host-paced), "
          f"the fused S3 {ui_pass['fused']:.3f} ms (device, queued) | {card}", flush=True)
    replay = {name: engine_stats.fused_frame_ms(r, sc, iters=REPLAYS)
              for name, r, sc in (("A", ra, sc_a), ("B", rb, sc_b), ("C", rc, sc_c))}
    profiles = {"B": frame_profile.profile_frame(rb, sc_b),
                "C": frame_profile.profile_frame(rc, sc_c, ui_c)}
    out = {"replayed_frame_ms": replay, "eager_frame_ms": frame_ms,
           "launch_floor_ms": floors,
           "profiles": profiles, "ui_msaa": ui_msaa, "ui_pass_ms": ui_pass,
           "ui_pass_launches": ui_pass_launches, "seconds": time.perf_counter() - t0}
    print(f"shading: frames replayed as CUDA graphs (median of {REPLAYS}, no UI pass) "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in replay.items())
          + " vs eager (phase 6) " + ", ".join(f"{k} {v:.2f} ms" for k, v in frame_ms.items())
          + f" | {card}", flush=True)
    for name, p in profiles.items():
        own = ", ".join(f"{k} {v['device_ms']:.3f} ms x{v['launches']} "
                        f"({v['share']:.1%})" for k, v in p["own_kernels"].items())
        was_n, was_ms = TORCH_LOOPS_PROFILE[name]
        print(f"shading: profiled eager frame {name}: {p['kernels_and_copies']} kernels "
              f"and copies (loops as torch ops: {was_n}), device busy "
              f"{p['device_busy_ms']:.2f} ms (loops as torch ops: {was_ms:.2f}) of "
              f"{p['profiled_frame_ms']:.2f} ms | {own} (S2 covered share "
              f"{p['own_kernels']['S2']['covered_share']}) | top ops "
              f"{[(k, round(ms, 3), n) for k, ms, n in p['top_ops_device_ms'][:6]]} "
              f"| traffic {p['traffic']} | {card}", flush=True)
    print(f"phase 12 took {out['seconds']:.1f} s", flush=True)
    del ra, rb, rc
    torch.cuda.empty_cache()
    return rows, out


def phase13(dev, card, frame_ms) -> tuple[dict, dict]:
    """Phase 13 (module docstring): the port's bench on the card. Returns
    the three JSON lines and the launches of the three runs."""
    from renderer_tpu_torch.tools import bench

    t0 = time.perf_counter()
    keys = {"metric", "value", "unit", "vs_baseline", "dropped_pairs", "dropped_rows",
            "overflow_checked", "measures", "scene", "frames", "passes_fps", "frame_ms",
            "dropped_other", "shade_clamped_px", "device"}
    reset_counters()
    runs = {}
    for scene, replay in (("default", False), ("mini-sandbox", False), ("patch-wall", True)):
        out = io.StringIO()
        runs[scene] = bench.run(BENCH_FRAMES[scene], scene=scene, replay=replay, device=dev,
                                out=out)
        line = json.loads(out.getvalue().splitlines()[-1])
        print(f"bench: {json.dumps(line)} | {card}", flush=True)
        if set(line) != keys or runs[scene].dropped:
            raise RuntimeError(f"bench: {scene}: keys {sorted(set(line) ^ keys)} differ, or "
                               f"work was dropped / not checked: {line}")
    launches = counters()
    missing = [k for k in MAIN_PATH_KERNELS if launches[k] < 1]
    if missing:
        raise RuntimeError(f"bench: {missing} not launched in phase 13: {launches}")
    mini = runs["mini-sandbox"]
    sc, ui = mini.frames[-1]
    if not np.array_equal(mini.images.cpu().numpy(), mini.renderer.render_frame(sc, 0, ui=ui)):
        raise RuntimeError("bench: the mini-sandbox's last frame differs from render_frame")
    wall = runs["patch-wall"]
    differing = [k for k, (sc, _) in enumerate(wall.frames)
                 if not torch.equal(wall.images[k], wall.renderer.render_frame_device(sc, 0))]
    if differing:
        raise RuntimeError(f"bench: replayed frames {differing} differ from the eager frames")
    out = {name: r.line for name, r in runs.items()}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    fm = mini.line["frame_ms"]
    print(f"bench: the mini-sandbox's last frame = render_frame, {len(wall.frames)} replayed "
          f"patch-wall frames = eager | eager mini-sandbox frame_ms median {fm['median']:.2f} "
          f"p90 {fm['p90']:.2f} (n {fm['n']}, intervals of CUDA events after each frame) vs "
          f"phase 6's eager frame C {frame_ms['C']:.2f} ms (events around each frame, synced) "
          f"| launches {launches} | {card}", flush=True)
    print(f"phase 13 took {out['seconds']:.1f} s", flush=True)
    del runs, mini, wall
    torch.cuda.empty_cache()
    return out, launches


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls as
    the host issues them (CUDA events; the host's launch gaps included)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int, cycles: int = SPIN_CYCLES) -> float:
    """Mean device milliseconds of fn() over `reps` calls that the host
    enqueues while a spin kernel of `cycles` holds the stream, so the
    events time the device's work without the host's launch gaps. Raises
    when the spin had ended before the last call was enqueued (the time
    would then be host-paced)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with engine_stats.held_stream(cycles):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> float:
    """Largest |difference| between two output tuples; integer outputs must
    be equal and floating ones bit-equal, else raise."""
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise RuntimeError("kernel and plain version differ in f32 bits")
            err = max(err, float((g - w).abs().max()))
        elif not torch.equal(g, w):
            raise RuntimeError("kernel and plain version differ in ids/counts")
    return err


def main() -> int:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    script_t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind} x{torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    nvcc_s = profiling.setup_seconds("setup.nvcc")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {nvcc_s:.1f} s) -> {kernels.library_path().name}", flush=True)
    host = native.status()  # builds the host library (g++)
    if host["path"] != "native":
        raise RuntimeError(f"build: the host library took the numpy path: {host}")
    print(f"build: host library {host['build_seconds']:.1f} s ({host['reason']}, "
          f"g++ {' '.join(native.CXX_FLAGS)}) -> {Path(host['library']).name}", flush=True)

    # -- 3. main path: Renderer.render_frame on scenes A, B and C ----------
    reg_a, sc_a, cfg_a, pol_a = scene_a()
    reg_b, sc_b, cfg_b, pol_b = scene_b()
    frames_c, cfg_c, pol_c = scene_c()
    registries = {"A": reg_a, "B": reg_b, "C": frames_c.registry}
    ra = trt.Renderer(reg_a, cfg_a, overflow_policy=pol_a, device=dev)
    rb = trt.Renderer(reg_b, cfg_b, overflow_policy=pol_b, device=dev)
    rc = trt.Renderer(frames_c.registry, cfg_c, profiler=frames_c.profiler,
                      overflow_policy=pol_c, device=dev)
    sc_c, ui_c = frames_c.next()
    reset_counters()
    t0 = time.perf_counter()
    img_a, stats_a, moved_a = render_checked(ra, sc_a, "A")
    img_b, stats_b, moved_b = render_checked(rb, sc_b, "B")
    img_c, stats_c, moved_c = render_checked(rc, sc_c, "C", ui=ui_c)
    torch.cuda.synchronize()
    main_launches = counters()
    first_s = time.perf_counter() - t0
    for name, moved in (("A", moved_a), ("B", moved_b), ("C", moved_c)):
        if moved["k1"] < 1 or moved["s1"] < 1 or moved["c1"] < 1 or moved["c3"] < 1:
            raise RuntimeError(f"K1, S1, C1 or C3 not launched for {name}: {moved}")
    for name, moved in (("B", moved_b), ("C", moved_c)):
        if (moved["k2_masked"] < 1 or moved["k2_blended"] < 1 or moved["s2"] < 1
                or moved["c2"] < 1):
            raise RuntimeError(f"K2 (both modes), S2 or C2 not launched for {name}: {moved}")
    if moved_c["k2_ui"] < 1 or moved_c["s3c"] < 1:
        raise RuntimeError(f"K2's UI launch or the fused S3 not made for C: {moved_c}")
    for name, moved in (("A", moved_a), ("B", moved_b), ("C", moved_c)):
        # C's UI pass runs setup and binning a second time
        if any(moved[k] < (2 if name == "C" else 1) for k in FRONTEND):
            raise RuntimeError(f"F1-F4 not launched in every pass of {name}: {moved}")
    print(f"main path: A {moved_a} B {moved_b} C {moved_c} first frames "
          f"{first_s:.1f} s | A total_pairs {stats_a['total_pairs']} | B total_pairs "
          f"{stats_b['total_pairs']} masked_demand {stats_b['masked_demand_max']} "
          f"blended_demand {stats_b['blended_demand_max']} -> mask_layers "
          f"{rb.config.mask_layers} blend_layers {rb.config.blend_layers} "
          f"pair_capacity {rb.config.pair_capacity} | C UI triangles "
          f"{int(ui_c.pack()['counts'][0])} ui_demand {stats_c['ui_demand_max']} -> ui_layers "
          f"{rc.config.ui_layers}, {stats_c['total_pairs']} scene pairs", flush=True)

    # -- 4. kernels against their plain versions, on the scenes' bins -----
    # K1 on both scenes; K2 on scene B at K=4 and at the layer counts the
    # frame grew to
    results = scene_rows("B", rb, sc_b, {
        "masked": sorted({4, rb.config.mask_layers}),
        "blended": sorted({4, rb.config.blend_layers})}, main_launches)
    results += scene_rows("A", ra, sc_a, {"masked": [], "blended": []},
                          main_launches)
    results += ui_rows(rc, ui_c, main_launches)
    for row in results:
        print_kernel_row(row, card)

    # -- 5. goldens on the card -------------------------------------------
    golden_checks(dev)

    # -- 6. frame timing ---------------------------------------------------
    # scene C's host work of a frame (game time, animation, skinning, the UI
    # window) runs before the first event and is not in the frame's time
    def fixed(sc):
        return lambda: (sc, None)

    frame_ms, per_frame = {}, {}
    for name, r, next_frame in (("A", ra, fixed(sc_a)), ("B", rb, fixed(sc_b)),
                                ("C", rc, frames_c.next)):
        times, host = [], []
        n = FRAMES[name]
        reset_counters()
        for _ in range(n):
            sc, ui = next_frame()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            r.render_frame_device(sc, 0, ui=ui)
            e1.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            times.append(e0.elapsed_time(e1))
        frame_ms[name] = statistics.median(times)
        per_frame[name] = {k: v / n for k, v in counters().items()}
        print(f"frame {name}: median {frame_ms[name]:.2f} ms (CUDA events, "
              f"{n} frames; host median {statistics.median(host):.2f} ms, "
              f"min {min(times):.2f} max {max(times):.2f}) | launches a frame "
              f"{per_frame[name]} | {card}", flush=True)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    # -- 7. the asset path: BC7, ntex, the device atlas, the loader, run_loop
    assets = asset_checks(dev, registries, card)

    # -- 8. the multi-frame path: flythrough through one CUDA graph --------
    frames = frames_checks(dev, rb, sc_b, card)
    del ra, rb, rc
    torch.cuda.empty_cache()

    # -- 9. the config matrix and the frame tools -------------------------
    tools, k1_row8, tool_launches = tools_checks(dev, card)
    results.append(k1_row8)
    per_frame["8"] = tool_launches.pop("9 configs row 8 frame")
    torch.cuda.empty_cache()

    # -- 10. the host library, make_ntex and the mesh ----------------------
    reset_counters()
    extra, mesh_launches = phase10(dev, card)

    # -- 11. JPEG: decode, a GLB with an embedded JPEG, make_ntex ----------
    jpeg_out, glb_launches = phase11(dev, card)

    # -- 13. the port's bench, before phase 12: its torch.profiler leaves
    # the process's host dispatch slower, which the bench would measure ---
    bench_out, bench_launches = phase13(dev, card, frame_ms)

    # -- 12. the shading kernels on scenes A-C, replayed frames, profiles --
    shade_rows, shading = phase12(dev, card, main_launches, frame_ms)
    results += shade_rows

    phases = {"3 main path": main_launches, "7 run_loop": assets["run_loop_launches"],
              "8 flythrough": frames["launches"], **tool_launches,
              "10 mesh": mesh_launches, "11 glb": glb_launches,
              "12 frame_profile.ui_pass_ms": shading["ui_pass_launches"],
              "13 bench": bench_launches}
    for row in results:
        counter = row.pop("counter")
        row["launches_per_frame"] = per_frame[row.pop("scene")][counter]
        row["launches_by_phase"] = {name: n[counter] for name, n in phases.items()}
        for key in ("pairs", "n_s", "dense_ms"):
            row.pop(key, None)
    print(f"chip_smoke: phases 1-13 took {time.perf_counter() - script_t0:.1f} s", flush=True)
    print(json.dumps({"frame_ms": frame_ms, "card": card}))
    print(json.dumps({"assets": assets, "card": card}))
    print(json.dumps({"frames": frames, "card": card}))
    print(json.dumps({"tools": tools, "card": card}))
    print(json.dumps({"phase10": extra, "card": card}))
    print(json.dumps({"phase11": jpeg_out, "card": card}))
    print(json.dumps({"phase12": shading, "card": card}))
    print(json.dumps({"phase13": bench_out, "card": card}))
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
