"""Probe of kernel K1's pixels a thread (P) and copy stages on one NVIDIA GPU.

Builds csrc/raster_kernel.cu once for each (P, STAGES) variant at each
sample count, in a temporary directory (the dispatch line and the STAGES
constant edited, everything else as built by renderer_tpu_torch.kernels),
and times every variant on the bins of chip_smoke.py's two scenes against
the library's own kernel, with the share of (pair, footprint) blocks the
footprint rejection keeps and the spread of bin sizes over tiles. Each
variant must be bit-equal to the library's kernel.

    python3 -m renderer_tpu_torch.tools.k1_probe
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
import renderer_tpu_torch as trt
from renderer_tpu_torch import kernels
from renderer_tpu_torch.raster import raster_kernel
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS

VARIANTS = ((1, 2), (2, 2), (4, 2), (1, 3), (1, 4))  # (P, STAGES)


def _edit(text: str, pattern: str, repl: str) -> str:
    text, n = re.subn(pattern, repl, text)
    assert n == 1, f"{pattern!r} not found"
    return text


def build(tmp: Path, n_s: int, p: int, stages: int):
    """nvcc command and library path of raster_kernel.cu with S = n_s served
    by P = p pixels a thread and `stages` chunk buffers."""
    d = tmp / f"s{n_s}p{p}st{stages}"
    d.mkdir()
    (d / "raster_kernel.cu").write_text(_edit(
        (kernels.CSRC / "raster_kernel.cu").read_text(),
        rf"RT_CASE\({n_s}, \d\)", f"RT_CASE({n_s}, {p})"))
    (d / "raster_common.cuh").write_text(_edit(
        (kernels.CSRC / "raster_common.cuh").read_text(),
        r"constexpr int STAGES = \d+;", f"constexpr int STAGES = {stages};"))
    so = d / "k1.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
           str(d / "raster_kernel.cu")]
    return cmd, so


def entry(so: Path):
    fn = ctypes.CDLL(str(so)).rt_rasterize_binned
    fn.argtypes = list(kernels._SIGNATURES["rt_rasterize_binned"])
    fn.restype = ctypes.c_int
    return fn


def launch(fn, b, s, c, cfg, spos):
    n_s = len(spos)
    depth = torch.empty((n_s, cfg.padded_height, cfg.padded_width),
                        dtype=torch.float32, device=b.device)
    tid = torch.empty_like(depth, dtype=torch.int32)
    err = fn(b.data_ptr(), b.shape[1], s.data_ptr(), c.data_ptr(),
             depth.data_ptr(), tid.data_ptr(), cfg.tiles_x * cfg.tiles_y,
             cfg.tiles_x, cfg.tile_h, cfg.tile_w, cfg.padded_height,
             cfg.padded_width, 0, 1, n_s, kernels.sample_xy(spos),
             kernels.current_stream())
    kernels.check_launch("probe", err)
    return depth, tid


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe: torch.cuda.is_available() is False")
    card = cs.card_line()
    print(card, flush=True)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="k1_probe", dir=kernels.BUILD_DIR))
    try:
        return _run(tmp, card)
    finally:
        shutil.rmtree(tmp)


def _run(tmp: Path, card: str) -> int:
    builds = {(n_s, *v): build(tmp, n_s, *v) for n_s in (1, 4) for v in VARIANTS}
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
             for k, (cmd, _) in builds.items()}
    for k, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {k}: {proc.stderr.read()[-2000:]}")
    for name, make in (("A", cs.scene_a), ("B", cs.scene_b)):
        reg, sc, cfg, pol = make()
        r = trt.Renderer(reg, cfg, overflow_policy=pol)
        r.render_frame(sc, 0)
        b, s, c = cs.scene_bins(r, sc, name)
        cfg = r.config
        spos = STANDARD_SAMPLE_POSITIONS[cfg.msaa_samples]
        n_s = len(spos)
        counts = sorted(c[0].tolist())
        print(f"scene {name}: S={n_s}, {sum(counts)} opaque pairs over "
              f"{len(counts)} tiles; bin sizes median {statistics.median(counts)}, "
              f"p90 {counts[int(0.9 * len(counts))]}, max {counts[-1]}", flush=True)
        kw = dict(padded_height=cfg.padded_height, padded_width=cfg.padded_width,
                  tile_h=cfg.tile_h, tile_w=cfg.tile_w, sample_positions=spos)
        want = raster_kernel.rasterize_binned(b, s[0], c[0], **kw)
        lib_ms = cs.cuda_ms(lambda: raster_kernel.rasterize_binned(b, s[0], c[0], **kw), 10)
        print(f"  library kernel: {lib_ms:.3f} ms | {card}", flush=True)
        for p, stages in VARIANTS:
            fn = entry(builds[(n_s, p, stages)][1])
            got = launch(fn, b, s[0], c[0], cfg, spos)
            cs.max_abs_err(got, want)
            ms = cs.cuda_ms(lambda: launch(fn, b, s[0], c[0], cfg, spos), 10)
            kept = raster_kernel.footprint_keep(
                b, s[0], c[0], None, fp_w=8 * p, fp_h=4, samples_per_block=n_s, **kw)
            print(f"  P={p} (footprint {8 * p}x4), STAGES={stages}: {ms:.3f} ms, tests_kept "
                  f"{float(kept.float().mean()):.4f}, bit-equal | {card}", flush=True)
        del b, s, c, r
    return 0


if __name__ == "__main__":
    sys.exit(main())
