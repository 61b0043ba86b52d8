"""Build and bind the hand-written CUDA kernels (renderer_tpu_torch/csrc/*.cu).

The sources are compiled with nvcc for Hopper (sm_90a), one nvcc per
source, all started together, and linked into one shared library with a
plain C interface, at first use, into `build/kernels/` under the repository
root, and loaded with ctypes. The library name carries a digest of the
sources and flags, so an edited kernel is rebuilt and a stale one is never
loaded. Nothing here runs at import time: a CPU-only process never builds
or loads anything.

Kernels are compiled with `--fmad=false`: the coverage tests compare edge
functions `a*px + b*py + c` against 0, and a contracted FMA rounds them
differently from the plain PyTorch versions, moving boundary pixels. They
are compiled with `-ftz=false` (nvcc's default, stated because the kernels'
edge test compares against the smallest denormal).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

from renderer_tpu_torch.engine import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-ftz=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # binned, pp, starts, counts, depth, tid, n_tiles, tiles_x, tile_h,
    # tile_w, hp, wp, tile_row_offset, row_stride, n_s, sample_xy, stream
    "rt_rasterize_binned": (_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P, _P),
    # binned, pp, starts, counts, depth_in, lz, lt, aux, masked, k, n_tiles,
    # tiles_x, tile_h, tile_w, hp, wp, tile_row_offset, row_stride, n_s,
    # sample_xy, stream
    "rt_rasterize_layers": (_P, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # the shading kernels (csrc/shade.cu) take a pointer to their argument
    # structure (ShadeArgs, UiArgs) and the stream
    "rt_shade_stack": (_P, _P),
    "rt_alpha_stack": (_P, _P),
    "rt_shade_ui": (_P, _P),
    "rt_shade_composite_ui": (_P, _P),
    # kernel (1 S1, 2 S2, 3 S3, 4 the fused S3), bf16, per_tap, long long out[6]
    "rt_shade_info": (_I, _I, _I, _P),
    # the candidate loops (csrc/candidates.cu)
    # slots, cands, count, n_slots, n, plane, stream
    "rt_extract_candidates": (_P, _P, _P, _I, _I, _L, _P),
    # lt, lz, cands, alpha, cutoff, solid_tid, solid_z, clamp, n_s, k, n,
    # plane, stream
    "rt_masked_merge": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _P),
    # n_s, k, n, plane, long long out[6] (MERGE_INFO)
    "rt_merge_info": (_I, _I, _I, _L, _P),
    # solid_tid, cands_s, shaded_s, lt_b, cands_b, shaded_b, hdr, clamp, n_s,
    # n_cs, k, n_cb, plane, stream
    "rt_resolve": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P),
    # the raster front end (csrc/frontend.cu)
    # clip, tri_v, num_ptr, num_value, num_is64, out, tc, n_verts, width,
    # height, bbox_pad, maxdim, double_sided, stream
    "rt_setup": (_P, _P, _P, _L, _I, _P, _I, _L, _F, _F, _F, _F, _I, _P),
    # tc, double_sided, long long out[2]: F1's grid for tc triangles and the
    # blocks resident at once
    "rt_setup_launch": (_L, _I, _P),
    # the binning kernels take a pointer to BinArgs and the stream
    "rt_bin_spans": (_P, _P),
    "rt_bin_rows": (_P, _P),
    "rt_bin_pairs": (_P, _P),
    "rt_bin_scan": (_P, _P),
    "rt_bin_scatter": (_P, _P),
    # BinArgs, what (0 F4 scan's one block, 1 F2 spans' grid, 2 a thread a
    # triangle, 3 a thread a binned column, 4 F1's grid, 5 F4 scatter's
    # grid), stream: an empty kernel, the launch floor of
    # tools/frontend_probe
    "rt_launch_floor": (_P, _I, _P),
}


def _struct(name: str, pointers: tuple, longs: tuple, ints: tuple,
            floats: tuple = ()) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": (
        [(f, _P) for f in pointers] + [(f, _L) for f in longs]
        + [(f, _I) for f in ints] + [(f, _F) for f in floats])})


#: csrc/shade_common.cuh `ShadeArgs`, field for field (S1 and S2)
ShadeArgs = _struct(
    "ShadeArgs",
    ("tid", "row0", "tri_v", "clip", "uv", "normal", "tangent", "draw",
     "material_id", "debug_id", "debug_mode", "atlas", "table", "srgb", "wrap",
     "tex_indices", "base_color_factor", "emissive_occlusion", "arm", "out",
     "out2"),
    ("n_cand", "n_tris", "n_verts", "n_draws", "mat_stride", "dbg_stride",
     "n_mats", "n_atlas", "n_tex"),
    ("h", "w", "width", "height", "atlas_w", "trilinear", "aniso",
     "srgb_per_tap", "bf16"))

#: csrc/shade_common.cuh `MAX_HDR`: the fused S3's HDR buffers at most
MAX_HDR = 8

#: csrc/shade_common.cuh `UiArgs`, field for field (S3 and the fused S3;
#: hdr0..hdr7 are its array `hdr`)
UiArgs = _struct(
    "UiArgs",
    ("lt", "row0", "tris", "pos", "uv", "col", "tri_cmd", "cliprect",
     "tex_kind", "tex_slot", "atlas", "table", "srgb", "wrap", "rgb", "alpha",
     *(f"hdr{i}" for i in range(MAX_HDR))),
    ("n_cand", "n_tris", "n_verts", "n_cmds", "n_atlas", "n_tex"),
    ("h", "w", "atlas_w", "n_samples", "n_layers", "per_sample", "round_px"))


#: csrc/frontend.cu MAX_CLASSES: the alpha classes one binning call takes
MAX_BIN_CLASSES = 3

#: csrc/frontend.cu `BinArgs`, field for field (bound_ptr0..3 and the
#: others of the same stem are its arrays)
BinArgs = _struct(
    "BinArgs",
    ("td", "n_rows", "tri_info", "cum_r", "row_span", "row_rec", "cum_p", "key",
     "tri_pair", "order", "acc", "scan", "binned",
     *(f"bound_ptr{i}" for i in range(MAX_BIN_CLASSES + 1))),
    (*(f"bound_value{i}" for i in range(MAX_BIN_CLASSES + 1)), "p_total"),
    (*(f"bound_is64{i}" for i in range(MAX_BIN_CLASSES + 1)), "tc", "rc", "pc",
     "n_classes", "tiles_x", "tiles_y", "tile_w", "tile_h", "tile_row_lo",
     "local_tiles_y", "row_stride", "zbuckets"),
    ("inv_tile_w", "inv_tile_h"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librenderer_kernels-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile every source to an object in parallel, then link `so`; the
    commands and their output (with `ptxas -v`) go to build.log."""
    tmp = so.with_name(f"{so.stem}.tmp{os.getpid()}")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [Path(f"{tmp}.{src.stem}.o") for src in srcs]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs))
    failed = [(cmd, proc.returncode) for cmd, proc in zip(cmds, procs)
              if proc.returncode != 0]
    if not failed:
        link = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", f"{tmp}.so",
                *(str(obj) for obj in objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append((link, proc.returncode))
    (BUILD_DIR / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0][1]}): {failed[0][0]}\n"
                           f"{log[-4000:]}")
    os.replace(f"{tmp}.so", so)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (set-up spans setup.kernels
    around the build or load, setup.nvcc around a build). Raises if it
    cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with profiling.setup_span("setup.kernels"):
            so = library_path()
            if not so.exists():
                with profiling.setup_span("setup.nvcc"):
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    _build(so)
            lib = ctypes.CDLL(str(so))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
        _lib = lib
        return lib


#: rt_shade_info's fields, in order
SHADE_INFO = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm", "sms",
              "grid_cap")


def shade_info(kernel: str, bf16: bool = False, per_tap: bool = True) -> dict:
    """What the host knows of a shading kernel's instantiation on the
    current device: kernel "s1", "s2", "s3" or "s3c" (the fused S3; bf16
    and per_tap pick S1's and S2's template; S2 has no per-tap variant): its
    registers a thread, local bytes a thread (stack frame and spills),
    static shared bytes a block, the blocks an SM that its launches assume
    (from cudaOccupancyMaxActiveBlocksPerMultiprocessor), the SMs, and the
    most blocks a launch of S1 and the fused S3 (0 for the others)."""
    out = (ctypes.c_longlong * len(SHADE_INFO))()
    which = {"s1": 1, "s2": 2, "s3": 3, "s3c": 4}[kernel]
    check_launch(f"shade_info({kernel})",
                 load().rt_shade_info(which, int(bf16), int(per_tap), out))
    return dict(zip(SHADE_INFO, (int(v) for v in out)))


#: rt_merge_info's fields, in order
MERGE_INFO = ("threads", "dynamic_shared_bytes", "blocks_per_sm", "sms", "grid",
              "registers")


def merge_info(n_s: int, k: int, n: int, plane: int) -> dict:
    """The launch of C2 (csrc/candidates.cu `merge_kernel`) for S = n_s
    samples, k layers, n candidates and a plane of `plane` pixels on the
    current device: a block's threads (a warp a 32-pixel tile), its
    dynamic shared bytes (each warp's ring of staged ids, its matches and
    pass counts), the blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the SMs, the
    persistent grid and the instantiation's registers a thread."""
    out = (ctypes.c_longlong * len(MERGE_INFO))()
    check_launch("merge_info", load().rt_merge_info(n_s, k, n, plane, out))
    return dict(zip(MERGE_INFO, (int(v) for v in out)))


def ptxas_report(log: Path | None = None) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads", "shared"}} from the `ptxas -v` output in the build's
    build.log ("shared": static shared bytes, 0 where ptxas prints none)."""
    text = (log or BUILD_DIR / "build.log").read_text()
    out = {}
    for m in re.finditer(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
            r"spill stores, (\d+) bytes spill loads\n[^\n]*Used (\d+) registers"
            r"(?:[^\n]*?(\d+) bytes smem)?", text):
        out[m.group(1)] = dict(stack=int(m.group(2)), spill_stores=int(m.group(3)),
                               spill_loads=int(m.group(4)), registers=int(m.group(5)),
                               shared=int(m.group(6) or 0))
    return out


def sample_xy(sample_positions) -> ctypes.Array:
    """Host float array (x0, y0, x1, y1, …) of in-pixel sample positions,
    passed by pointer and copied into the kernel's parameters."""
    flat = [float(v) for xy in sample_positions for v in xy]
    return (ctypes.c_float * len(flat))(*flat)


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def current_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
