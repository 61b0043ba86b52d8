"""ctypes binding over the repository's host C++ library (csrc/*.cpp), with
numpy plain versions.

The library holds the BC7 encoder (csrc/bc7enc.cpp), the atlas blit
(csrc/atlas_pack.cpp), the draw prologue's sort and gather
(csrc/draw_prologue.cpp) and the animation pose and queue prologue
(csrc/anim_pose.cpp). It is built on first use with g++ into
`build/native/librenderer_native-<digest>.so` under the repository root
(the digest covers the sources and the flags) and loaded with ctypes;
nothing is written under csrc/. Nothing here runs at import time.

Which path runs is never silent:
- the numpy plain versions are taken only when no C++ compiler is found;
- a compiler that fails raises, with its log;
- the choice is printed once to stderr, and `status()` reports it.

The callers (scene/draw_stream.frame_view, materials/atlas._blit_wrap,
assets/gltf_loader) keep their numpy code as the plain version: each entry
point here returns None (or False) when the library is absent, and the
caller then runs its numpy code. `plain()` forces that path for a while,
for the tests that hold the two against each other.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from renderer_tpu_torch.engine import profiling

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = ("bc7enc.cpp", "atlas_pack.cpp", "draw_prologue.cpp", "anim_pose.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# csrc/Makefile's flags
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_status: dict | None = None
_plain_depth = 0  # > 0 inside plain()

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_I = ctypes.c_int
_D = ctypes.c_double


class _AnimProloguePack(ctypes.Structure):
    """Mirror of csrc/anim_pose.cpp AnimProloguePack: every member is 8
    bytes (int64 or pointer), so both sides agree on the layout with no
    padding. Filled once per compiled prologue; the per-frame call passes
    only (pack*, query_times*, root*, mats*, palettes*, block_transforms*)."""

    _fields_ = [
        ("n_anims", ctypes.c_int64),
        ("chan_off", _i64p), ("offsets", _i64p),
        ("times", _f64p), ("values", _f32p),
        ("in_tan", _f32p), ("out_tan", _f32p),
        ("slot_of_chan", _i64p), ("path_id", _i32p),
        ("step", _u8p), ("cubic", _u8p),
        ("touch_off", _i64p),
        ("s0", _f32p), ("q0", _f32p), ("t0", _f32p),
        ("touched_idx", _i64p),
        ("n_nodes", ctypes.c_int64), ("static_locals", _f32p),
        ("n_order", ctypes.c_int64), ("order", _i64p), ("parents", _i64p),
        ("n_joints", ctypes.c_int64), ("joint_nodes", _i64p),
        ("ibms", _f32p),
        ("n_skinned", ctypes.c_int64), ("n_static", ctypes.c_int64),
        ("static_idx", _i64p),
    ]


_SIGNATURES = {
    "bc7_encode_mode6": ((_u8p, _I, _I, _u8p), None),
    "bc7_encode": ((_u8p, _I, _I, _u8p, _u8p, _u8p, _u8p, _u8p, _u8p), None),
    "atlas_blit_wrap": ((_u8p, _I, _I, _u32p, _I, _I, _I), None),
    "draw_prologue": ((_u64p, _f32p, _i32p, _i32p, _i32p, _I, _i32p, _u64p,
                       _f32p, _i32p), None),
    "anim_pose": ((_I, _i64p, _f64p, _f32p, _f32p, _f32p, _i64p, _i32p, _u8p,
                   _u8p, _D, _I, _f32p, _f32p, _f32p, _i64p, _I, _f32p, _I,
                   _i64p, _i64p, _f32p), _I),
    "anim_pose_multi": ((_I, _i64p, _i64p, _f64p, _f32p, _f32p, _f32p, _i64p,
                         _i32p, _u8p, _u8p, _f64p, _i64p, _f32p, _f32p,
                         _f32p, _i64p, _I, _f32p, _I, _i64p, _i64p, _f32p),
                        _I),
    "anim_prologue": ((ctypes.POINTER(_AnimProloguePack), _f64p, _f32p, _f32p,
                       _f32p, _f32p), _I),
}


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librenderer_native-{h.hexdigest()[:16]}.so"


def _build(cxx: str, so: Path) -> None:
    """Compile the sources into `so`: a per-process temporary name, then an
    atomic rename, so concurrent builders never load a half-written file."""
    tmp = so.with_name(f"{so.stem}.tmp{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout
                                         + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, so)


def _announce(status: dict) -> None:
    if status["path"] == "native":
        print(f"[native] host library {status['library']} (built in "
              f"{status['build_seconds']:.1f} s)", file=sys.stderr, flush=True)
    else:
        print(f"[native] {status['reason']}: the numpy plain versions run",
              file=sys.stderr, flush=True)


def load() -> ctypes.CDLL | None:
    """The host library, built on first use; None when it is not built and
    no C++ compiler is found (the numpy path), or inside `plain()`. Raises
    when the compiler fails. Other processes building the same library wait on a file lock
    in the build directory (released when its holder exits)."""
    global _lib, _status
    if _plain_depth:
        return None
    with _lock:
        if _status is not None:
            return _lib
        with profiling.setup_span("setup.native"):
            so = library_path()
            cxx = _compiler()
            seconds = 0.0
            if not so.exists():
                if cxx is None:
                    _status = {"path": "numpy", "library": None, "build_seconds": 0.0,
                               "reason": "no C++ compiler (g++) found"}
                    _announce(_status)
                    return None
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                t0 = time.perf_counter()
                with open(BUILD_DIR / "lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not so.exists():
                        _build(cxx, so)
                        seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(so))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = res
            _lib = lib
            _status = {"path": "native", "library": str(so), "build_seconds": seconds,
                       "reason": "built" if seconds else "already built"}
        _announce(_status)
        return lib


def status() -> dict:
    """Which path the host library takes: {"path": "native" | "numpy",
    "library", "build_seconds", "reason"} (loads the library first)."""
    if _plain_depth:
        return {"path": "numpy", "library": None, "build_seconds": 0.0,
                "reason": "inside native.plain()"}
    load()
    return dict(_status)


@contextlib.contextmanager
def plain():
    """Run the numpy plain versions inside the block (load() returns None).
    Caches built on the library's path before the block stay as they were:
    callers invalidate them (Gltf.invalidate_caches) for a clean
    comparison."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def atlas_blit_wrap(src: np.ndarray, atlas: np.ndarray, x: int, y: int) -> bool:
    """Blit an RGBA8 [h,w,4] image into the u32 atlas at (x, y) with a
    1-texel REPEAT border. False (nothing written) without the library."""
    lib = load()
    if lib is None:
        return False
    h, w = src.shape[:2]
    if not (atlas.dtype == np.uint32 and atlas.flags.c_contiguous
            and x >= 1 and y >= 1 and y + h + 1 <= atlas.shape[0]
            and x + w + 1 <= atlas.shape[1]):
        raise ValueError(f"atlas_blit_wrap: {w}x{h} at ({x}, {y}) does not fit "
                         f"a contiguous u32 atlas {atlas.shape} {atlas.dtype}")
    src = np.ascontiguousarray(src, np.uint8)
    lib.atlas_blit_wrap(_ptr(src, ctypes.c_uint8), w, h,
                        _ptr(atlas, ctypes.c_uint32), atlas.shape[1], x, y)
    return True


def draw_prologue(keys, transforms, material, joints, skinned, cap):
    """Sort draws by packed key and gather the frame upload arrays in one
    native pass (csrc/draw_prologue.cpp). Returns (order i32[n],
    sorted_keys u64[n], pdf f32[cap,12], pdi i32[cap,4]), or None without
    the library (the caller's numpy code runs)."""
    lib = load()
    if lib is None:
        return None
    n = len(keys)
    order = np.empty(n, np.int32)
    sorted_keys = np.empty(n, np.uint64)
    pdf = np.zeros((cap, 12), np.float32)
    pdi = np.zeros((cap, 4), np.int32)
    if n:
        keys = np.ascontiguousarray(keys, np.uint64)
        transforms = np.ascontiguousarray(transforms, np.float32)
        material = np.ascontiguousarray(material, np.int32)
        joints = np.ascontiguousarray(joints, np.int32)
        skinned = np.ascontiguousarray(skinned, np.int32)
        if transforms.shape != (n, 4, 4) or cap < n:
            raise ValueError(f"draw_prologue: transforms {transforms.shape} for {n} "
                             f"draws, capacity {cap}")
        lib.draw_prologue(
            _ptr(keys, ctypes.c_uint64), _ptr(transforms, ctypes.c_float),
            _ptr(material, ctypes.c_int32), _ptr(joints, ctypes.c_int32),
            _ptr(skinned, ctypes.c_int32), n,
            _ptr(order, ctypes.c_int32), _ptr(sorted_keys, ctypes.c_uint64),
            _ptr(pdf, ctypes.c_float), _ptr(pdi, ctypes.c_int32),
        )
    return order, sorted_keys, pdf, pdi


class _Keep:
    """Contiguous copies of the arrays behind raw pointers, held for as long
    as the sampler that uses them lives."""

    def __init__(self) -> None:
        self.arrays: list = []

    def ptr(self, a, ct, dtype=None):
        a = np.ascontiguousarray(a, dtype)
        self.arrays.append(a)
        return _ptr(a, ct)


def make_anim_pose(comp, static_locals, order, parents):
    """The native single-animation pose evaluator (csrc/anim_pose.cpp):
    `sample(time) -> mats f32 [n, 4, 4]` of global node poses, or None
    without the library. Every pointer is made once, here. `sample` raises
    ValueError on a past-the-end timestamp."""
    lib = load()
    if lib is None:
        return None
    n_nodes = static_locals.shape[0]
    keep = _Keep()
    fixed = (
        comp.n_channels, keep.ptr(comp.offsets, ctypes.c_int64),
        keep.ptr(comp.times_raw, ctypes.c_double),
        keep.ptr(comp.values, ctypes.c_float),
        keep.ptr(comp.in_tan, ctypes.c_float),
        keep.ptr(comp.out_tan, ctypes.c_float),
        keep.ptr(comp.slot_of_chan, ctypes.c_int64),
        keep.ptr(comp.path_id32, ctypes.c_int32),
        keep.ptr(comp.step_u8, ctypes.c_uint8),
        keep.ptr(comp.cubic_u8, ctypes.c_uint8),
    )
    fixed2 = (
        len(comp.touched), keep.ptr(comp.s0, ctypes.c_float),
        keep.ptr(comp.q0, ctypes.c_float), keep.ptr(comp.t0, ctypes.c_float),
        keep.ptr(comp.touched_arr, ctypes.c_int64),
        n_nodes, keep.ptr(static_locals, ctypes.c_float),
        len(order), keep.ptr(order, ctypes.c_int64),
        keep.ptr(parents, ctypes.c_int64),
    )
    fn = lib.anim_pose

    def sample(time: float) -> np.ndarray:
        mats = np.empty((n_nodes, 4, 4), np.float32)
        if fn(*fixed, float(time), *fixed2, _ptr(mats, ctypes.c_float)) != 0:
            raise ValueError("invalid timestamp")
        return mats

    sample.keep = keep
    return sample


def _concat_comp_arrays(comps):
    """The per-animation compiled arrays concatenated in play order: the
    layered layout of anim_pose_multi and anim_prologue."""
    chan_off = np.concatenate(
        [[0], np.cumsum([c.n_channels for c in comps])]).astype(np.int64)
    offs, row_base = [], 0
    for c in comps:
        offs.append(np.asarray(c.offsets[:-1], np.int64) + row_base)
        row_base += int(c.offsets[-1])
    offsets = np.concatenate(offs + [np.asarray([row_base], np.int64)])

    def cat(arrs, dtype, width=None):
        arrs = [a for a in arrs if len(a)]
        if arrs:
            return np.concatenate(arrs).astype(dtype)
        return np.zeros((0,) if width is None else (0, width), dtype)

    return {
        "chan_off": chan_off, "offsets": offsets,
        "times": cat([c.times_raw for c in comps], np.float64),
        "values": cat([c.values for c in comps], np.float32, 4),
        "in_tan": cat([c.in_tan for c in comps], np.float32, 4),
        "out_tan": cat([c.out_tan for c in comps], np.float32, 4),
        "slot_of_chan": cat([c.slot_of_chan for c in comps], np.int64),
        "path_id": cat([c.path_id32 for c in comps], np.int32),
        "step": cat([c.step_u8 for c in comps], np.uint8),
        "cubic": cat([c.cubic_u8 for c in comps], np.uint8),
        "touch_off": np.concatenate(
            [[0], np.cumsum([len(c.touched) for c in comps])]).astype(np.int64),
        "s0": cat([c.s0 for c in comps], np.float32, 3),
        "q0": cat([c.q0 for c in comps], np.float32, 4),
        "t0": cat([c.t0 for c in comps], np.float32, 3),
        "touched_idx": cat([c.touched_arr for c in comps], np.int64),
    }


def make_anim_pose_multi(comps, static_locals, order, parents):
    """The native layered pose evaluator for N ≥ 2 playing animations
    (csrc/anim_pose.cpp anim_pose_multi): `sample(times) -> mats f32
    [n, 4, 4]` of global node poses, or None without the library. `sample`
    raises ValueError(anim_index) on a past-the-end timestamp."""
    lib = load()
    if lib is None:
        return None
    n_anims = len(comps)
    n_nodes = static_locals.shape[0]
    keep = _Keep()
    cc = _concat_comp_arrays(comps)
    fixed = (
        n_anims, keep.ptr(cc["chan_off"], ctypes.c_int64),
        keep.ptr(cc["offsets"], ctypes.c_int64),
        keep.ptr(cc["times"], ctypes.c_double),
        keep.ptr(cc["values"], ctypes.c_float),
        keep.ptr(cc["in_tan"], ctypes.c_float),
        keep.ptr(cc["out_tan"], ctypes.c_float),
        keep.ptr(cc["slot_of_chan"], ctypes.c_int64),
        keep.ptr(cc["path_id"], ctypes.c_int32),
        keep.ptr(cc["step"], ctypes.c_uint8), keep.ptr(cc["cubic"], ctypes.c_uint8),
    )
    fixed2 = (
        keep.ptr(cc["touch_off"], ctypes.c_int64),
        keep.ptr(cc["s0"], ctypes.c_float), keep.ptr(cc["q0"], ctypes.c_float),
        keep.ptr(cc["t0"], ctypes.c_float),
        keep.ptr(cc["touched_idx"], ctypes.c_int64),
        n_nodes, keep.ptr(static_locals, ctypes.c_float),
        len(order), keep.ptr(order, ctypes.c_int64),
        keep.ptr(parents, ctypes.c_int64),
    )
    qt = np.zeros(n_anims, np.float64)
    keep.arrays.append(qt)
    qt_ptr = _ptr(qt, ctypes.c_double)
    fn = lib.anim_pose_multi

    def sample(query_times) -> np.ndarray:
        qt[:] = query_times
        mats = np.empty((n_nodes, 4, 4), np.float32)
        rc = fn(*fixed, qt_ptr, *fixed2, _ptr(mats, ctypes.c_float))
        if rc != 0:
            raise ValueError(rc - 1)
        return mats

    sample.keep = keep
    return sample


def make_anim_prologue(comps, static_locals, order, parents,
                       joint_nodes, ibms, n_skinned, static_idx):
    """The one-call animated-queue frame prologue (csrc/anim_pose.cpp
    anim_prologue): layered pose evaluation, joint palettes written into
    the caller's palette storage, and the per-draw transforms in DrawBlock
    row order (n_skinned rows of the root, then root @ static node poses;
    scene_queueing.rs:17-57). Returns `sample(times, root, palettes_out) ->
    transforms f32 [n_skinned + n_static, 4, 4]`, or None without the
    library. `palettes_out` must be a C-contiguous f32 [n_joints, 4, 4]
    view; the returned array is reused by the next call. Raises
    ValueError(anim_index) on a past-the-end timestamp.

    The pack holds raw pointers into the arrays of `keep`; both are
    attributes of `sample`, so they live exactly as long as it does."""
    lib = load()
    if lib is None:
        return None
    n_anims = len(comps)
    n_nodes = static_locals.shape[0]
    keep = _Keep()
    cc = _concat_comp_arrays(comps)
    p = keep.ptr
    pack = _AnimProloguePack(
        n_anims=n_anims,
        chan_off=p(cc["chan_off"], ctypes.c_int64),
        offsets=p(cc["offsets"], ctypes.c_int64),
        times=p(cc["times"], ctypes.c_double),
        values=p(cc["values"], ctypes.c_float),
        in_tan=p(cc["in_tan"], ctypes.c_float),
        out_tan=p(cc["out_tan"], ctypes.c_float),
        slot_of_chan=p(cc["slot_of_chan"], ctypes.c_int64),
        path_id=p(cc["path_id"], ctypes.c_int32),
        step=p(cc["step"], ctypes.c_uint8),
        cubic=p(cc["cubic"], ctypes.c_uint8),
        touch_off=p(cc["touch_off"], ctypes.c_int64),
        s0=p(cc["s0"], ctypes.c_float),
        q0=p(cc["q0"], ctypes.c_float),
        t0=p(cc["t0"], ctypes.c_float),
        touched_idx=p(cc["touched_idx"], ctypes.c_int64),
        n_nodes=n_nodes,
        static_locals=p(static_locals, ctypes.c_float, np.float32),
        n_order=len(order),
        order=p(order, ctypes.c_int64, np.int64),
        parents=p(parents, ctypes.c_int64, np.int64),
        n_joints=len(joint_nodes),
        joint_nodes=p(joint_nodes, ctypes.c_int64, np.int64),
        ibms=p(ibms, ctypes.c_float, np.float32),
        n_skinned=int(n_skinned),
        n_static=len(static_idx),
        static_idx=p(static_idx, ctypes.c_int64, np.int64),
    )
    pack_ptr = ctypes.byref(pack)
    qt = np.zeros(n_anims, np.float64)
    root = np.zeros((4, 4), np.float32)
    mats = np.empty((n_nodes, 4, 4), np.float32)
    transforms = np.empty((int(n_skinned) + len(static_idx), 4, 4), np.float32)
    keep.arrays += [qt, root, mats, transforms]
    qt_ptr, root_ptr = _ptr(qt, ctypes.c_double), _ptr(root, ctypes.c_float)
    mats_ptr, bt_ptr = _ptr(mats, ctypes.c_float), _ptr(transforms, ctypes.c_float)
    n_joints = len(joint_nodes)
    fn = lib.anim_prologue

    def sample(query_times, root_transform, palettes_out) -> np.ndarray:
        if not (palettes_out.flags.c_contiguous and palettes_out.dtype == np.float32
                and palettes_out.shape == (n_joints, 4, 4)):
            raise ValueError(f"anim_prologue: palettes_out must be a contiguous "
                             f"f32 [{n_joints}, 4, 4] array")
        qt[:] = query_times
        root[:] = root_transform
        rc = fn(pack_ptr, qt_ptr, root_ptr, mats_ptr,
                _ptr(palettes_out, ctypes.c_float), bt_ptr)
        if rc != 0:
            raise ValueError(rc - 1)
        return transforms

    sample.keep = (keep, pack)
    sample.node_mats = mats  # the last call's global node poses (reused)
    return sample


BC7_WEIGHTS4 = np.array(
    [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], np.int32
)


def _blocks_out(rgba: np.ndarray):
    h, w = rgba.shape[:2]
    return np.zeros(((w + 3) // 4) * ((h + 3) // 4) * 16, np.uint8)


def bc7_encode(rgba: np.ndarray) -> np.ndarray:
    """Alpha-aware all-8-mode BC7 encode: [h, w, 4] u8 → blocks
    (u8 [n_blocks*16]). Per block the native encoder keeps the lowest-error
    of the tried modes (opaque blocks: 6 / 1 / 3 / 0 / 2; alpha blocks:
    6 / 5 + 4 with their channel rotations / 7), the analog of make-ntex's
    slow settings (make-ntex/src/main.rs:231-246). The partition and anchor
    tables come from materials/bc7_tables.py. Without the library the numpy
    mode-6 encoder runs (valid blocks, lower quality on alpha and
    multi-subset content), which load() has announced."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    out = _blocks_out(rgba)
    lib = load()
    if lib is None:
        return _bc7_encode_mode6_numpy(rgba, out)
    from renderer_tpu_torch.materials import bc7_tables

    tables = [np.ascontiguousarray(t, np.uint8) for t in (
        bc7_tables.PARTITION_2, bc7_tables.ANCHOR_2, bc7_tables.PARTITION_3,
        bc7_tables.ANCHOR_3_2, bc7_tables.ANCHOR_3_3)]
    lib.bc7_encode(_ptr(rgba, ctypes.c_uint8), w, h,
                   *[_ptr(t, ctypes.c_uint8) for t in tables],
                   _ptr(out, ctypes.c_uint8))
    return out


def bc7_encode_mode6(rgba: np.ndarray) -> np.ndarray:
    """Encode [h, w, 4] u8 → BC7 mode-6 blocks (u8 [n_blocks*16])."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    out = _blocks_out(rgba)
    lib = load()
    if lib is None:
        return _bc7_encode_mode6_numpy(rgba, out)
    lib.bc7_encode_mode6(_ptr(rgba, ctypes.c_uint8), w, h, _ptr(out, ctypes.c_uint8))
    return out


def _bc7_encode_mode6_numpy(rgba: np.ndarray, out: np.ndarray) -> np.ndarray:
    """Vectorized numpy mode-6 encoder (the native one's algorithm with a
    coarser p-bit search)."""
    h, w = rgba.shape[:2]
    bw, bh = (w + 3) // 4, (h + 3) // 4
    # pad to a block multiple with edge clamp
    padded = np.pad(rgba, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)), mode="edge")
    blocks = (
        padded.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    ).astype(np.float32)  # [N,16,4]

    mean = blocks.mean(axis=1, keepdims=True)
    d = blocks - mean
    cov = np.einsum("nia,nib->nab", d, d)
    axis = np.ones((blocks.shape[0], 4), np.float32)
    for _ in range(8):
        axis = np.einsum("nab,nb->na", cov, axis)
        axis /= np.maximum(np.linalg.norm(axis, axis=1, keepdims=True), 1e-9)
    t = np.einsum("nia,na->ni", d, axis)
    e0 = np.clip(mean[:, 0] + t.min(axis=1, keepdims=True).transpose(0, 1) * axis, 0, 255)
    e1 = np.clip(mean[:, 0] + t.max(axis=1, keepdims=True).transpose(0, 1) * axis, 0, 255)

    def quant(e):
        v = np.rint(e).astype(np.int32)
        p = ((v & 1).sum(axis=1) >= 2).astype(np.int32)  # majority LSB
        q = np.clip((v - p[:, None]) >> 1, 0, 127)
        return q, p, q * 2 + p[:, None]

    q0, p0, r0 = quant(e0)
    q1, p1, r1 = quant(e1)

    # indices: nearest of the 16 interpolated colors
    wts = BC7_WEIGHTS4[None, :, None].astype(np.int32)
    palette = (r0[:, None, :] * (64 - wts) + r1[:, None, :] * wts + 32) >> 6  # [N,16,4]
    dist = ((blocks[:, :, None, :] - palette[:, None, :, :]) ** 2).sum(-1)  # [N,16,16]
    idx = dist.argmin(-1).astype(np.int32)  # [N,16]

    flip = idx[:, 0] >= 8
    q0f = np.where(flip[:, None], q1, q0)
    q1f = np.where(flip[:, None], q0, q1)
    p0f = np.where(flip, p1, p0)
    p1f = np.where(flip, p0, p1)
    idx = np.where(flip[:, None], 15 - idx, idx)

    # pack bits into u128 via two u64 halves
    lo = np.zeros(blocks.shape[0], np.uint64)
    hi = np.zeros(blocks.shape[0], np.uint64)

    def put(value, nbits, pos):
        # numpy shifts by ≥ 64 are undefined: split at the 64-bit boundary
        nonlocal lo, hi
        v = value.astype(np.uint64)
        if pos < 64:
            lo |= v << np.uint64(pos)
            if pos + nbits > 64:
                hi |= v >> np.uint64(64 - pos)
        else:
            hi |= v << np.uint64(pos - 64)
        return pos + nbits

    pos = 0
    pos = put(np.full_like(lo, 1 << 6, dtype=np.uint64), 7, pos)
    for c in range(4):
        pos = put(q0f[:, c].astype(np.uint64), 7, pos)
        pos = put(q1f[:, c].astype(np.uint64), 7, pos)
    pos = put(p0f.astype(np.uint64), 1, pos)
    pos = put(p1f.astype(np.uint64), 1, pos)
    pos = put(idx[:, 0].astype(np.uint64), 3, pos)
    for i in range(1, 16):
        pos = put(idx[:, i].astype(np.uint64), 4, pos)
    assert pos == 128

    packed = np.empty((blocks.shape[0], 2), np.uint64)
    packed[:, 0] = lo
    packed[:, 1] = hi
    out[:] = packed.view(np.uint8).reshape(-1)
    return out
