"""The deferred stage's candidate loops: kernels C1-C3 and their plain
PyTorch versions.

Shading runs once per DISTINCT triangle of a pixel: the ids a pixel's
samples and layers hold are deduplicated into a short candidate list, the
candidates are shaded as stacked maps (S1, S2), and each slot selects its
value back. The JAX package writes these steps as elementwise loops in
`render_shard` (renderer_tpu/raster/pipeline.py `_extract_candidates`
:118, `_select` :203, the masked merge :407-439, the solid select
:452-476, the blended composite :478-490), which XLA fuses into its jitted
frame.

The entry points dispatch on the tensors' device, as the shading stage's
do: CPU tensors run the plain versions (the JAX package's loops, op for
op), CUDA tensors launch the hand-written kernels of csrc/candidates.cu —
C1 `extract_candidates`, C2 `masked_merge`, C3 `resolve` — or raise:

    cands = extract_candidates(slots, n)                 # [n, h, w] i32
    masked_merge(lt, lz, cands, alpha, cutoff, solid_tid, solid_z, clamp)
    hdr = resolve(solid_tid, cands_s, shaded_s, clamp, lt_b, cands_b, shaded_b)

The kernels allocate nothing but their outputs (torch.empty), never wait
for the device and launch on the current stream, so a frame that calls
them captures into a CUDA graph.
"""

from __future__ import annotations

import torch

from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.raster.shade import check_tensor

#: the launch counters in profiling.COUNTERS of C1 ("cand_extract"), C2
#: ("cand_merge") and C3 ("cand_resolve"); the plain versions do not count
LAUNCHES = ("cand_extract", "cand_merge", "cand_resolve")
profiling.register_launches(LAUNCHES)

#: the kernels' limits (csrc/candidates.cu): slots in C1 and C2 (8 samples ×
#: 16 layers, layers.MAX_KERNEL_LAYERS), candidates (16 layers + 7 extra
#: candidates) and solid candidates in C3 (at most the MSAA count)
MAX_SLOTS, MAX_CANDIDATES, MAX_SOLID = 128, 23, 8


# -- plain versions: the JAX package's loops, op for op ---------------------

def extract_candidates_plain(slots: torch.Tensor, n: int, count: bool = False):
    """Per pixel: the first `n` DISTINCT ids across the slots [n_slots, h, w]
    (slot order = priority) as [n, h, w] i32, -2 where fewer than n distinct
    ids exist. The -1 background sentinel is skipped — background samples
    and layers never consult the shaded candidates. With `count`, also
    returns the per-pixel count [h, w] i32 of distinct ids != -1 across all
    the slots (the demand signal shade_demand_max)."""
    tids = list(slots)
    cands: list = []
    for _ in range(n):
        nxt = torch.full_like(tids[0], -2)
        # reversed so the EARLIEST slot with a new value wins the overwrite
        for t in reversed(tids):
            is_new = t != -1
            for c in cands:
                is_new = is_new & (t != c)
            nxt = torch.where(is_new, t, nxt)
        cands.append(nxt)
    out = torch.stack(cands)
    if not count:
        return out
    distinct = torch.zeros_like(tids[0])
    for i, t in enumerate(tids):
        is_new = t != -1
        for u in tids[:i]:
            is_new = is_new & (t != u)
        distinct = distinct + is_new.to(torch.int32)
    return out, distinct


def select_plain(tid, cands, values):
    """values: per candidate, tensors whose leading dims are [h, w]
    (optionally a trailing channel dim), as a list or stacked. Returns
    (the value of the last candidate equal to tid, candidate 0's where
    none is; the unmatched mask)."""
    def pick(hit, a, b):
        if a.ndim == hit.ndim + 1:
            hit = hit[..., None]
        return torch.where(hit, a, b)

    out = values[0]
    matched = tid == cands[0]
    for c, v in zip(cands[1:], values[1:]):
        hit = tid == c
        out = pick(hit, v, out)
        matched = matched | hit
    return out, ~matched


def masked_merge_plain(lt, lz, cands, alpha, cutoff, solid_tid, solid_z, clamp) -> None:
    """Plain version of C2 (masked_merge), in place."""
    n_s, n_layers = lt.shape[:2]
    for s in range(n_s):
        # a2c: with MSAA, alpha additionally gates per-sample coverage
        # (sample s covered iff a·S > s + 0.5).
        a2c_floor = (s + 0.5) / n_s if n_s > 1 else 0.0
        # far → near so the nearest passing fragment wins.
        for k in reversed(range(n_layers)):
            t = lt[s, k]
            a, unmatched_a = select_plain(t, cands, alpha)
            co, _ = select_plain(t, cands, cutoff)
            live = t >= 0
            # unmatched fragments have unknown alpha → treated as failing
            # the cutoff (counted in shade_clamped_px)
            clamp |= live & unmatched_a
            passes = live & ~unmatched_a & (a > co) & (a > a2c_floor)
            solid_tid[s] = torch.where(passes, t, solid_tid[s])
            solid_z[s] = torch.where(passes, lz[s, k], solid_z[s])


def resolve_plain(solid_tid, cands_s, shaded_s, clamp, lt_b=None, cands_b=None,
                  shaded_b=None) -> torch.Tensor:
    """Plain version of C3 (resolve); updates `clamp` in place."""
    hdr = []
    for s in range(solid_tid.shape[0]):
        color, unmatched = select_plain(solid_tid[s], cands_s, shaded_s)
        covered_s = solid_tid[s] >= 0
        clamp |= unmatched & covered_s
        # a BACKGROUND sample whose -1 didn't fit the candidate set must
        # resolve to the clear color, not candidate 0's fallback color
        hdr.append(torch.where(covered_s[..., None], color[..., :3],
                               torch.zeros_like(color[..., :3])))
    if lt_b is not None:
        for s in range(len(hdr)):
            for k in range(lt_b.shape[1]):
                t = lt_b[s, k]
                color_k, unmatched = select_plain(t, cands_b, shaded_b)
                live = (t >= 0) & ~unmatched
                clamp |= (t >= 0) & unmatched
                a = torch.where(live[..., None], color_k[..., 3:4],
                                torch.zeros_like(color_k[..., 3:4]))
                hdr[s] = hdr[s] * (1.0 - a) + color_k[..., :3] * a
    return torch.stack(hdr)


# -- entry points -------------------------------------------------------------

def _device(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def extract_candidates(slots: torch.Tensor, n: int, count: bool = False):
    """The first `n` distinct ids of each pixel's slots: slots [n_slots, h,
    w] i32 → cands [n, h, w] i32 (and, with `count`, the [h, w] i32 count
    of distinct ids != -1; extract_candidates_plain). CPU tensors run the
    plain version; CUDA tensors launch C1 (csrc/candidates.cu, which stands
    for the JAX package's XLA-fused `_extract_candidates`,
    renderer_tpu/raster/pipeline.py:118), which takes 1..MAX_SLOTS slots
    and 1..MAX_CANDIDATES candidates and raises ValueError past them."""
    if _device(slots, "extract_candidates") == "cpu":
        return extract_candidates_plain(slots, n, count)
    if slots.ndim != 3 or not 1 <= slots.shape[0] <= MAX_SLOTS:
        raise ValueError(f"extract_candidates: slots {tuple(slots.shape)}; the kernel "
                         f"takes [1..{MAX_SLOTS}, h, w]")
    if not 1 <= n <= MAX_CANDIDATES:
        raise ValueError(f"extract_candidates: {n} candidates; the kernel takes "
                         f"1..{MAX_CANDIDATES}")
    check_tensor("slots", slots, torch.int32)
    n_slots, h, w = slots.shape
    cands = torch.empty((n, h, w), dtype=torch.int32, device=slots.device)
    distinct = (torch.empty((h, w), dtype=torch.int32, device=slots.device)
                if count else None)
    lib = kernels.load()
    with torch.cuda.device(slots.device):
        err = lib.rt_extract_candidates(slots.data_ptr(), cands.data_ptr(),
                                        _ptr(distinct), n_slots, n, h * w,
                                        kernels.current_stream())
    kernels.check_launch("extract_candidates", err)
    profiling.count("cand_extract")
    return (cands, distinct) if count else cands


def masked_merge(lt: torch.Tensor, lz: torch.Tensor, cands: torch.Tensor,
                 alpha: torch.Tensor, cutoff: torch.Tensor, solid_tid: torch.Tensor,
                 solid_z: torch.Tensor, clamp: torch.Tensor) -> None:
    """The masked alpha test's merge, IN PLACE: the masked layers lt / lz
    [S, K, h, w] (i32 / f32), their candidates cands [n, h, w] i32 with the
    candidates' alpha and cutoff [n, h, w] f32 (S2's outputs); per sample
    s, layers far → near, a live layer (id ≥ 0) whose id matches a
    candidate passes when alpha > cutoff and alpha > (s + 0.5) / S (0 at S
    = 1) and becomes the sample's solid id and depth (solid_tid i32 /
    solid_z f32 [S, h, w], updated in place); a live layer matching no
    candidate sets clamp [h, w] bool (in place). CPU tensors run
    masked_merge_plain; CUDA tensors launch C2 (csrc/candidates.cu, for
    the JAX package's XLA-fused merge, renderer_tpu/raster/pipeline.py:407-439),
    which takes 1..MAX_SLOTS slots (S·K) and 1..MAX_CANDIDATES candidates."""
    if _device(lt, "masked_merge") == "cpu":
        return masked_merge_plain(lt, lz, cands, alpha, cutoff, solid_tid, solid_z, clamp)
    if lt.ndim != 4 or not 1 <= lt.shape[0] * lt.shape[1] <= MAX_SLOTS:
        raise ValueError(f"masked_merge: lt {tuple(lt.shape)}; the kernel takes [S, K, h, w] "
                         f"with 1..{MAX_SLOTS} slots S·K")
    n_s, k, h, w = lt.shape
    n = cands.shape[0] if cands.ndim == 3 else 0
    if not 1 <= n <= MAX_CANDIDATES:
        raise ValueError(f"masked_merge: cands {tuple(cands.shape)}; the kernel takes "
                         f"[1..{MAX_CANDIDATES}, h, w]")
    dev = lt.device
    check_tensor("lt", lt, torch.int32, (n_s, k, h, w), dev)
    check_tensor("lz", lz, torch.float32, (n_s, k, h, w), dev)
    check_tensor("cands", cands, torch.int32, (n, h, w), dev)
    check_tensor("alpha", alpha, torch.float32, (n, h, w), dev)
    check_tensor("cutoff", cutoff, torch.float32, (n, h, w), dev)
    check_tensor("solid_tid", solid_tid, torch.int32, (n_s, h, w), dev)
    check_tensor("solid_z", solid_z, torch.float32, (n_s, h, w), dev)
    check_tensor("clamp", clamp, torch.bool, (h, w), dev, align=1)
    lib = kernels.load()
    with torch.cuda.device(dev):
        err = lib.rt_masked_merge(
            lt.data_ptr(), lz.data_ptr(), cands.data_ptr(), alpha.data_ptr(),
            cutoff.data_ptr(), solid_tid.data_ptr(), solid_z.data_ptr(),
            clamp.data_ptr(), n_s, k, n, h * w, kernels.current_stream())
    kernels.check_launch("masked_merge", err)
    profiling.count("cand_merge")


def resolve(solid_tid: torch.Tensor, cands_s: torch.Tensor, shaded_s: torch.Tensor,
            clamp: torch.Tensor, lt_b: torch.Tensor | None = None,
            cands_b: torch.Tensor | None = None,
            shaded_b: torch.Tensor | None = None) -> torch.Tensor:
    """Each sample's HDR colour before the UI: the solid select (a covered
    sample, solid_tid [S, h, w] ≥ 0, takes the rgb of its candidate among
    cands_s [n_s, h, w] from shaded_s [n_s, h, w, 4], an uncovered one
    +0.0), then, with blended layers lt_b [S, K, h, w], their candidates
    cands_b and shades shaded_b, the src-alpha composite of every layer in
    order, hdr·(1 − a) + rgb·a (a = 0 where the layer is empty or
    unmatched). Returns hdr [S, h, w, 3] f32; an unmatched covered sample
    or live layer sets clamp [h, w] bool (in place). CPU tensors run
    resolve_plain; CUDA tensors launch C3 (csrc/candidates.cu, for the JAX
    package's XLA-fused select and composite, renderer_tpu/raster/
    pipeline.py:452-490), which takes 1..MAX_SOLID solid and
    1..MAX_CANDIDATES blended candidates."""
    if _device(solid_tid, "resolve") == "cpu":
        return resolve_plain(solid_tid, cands_s, shaded_s, clamp, lt_b, cands_b, shaded_b)
    if solid_tid.ndim != 3:
        raise ValueError(f"resolve: solid_tid must be [S, h, w], got {tuple(solid_tid.shape)}")
    n_s, h, w = solid_tid.shape
    n_cs = cands_s.shape[0] if cands_s.ndim == 3 else 0
    if not 1 <= n_cs <= MAX_SOLID:
        raise ValueError(f"resolve: cands_s {tuple(cands_s.shape)}; the kernel takes "
                         f"[1..{MAX_SOLID}, h, w]")
    dev = solid_tid.device
    check_tensor("solid_tid", solid_tid, torch.int32, (n_s, h, w), dev)
    check_tensor("cands_s", cands_s, torch.int32, (n_cs, h, w), dev)
    check_tensor("shaded_s", shaded_s, torch.float32, (n_cs, h, w, 4), dev, align=16)
    check_tensor("clamp", clamp, torch.bool, (h, w), dev, align=1)
    k = n_cb = 0
    if lt_b is not None:
        if lt_b.ndim != 4 or cands_b is None or cands_b.ndim != 3:
            raise ValueError("resolve: lt_b must be [S, K, h, w] with cands_b [n, h, w]")
        k, n_cb = lt_b.shape[1], cands_b.shape[0]
        if not 1 <= n_cb <= MAX_CANDIDATES:
            raise ValueError(f"resolve: cands_b {tuple(cands_b.shape)}; the kernel takes "
                             f"[1..{MAX_CANDIDATES}, h, w]")
        check_tensor("lt_b", lt_b, torch.int32, (n_s, k, h, w), dev)
        check_tensor("cands_b", cands_b, torch.int32, (n_cb, h, w), dev)
        check_tensor("shaded_b", shaded_b, torch.float32, (n_cb, h, w, 4), dev, align=16)
    hdr = torch.empty((n_s, h, w, 3), dtype=torch.float32, device=dev)
    lib = kernels.load()
    with torch.cuda.device(dev):
        err = lib.rt_resolve(
            solid_tid.data_ptr(), cands_s.data_ptr(), shaded_s.data_ptr(), _ptr(lt_b),
            _ptr(cands_b), _ptr(shaded_b), hdr.data_ptr(), clamp.data_ptr(), n_s,
            n_cs, k, n_cb, h * w, kernels.current_stream())
    kernels.check_launch("resolve", err)
    profiling.count("cand_resolve")
    return hdr
