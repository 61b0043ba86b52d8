# Frozen copy of renderer_tpu_torch/raster/candidates.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
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

from benchmark.reference.raster.shade import check_tensor

#: launches of the CUDA kernels in this process, C1 ("cand_extract"), C2
#: ("cand_merge") and C3 ("cand_resolve"); the plain versions do not count
launches = {"cand_extract": 0, "cand_merge": 0, "cand_resolve": 0}

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






