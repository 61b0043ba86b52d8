# Restated per frame from chip_smoke.py `candidate_work`, `_nbytes`,
# `_last_match` and `_distinct_refs` at commit 5822f29: the same counts a
# call, on the reference's own candidates of the frame
# (benchmark/reference/frame.py `probe`) instead of a record of the port's
# calls. Part of the benchmark's yardstick; do not edit.
"""Work of the candidate kernels (C1 extraction, three calls a frame with
blended geometry; C2 the masked merge; C3 the solid select and the blended
composite) in one frame. Bytes: each value the step must read, once, and
each value it must write, once:
- C1: a pixel's slots up to the one that fills its candidate list (all of
  them when it never fills, or when counting), the candidates (and the
  count) written;
- C2: the masked ids and the candidates in full; alpha and cutoff of each
  (candidate, pixel) a live layer matches; a sample's solid id and depth
  (the depth read, both written) where a layer passes; the clamp mask
  written where a live layer matches no candidate;
- C3: the solid ids, both candidate lists and the blended ids in full; the
  rgb of each (candidate, pixel) a covered sample selects and the rgba of
  each one a blended layer selects; the HDR samples written; the clamp mask
  as in C2.
Operations: at most the compares and arithmetic the step needs (C1 a
compare with -1 and one with each candidate a slot, and, counting, each
earlier slot; C2 a match and three compares a slot; C3 a match a solid
sample and a match and ten f32 operations a blended layer)."""

from __future__ import annotations

import torch

from benchmark.reference.raster.candidates import extract_candidates_plain


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _last_match(tid: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Index of the last candidate equal to tid ([..., h, w] against
    [n, h, w]), -1 where none is."""
    idx = torch.full(tid.shape, -1, dtype=torch.int64, device=tid.device)
    for j in range(cands.shape[0]):
        idx = torch.where(tid == cands[j], j, idx)
    return idx


def _distinct_refs(idx: torch.Tensor, n: int) -> int:
    """Distinct (candidate, pixel) pairs that the [..., h, w] indices `idx`
    (< 0: none) reference."""
    flat = idx.reshape(-1, *idx.shape[-2:])
    return sum(int((flat == j).any(0).sum()) for j in range(n))


def _c1(slots, n, count=False):
    n_slots, h, w = slots.shape
    ops = h * w * n_slots * (n + 1 + ((n_slots - 1) // 2 if count else 0))
    if count:
        reads = n_slots * h * w
    else:
        cands = extract_candidates_plain(slots, n)
        hit = slots == cands[n - 1]
        filled = hit.any(0) & (cands[n - 1] != -2)
        reads = int(torch.where(filled, hit.int().argmax(0) + 1, n_slots).sum())
    return ops, 4 * reads + (n + int(count)) * h * w * 4


def _c2(lt, cands, alpha, cutoff):
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


def _c3(solid_tid, cands_s, lt_b, cands_b):
    n_s, h, w = solid_tid.shape
    idx_s = _last_match(solid_tid, cands_s)
    covered = solid_tid >= 0
    clamped = (covered & (idx_s < 0)).any(0)
    n_bytes = (_nbytes(solid_tid, cands_s, lt_b, cands_b) + n_s * h * w * 12
               + 12 * _distinct_refs(torch.where(covered, idx_s.clamp(min=0), -1),
                                     cands_s.shape[0]))
    ops = h * w * n_s * cands_s.shape[0]
    if lt_b is not None:
        idx_b = _last_match(lt_b, cands_b)
        clamped |= ((lt_b >= 0) & (idx_b < 0)).any((0, 1))
        n_bytes += 16 * _distinct_refs(idx_b.clamp(min=0), cands_b.shape[0])
        ops += h * w * n_s * lt_b.shape[1] * (cands_b.shape[0] + 10)
    return ops, n_bytes + int(clamped.sum())


def count(probe: dict, cfg) -> list:
    """[(step, operations, bytes)] of one frame's candidate kernels."""
    n_s = cfg.msaa_samples
    extra = max(cfg.msaa_shade_candidates - 1, 0) if n_s > 1 else 0
    out = []
    lt_m, lt_b = probe.get("lt_m"), probe.get("lt_b")
    if lt_m is not None:
        slots = lt_m.reshape(-1, *lt_m.shape[2:])
        out.append(("C1 masked", *_c1(slots, min(slots.shape[0], cfg.mask_layers + extra))))
        out.append(("C2", *_c2(lt_m, probe["cands_m"], probe["alpha"], probe["cutoff"])))
    n_c = min(n_s, max(cfg.msaa_shade_candidates, 1))
    out.append(("C1 solid", *_c1(probe["solid_tid"], n_c, count=n_s > 1)))
    if lt_b is not None:
        slots = lt_b.reshape(-1, *lt_b.shape[2:])
        out.append(("C1 blended",
                    *_c1(slots, min(slots.shape[0], cfg.blend_layers + extra))))
    out.append(("C3", *_c3(probe["solid_tid"], probe["cands_s"], lt_b, probe.get("cands_b"))))
    return out
