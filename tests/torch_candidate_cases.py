"""Inputs of the candidate loops (renderer_tpu_torch/raster/candidates.py),
made with numpy from a seed, for the CPU parity tests against the JAX
package (tests/test_torch_candidates.py) and the card tests of kernels
C1-C3 (tests/test_torch_cuda_kernels.py). Imports neither jax nor torch.

`loop_inputs(case, msaa, k, h, w)` gives the slots of one frame's loops:
the masked layers lt_m / lz_m [S, K, h, w], the solid ids and depths
[S, h, w], the blended layers lt_b [S, K, h, w], and the candidate counts
the pipeline takes (`n_masked`, `n_solid`, `n_blended`, with the most
extra candidates the Renderer grows to, msaa − 1). `alpha_cutoff` and
`shades` give the candidates' alpha, cutoff and shades. The crafted cases:

- "random": ids from a small range (duplicates and -1 mixed), alpha and
  cutoff uniform, shades normal;
- "all-background": every slot and solid id -1;
- "more-than-n": every slot a different id and half the candidates, so
  a pixel holds more distinct ids than candidates (the clamp mask);
- "duplicates": a layer's id the same in every sample;
- "alpha-edges": alpha NaN, equal to the cutoff, or exactly at a sample's
  alpha-to-coverage floor (s + 0.5) / S;
- "non-finite": shades with +inf, -inf, NaN and -0.0 (a solid sample of
  -0.0 under empty blended layers turns +0.0; inf · 0 is NaN);
- "pass-prefix": alpha at each alpha-to-coverage floor of this MSAA count
  and at its f32 neighbours either side, cutoff NaN, ±inf, equal to alpha
  or below it, and every third pixel's slots all naming one id (C2 counts
  the samples a candidate passes, a prefix of 0 .. S-1);
- "ragged-plane": the plane cut to (h - 1) × (w - 1) at MSAA 1 and 2, a
  pixel count that is odd, and (h - 1) × (w - 4) at 4 and 8, a multiple of
  4: neither a multiple of C2's tile, whose last, partial tile holds live
  slots;
- "empty-then-live": every other layer -1 (alternating by column), so
  live layers follow empty ones: no kernel may stop at the first -1.
"""

from __future__ import annotations

import numpy as np

CASES = ("random", "all-background", "more-than-n", "duplicates", "alpha-edges",
         "non-finite", "pass-prefix", "ragged-plane", "empty-then-live")


def candidate_counts(msaa: int, k: int) -> tuple[int, int, int]:
    """(masked, solid, blended) candidate counts as render_shard takes them
    with msaa_shade_candidates grown to msaa."""
    extra = msaa - 1
    return min(msaa * k, k + extra), msaa, min(msaa * k, k + extra)


def _ids(rng, case: str, shape: tuple, n_ids: int, salt: int) -> np.ndarray:
    s, k, h, w = shape
    if case == "all-background":
        return np.full(shape, -1, np.int32)
    if case == "more-than-n":
        slot = np.arange(s * k, dtype=np.int32).reshape(s, k, 1, 1)
        return (slot * 7 + salt + np.zeros(shape, np.int32)).astype(np.int32)
    if case == "empty-then-live":
        ids = rng.integers(0, n_ids, shape).astype(np.int32)
        layer = np.arange(k).reshape(1, k, 1, 1)
        column = np.arange(w).reshape(1, 1, 1, w)
        return np.where((layer + column) % 2 == 0, -1, ids).astype(np.int32)
    ids = rng.integers(-1, n_ids, shape).astype(np.int32)
    if case == "duplicates":
        ids[:] = ids[:1]
    if case == "pass-prefix":  # every third pixel: one id in every slot
        one = rng.integers(0, n_ids, (h, w)).astype(np.int32)
        every = (np.arange(h * w).reshape(h, w) % 3) == 0
        ids = np.where(every, one, ids).astype(np.int32)
    return ids


def plane_shape(case: str, msaa: int, h: int, w: int) -> tuple[int, int]:
    """The (h, w) of a case's maps: "ragged-plane" cuts the plane."""
    if case == "ragged-plane":
        return h - 1, w - (1 if msaa <= 2 else 4)
    return h, w


def loop_inputs(case: str, msaa: int, k: int, h: int, w: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    h, w = plane_shape(case, msaa, h, w)
    n_ids = max(3 * k, 4)
    lt_m = _ids(rng, case, (msaa, k, h, w), n_ids, 0)
    lt_b = _ids(rng, case, (msaa, k, h, w), n_ids, 1000)
    solid = _ids(rng, case, (msaa, 1, h, w), n_ids, 2000)[:, 0]
    n_m, n_s, n_b = candidate_counts(msaa, k)
    if case == "more-than-n":  # fewer candidates than a pixel's ids
        n_m, n_s, n_b = (max(n // 2, 1) for n in (n_m, n_s, n_b))
    return dict(
        lt_m=lt_m, lz_m=rng.uniform(0.0, 1.0, (msaa, k, h, w)).astype(np.float32),
        solid_tid=solid, solid_z=rng.uniform(0.0, 1.0, (msaa, h, w)).astype(np.float32),
        lt_b=lt_b, n_masked=n_m, n_solid=n_s, n_blended=n_b)


def alpha_cutoff(case: str, msaa: int, n: int, h: int, w: int,
                 seed: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """The candidates' alpha and cutoff [n, h, w] f32."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.0, 1.0, (n, h, w)).astype(np.float32)
    cutoff = rng.uniform(0.0, 0.6, (n, h, w)).astype(np.float32)
    if case == "alpha-edges":
        floors = np.array([(s + 0.5) / msaa for s in range(msaa)] + [0.0], np.float32)
        pick = rng.integers(0, 4, (n, h, w))
        alpha = np.where(pick == 0, np.float32(np.nan), alpha)
        alpha = np.where(pick == 1, cutoff, alpha)
        at_floor = floors[rng.integers(0, len(floors), (n, h, w))]
        alpha = np.where(pick == 2, at_floor, alpha).astype(np.float32)
        cutoff = np.where(pick == 2, np.float32(0.0), cutoff).astype(np.float32)
    if case == "pass-prefix":
        floors = np.array([(s + 0.5) / msaa if msaa > 1 else 0.0 for s in range(msaa)],
                          np.float32)
        edges = np.concatenate([floors, np.nextafter(floors, np.float32(-np.inf)),
                                np.nextafter(floors, np.float32(np.inf)),
                                np.array([0.0, 1.0, np.nan], np.float32)])
        alpha = edges[rng.integers(0, len(edges), (n, h, w))]
        pick = rng.integers(0, 6, (n, h, w))
        specials = np.array([np.nan, np.inf, -np.inf], np.float32)
        cutoff = np.where(pick < 3, specials[np.minimum(pick, 2)],
                          np.where(pick == 3, alpha, cutoff * np.float32(0.5)))
        alpha, cutoff = alpha.astype(np.float32), cutoff.astype(np.float32)
    return alpha, cutoff


def shades(case: str, n: int, h: int, w: int, seed: int = 2) -> np.ndarray:
    """The candidates' shades [n, h, w, 4] f32 (rgb, alpha)."""
    rng = np.random.default_rng(seed)
    out = rng.normal(0.0, 1.0, (n, h, w, 4)).astype(np.float32)
    out[..., 3] = rng.uniform(0.0, 1.0, (n, h, w))
    if case == "non-finite":
        special = np.array([np.inf, -np.inf, np.nan, -0.0, 0.0], np.float32)
        pick = rng.integers(0, 8, out.shape)
        out = np.where(pick < len(special), special[np.minimum(pick, len(special) - 1)],
                       out).astype(np.float32)
    return out
