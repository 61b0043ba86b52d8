# Restated per frame from chip_smoke.py `sampler_work`,
# `S1_LIT_CHANNELS` and `shade_work` (its S1 and S2 branches, lit) at commit
# 5822f29: the same operations, on the reference's own candidate maps of the
# frame (benchmark/reference/frame.py `probe`) instead of a record of the
# port's calls. Part of the benchmark's yardstick; do not edit.
"""Work of the shading kernels S1 (full shade of the solid and the blended
candidates) and S2 (the masked candidates' alpha and cutoff) in one frame.

Operations (FP32, each multiply and add its own: the kernels are built with
--fmad=false), on the covered (candidate, pixel) elements only: S1 115
operations of perspective interpolation, then the lit mode's samples
with the channels each uses (base colour 4, emissive 3, occlusion 1,
normal 3) and 60 of lighting; S2 interpolation and one sample of one
channel (alpha). (chip_smoke counts S2 over every element of its call.)
A sample (`sampler_work`): 17 for the footprint and LOD, 5 for the choice
of mips and their weights (2 without trilinear), (aniso + 1) a channel to
accumulate and scale; a tap: 4 for its uv, 4 for the address modes, 3 a
channel for the two-mip blend (none without trilinear); a mip: 10 for the
texel coordinates and weights, 11 a channel for the bilinear blend; a
decode after the filter (not per tap) 13 a decoded channel a mip.
Bytes: every candidate id read once, and the outputs of the covered
elements written once (S1 RGBA, S2 alpha and cutoff, 4 bytes a value): what
an empty slot would hold is read by no later step. Texels and vertex data
are left out,
so the count is a floor of the bytes and the operations bound both
kernels on these frames."""

from __future__ import annotations

#: the channels of each sample S1 takes in the lit mode (the benchmark's
#: frames): base colour RGBA, emissive RGB, occlusion R, normal RGB
S1_LIT_CHANNELS = (4, 3, 1, 3)


def sampler_work(n: int, n_srgb: int, trilinear: bool, aniso: int,
                 per_tap: bool, channels: int = 4, decoded: int = 3) -> tuple[int, int]:
    """(FP32 operations, texel taps) of one sample of `channels` channels
    at n pixels, n_srgb of them on sRGB textures with `decoded` of those
    channels decoded."""
    mips = 2 if trilinear else 1
    tap = 8 + (3 * channels if trilinear else 0) + mips * (10 + 11 * channels)
    ops = n * (17 + (5 if trilinear else 2) + (aniso + 1) * channels + aniso * tap)
    if not per_tap:
        ops += n_srgb * aniso * mips * decoded * 13
    return ops, n * aniso * mips * 4


def _elements(cands) -> tuple[int, int]:
    """(covered elements, all elements) of a candidate map stack."""
    return int((cands >= 0).sum()), cands.numel()


def count(probe: dict, cfg) -> list:
    """[(kernel, operations, bytes)] of one frame's S1 and S2 calls."""
    kw = dict(trilinear=cfg.trilinear, aniso=cfg.aniso_samples, per_tap=cfg.srgb_per_tap)
    n, total = 0, 0
    for key in ("cands_s", "cands_b"):
        if probe.get(key) is not None:
            c, t = _elements(probe[key])
            n, total = n + c, total + t
    ops = n * (115 + 60)
    for c in S1_LIT_CHANNELS:
        ops += sampler_work(n, 0, channels=c, **kw)[0]
    out = [("S1", ops, total * 4 + n * 16)]
    if probe.get("cands_m") is not None:
        m, total_m = _elements(probe["cands_m"])
        out.append(("S2", m * 115 + sampler_work(m, 0, channels=1, **kw)[0],
                    total_m * 4 + m * 8))
    return out
