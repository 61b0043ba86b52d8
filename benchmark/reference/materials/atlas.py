# Frozen copy of renderer_tpu_torch/materials/atlas.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Texture atlas: the bindless 300-slot texture array as one packed image.

The reference binds up to 300 independent sampled images and lets fragment
shaders index them dynamically (descriptors.rs:124-173, main.frag:35-47).
The renderer has no texture units; sampling is arithmetic + gathers from device
memory. All
texture mips are packed into ONE [H, W] uint32 (RGBA8-packed) atlas so every
texture fetch in a frame becomes a gather into a single array — the
"descriptor table" is a per-(slot, mip) rectangle table.

Layout: shelf packing, one texel of border around every rectangle so
bilinear taps can sample across the edge without bleeding into a neighbor.
The border content follows the texture's own wrap mode (TextureWrap):
wrapped for REPEAT (the reference sampler is repeat-mode anisotropic
trilinear, descriptors.rs:90-105 — and the only mode it ever uses), edge /
mirror texels for CLAMP_TO_EDGE / MIRRORED_REPEAT (BEYOND the reference:
glTF sampler wrap modes honored per texture axis, raster/shade.apply_wrap).

Texels are stored sRGB-encoded (as decoded-from-BC7), flagged per slot; the
sampler decodes each tap before filtering by default and the filtered value
under RenderConfig.fast_sampler() (raster/shade.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference.core import constants
from benchmark.reference.materials.registry import MaterialRegistry, TextureKind

MAX_MIPS = 12
ATLAS_WIDTH = 4096


@dataclass
class Atlas:
    data: np.ndarray  # [AH, AW] uint32 (RGBA8 packed, little-endian r|g<<8|…)
    table: np.ndarray  # [MAX_TEXTURES, MAX_MIPS, 4] i32: x, y, w, h per mip
    srgb: np.ndarray  # [MAX_TEXTURES] i32: 1 if color channels are sRGB-encoded
    flat: np.ndarray  # [MAX_TEXTURES, 4] f32: mean linear color (cheap fallback)
    wrap: np.ndarray  # [MAX_TEXTURES, 2] i32: TextureWrap per axis (s, t)


def _pack_rgba(rgba: np.ndarray) -> np.ndarray:
    # RGBA8 → packed u32 is a pure reinterpret on little-endian hosts.
    rgba = np.ascontiguousarray(rgba, np.uint8)
    return rgba.view("<u4")[..., 0]


# numpy pad mode matching each TextureWrap's border texel: REPEAT wraps to
# the opposite edge; CLAMP_TO_EDGE replicates the edge texel; for a 1-texel
# border, MIRRORED_REPEAT's reflection about the edge is the edge texel too
# (np.pad "symmetric" ≡ "edge" at depth 1, kept distinct for clarity)
_PAD_MODES = {0: "wrap", 1: "edge", 2: "symmetric"}


def _with_mode_border(img: np.ndarray, wrap_s: int, wrap_t: int) -> np.ndarray:
    """Pad 1 texel per side: rows (v/t axis) per wrap_t, columns (u/s axis)
    per wrap_s. Two passes so the corners compose the two modes exactly as a
    hardware sampler's tap at (-1, -1) would resolve them."""
    img = np.pad(img, ((1, 1), (0, 0), (0, 0)), mode=_PAD_MODES[wrap_t])
    return np.pad(img, ((0, 0), (1, 1), (0, 0)), mode=_PAD_MODES[wrap_s])










def _plan_placements(shapes: dict[int, list[tuple[int, int]]]):
    """Shelf packing (tallest first, stable on registry slot/mip order) of
    bordered rects. `shapes[slot]` = [(h, w) per mip]. Returns
    (placements {(slot, mip): (x, y)}, atlas height). Shared by the host
    atlas and the device-decode plan (materials/atlas_device.py), so both
    produce the same layout."""
    rects = [
        (slot, mip, h + 2, w + 2)
        for slot, per in sorted(shapes.items())
        for mip, (h, w) in enumerate(per[:MAX_MIPS])
    ]
    rects.sort(key=lambda r: (-r[2], -r[3]))
    placements = {}
    shelf_y = 0
    shelf_h = 0
    cursor_x = 0
    for slot, mip, h, w in rects:
        assert w <= ATLAS_WIDTH, (
            f"texture slot {slot} mip {mip} is {w - 2} px wide (+2 border); "
            f"the atlas row is {ATLAS_WIDTH} px — downsample the source image"
        )
        if cursor_x + w > ATLAS_WIDTH:
            shelf_y += shelf_h
            cursor_x = 0
            shelf_h = 0
        placements[(slot, mip)] = (cursor_x, shelf_y)
        cursor_x += w
        shelf_h = max(shelf_h, h)
    height = shelf_y + shelf_h
    # round height to a sublane multiple
    return placements, (height + 7) // 8 * 8




def _blit_wrap(src: np.ndarray, atlas: np.ndarray, x: int, y: int) -> None:
    """Blit an RGBA8 [h,w,4] image into the u32 atlas at (x, y) with a
    1-texel REPEAT border (the port's numpy plain version)."""
    h, w = src.shape[:2]
    bordered = np.pad(_pack_rgba(src), ((1, 1), (1, 1)), mode="wrap")
    atlas[y - 1 : y + h + 1, x - 1 : x + w + 1] = bordered


def build_atlas(registry: MaterialRegistry) -> Atlas:
    """The host atlas: decoded mips blitted with their borders (the
    renderer uploads the finished arrays once per registry version)."""
    from benchmark.reference.raster.post import srgb_decode_np

    shapes = {
        slot: [img.shape[:2] for img in tex.mips[:MAX_MIPS]]
        for slot, tex in sorted(registry.textures.items())
    }
    placements, height = _plan_placements(shapes)

    data = np.zeros((max(height, 8), ATLAS_WIDTH), np.uint32)
    table = np.zeros((constants.MAX_TEXTURES, MAX_MIPS, 4), np.int32)
    srgb = np.zeros(constants.MAX_TEXTURES, np.int32)
    flat = np.zeros((constants.MAX_TEXTURES, 4), np.float32)
    wrap = np.zeros((constants.MAX_TEXTURES, 2), np.int32)

    for slot, tex in sorted(registry.textures.items()):
        srgb[slot] = 1 if tex.kind == TextureKind.SRGB_COLOR else 0
        wrap[slot] = (tex.wrap_s, tex.wrap_t)
        # average color from a small mip (box-filtered ≈ the full-res mean)
        small = tex.mips[min(len(tex.mips) - 1, max(len(tex.mips) - 5, 0))]
        mean = small.reshape(-1, 4).mean(axis=0) / 255.0
        if srgb[slot]:
            mean[:3] = srgb_decode_np(mean[:3])
        flat[slot] = mean
        for mip in range(MAX_MIPS):
            img = tex.mips[min(mip, len(tex.mips) - 1)]
            src_mip = min(mip, len(tex.mips) - 1)
            x, y = placements[(slot, src_mip)]
            h, w = img.shape[:2]
            table[slot, mip] = (x + 1, y + 1, w, h)
            if mip == src_mip:
                if tex.wrap_s == 0 and tex.wrap_t == 0:
                    _blit_wrap(img, data, x + 1, y + 1)
                else:
                    # non-repeat border texels (clamp/mirror); startup-only
                    # numpy path — non-repeat textures are the rare case
                    data[y : y + h + 2, x : x + w + 2] = _pack_rgba(
                        _with_mode_border(img, tex.wrap_s, tex.wrap_t)
                    )

    return Atlas(data=data, table=table, srgb=srgb, flat=flat, wrap=wrap)
