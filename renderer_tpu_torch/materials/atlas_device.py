"""Device-decoded texture atlas: upload compressed blocks, decode on the card.

The host atlas path (materials/atlas.py) decodes BC7 on the host and
uploads the full decoded [AH, AW] atlas — 4 bytes a texel plus packing
gaps. This module uploads the SOURCE instead:

- the raw BC7 block stream (1 byte a texel) in ORIGINAL rect order; the
  device derives everything else: block modes from the block bytes, the
  mode grouping by one stable sort (each mode's group then decodes with its
  static layout, materials/bc7.py), and per-block destinations from
  per-RECT segment metadata by a searchsorted (a few KB for the whole
  atlas),
- the non-BC7 rects' texels verbatim (small: fonts, embedded PNGs),
- border gather/scatter index lists replaying atlas.py's two-pass border
  composition (rows per wrap_t, then columns per wrap_s INCLUDING the row
  borders, exactly np.pad's corner composition).

`realize_atlas(plan)` returns the [AH, AW] atlas on the device,
bit-identical to materials/atlas.build_atlas(...).data (held by
tests/test_torch_bc7.py and chip_smoke.py). The plan is disk-cached by
texture content fingerprints like the host atlas bundle.

Reference analog: the GPU samples BC7 natively, so only compressed bytes
ever cross the bus (image_loading.rs:83-237); here the decode happens once
at startup, but the link carries compressed bytes as the reference's does.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from renderer_tpu_torch.core import constants
from renderer_tpu_torch.interop import resolve_device
from renderer_tpu_torch.materials import bc7
from renderer_tpu_torch.materials.atlas import (
    ATLAS_WIDTH,
    MAX_MIPS,
    _atlas_cache_file,
    _pack_rgba,
    _plan_placements,
    publish_dir,
)
from renderer_tpu_torch.materials.registry import MaterialRegistry, TextureKind

# block meta packing: flat_base << 4 | (vh-1) << 2 | (vw-1)
_META_SHIFT = 4

_PLAN_ARRAYS = ("seg_start", "seg_base", "seg_bw", "seg_w", "seg_h",
                "raw_tiles", "raw_meta", "border_src1", "border_dst1",
                "border_src2", "border_dst2", "table", "srgb", "flat", "wrap")


@dataclass
class AtlasPlan:
    shape: tuple[int, int]  # (AH, AW)
    blocks: np.ndarray  # [N, 4] u32 BC7 blocks in ORIGINAL rect order
    mode_counts: dict[int, int]  # mode -> block count
    # per-RECT segment metadata (one row per (texture, mip) BC7 rect):
    seg_start: np.ndarray  # [R+1] i32 block-stream offsets (seg_start[R]=N)
    seg_base: np.ndarray   # [R] i32 atlas flat index of the rect's (+1,+1)
    seg_bw: np.ndarray     # [R] i32 blocks per rect row
    seg_w: np.ndarray      # [R] i32 rect texel width
    seg_h: np.ndarray      # [R] i32 rect texel height
    raw_tiles: np.ndarray  # [M, 16] u32 non-BC7 texels as 4x4 tiles
    raw_meta: np.ndarray  # [M] u32 packed placement (per tile; small)
    border_src1: np.ndarray  # row pass (wrap_t)
    border_dst1: np.ndarray
    border_src2: np.ndarray  # column pass (wrap_s, sees row borders)
    border_dst2: np.ndarray
    table: np.ndarray
    srgb: np.ndarray
    flat: np.ndarray
    wrap: np.ndarray

    @property
    def upload_bytes(self) -> int:
        """Host->device payload of realize_atlas — what crosses the link
        (the decision signal against the full decoded atlas)."""
        return (self.blocks.nbytes
                + self.seg_start.nbytes + self.seg_base.nbytes
                + self.seg_bw.nbytes + self.seg_w.nbytes + self.seg_h.nbytes
                + self.raw_tiles.nbytes + self.raw_meta.nbytes
                + self.border_src1.nbytes + self.border_dst1.nbytes
                + self.border_src2.nbytes + self.border_dst2.nbytes)


def _mip_shapes(h: int, w: int, n: int) -> list[tuple[int, int]]:
    return [(max(h >> m, 1), max(w >> m, 1)) for m in range(n)]


def _tile_meta(x: int, y: int, w: int, h: int, aw: int, n_tiles: int):
    """Packed placement word per 4x4 tile of a (w, h) rect at atlas
    (x+1, y+1): top-left flat index << 4 | (valid_h-1) << 2 | (valid_w-1)."""
    bi = np.arange(n_tiles, dtype=np.int64)
    bw = (w + 3) // 4
    by, bx = bi // bw, bi % bw
    base = (y + 1 + by * 4) * aw + (x + 1 + bx * 4)
    vw = np.minimum(w - bx * 4, 4)
    vh = np.minimum(h - by * 4, 4)
    assert base.max() < (1 << (32 - _META_SHIFT)), "atlas too tall"
    return ((base << _META_SHIFT) | ((vh - 1) << 2) | (vw - 1)).astype(np.uint32)


def _border_indices(x0, y0, w, h, wrap_s, wrap_t, aw):
    """Flat (src, dst) index lists replaying atlas._with_mode_border: pass 1
    writes the top/bottom border rows from the rect's interior (wrap →
    opposite edge, clamp/mirror-at-1 → nearest edge); pass 2 writes the
    left/right border columns over the FULL bordered height, reading pass-1
    results at the corners."""
    xs = np.arange(w, dtype=np.int64) + (x0 + 1)
    top_src_y = y0 + h if wrap_t == 0 else y0 + 1
    bot_src_y = y0 + 1 if wrap_t == 0 else y0 + h
    dst1 = np.concatenate([y0 * aw + xs, (y0 + h + 1) * aw + xs])
    src1 = np.concatenate([top_src_y * aw + xs, bot_src_y * aw + xs])

    ys = np.arange(h + 2, dtype=np.int64) + y0
    left_src_x = x0 + w if wrap_s == 0 else x0 + 1
    right_src_x = x0 + 1 if wrap_s == 0 else x0 + w
    dst2 = np.concatenate([ys * aw + x0, ys * aw + (x0 + w + 1)])
    src2 = np.concatenate([ys * aw + left_src_x, ys * aw + right_src_x])
    return src1, dst1, src2, dst2


def reserved_block(registry: MaterialRegistry) -> str | None:
    """Where the first reserved BC7 block (byte 0 zero: no mode bit) of the
    registry's block streams lies, as "texture 'name' mip m"; None if there
    is none."""
    for _, tex in sorted(registry.textures.items()):
        for mip, blocks in enumerate((tex.bc7_mips or [])[:MAX_MIPS]):
            if not np.asarray(blocks)[:, 0].all():
                return f"texture {tex.name!r} mip {mip}"
    return None


def build_atlas_plan(registry: MaterialRegistry) -> AtlasPlan:
    """Host phase: shelf-pack (the host atlas's layout, through the shared
    _plan_placements), gather block streams + placement meta + border
    indices. Decodes no BC7 except one small mip per texture, on the host,
    for the `flat` mean-color fallback."""
    from renderer_tpu_torch.raster.post import srgb_decode_np

    where = reserved_block(registry)
    if where is not None:
        # the host decode gives these Pillow's opaque black, which the
        # device decode does not reproduce: refuse them, as the JAX plan does
        raise ValueError(f"{where}: reserved BC7 block (no mode bit) in stream")
    texs = dict(sorted(registry.textures.items()))
    blocks_of = {slot: tex.bc7_mips for slot, tex in texs.items()}
    shapes = {}
    for slot, tex in texs.items():
        bm = blocks_of[slot]
        if bm is not None:
            shapes[slot] = _mip_shapes(tex.height, tex.width, len(bm))[:MAX_MIPS]
        else:
            shapes[slot] = [img.shape[:2] for img in tex.mips[:MAX_MIPS]]
    placements, height = _plan_placements(shapes)
    ah, aw = max(height, 8), ATLAS_WIDTH

    table = np.zeros((constants.MAX_TEXTURES, MAX_MIPS, 4), np.int32)
    srgb = np.zeros(constants.MAX_TEXTURES, np.int32)
    flat = np.zeros((constants.MAX_TEXTURES, 4), np.float32)
    wrap = np.zeros((constants.MAX_TEXTURES, 2), np.int32)

    all_blocks, seg_start, seg_base, seg_bw, seg_w, seg_h = [], [0], [], [], [], []
    raw_tiles, raw_meta = [], []
    b_s1, b_d1, b_s2, b_d2 = [], [], [], []

    for slot, tex in texs.items():
        srgb[slot] = 1 if tex.kind == TextureKind.SRGB_COLOR else 0
        wrap[slot] = (tex.wrap_s, tex.wrap_t)
        bm = blocks_of[slot]
        n_mips = len(shapes[slot])

        # mean linear color from a small mip (the flat fallback): for block
        # textures only that one small mip is decoded, on the host
        small_i = min(n_mips - 1, max(n_mips - 5, 0))
        if bm is not None:
            sh, sw = shapes[slot][small_i]
            texels = bc7.decode_blocks(bm[small_i], device="cpu")
            small_rgba = bc7.blocks_to_image(texels, sw, sh).numpy()
        else:
            small_rgba = tex.mips[small_i]
        mean = small_rgba.reshape(-1, 4).astype(np.float64).mean(axis=0) / 255.0
        if srgb[slot]:
            mean[:3] = srgb_decode_np(mean[:3])
        flat[slot] = mean

        for mip in range(MAX_MIPS):
            src_mip = min(mip, n_mips - 1)
            h, w = shapes[slot][src_mip]
            x, y = placements[(slot, src_mip)]
            table[slot, mip] = (x + 1, y + 1, w, h)
            if mip != src_mip:
                continue
            if bm is not None:
                blocks = bm[src_mip]
                all_blocks.append(np.ascontiguousarray(blocks).view("<u4"))
                seg_start.append(seg_start[-1] + len(blocks))
                seg_base.append((y + 1) * aw + (x + 1))
                seg_bw.append((w + 3) // 4)
                seg_w.append(w)
                seg_h.append(h)
            else:
                texels = _pack_rgba(tex.mips[src_mip])  # [h, w] u32
                bw, bh = (w + 3) // 4, (h + 3) // 4
                padded = np.zeros((bh * 4, bw * 4), np.uint32)
                padded[:h, :w] = texels
                tiles = padded.reshape(bh, 4, bw, 4).transpose(0, 2, 1, 3).reshape(-1, 16)
                raw_tiles.append(tiles)
                raw_meta.append(_tile_meta(x, y, w, h, aw, len(tiles)))
            s1, d1, s2, d2 = _border_indices(x, y, w, h, tex.wrap_s, tex.wrap_t, aw)
            b_s1.append(s1)
            b_d1.append(d1)
            b_s2.append(s2)
            b_d2.append(d2)

    blocks_cat = (np.concatenate(all_blocks) if all_blocks
                  else np.zeros((0, 4), np.uint32))
    # per-mode group sizes (the grouping itself happens on the device)
    modes = bc7.block_modes(torch.from_numpy(
        blocks_cat.view(np.uint8).reshape(-1, 16)[:, 0].copy())).numpy()
    mode_counts = {int(m): int(c)
                   for m, c in zip(*np.unique(modes, return_counts=True))}

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)

    return AtlasPlan(
        shape=(ah, aw),
        blocks=blocks_cat,
        mode_counts=mode_counts,
        seg_start=np.asarray(seg_start, np.int32),
        seg_base=np.asarray(seg_base or [0], np.int32),
        seg_bw=np.asarray(seg_bw or [1], np.int32),
        seg_w=np.asarray(seg_w or [4], np.int32),
        seg_h=np.asarray(seg_h or [4], np.int32),
        raw_tiles=(np.concatenate(raw_tiles) if raw_tiles
                   else np.zeros((0, 16), np.uint32)),
        raw_meta=cat(raw_meta, np.uint32),
        border_src1=cat(b_s1, np.int32), border_dst1=cat(b_d1, np.int32),
        border_src2=cat(b_s2, np.int32), border_dst2=cat(b_d2, np.int32),
        table=table, srgb=srgb, flat=flat, wrap=wrap,
    )


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    """A plan array on the device as int64 (u32 bits widened there)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a memory-mapped cache entry
        a = a.copy()
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(dev).to(torch.int64) & 0xFFFFFFFF
    return torch.from_numpy(a.astype(np.int64, copy=False)).to(dev)


def realize_atlas(plan: AtlasPlan, device="cuda") -> torch.Tensor:
    """The [AH, AW] int32 atlas (the packed u32 texels' bits) on `device` —
    the card unless the caller asks for the CPU — bit-identical to
    build_atlas(registry).data.

    The block stream arrives in ORIGINAL rect order; the device computes
    each block's mode from its bytes, groups by mode with ONE stable sort,
    derives each block's destination from the per-rect segment table by a
    searchsorted, decodes and scatters each mode's group
    bc7.DECODE_CHUNK blocks at a time, scatters the raw tiles, then runs
    the two border passes."""
    dev = resolve_device(device)
    ah, aw = plan.shape
    n_flat = ah * aw
    # the last slot takes the texels that edge blocks crop away
    flat = torch.zeros(n_flat + 1, dtype=torch.int32, device=dev)
    t = torch.arange(16, dtype=torch.int64, device=dev)
    ty, tx = t // 4, t % 4

    def scatter(tiles, base, vw, vh):
        dest = base[:, None] + ty[None, :] * aw + tx[None, :]
        oob = (ty[None, :] >= vh[:, None]) | (tx[None, :] >= vw[:, None])
        dest = torch.where(oob, n_flat, dest)
        flat[dest.reshape(-1)] = tiles.reshape(-1)

    if plan.blocks.shape[0]:
        words = _upload(plan.blocks, dev)
        seg_start = _upload(plan.seg_start, dev)
        seg_base, seg_bw = _upload(plan.seg_base, dev), _upload(plan.seg_bw, dev)
        seg_w, seg_h = _upload(plan.seg_w, dev), _upload(plan.seg_h, dev)
        mode = bc7.block_modes(words[:, 0])
        perm = torch.sort(mode, stable=True).indices
        off = 0
        for m, n_m in sorted(plan.mode_counts.items()):
            for c0 in range(off, off + n_m, bc7.DECODE_CHUNK):
                orig = perm[c0:min(c0 + bc7.DECODE_CHUNK, off + n_m)]
                tex = bc7.to_int32_bits(bc7.decode_mode(words[orig], m))
                # destination from the per-rect segment table
                r = torch.searchsorted(seg_start, orig, right=True) - 1
                local = orig - seg_start[r]
                by = local // seg_bw[r]
                bx = local - by * seg_bw[r]
                base = seg_base[r] + by * 4 * aw + bx * 4
                scatter(tex, base, torch.clamp(seg_w[r] - bx * 4, max=4),
                        torch.clamp(seg_h[r] - by * 4, max=4))
            off += n_m
    if plan.raw_tiles.shape[0]:
        meta = _upload(plan.raw_meta, dev)
        tiles = bc7.to_int32_bits(_upload(plan.raw_tiles, dev))
        scatter(tiles, meta >> _META_SHIFT, (meta & 3) + 1, ((meta >> 2) & 3) + 1)
    if plan.border_src1.shape[0]:
        bs1, bd1 = _upload(plan.border_src1, dev), _upload(plan.border_dst1, dev)
        flat[bd1] = flat[bs1]
        bs2, bd2 = _upload(plan.border_src2, dev), _upload(plan.border_dst2, dev)
        flat[bd2] = flat[bs2]
    return flat[:n_flat].reshape(ah, aw)


def _plan_cache_dir(registry: MaterialRegistry):
    base = _atlas_cache_file(registry)
    return base.with_name(base.name + "-plan")


def build_atlas_plan_cached(registry: MaterialRegistry) -> AtlasPlan | None:
    """Disk-cached plan (keyed by texture content fingerprints like the
    host atlas bundle): a warm start reads raw arrays — no ntex parsing, no
    packing. None when a block stream holds a reserved block, which the plan
    refuses (so a cached plan never holds one)."""
    cdir = _plan_cache_dir(registry)
    if cdir.is_dir():
        try:
            meta = json.loads((cdir / "meta.json").read_text())
            if meta.get("version") != 2:
                raise ValueError("plan cache format changed")
            kw = {n: np.load(cdir / f"{n}.npy", allow_pickle=False)
                  for n in _PLAN_ARRAYS}
            blocks = np.load(cdir / "blocks.npy", mmap_mode="r", allow_pickle=False)
            return AtlasPlan(
                shape=tuple(meta["shape"]), blocks=blocks,
                mode_counts={int(m): int(c) for m, c in meta["mode_counts"].items()},
                **kw)
        except (OSError, ValueError, KeyError):
            pass  # corrupt/stale/old-format → rebuild

    if reserved_block(registry) is not None:
        return None
    plan = build_atlas_plan(registry)
    try:
        cdir.parent.mkdir(parents=True, exist_ok=True)
        tmp = cdir.with_name(f"{cdir.name}.tmp{os.getpid()}")
        tmp.mkdir(exist_ok=True)
        for n in _PLAN_ARRAYS:
            np.save(tmp / f"{n}.npy", getattr(plan, n), allow_pickle=False)
        np.save(tmp / "blocks.npy", plan.blocks, allow_pickle=False)
        (tmp / "meta.json").write_text(json.dumps(
            {"version": 2, "shape": list(plan.shape),
             "mode_counts": {str(m): int(c) for m, c in plan.mode_counts.items()}}))
        publish_dir(tmp, cdir)
    except OSError:
        pass  # the cache is an optimization only
    return plan
