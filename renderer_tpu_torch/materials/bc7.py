"""BC7 block decode as PyTorch integer ops on an explicit device.

The reference samples BC7 natively (the GPU's texture units decode per tap,
renderer/src/image_loading.rs:83-237). The renderer has no texture units,
so it decodes once at load time, into RGBA mips (assets/ntex.py) or straight
into the packed atlas (materials/atlas_device.py). On the card the decode
runs where the atlas lives: the compressed blocks (1 byte a texel) cross
the link and the 4-byte texels never do.

The decode is exact (BC7 is integer-deterministic): bit-equal to Pillow's
bcn decoder on every mode, held by tests/test_torch_bc7.py against the
committed vectors in tests/golden/torch-bc7-vectors.npz and against the JAX
package's decoder. A 128-bit block is held as four little-endian 32-bit
words in int64, so every shift is a plain non-negative int64 shift (torch's
uint32 support on CUDA is thin, and `>>` on int32 is arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from renderer_tpu_torch.interop import resolve_device
from renderer_tpu_torch.materials import bc7_tables as T

# Interpolation weight tables (BC7 spec): color = (lo*(64-w) + hi*w + 32)>>6
WEIGHTS = {
    2: (0, 21, 43, 64),
    3: (0, 9, 18, 27, 37, 46, 55, 64),
    4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64),
}

# Per-mode field parameters (BC7 spec layout, LSB-first):
# (subsets, partition bits, rotation bits, index-selection bits, color bits,
#  alpha bits, p-bit kind, index bits, secondary index bits)
MODES = {
    0: (3, 4, 0, 0, 4, 0, "unique", 3, 0),
    1: (2, 6, 0, 0, 6, 0, "shared", 3, 0),
    2: (3, 6, 0, 0, 5, 0, "none", 2, 0),
    3: (2, 6, 0, 0, 7, 0, "unique", 2, 0),
    4: (1, 0, 2, 1, 5, 6, "none", 2, 3),
    5: (1, 0, 2, 0, 7, 8, "none", 2, 2),
    6: (1, 0, 0, 0, 7, 7, "unique", 4, 0),
    7: (2, 6, 0, 0, 5, 5, "unique", 2, 0),
}

#: blocks decoded per step of decode_words and of the device atlas's
#: realize_atlas: bounds the decode's temporaries (~40 [chunk, 16] int64
#: tensors, 2^18 blocks = 4.2M texels) independent of the texture's size
DECODE_CHUNK = 1 << 18


def block_modes(byte0: torch.Tensor) -> torch.Tensor:
    """Mode of each block from its first byte [N]: the index of the lowest
    set bit, 8 when the byte is zero (reserved)."""
    byte0 = byte0.to(torch.int64) & 0xFF
    shifts = torch.arange(8, dtype=torch.int64, device=byte0.device)
    bits = ((byte0[:, None] >> shifts) & 1).to(torch.int32)
    mode = torch.argmax(bits, dim=1).to(torch.int32)  # first set bit
    return torch.where(byte0 == 0, torch.full_like(mode, 8), mode)


def words_from_bytes(blocks_u8, device) -> torch.Tensor:
    """[N, 16] u8 blocks (numpy or tensor) → [N, 4] int64 little-endian
    words on `device`, each in [0, 2^32)."""
    if isinstance(blocks_u8, torch.Tensor):
        b = blocks_u8.to(device=device, dtype=torch.uint8).reshape(-1, 16)
    else:
        b = np.ascontiguousarray(blocks_u8, np.uint8).reshape(-1, 16)
        if not b.flags.writeable:  # e.g. a view of file bytes
            b = b.copy()
        b = torch.from_numpy(b).to(device)
    b = b.to(torch.int64).reshape(-1, 4, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _get(blocks: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """The n bits at LSB-first static offset `off` of each block, [N] int64."""
    w, s = off // 32, off % 32
    v = blocks[:, w] >> s
    if s and s + n > 32:
        v = v | (blocks[:, w + 1] << (32 - s))
    return v & ((1 << n) - 1)


def _get_dyn(blocks: torch.Tensor, off: torch.Tensor, width: torch.Tensor):
    """Per-texel fields at dynamic offsets: off/width [N, 16] int64 (the
    index fields move with the partition's anchors). Width ≤ 4, so a field
    spans at most two words."""
    word = off >> 5
    s = off & 31
    w0 = torch.gather(blocks, 1, word)
    w1 = torch.gather(blocks, 1, torch.clamp(word + 1, max=3))
    lo = w0 >> s
    hi = torch.where(s == 0, torch.zeros_like(w1), w1 << (32 - s))
    return (lo | hi) & ((torch.ones_like(width) << width) - 1)


def _expand(v: torch.Tensor, n: int) -> torch.Tensor:
    """Endpoint dequantization: left-align the n-bit value to 8 bits and
    replicate its top bits (every BC7 endpoint incl. p-bit is 5-8 bits)."""
    assert 5 <= n <= 8, n
    return (v << (8 - n)) | (v >> (2 * n - 8))


def _texel_index_fields(part, anchors, ibits: int, idx_start: int):
    """Per-texel (offset, width) of the index fields: texel 0 and the
    partition's anchor texels carry one bit fewer."""
    n = part.shape[0]
    t = torch.arange(16, dtype=torch.int64, device=part.device)[None, :]
    width = torch.full((n, 16), ibits, dtype=torch.int64, device=part.device)
    width = torch.where(t == 0, ibits - 1, width)
    for a in anchors:
        width = torch.where(t == a[:, None], ibits - 1, width)
    off = idx_start + torch.cumsum(width, dim=1) - width
    return off, width


def _table(arr, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr), dtype=torch.int64, device=device)


def decode_mode(blocks: torch.Tensor, mode: int) -> torch.Tensor:
    """Decode [N, 4] int64 words of ONE mode → [N, 16] int64 packed RGBA8
    texels (r | g<<8 | b<<16 | a<<24, in [0, 2^32)) in 4x4 raster order."""
    (ns, pb, rb, isb, cb, ab, pkind, ib, ib2) = MODES[mode]
    dev = blocks.device
    n = blocks.shape[0]
    cur = mode + 1

    part = (_get(blocks, cur, pb) if pb
            else torch.zeros(n, dtype=torch.int64, device=dev))
    cur += pb
    rot = _get(blocks, cur, rb) if rb else None
    cur += rb
    ism = _get(blocks, cur, isb) if isb else None
    cur += isb

    # endpoints: channel-major, then per-endpoint p-bits
    ne = 2 * ns
    channels = 3 + (1 if ab else 0)
    raw = []  # [channels][ne] of [N]
    for c in range(channels):
        bits = ab if c == 3 else cb
        row = []
        for _e in range(ne):
            row.append(_get(blocks, cur, bits))
            cur += bits
        raw.append(row)
    if pkind == "unique":
        pbits = []
        for _e in range(ne):
            pbits.append(_get(blocks, cur, 1))
            cur += 1
    elif pkind == "shared":
        shared = []
        for _s in range(ns):
            shared.append(_get(blocks, cur, 1))
            cur += 1
        pbits = [shared[e // 2] for e in range(ne)]
    else:
        pbits = None

    # dequantize to 8 bits
    ep = [[None] * ne for _ in range(channels)]
    for c in range(channels):
        bits = ab if c == 3 else cb
        for e in range(ne):
            v = raw[c][e]
            if pbits is not None:
                ep[c][e] = _expand((v << 1) | pbits[e], bits + 1)
            else:
                ep[c][e] = _expand(v, bits)

    # index fields
    if ns == 1:
        anchors = []
    elif ns == 2:
        anchors = [_table(T.ANCHOR_2, dev)[part]]
    else:
        anchors = [_table(T.ANCHOR_3_2, dev)[part], _table(T.ANCHOR_3_3, dev)[part]]
    off, width = _texel_index_fields(part, anchors, ib, cur)
    idx = _get_dyn(blocks, off, width)  # [N, 16]
    cur += 16 * ib - 1 - len(anchors)
    idx2 = None
    if ib2:
        off2, width2 = _texel_index_fields(part, [], ib2, cur)
        idx2 = _get_dyn(blocks, off2, width2)

    # subset of each texel
    if ns == 1:
        sub = torch.zeros((n, 16), dtype=torch.int64, device=dev)
    elif ns == 2:
        sub = _table(T.PARTITION_2, dev)[part]
    else:
        sub = _table(T.PARTITION_3, dev)[part]

    def interp(channel: int, indices, ibits_used: int):
        lo = torch.stack([ep[channel][2 * s] for s in range(ns)], dim=1)
        hi = torch.stack([ep[channel][2 * s + 1] for s in range(ns)], dim=1)
        lo = torch.gather(lo, 1, sub)
        hi = torch.gather(hi, 1, sub)
        w = _table(WEIGHTS[ibits_used], dev)[indices]
        return (lo * (64 - w) + hi * w + 32) >> 6  # [N, 16]

    if mode == 4:
        # index-selection bit: 0 → color from the 2-bit set, alpha from the
        # 3-bit set; 1 → swapped
        swap = (ism == 1)[:, None]
        rgb = [torch.where(swap, interp(c, idx2, ib2), interp(c, idx, ib))
               for c in range(3)]
        alpha = torch.where(swap, interp(3, idx, ib), interp(3, idx2, ib2))
    elif mode == 5:
        rgb = [interp(c, idx, ib) for c in range(3)]
        alpha = interp(3, idx2, ib2)
    else:
        rgb = [interp(c, idx, ib) for c in range(3)]
        alpha = (interp(3, idx, ib) if ab
                 else torch.full((n, 16), 255, dtype=torch.int64, device=dev))

    if rot is not None:
        # rotation swaps alpha with one color channel (modes 4/5)
        r = rot[:, None]
        out_rgb = [torch.where(r == c + 1, alpha, rgb[c]) for c in range(3)]
        alpha = torch.where(
            r == 0, alpha,
            torch.where(r == 1, rgb[0], torch.where(r == 2, rgb[1], rgb[2])))
        rgb = out_rgb

    return rgb[0] | (rgb[1] << 8) | (rgb[2] << 16) | (alpha << 24)


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 with the same 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def decode_words(words: torch.Tensor) -> torch.Tensor:
    """Decode [N, 4] int64 words of mixed modes → [N, 16] int32 packed
    texels on their device: each mode's group decodes with its static
    layout, DECODE_CHUNK blocks at a time. Reserved blocks (mode 8) decode to
    transparent black, as the JAX package's decoder gives them."""
    out = torch.zeros((words.shape[0], 16), dtype=torch.int32,
                      device=words.device)
    if not words.shape[0]:
        return out
    modes = block_modes(words[:, 0])
    for m in range(8):
        sel = torch.nonzero(modes == m).reshape(-1)
        for i in range(0, sel.numel(), DECODE_CHUNK):
            s = sel[i:i + DECODE_CHUNK]
            out[s] = to_int32_bits(decode_mode(words[s], m))
    return out


def decode_blocks(blocks_u8, device="cuda") -> torch.Tensor:
    """[N, 16] u8 BC7 blocks (numpy or tensor) → [N, 16] int32 packed RGBA8
    texels (r | g<<8 | b<<16 | a<<24, the int32 holding the u32's bits),
    decoded on `device` — the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    return decode_words(words_from_bytes(blocks_u8, dev))


def blocks_to_image(texels: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[N, 16] packed texels of a (width, height) mip's blocks in raster
    block order → the [height, width, 4] u8 image (edge blocks cropped)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    img = texels.reshape(bh, bw, 4, 4).permute(0, 2, 1, 3).reshape(bh * 4, bw * 4)
    img = img[:height, :width].contiguous()
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=img.device)
    return ((img[..., None] >> shifts) & 0xFF).to(torch.uint8)
