"""ntex texture container decoder.

Parity: renderer/src/image_loading/ntex.rs — 1024-byte header (40-byte magic
string, then w/h/depth/mips/VkFormat/block dims at offsets 992-1024), followed
by tightly packed mip levels. The reference samples BC7 blocks directly on the
GPU; the renderer has no texture units, so mips are decoded to RGBA8 numpy
arrays at load time. BC7 decodes on a torch device through
materials/bc7.py (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MAGIC = b"The GPU decodable image container format"

# VkFormat ids used by ntex files (physical_device.rs:18-19 TEXTURE_FORMATS).
VK_FORMAT_R8_UNORM = 9
VK_FORMAT_R8G8B8A8_UNORM = 37
VK_FORMAT_R8G8B8A8_SRGB = 43
VK_FORMAT_BC7_UNORM = 145
VK_FORMAT_BC7_SRGB = 146

# a texel of opaque black as the packed RGBA8 bits in int32 (a = 0xFF)
OPAQUE_BLACK = -(1 << 24)


class NtexDecodeError(Exception):
    pass


@dataclass
class NtexHeader:
    width: int
    height: int
    depth: int
    mip_levels: int
    vk_format: int
    block_width: int
    block_height: int
    block_size: int

    def mip_ranges(self) -> list[tuple[int, int]]:
        """Byte ranges of each mip relative to the pixel data (ntex.rs:60-72;
        `width >> mip` with no floor at 1, as the reference computes it)."""
        ranges = []
        offset = 0
        for mip in range(self.mip_levels):
            mw = self.width >> mip
            mh = self.height >> mip
            size = (-(-mw // self.block_width) * -(-mh // self.block_height)
                    * self.block_size)
            ranges.append((offset, offset + size))
            offset += size
        return ranges


def decode_header(data: bytes) -> NtexHeader:
    if len(data) < 1024 or data[:40] != MAGIC:
        raise NtexDecodeError("invalid ntex header")
    w, h, d, mips, fmt, bw, bh, bs = struct.unpack("<8I", data[992:1024])
    if d != 1:
        raise NtexDecodeError(f"ntex depth {d} not supported")
    return NtexHeader(w, h, d, mips, fmt, bw, bh, bs)


def _is_bc7(vk_format: int) -> bool:
    return vk_format in (VK_FORMAT_BC7_UNORM, VK_FORMAT_BC7_SRGB)


def _decode_bc7(block_data: bytes, width: int, height: int,
                device="cuda") -> np.ndarray:
    """One BC7 mip → [height, width, 4] u8: the blocks of the padded
    (≥ 4×4) image decode on `device`, then the edge blocks are cropped.
    Reserved blocks (byte 0 zero) give opaque black, as Pillow's bcn
    decoder (the JAX package's ntex) does; bc7.decode_blocks itself gives
    them transparent black, as bc7_jax does. Raises ValueError when the
    payload holds fewer blocks than the padded image needs (as Pillow's
    bcn decoder does)."""
    import torch

    from renderer_tpu_torch.materials import bc7

    pw = max(4, (width + 3) // 4 * 4)
    ph = max(4, (height + 3) // 4 * 4)
    n = (pw // 4) * (ph // 4)
    if len(block_data) < n * 16:
        raise ValueError("not enough image data")
    blocks = np.frombuffer(block_data, np.uint8, count=n * 16).reshape(n, 16)
    texels = bc7.decode_blocks(blocks, device=device)
    reserved = torch.from_numpy(blocks[:, 0] == 0).to(texels.device)
    texels = torch.where(reserved[:, None], torch.full_like(texels, OPAQUE_BLACK),
                         texels)
    return bc7.blocks_to_image(texels, pw, ph)[:height, :width].cpu().numpy()


def decode(data: bytes, device="cuda") -> tuple[NtexHeader, list[np.ndarray]]:
    """Returns (header, [mip0, mip1, ...]) with each mip an [h, w, 4] u8 RGBA
    array (R8 broadcast to RGB with alpha=R for font-style textures; the
    reference binds R8 directly and the imgui shader reads .r). BC7 mips
    decode on `device`."""
    header = decode_header(data)
    pixels = data[1024:]
    ranges = header.mip_ranges()
    expected = ranges[-1][1]
    if len(pixels) != expected:
        raise NtexDecodeError(
            f"ntex length mismatch: expected {expected + 1024}, got {len(data)}"
        )

    mips = []
    for mip, (start, end) in enumerate(ranges):
        mw = max(header.width >> mip, 1)
        mh = max(header.height >> mip, 1)
        raw = pixels[start:end]
        if _is_bc7(header.vk_format):
            mips.append(_decode_bc7(raw, mw, mh, device))
        elif header.vk_format in (VK_FORMAT_R8G8B8A8_UNORM, VK_FORMAT_R8G8B8A8_SRGB):
            mips.append(np.frombuffer(raw, np.uint8).reshape(mh, mw, 4).copy())
        elif header.vk_format == VK_FORMAT_R8_UNORM:
            r = np.frombuffer(raw, np.uint8).reshape(mh, mw)
            mips.append(np.repeat(r[..., None], 4, axis=-1))
        else:
            raise NtexDecodeError(f"unsupported VkFormat {header.vk_format}")
    return header, mips


def read_blocks(data: bytes) -> tuple[NtexHeader, list[np.ndarray] | None]:
    """Raw compressed mip payloads WITHOUT decoding: returns (header,
    [blocks_u8 [nb, 16] per mip]) for BC7 files, (header, None) for
    non-block formats. The device-decode atlas (materials/atlas_device.py)
    uploads these 1-byte/texel blocks instead of 4-byte/texel RGBA."""
    header = decode_header(data)
    if not _is_bc7(header.vk_format):
        return header, None
    pixels = data[1024:]
    ranges = header.mip_ranges()
    if len(pixels) != ranges[-1][1]:
        raise NtexDecodeError(
            f"ntex length mismatch: expected {ranges[-1][1] + 1024}, "
            f"got {len(data)}"
        )
    mips = [
        np.frombuffer(pixels[start:end], np.uint8).reshape(-1, 16)
        for start, end in ranges
    ]
    return header, mips


def read_blocks_file(path) -> tuple[NtexHeader, list[np.ndarray] | None]:
    with open(path, "rb") as f:
        return read_blocks(f.read())


def is_srgb_format(vk_format: int) -> bool:
    return vk_format in (VK_FORMAT_BC7_SRGB, VK_FORMAT_R8G8B8A8_SRGB)


# -- decoded-texture cache: a per-file npz of RGBA8 mips keyed by (path,
# size, mtime), so a warm start reads decoded mips instead of decoding ------

def _cache_dir() -> Path:
    root = os.environ.get("RENDERER_TPU_CACHE")
    if root:
        return Path(root) / "ntex"
    return Path(__file__).resolve().parents[2] / ".cache" / "ntex"


def decode_header_file(path) -> NtexHeader:
    """Header-only read (the reference's measure-phase mmap of the first
    1 KiB, gltf/src/lib.rs:393-409) — no pixel decode."""
    with open(path, "rb") as f:
        return decode_header(f.read(2048))


def file_fingerprint(path) -> str:
    """Cheap content identity for cache keys: absolute path + size + mtime."""
    p = Path(path)
    st = p.stat()
    return f"{p.resolve()}|{st.st_size}|{st.st_mtime_ns}"


def decode_file(path, device="cuda") -> tuple[NtexHeader, list[np.ndarray]]:
    """decode() for an on-disk ntex file, with a decoded-mips disk cache
    (the decode, on a miss, runs on `device`)."""
    path = Path(path)
    cfile = _cache_dir() / (hashlib.sha1(
        f"{file_fingerprint(path)}|port-v2".encode()).hexdigest() + ".npz")
    if cfile.exists():
        try:
            with np.load(cfile, allow_pickle=False) as z:
                header = NtexHeader(*(int(v) for v in z["header"]))
                mips = [z[f"mip{i}"] for i in range(header.mip_levels)]
            return header, mips
        except (OSError, ValueError, KeyError):
            pass  # corrupt/stale cache entry → re-decode
    header, mips = decode(path.read_bytes(), device)
    try:
        cfile.parent.mkdir(parents=True, exist_ok=True)
        tmp = cfile.with_name(f"{cfile.stem}.tmp{os.getpid()}.npz")
        meta = np.array(
            [header.width, header.height, header.depth, header.mip_levels,
             header.vk_format, header.block_width, header.block_height,
             header.block_size], np.int64,
        )
        np.savez(tmp, header=meta, **{f"mip{i}": m for i, m in enumerate(mips)})
        tmp.replace(cfile)
    except OSError:
        pass  # the cache is an optimization only
    return header, mips
