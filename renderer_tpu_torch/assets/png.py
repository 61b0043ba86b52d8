"""PNG decode and encode on zlib + numpy (no Pillow: the card's machine has
none).

The decoder takes every image the PNG specification allows: colour types 0
(grey), 2 (RGB), 3 (palette, with tRNS), 4 (grey + alpha) and 6 (RGBA), bit
depths 1, 2 and 4 (grey and palette), 8 and 16 (16-bit samples by their
high byte), plain or Adam7-interlaced. Its output is what Pillow's
`Image.open(...).convert("RGBA")` gives (tests/test_torch_sandbox.py holds
the two equal over every colour type, depth, filter and interlace choice),
Pillow's quirks included: 16-bit grey is clipped to 255 rather than taking
its high byte, and a tRNS colour key applies as Pillow applies it (see
decode_png).

The encoder writes grey, RGB or RGBA u8 images.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _fail(msg: str):
    from renderer_tpu_torch.assets.gltf_loader import GltfLoadingError

    raise GltfLoadingError(msg)


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        _fail("not a PNG image (bad signature)")
    off = 8
    while off + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[off:off + 8])
        if off + 12 + n > len(data):
            _fail(f"PNG truncated in a {kind!r} chunk")
        yield kind, data[off + 8:off + 8 + n]
        off += 12 + n
        if kind == b"IEND":
            return
    _fail("PNG truncated: no IEND chunk")


def _unfilter(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9.2) of the first `height` rows
    of `raw` → [height, stride] u8.
    None and Up are row-wide; Sub is a running sum; Average and Paeth
    depend on the texel just decoded and run byte by byte."""
    if len(raw) < height * (stride + 1):
        _fail("PNG image data is shorter than its size")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        f, line = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif f == 2:
            cur = line + prior
        elif f in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if f == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            _fail(f"PNG row filter {f} is not one of 0-4")
        out[y] = cur
        prior = out[y]
    return out


# Adam7's seven passes: (x0, y0, dx, dy) of the pixels each one carries
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(raw, width: int, height: int, nch: int, depth: int) -> np.ndarray:
    """Unfilter and unpack one (sub-)image at the start of `raw` →
    [height, width, nch] samples (u8, or >u2 at depth 16)."""
    stride = (width * nch * depth + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, nch * depth // 8))
    if depth == 16:
        return rows.view(">u2").reshape(height, width, nch)
    if depth == 8:
        return rows.reshape(height, width, nch)
    # 1, 2 or 4 bits a sample (one channel), the leftmost in the high bits
    per = 8 // depth
    shifts = depth * np.arange(per - 1, -1, -1, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(height, stride * per)[:, :width, None]


def _image_samples(raw: bytes, width: int, height: int, nch: int, depth: int,
                   interlace: int) -> np.ndarray:
    """All samples of the image, [height, width, nch]: plain, or gathered
    from its seven Adam7 passes (each filtered as an image of its own)."""
    if not interlace:
        return _samples(raw, width, height, nch, depth)
    view = memoryview(raw)
    full = np.zeros((height, width, nch), ">u2" if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = max(0, (width - x0 + dx - 1) // dx)
        ph = max(0, (height - y0 + dy - 1) // dy)
        if pw == 0 or ph == 0:
            continue  # an empty pass has no scanlines at all
        full[y0::dy, x0::dx] = _samples(view[off:], pw, ph, nch, depth)
        off += ph * ((pw * nch * depth + 7) // 8 + 1)
    return full


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → [h, w, 4] u8 RGBA (as Pillow's convert("RGBA") gives
    it)."""
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        _fail("PNG without an IHDR chunk")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _CHANNELS:
        _fail(f"PNG colour type {ctype} is not a valid colour type")
    if interlace not in (0, 1):
        _fail(f"PNG interlace method {interlace} is not 0 or 1")
    allowed = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if depth not in allowed:
        _fail(f"PNG colour type {ctype} at bit depth {depth} is not valid "
              f"(bit depths {allowed})")
    nch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        _fail(f"PNG image data is not a complete zlib stream ({e})")
    full = _image_samples(raw, width, height, nch, depth, interlace)
    if depth == 16:
        px = (full >> 8).astype(np.uint8)  # the high byte
        if ctype == 0:
            # Pillow opens 16-bit grey as "I;16" and its RGBA conversion
            # clips the 16-bit value to 255 rather than taking the high byte
            px = np.minimum(full, 255).astype(np.uint8)
    elif depth < 8 and ctype == 0:
        # grey below 8 bits, scaled to the u8 range (1 bit: 0 or 255)
        px = full * np.uint8(255 // ((1 << depth) - 1))
    else:
        px = full
    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            out[..., 3] = px[..., 1]
    elif ctype in (2, 6):
        out[..., :3] = px[..., :3]
        if ctype == 6:
            out[..., 3] = px[..., 3]
    else:
        if palette is None:
            _fail("palette PNG without a PLTE chunk")
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:256]
            alpha[:t.size] = t
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        idx = px[..., 0]
        out[..., :3] = pal[idx]
        out[..., 3] = alpha[idx]
    if trns is not None and ctype in (0, 2):
        # one transparent colour, as Pillow applies it: compared at 8 bits;
        # 1-bit grey scales its key with its samples (0 or 255); 2-, 4- and
        # 16-bit grey compare their scaled or clipped value with the key's
        # low byte; 16-bit RGB ignores the key
        key = np.frombuffer(trns, ">u2")[:nch]
        if depth == 8:
            out[..., 3] = np.where((full == key).all(axis=-1), 0, out[..., 3])
        elif ctype == 0:
            k = (255 if key[0] else 0) if depth == 1 else key[0] & 0xFF
            out[..., 3] = np.where(px[..., 0] == k, 0, out[..., 3])
    return out


def _filter_rows(img: np.ndarray, filter_type: int) -> bytes:
    """The filtered scanlines of an [h, w, c] u8 image, one filter type
    for every row (PNG spec §9.2)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # up
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    elif filter_type == 4:
        cc = np.zeros_like(x)
        cc[1:, c:] = x[:-1, :-c]  # up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    else:
        raise ValueError(f"PNG filter type {filter_type} is not one of 0-4")
    rows = ((x - pred) & 0xFF).astype(np.uint8)
    return np.concatenate(
        [np.full((h, 1), filter_type, np.uint8), rows], axis=1).tobytes()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filter_type: int = 1) -> bytes:
    """An [h, w] (grey), [h, w, 3] (RGB) or [h, w, 4] (RGBA) u8 image → PNG
    bytes."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"encode_png takes [h, w] or [h, w, 3|4] u8, got "
                         f"{img.shape} {img.dtype}")
    h, w, c = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(_filter_rows(img, filter_type), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """Save a grey, RGB or RGBA u8 image as a PNG file."""
    Path(path).write_bytes(encode_png(img))
