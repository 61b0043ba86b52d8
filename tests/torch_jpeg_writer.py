"""A small baseline JPEG encoder for the port's JPEG tests: any sampling
factors, YCbCr, RGB, grey, CMYK or YCCK components, an optional Adobe
APP14 marker. Pillow writes only 4:4:4, 4:2:2 and 4:2:0 and never YCCK,
so the files of the other layouts come from here; Pillow's decode of them
is the oracle (tests/test_torch_jpeg.py).

numpy only (no Pillow): chip_smoke.py phase 11 takes its files from the
vectors file, which `python -m tests.test_torch_jpeg regen` writes with
this encoder and Pillow's decodes.

The encoder is plain: box-filtered downsampling, a float forward DCT,
one quantisation table for all components, and Huffman tables of fixed
code lengths (4 bits for every DC size, 8 for every AC symbol), which any
decoder reads from the DHT segment like the standard ones.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag position k -> natural (row-major) index of the 8×8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# T.81 Annex K.1's luminance table, scaled to a quality as libjpeg does
_K1 = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)

_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _qtable(quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_K1 * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


_DCT = _dct_matrix()


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with ones
        return bytes(self.out)


def _magnitude(v: int) -> tuple[int, int]:
    """(size category, its bits) of a coefficient (T.81 F.1.2.1)."""
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def _blocks(plane: np.ndarray, bw: int, bh: int, q: np.ndarray) -> np.ndarray:
    """Quantised DCT coefficients [bh, bw, 64] (zigzag order) of a plane
    padded by edge replication to bh × bw blocks."""
    h, w = plane.shape
    padded = np.pad(plane.astype(np.float64) - 128, ((0, bh * 8 - h), (0, bw * 8 - w)),
                    mode="edge")
    tiles = padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ui,abij,vj->abuv", _DCT, tiles, _DCT).reshape(bh, bw, 64)
    quant = np.round(coef / q.reshape(64)).astype(np.int64)
    return np.clip(quant, -1023, 1023)[..., _ZIGZAG]


def _downsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """Box average over fx × fy samples, the plane's edge replicated to
    whole boxes (ceil(w / fx) × ceil(h / fy) samples)."""
    h, w = plane.shape
    ch, cw = -(-h // fy), -(-w // fx)
    p = np.pad(plane.astype(np.float64), ((0, ch * fy - h), (0, cw * fx - w)), mode="edge")
    return np.round(p.reshape(ch, fy, cw, fx).mean(axis=(1, 3))).astype(np.uint8)


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """u8 [..., 3] RGB → u8 YCbCr (JFIF's equations)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255).astype(np.uint8)


def encode(planes: np.ndarray, factors, *, quality: int = 75, jfif: bool = False,
           adobe: int | None = None, ids=None) -> bytes:
    """Baseline JPEG of `planes` (u8 [h, w, n], n = 1, 3 or 4: the
    components as stored, full size) with sampling `factors` [(h, v)] per
    component. `adobe` writes an APP14 Adobe marker with that transform
    byte; `ids` are the component ids (1, 2, ... by default)."""
    height, width, n = planes.shape
    ids = list(ids or range(1, n + 1))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    q = _qtable(quality)
    comps = []
    for c, (h, v) in enumerate(factors):
        if hmax % h or vmax % v:
            raise ValueError(f"factors {factors}: {h}x{v} does not divide the maximum")
        sub = _downsample(planes[..., c], hmax // h, vmax // v)
        comps.append(_blocks(sub, mcux * h, mcuy * v, q))
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    out += _segment(0xDB, bytes([0]) + bytes(q[_ZIGZAG].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, height, width, n)
    for c, (h, v) in enumerate(factors):
        sof += bytes([ids[c], (h << 4) | v, 0])
    out += _segment(0xC0, sof)
    dc_counts = [0] * 16
    dc_counts[3] = len(_DC_SYMBOLS)
    ac_counts = [0] * 16
    ac_counts[7] = len(_AC_SYMBOLS)
    out += _segment(0xC4, bytes([0x00] + dc_counts + _DC_SYMBOLS)
                    + bytes([0x10] + ac_counts + _AC_SYMBOLS))
    dc_code = {s: (i, 4) for i, s in enumerate(_DC_SYMBOLS)}
    ac_code = {s: (i, 8) for i, s in enumerate(_AC_SYMBOLS)}
    sos = bytes([n]) + b"".join(bytes([ids[c], 0x00]) for c in range(n)) + b"\x00\x3f\x00"
    out += _segment(0xDA, sos)
    bits = _Bits()
    pred = [0] * n
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (h, v) in enumerate(factors):
                for y in range(v):
                    for x in range(h):
                        blk = comps[c][my * v + y, mx * h + x]
                        s, b = _magnitude(int(blk[0]) - pred[c])
                        pred[c] = int(blk[0])
                        bits.put(*dc_code[s])
                        if s:
                            bits.put(b, s)
                        run = 0
                        for k in range(1, 64):
                            a = int(blk[k])
                            if not a:
                                run += 1
                                continue
                            while run > 15:
                                bits.put(*ac_code[0xF0])
                                run -= 16
                            s, b = _magnitude(a)
                            bits.put(*ac_code[(run << 4) | s])
                            bits.put(b, s)
                            run = 0
                        if run:
                            bits.put(*ac_code[0x00])
    out += bits.flush() + b"\xff\xd9"
    return bytes(out)
