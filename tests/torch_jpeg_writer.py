"""Small JPEG encoders for the port's JPEG tests, for what Pillow reads
but does not write; Pillow's decode of their files is the oracle
(tests/test_torch_jpeg.py).

- `encode`: baseline Huffman at any sampling factors, YCbCr, RGB, grey,
  CMYK or YCCK components, an optional Adobe APP14 marker (Pillow writes
  only 4:4:4, 4:2:2 and 4:2:0 and never YCCK).
- `encode_arithmetic`: the same frames arithmetic-coded (T.81 Annex D's
  QM coder and the statistical models of Annexes F and G, as libjpeg's
  jcarith.c codes them), sequential (SOF9) or progressive (SOF10) with
  any scan script, optional DAC conditioning tables and restart intervals.
- `encode_lossless`: lossless Huffman (SOF3, T.81 Annex H) with any
  predictor 1-7 and point transform, restart intervals, interleaved or
  one scan a component.

numpy only (no Pillow): chip_smoke.py phase 11 takes its files from the
vectors file, which `python -m tests.test_torch_jpeg regen` writes with
this encoder and Pillow's decodes.

The DCT encoders are plain: box-filtered downsampling, a float forward
DCT, one quantisation table for all components, and Huffman tables of
fixed code lengths (4 bits for every DC size, 8 for every AC symbol, 5 for
every lossless difference size), which any decoder reads from the DHT
segment like the standard ones.
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


def _prepare(planes: np.ndarray, factors, quality: int):
    """(quantisation table, MCU columns, MCU rows, per component its
    quantised blocks [bh, bw, 64] in zigzag order)."""
    height, width, _ = planes.shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    q = _qtable(quality)
    comps = []
    for c, (h, v) in enumerate(factors):
        if hmax % h or vmax % v:
            raise ValueError(f"factors {factors}: {h}x{v} does not divide the maximum")
        sub = _downsample(planes[..., c], hmax // h, vmax // v)
        comps.append(_blocks(sub, mcux * h, mcuy * v, q))
    return q, mcux, mcuy, comps


def _header(planes: np.ndarray, factors, ids, sof: int, jfif: bool, adobe,
            tables: bytes, precision: int = 8) -> bytearray:
    """SOI, the optional JFIF and Adobe markers, `tables` (DQT, DHT...)
    and the frame header of marker `sof` (every component on
    quantisation table 0)."""
    height, width, n = planes.shape
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    out += tables
    body = struct.pack(">BHHB", precision, height, width, n)
    for c, (h, v) in enumerate(factors):
        body += bytes([ids[c], (h << 4) | v, 0])
    return out + _segment(sof, body)


def encode(planes: np.ndarray, factors, *, quality: int = 75, jfif: bool = False,
           adobe: int | None = None, ids=None) -> bytes:
    """Baseline JPEG of `planes` (u8 [h, w, n], n = 1, 3 or 4: the
    components as stored, full size) with sampling `factors` [(h, v)] per
    component. `adobe` writes an APP14 Adobe marker with that transform
    byte; `ids` are the component ids (1, 2, ... by default)."""
    n = planes.shape[2]
    ids = list(ids or range(1, n + 1))
    q, mcux, mcuy, comps = _prepare(planes, factors, quality)
    dc_counts = [0] * 16
    dc_counts[3] = len(_DC_SYMBOLS)
    ac_counts = [0] * 16
    ac_counts[7] = len(_AC_SYMBOLS)
    out = _header(planes, factors, ids, 0xC0, jfif, adobe,
                  _segment(0xDB, bytes([0]) + bytes(q[_ZIGZAG].astype(np.uint8))))
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


# -- arithmetic coding (T.81 Annex D; libjpeg's jcarith.c) --------------------

# Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed estimate of 0.5
_QE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]
_ARITAB = [(qe << 16) | (nm << 8) | (sw << 7) | nl for qe, nl, nm, sw in _QE]


class _QMEncoder:
    """jcarith.c's arith_encode and finish_pass over one restart interval:
    the shortest output (no trailing zero bytes), 0xFF bytes stuffed."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _byte(self, b: int) -> None:
        if self.zc:
            self.out += bytes(self.zc)
            self.zc = 0
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _flush_stacked(self) -> None:
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._byte(self.buffer)
        if self.sc:
            if self.zc:
                self.out += bytes(self.zc)
                self.zc = 0
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self) -> None:
        if self.buffer >= 0:
            self._byte(self.buffer + 1)
        self.zc += self.sc  # the carry turns the stacked 0xFF bytes to 0x00
        self.sc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalisation and output, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stacked()
                    self.buffer = temp
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stacked()
        if self.c & 0x7FFF800:
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_value(enc, stats, st, v: int, k: int, kx: int, x1: int) -> None:
    """Figures F.8 and F.9 for the magnitude v ≥ 1 of a coefficient whose
    sign is coded: the category from bin `st` of `stats` (the AC form, whose
    second decision also sits at st, when x1 is None), then its bits."""
    m = 0
    v -= 1
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v
        if x1 is not None:  # DC: X1 = 20
            st = x1
            while v2 >> 1:
                v2 >>= 1
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st = 189 if k <= kx else 217
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
    enc.encode(stats, st, 0)
    st += 14
    while m >> 1:
        m >>= 1
        enc.encode(stats, st, 1 if m & v else 0)


def _sign_abs(v: int, al: int) -> tuple[int, int]:
    """(sign, |v| >> al): the point transform of an AC coefficient."""
    return (0, v >> al) if v >= 0 else (1, (-v) >> al)


class _ArithScan:
    """jcarith.c's MCU encoders for one scan, with each table's statistics."""

    def __init__(self, ss, se, ah, al, progressive, dc_l, dc_u, ac_k):
        self.ss, self.se, self.ah, self.al, self.progressive = ss, se, ah, al, progressive
        self.dc_l, self.dc_u, self.ac_k = dc_l, dc_u, ac_k
        self.fixed = bytearray([113])

    def reset(self, ncomp: int) -> None:
        self.dc_stats = {t: bytearray(64) for t in (0, 1)}
        self.ac_stats = {t: bytearray(256) for t in (0, 1)}
        self.last_dc = [0] * ncomp
        self.dc_context = [0] * ncomp

    def dc(self, enc, blk, si: int, tbl: int) -> None:
        """F.1.4.1: a DC difference (first passes: after the point transform)."""
        stats = self.dc_stats[tbl]
        m = int(blk[0]) >> self.al
        st = self.dc_context[si]
        v = m - self.last_dc[si]
        if v == 0:
            enc.encode(stats, st, 0)
            self.dc_context[si] = 0
            return
        self.last_dc[si] = m
        enc.encode(stats, st, 1)
        sign = 1 if v < 0 else 0
        enc.encode(stats, st + 1, sign)
        st += 2 + sign
        self.dc_context[si] = 8 if sign else 4
        v = abs(v)
        mag = (v - 1).bit_length()
        m = 1 << (mag - 1) if mag else 0
        if m < (1 << self.dc_l[tbl]) >> 1:
            ctx = 0
        elif m > (1 << self.dc_u[tbl]) >> 1:
            ctx = self.dc_context[si] + 8
        else:
            ctx = self.dc_context[si]
        _arith_value(enc, stats, st, v, 0, 0, 20)
        self.dc_context[si] = ctx

    def ac(self, enc, blk, tbl: int, ss: int) -> None:
        """F.1.4.2 / G.1.3.2: the AC band ss..se (zigzag positions) of a
        block, the point transform applied."""
        stats, kx, al, se = self.ac_stats[tbl], self.ac_k[tbl], self.al, self.se
        ke = se
        while ke > 0 and not _sign_abs(int(blk[ke]), al)[1]:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(stats, st, 0)
            while True:
                sign, v = _sign_abs(int(blk[k]), al)
                if v:
                    enc.encode(stats, st + 1, 1)
                    enc.encode(self.fixed, 0, sign)
                    break
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            _arith_value(enc, stats, st + 2, v, k, kx, None)
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, enc, blk, tbl: int) -> None:
        """G.1.3.3: the next bit of the band's coefficients."""
        stats, al = self.ac_stats[tbl], self.al
        ss, se = self.ss, self.se
        ke = se
        while ke > 0 and not _sign_abs(int(blk[ke]), al)[1]:
            ke -= 1
        kex = ke
        while kex > 0 and not _sign_abs(int(blk[kex]), self.ah)[1]:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, st, 0)
            while True:
                sign, v = _sign_abs(int(blk[k]), al)
                if v:
                    if v >> 1:
                        enc.encode(stats, st + 2, v & 1)
                    else:
                        enc.encode(stats, st + 1, 1)
                        enc.encode(self.fixed, 0, sign)
                    break
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)

    def block(self, enc, blk, si: int, tbl: int) -> None:
        if not self.progressive:
            self.dc(enc, blk, si, tbl)
            self.ac(enc, blk, tbl, 1)
        elif self.ss == 0 and self.ah == 0:
            self.dc(enc, blk, si, tbl)
        elif self.ss == 0:
            enc.encode(self.fixed, 0, (int(blk[0]) >> self.al) & 1)
        elif self.ah == 0:
            self.ac(enc, blk, tbl, self.ss)
        else:
            self.ac_refine(enc, blk, tbl)


def _scan_mcus(comps, factors, scomps, mcux, mcuy, width, height):
    """Per MCU of a scan the (scan component, block) pairs in stream order
    (a one-component scan: the component's own block grid)."""
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    if len(scomps) == 1:
        c = scomps[0]
        h, v = factors[c]
        cols, rows = -(-(-(-width * h // hmax)) // 8), -(-(-(-height * v // vmax)) // 8)
        return [[(0, comps[c][by, bx])] for by in range(rows) for bx in range(cols)]
    mcus = []
    for my in range(mcuy):
        for mx in range(mcux):
            mcus.append([(si, comps[c][my * factors[c][1] + y, mx * factors[c][0] + x])
                         for si, c in enumerate(scomps)
                         for y in range(factors[c][1]) for x in range(factors[c][0])])
    return mcus


def _dac(dac) -> bytes:
    """A DAC segment: {("dc", t): (L, U), ("ac", t): K}."""
    body = b""
    for (kind, t), val in sorted(dac.items()):
        body += bytes([t, (val[1] << 4) | val[0]]) if kind == "dc" else bytes([16 + t, val])
    return _segment(0xCC, body)


#: libjpeg's jpeg_simple_progression for three components (jcparam.c):
#: (components, Ss, Se, Ah, Al)
SIMPLE_PROGRESSION_3 = [
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


def progression(n: int):
    """A scan script of spectral selection and successive approximation
    for n components: SIMPLE_PROGRESSION_3's pattern, each component's AC
    bands on their own (first passes and refinements)."""
    if n == 3:
        return SIMPLE_PROGRESSION_3
    every = tuple(range(n))
    script = [(every, 0, 0, 0, 1)]
    script += [((c,), 1, 5, 0, 2) for c in every] + [((c,), 6, 63, 0, 2) for c in every]
    script += [((c,), 1, 63, 2, 1) for c in every] + [(every, 0, 0, 1, 0)]
    return script + [((c,), 1, 63, 1, 0) for c in every]


def encode_arithmetic(planes: np.ndarray, factors, *, quality: int = 75,
                      jfif: bool = False, adobe: int | None = None, ids=None,
                      scans=None, dac=None, restart: int = 0) -> bytes:
    """`encode`'s frame arithmetic-coded: sequential (SOF9) when `scans` is
    None, else progressive (SOF10) with that scan script [(components, Ss,
    Se, Ah, Al)] (see `progression`). Component 0 takes DC and AC table 0,
    the others table 1; `dac` ({("dc", t): (L, U), ("ac", t): K}) writes
    a DAC segment and codes with those conditioning values (the defaults
    L=0, U=1, K=5 otherwise); `restart` writes a DRI of that many MCUs."""
    height, width, n = planes.shape
    ids = list(ids or range(1, n + 1))
    q, mcux, mcuy, comps = _prepare(planes, factors, quality)
    dc_l, dc_u, ac_k = {0: 0, 1: 0}, {0: 1, 1: 1}, {0: 5, 1: 5}
    tables = _segment(0xDB, bytes([0]) + bytes(q[_ZIGZAG].astype(np.uint8)))
    if dac:
        for (kind, t), val in dac.items():
            if kind == "dc":
                dc_l[t], dc_u[t] = val
            else:
                ac_k[t] = val
        tables += _dac(dac)
    if restart:
        tables += _segment(0xDD, struct.pack(">H", restart))
    progressive = scans is not None
    out = _header(planes, factors, ids, 0xCA if progressive else 0xC9, jfif, adobe, tables)
    for scomps, ss, se, ah, al in scans or [(tuple(range(n)), 0, 63, 0, 0)]:
        tbl = [0 if c == 0 else 1 for c in scomps]
        out += _segment(0xDA, bytes([len(scomps)]) + b"".join(
            bytes([ids[c], (t << 4) | t]) for c, t in zip(scomps, tbl))
            + bytes([ss, se, (ah << 4) | al]))
        coder = _ArithScan(ss, se, ah, al, progressive, dc_l, dc_u, ac_k)
        mcus = _scan_mcus(comps, factors, scomps, mcux, mcuy, width, height)
        per = restart or len(mcus)
        for r, first in enumerate(range(0, len(mcus), per)):
            if r:
                out += bytes([0xFF, 0xD0 + (r - 1) % 8])
            coder.reset(len(scomps))
            enc = _QMEncoder()
            for mcu in mcus[first:first + per]:
                for si, blk in mcu:
                    coder.block(enc, blk, si, tbl[si])
            out += enc.finish()
    return bytes(out + b"\xff\xd9")


# -- lossless (T.81 Annex H; libjpeg-turbo's jclossls.c / jcdiffct.c) ---------

_LOSSLESS_SYMBOLS = list(range(17))


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    """The predictors of Table H.1 (libjpeg-turbo's, in int arithmetic)."""
    return [0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
            (ra + rb) >> 1][psv]


def encode_lossless(planes: np.ndarray, factors, predictor: int, pt: int = 0, *,
                    jfif: bool = False, adobe: int | None = None, ids=None,
                    restart: int = 0, interleaved: bool = True,
                    precision: int = 8) -> bytes:
    """Lossless Huffman JPEG (SOF3) of `planes` ([h, w, n] integers below
    2^16: the components as stored, full size, box-downsampled to
    `factors` when those are not all 1×1) with predictor 1-7 and point
    transform `pt` (the samples shifted right by it). One scan of every
    component, or one a component when `interleaved` is False; `restart`
    writes a DRI of that many MCUs (a whole number of MCU rows). Each
    difference is taken modulo 2^16 and coded by its size 0-16 (size 16,
    the difference 32768, with no extra bits)."""
    height, width, n = planes.shape
    ids = list(ids or range(1, n + 1))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    subs = []
    for c, (h, v) in enumerate(factors):
        p = planes[..., c].astype(np.int64)
        if (h, v) != (hmax, vmax):
            p = _downsample(p, hmax // h, vmax // v).astype(np.int64)
        subs.append(p >> pt)
    counts = [0] * 16
    counts[4] = len(_LOSSLESS_SYMBOLS)
    tables = _segment(0xC4, bytes([0x00] + counts + _LOSSLESS_SYMBOLS))
    if restart:
        tables += _segment(0xDD, struct.pack(">H", restart))
    out = _header(planes, factors, ids, 0xC3, jfif, adobe, tables, precision)
    code = {s: (i, 5) for i, s in enumerate(_LOSSLESS_SYMBOLS)}
    initial = 1 << (precision - pt - 1)
    for scomps in [tuple(range(n))] if interleaved else [(c,) for c in range(n)]:
        out += _segment(0xDA, bytes([len(scomps)]) + b"".join(
            bytes([ids[c], 0]) for c in scomps) + bytes([predictor, 0, pt]))
        one = len(scomps) == 1
        grids, diffs = [], []
        for c in scomps:
            h, v = (1, 1) if one else factors[c]
            sub = subs[c]
            rows, cols = (sub.shape if one else (mcuy * v, mcux * h))
            g = np.pad(sub, ((0, rows - sub.shape[0]), (0, cols - sub.shape[1])), mode="edge")
            grids.append((g, v))
            diffs.append(np.zeros_like(g))
        mcu_cols = grids[0][0].shape[1] if one else mcux
        mcu_rows = grids[0][0].shape[0] if one else mcuy
        per_rows = restart // mcu_cols if restart else mcu_rows
        if restart and restart % mcu_cols:
            raise ValueError(f"restart {restart} is not a whole number of MCU rows ({mcu_cols})")
        for (g, v), d in zip(grids, diffs):
            v = 1 if one else v
            for y in range(g.shape[0]):
                first = (y // v) % per_rows == 0 and y % v == 0
                for x in range(g.shape[1]):
                    if first:
                        p = initial if x == 0 else g[y, x - 1]
                    elif x == 0:
                        p = g[y - 1, 0]
                    else:
                        p = _predict(predictor, int(g[y, x - 1]), int(g[y - 1, x]),
                                     int(g[y - 1, x - 1]))
                    d[y, x] = (int(g[y, x]) - int(p)) & 0xFFFF
        bits = _Bits()
        for my in range(mcu_rows):
            if my and my % per_rows == 0:
                out += bits.flush() + bytes([0xFF, 0xD0 + (my // per_rows - 1) % 8])
                bits = _Bits()
            for mx in range(mcu_cols):
                for si, c in enumerate(scomps):
                    h, v = (1, 1) if one else factors[c]
                    d = diffs[si]
                    for y in range(v):
                        for x in range(h):
                            dv = int(d[my * v + y, mx * h + x])
                            dv = dv - 0x10000 if dv >= 0x8000 else dv
                            s = abs(dv).bit_length()
                            bits.put(*code[s])
                            if s and s < 16:
                                bits.put(dv if dv >= 0 else dv + (1 << s) - 1, s)
        out += bits.flush()
    return bytes(out + b"\xff\xd9")
