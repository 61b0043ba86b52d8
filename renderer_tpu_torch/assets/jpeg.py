"""JPEG decode on numpy (no Pillow: the card's machine has none).

`decode_jpeg(data)` gives what `PIL.Image.open(...).convert("RGBA")` gives
under Pillow's bundled libjpeg-turbo, bit for bit (tests/test_torch_jpeg.py
holds the two equal): the integer pipeline of libjpeg-turbo's defaults,
which Pillow does not change —

- Huffman entropy decoding: baseline and extended sequential (SOF0/SOF1)
  and progressive (SOF2: DC and AC scans, first passes and refinements,
  EOB runs), restart intervals, any number of DHT and DQT segments (8- or
  16-bit tables, each latched by a component at its first scan);
- arithmetic entropy decoding (jdarith.c), sequential (SOF9) and
  progressive (SOF10): T.81 Annex D's QM decoder with its probability
  estimation table, the DC and AC statistical models of F.1.4.4 and the
  progressive passes of G.1.3, the conditioning of DAC segments (L=0,
  U=1, Kx=5 for a table no DAC names), the statistics reset at each
  restart marker; the coefficients then take the same path as Huffman's;
- lossless (SOF3, jdlossls.c / jddiffct.c): Huffman-coded differences
  (size 16 is 32768 with no extra bits), predictors 1-7 with the first
  row and column rules, the first row's prediction 2^(P-Pt-1) at the scan's
  start and after each restart, sums modulo 2^16, the point transform Pt;
  libjpeg-turbo reads it at 8 bits only (Pillow as well), upsamples by
  replication (no fancy upsampling without a DCT) and converts no colour:
  three components are RGB unless a JFIF marker or an Adobe transform but 0
  says YCbCr, four are CMYK;
- dequantisation and the `islow` inverse DCT (jidctint.c: CONST_BITS 13,
  PASS1_BITS 2, the range-limit table of jdmaster.c);
- the upsampler jdsample.c picks for each component's ratio to the
  largest factors: the "fancy" triangle filters h2v1 and h2v2 (clamped at
  the component's real edges as jdmainct.c pads them; box replication
  where the component is at most two samples wide) and h1v2 (at any
  width), and box replication (int_upsample) for every other whole-number
  ratio, such as 4:1:1 or 4:1:0; libjpeg-turbo takes the merged
  upsampler of jdmerge.c only without fancy upsampling;
- YCbCr → RGB with jdcolor.c's fixed-point tables (SCALEBITS 16).

Colour spaces as libjpeg-turbo reads them (jdapimin.c): one component is
grey (Pillow's "L"); three are YCbCr under a JFIF marker, RGB under an
Adobe marker with transform 0 or with component ids 'R', 'G', 'B' (what
Pillow's `keep_rgb=True` writes), YCbCr otherwise; four are CMYK under no
Adobe marker or transform 0, stored inverted as Adobe writes them, and
YCCK under any other transform (jdcolor.c ycck_cmyk_convert: YCbCr → RGB,
inverted, K as stored); either is converted as Pillow's CMYK → RGB does.
APPn and COM segments are skipped; EXIF orientation is ignored, as
`Image.open` ignores it.

Sampling: any factors 1-4 whose ratios to the largest are whole numbers.
What Pillow 12.1.0 (libjpeg-turbo 3.1.3) refuses raises ValueError naming
it, and nothing else is refused: a ratio that is not a whole number
(JERR_FRACT_SAMPLE_NOTIMPL), an interleaved scan of more than 10 blocks an
MCU (JERR_BAD_MCU_SIZE), samples of other than 8 bits (Pillow's plugin
reads 8 only), lossless YCbCr or YCCK (JERR_CONVERSION_NOTIMPL),
arithmetic-coded lossless (SOF11), hierarchical frames (SOF5-7, SOF13-15,
DHP, EXP), JPEG-LS, a DNL marker, and truncated or corrupt data (with the
byte offset where it was found); no partial image is ever returned.

Entropy decoding is sequential Python (Huffman over a table of every
16-bit lookahead); the inverse DCT, upsampling and colour conversion run
on numpy over all blocks at once.
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

# frame markers read: (progressive, arithmetic, lossless)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False),
        0xC2: (True, False, False), 0xC3: (False, False, True),
        0xC9: (False, True, False), 0xCA: (True, True, False)}
# what Pillow refuses as well (libjpeg-turbo has no decoder for them)
_REFUSED_SOF = {
    0xC5: "hierarchical differential sequential (SOF5)",
    0xC6: "hierarchical differential progressive (SOF6)",
    0xC7: "hierarchical differential lossless (SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "hierarchical arithmetic-coded sequential (SOF13)",
    0xCE: "hierarchical arithmetic-coded progressive (SOF14)",
    0xCF: "hierarchical arithmetic-coded lossless (SOF15)",
    0xF7: "JPEG-LS (SOF55)",
}
_REFUSED_OTHER = {
    0xDC: "a DNL marker (image height given after the first scan)",
    0xDE: "hierarchical mode (DHP)",
    0xDF: "hierarchical mode (EXP)",
}

# jidctint.c's constants: FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F_0_298, _F_0_390, _F_0_541, _F_0_765 = 2446, 3196, 4433, 6270
_F_0_899, _F_1_175, _F_1_501, _F_1_847 = 7373, 9633, 12299, 15137
_F_1_961, _F_2_053, _F_2_562, _F_3_072 = 16069, 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by (x & 1023) for a centred
    sample x: x + 128 over [-128, 127], 255 above up to 511, 0 below down
    to -512, and wrapping beyond as the C table does."""
    idx = np.arange(1024)
    out = np.where(idx < 128, idx + 128, np.where(idx < 512, 255, 0))
    out[896:] = idx[896:] - 896
    return out.astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix(1.40200) * x + half) >> 16
    cb_b = (_fix(1.77200) * x + half) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _refuse(what: str):
    raise ValueError(f"JPEG: {what} is not supported")


def _corrupt(offset: int, what: str):
    raise ValueError(f"JPEG: corrupt or truncated data at byte {offset}: {what}")


# T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | Next_Index_MPS
# << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed estimate
# of 0.5 (T.851 Table 5) that signs and DC refinement bits are coded with
_QE = (
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
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))
_ARITAB = tuple((qe << 16) | (nm << 8) | (sw << 7) | nl for qe, nl, nm, sw in _QE)
_FIXED_BIN = 113
# conditioning of an arithmetic table no DAC segment names (T.81 F.1.4.4)
_DC_L, _DC_U, _AC_K = 0, 1, 5


class _QMDecoder:
    """jdarith.c's arith_decode over one restart interval's unstuffed
    bytes, reading zeros past their end (what T.81 supplies once the
    decoder reaches a marker). `decode(stats, i)` decodes one binary
    decision with the adaptive estimate in stats[i] and updates it."""

    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, body: bytes):
        self.data, self.pos = body, 0
        self.c, self.a, self.ct = 0, 0, -16  # ct < 0: two bytes to read first

    def decode(self, stats, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:  # renormalisation and input, D.2.6
            ct -= 1
            if ct < 0:
                if self.pos < len(self.data):
                    c = (c << 8) | self.data[self.pos]
                    self.pos += 1
                else:
                    c <<= 8
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000  # the two first bytes are in
            a <<= 1
        sv = stats[i]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:  # the lower sub-interval, D.2.4
            c -= temp
            if a < qe:
                stats[i] = (sv & 0x80) ^ nm
            else:
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _s16(v: int) -> int:
    """v as the signed 16-bit JCOEF libjpeg stores it in."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class _Huffman:
    """A DHT table as one lookup over every 16-bit lookahead: entry
    (length << 8) | symbol, 0 where no code starts (a corrupt stream)."""

    __slots__ = ("lookup",)

    def __init__(self, counts: bytes, symbols: bytes, offset: int):
        table = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if code >= 1 << length:
                    _corrupt(offset, "a Huffman table with too many codes")
                lo = code << (16 - length)
                table[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
                code += 1
                k += 1
            code <<= 1
        self.lookup = table.tolist()


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qtable", "bw", "bh", "coef", "width", "height",
                 "plane")


class _Frame:
    __slots__ = ("progressive", "arithmetic", "lossless", "width", "height")

    def __init__(self, code: int, width: int, height: int):
        self.progressive, self.arithmetic, self.lossless = _SOF[code]
        self.width, self.height = width, height


def _markers(data: bytes, pos: int):
    """The next marker at or after pos: (code, offset of its 0xFF), skipping
    0xFF fill bytes. Raises if the stream ends first or pos is not at a
    marker."""
    n = len(data)
    if pos >= n or data[pos] != 0xFF:
        _corrupt(pos, "expected a marker")
    while pos + 1 < n and data[pos + 1] == 0xFF:
        pos += 1
    if pos + 1 >= n:
        _corrupt(pos, "the data ends inside a marker")
    return data[pos + 1], pos


def _payload(data: bytes, pos: int) -> tuple[bytes, int]:
    """The payload of the marker segment whose 0xFF is at pos, and the
    offset after it."""
    if pos + 4 > len(data):
        _corrupt(pos, "the data ends inside a segment length")
    (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
    end = pos + 2 + length
    if length < 2 or end > len(data):
        _corrupt(pos, f"a segment of length {length} runs past the end")
    return data[pos + 4:end], end


def _entropy_data(data: bytes, pos: int) -> tuple[list[tuple[int, bytes]], int]:
    """The entropy-coded data of a scan starting at pos, split at its RSTn
    markers: [(offset, unstuffed bytes)] per restart interval, the RST
    numbers checked in order. Returns the intervals and the offset of the
    marker that ends the scan."""
    intervals, start, expect = [], pos, 0
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            _corrupt(n, "the data ends inside a scan")
        nxt = data[i + 1]
        if nxt == 0x00:
            pos = i + 2
            continue
        if nxt == 0xFF:  # fill bytes before a marker
            j = i
            while j + 1 < n and data[j + 1] == 0xFF:
                j += 1
            if j + 1 >= n:
                _corrupt(n, "the data ends inside a scan")
            nxt = data[j + 1]
            if nxt == 0x00:
                _corrupt(j, "0xFF fill bytes before a stuffed zero")
        else:
            j = i
        intervals.append((start, data[start:i].replace(b"\xff\x00", b"\xff")))
        if 0xD0 <= nxt <= 0xD7:
            if nxt - 0xD0 != expect:
                _corrupt(j, f"restart marker RST{nxt - 0xD0} where RST{expect} was due")
            expect = (expect + 1) & 7
            start = pos = j + 2
            continue
        return intervals, j


class _BitReader:
    """Big-endian bit windows over one restart interval: win[i] holds the
    32 bits starting at byte i, padded with zero bytes so a lookahead past
    the end reads zeros; `nbits` is what the interval really holds."""

    __slots__ = ("win", "nbits", "offset")

    def __init__(self, offset: int, body: bytes, pad: int):
        a = np.frombuffer(body + bytes(pad + 4), np.uint8).astype(np.int64)
        self.win = ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()
        self.nbits = 8 * len(body)
        self.offset = offset


def _check_end(br: _BitReader, pos: int) -> None:
    if pos > br.nbits:
        _corrupt(br.offset + br.nbits // 8,
                 f"a scan needs {pos - br.nbits} bits more than its data holds")


def _dc_diff(win, pos, lookup, br):
    """One DC difference at bit pos: its Huffman-coded size s, then s bits,
    sign-extended (T.81 F.2.2.1). Returns (difference, new pos)."""
    e = lookup[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if not e:
        _corrupt(br.offset + (pos >> 3), "a bit pattern that is no Huffman code")
    pos += e >> 8
    s = e & 0xFF
    if not s:
        return 0, pos
    r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
    if r < 1 << (s - 1):
        r += (-1 << s) + 1
    return r, pos + s


def _scan_blocks(comps, scomps, mcux, mcuy):
    """The blocks of a scan in stream order: per MCU a list of (component
    index within the scan, coefficient offset). A one-component scan is
    non-interleaved: one block an MCU over the component's own block grid
    (its samples rounded up to blocks, not to MCUs)."""
    if len(scomps) == 1:
        c = comps[scomps[0]]
        cols, rows = -(-c.width // 8), -(-c.height // 8)
        return [[(0, (by * c.bw + bx) * 64)] for by in range(rows) for bx in range(cols)]
    mcus = []
    for my in range(mcuy):
        for mx in range(mcux):
            blocks = []
            for si, ci in enumerate(scomps):
                c = comps[ci]
                for y in range(c.v):
                    for x in range(c.h):
                        blocks.append((si, ((my * c.v + y) * c.bw + mx * c.h + x) * 64))
            mcus.append(blocks)
    return mcus


def _decode_scan(intervals, mcus, restart, coefs, dc_tabs, ac_tabs, ss, se, ah, al,
                 frame):
    """Entropy-decode one scan into `coefs` (per scan component, a flat list
    of coefficients in zigzag order, 64 a block). `dc_tabs` / `ac_tabs`
    are per scan component its Huffman lookups, or for an arithmetic
    frame (table id, conditioning)."""
    n_mcu = len(mcus)
    per = restart if restart else n_mcu
    if len(intervals) != -(-n_mcu // per):
        _corrupt(intervals[-1][0], f"{len(intervals)} restart intervals where "
                 f"{-(-n_mcu // per)} are due")
    interval = _arith_interval if frame.arithmetic else _huffman_interval
    for ii, (offset, body) in enumerate(intervals):
        interval(offset, body, mcus[ii * per:(ii + 1) * per], coefs, dc_tabs, ac_tabs,
                 ss, se, ah, al, frame.progressive)


def _huffman_interval(offset, body, mcus, coefs, dc_tabs, ac_tabs, ss, se, ah, al,
                      progressive):
    """One restart interval of a Huffman-coded scan (jdhuff.c, jdphuff.c)."""
    max_blocks = max(len(m) for m in mcus)
    br = _BitReader(offset, body, max_blocks * 64 * 4 + 8)
    win, pos = br.win, 0
    preds = [0] * len(coefs)
    eobrun = 0
    for mcu in mcus:
        for si, base in mcu:
            coef = coefs[si]
            if not progressive:
                pos = _block_sequential(win, pos, coef, base, dc_tabs[si],
                                        ac_tabs[si], preds, si, br)
            elif ss == 0:
                if ah == 0:
                    d, pos = _dc_diff(win, pos, dc_tabs[si], br)
                    preds[si] += d
                    coef[base] = preds[si] << al
                else:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                        coef[base] |= 1 << al
                    pos += 1
            elif ah == 0:
                if eobrun:
                    eobrun -= 1
                else:
                    pos, eobrun = _block_ac_first(win, pos, coef, base, ac_tabs[si],
                                                  ss, se, al, br)
            else:
                pos, eobrun = _block_ac_refine(win, pos, coef, base, ac_tabs[si],
                                               ss, se, al, eobrun, br)
        _check_end(br, pos)


def _arith_interval(offset, body, mcus, coefs, dc_tabs, ac_tabs, ss, se, ah, al,
                    progressive):
    """One restart interval of an arithmetic-coded scan (jdarith.c): the
    statistics of each table the scan uses start from zero, and so do the
    DC predictions and contexts. dc_tabs / ac_tabs[si] = (table id, its
    conditioning: (L, U) for DC, Kx for AC)."""
    dec = _QMDecoder(body)
    dc_stats = {t: bytearray(64) for t, _ in filter(None, dc_tabs)}
    ac_stats = {t: bytearray(256) for t, _ in filter(None, ac_tabs)}
    fixed = bytearray([_FIXED_BIN])
    last = [0] * len(coefs)
    context = [0] * len(coefs)
    p1 = 1 << al
    for mcu in mcus:
        for si, base in mcu:
            coef = coefs[si]
            if not progressive or (ss == 0 and ah == 0):
                tbl, (lo, hi) = dc_tabs[si]
                last[si], context[si] = _arith_dc(dec, dc_stats[tbl], context[si], lo, hi,
                                                  last[si], offset)
                coef[base] = _s16(last[si] << al)
                if progressive:
                    continue
                tbl, kx = ac_tabs[si]
                _arith_ac_first(dec, ac_stats[tbl], fixed, kx, coef, base, 1, 63, 0, offset)
            elif ss == 0:
                if dec.decode(fixed, 0):
                    coef[base] |= p1
            elif ah == 0:
                tbl, kx = ac_tabs[si]
                _arith_ac_first(dec, ac_stats[tbl], fixed, kx, coef, base, ss, se, al, offset)
            else:
                _arith_ac_refine(dec, ac_stats[ac_tabs[si][0]], fixed, coef, base, ss, se, al,
                                 offset)


def _arith_magnitude(dec, stats, st, m, offset):
    """Figures F.23's rest and F.24 once the category's first decisions set
    m = 1 (X1 from bin st on): the category's doubling decisions from st,
    then its bits from st + 14. Returns the magnitude - 1."""
    while dec.decode(stats, st):
        m <<= 1
        if m == 0x8000:
            _corrupt(offset, "an arithmetic-coded magnitude past 15 bits")
        st += 1
    v = m
    st += 14
    while m > 1:
        m >>= 1
        if dec.decode(stats, st):
            v |= m
    return v


def _arith_dc(dec, stats, context, lo, hi, last, offset):
    """F.2.4.1: one DC difference from statistics bin S0 = context;
    returns (the new prediction modulo 2^16, the next context)."""
    if not dec.decode(stats, context):
        return last, 0
    sign = dec.decode(stats, context + 1)
    st = context + 2 + sign
    if dec.decode(stats, st):
        v = _arith_magnitude(dec, stats, 20, 1, offset)
        m = 1 << (v.bit_length() - 1)
    else:
        v = m = 0
    if m < (1 << lo) >> 1:
        context = 0
    elif m > (1 << hi) >> 1:
        context = 12 + 4 * sign
    else:
        context = 4 + 4 * sign
    v += 1
    return (last + (-v if sign else v)) & 0xFFFF, context


def _arith_ac_first(dec, stats, fixed, kx, coef, base, ss, se, al, offset):
    """F.2.4.2 / G.1.3.2: the band ss..se of a block (a sequential block:
    1..63 with al = 0)."""
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if dec.decode(stats, st):  # end of block
            return
        while not dec.decode(stats, st + 1):
            st += 3
            k += 1
            if k > se:
                _corrupt(offset, "an arithmetic-coded run past the band's end")
        sign = dec.decode(fixed, 0)
        st += 2
        v = 0
        if dec.decode(stats, st):
            if dec.decode(stats, st):
                v = _arith_magnitude(dec, stats, 189 if k <= kx else 217, 2, offset)
            else:
                v = 1
        v += 1
        coef[base + k] = _s16((-v if sign else v) << al)
        k += 1


def _arith_ac_refine(dec, stats, fixed, coef, base, ss, se, al, offset):
    """G.1.3.3 (jdarith.c decode_mcu_AC_refine): a correction bit for each
    coefficient already nonzero, a sign for each that becomes nonzero."""
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not coef[base + kex]:
        kex -= 1
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if k > kex and dec.decode(stats, st):
            return
        while True:
            i = base + k
            c = coef[i]
            if c:
                if dec.decode(stats, st + 2):
                    coef[i] = c + (m1 if c < 0 else p1)
                break
            if dec.decode(stats, st + 1):
                coef[i] = m1 if dec.decode(fixed, 0) else p1
                break
            st += 3
            k += 1
            if k > se:
                _corrupt(offset, "an arithmetic-coded run past the band's end")
        k += 1


def _block_sequential(win, pos, coef, base, dc, ac, preds, si, br):
    d, pos = _dc_diff(win, pos, dc, br)
    preds[si] += d
    coef[base] = preds[si]
    k = 1
    while k < 64:
        e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e:
            _corrupt(br.offset + (pos >> 3), "a bit pattern that is no Huffman code")
        pos += e >> 8
        s = e & 15
        if s:
            k += (e >> 4) & 15
            if k > 63:
                _corrupt(br.offset + (pos >> 3), "an AC run past the block's end")
            r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if r < 1 << (s - 1):
                r += (-1 << s) + 1
            coef[base + k] = r
            k += 1
        elif (e & 0xFF) == 0xF0:
            k += 16
        else:
            break
    return pos


def _block_ac_first(win, pos, coef, base, ac, ss, se, al, br):
    k = ss
    while k <= se:
        e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e:
            _corrupt(br.offset + (pos >> 3), "a bit pattern that is no Huffman code")
        pos += e >> 8
        s, r = e & 15, (e >> 4) & 15
        if s:
            k += r
            if k > se:
                _corrupt(br.offset + (pos >> 3), "an AC run past the band's end")
            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if v < 1 << (s - 1):
                v += (-1 << s) + 1
            coef[base + k] = v << al
            k += 1
        elif r == 15:
            k += 16
        else:
            eobrun = 1 << r
            if r:
                eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                pos += r
            return pos, eobrun - 1
    return pos, 0


def _block_ac_refine(win, pos, coef, base, ac, ss, se, al, eobrun, br):
    """jdphuff.c decode_mcu_AC_refine for one block."""
    p1, m1 = 1 << al, -1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                _corrupt(br.offset + (pos >> 3), "a bit pattern that is no Huffman code")
            pos += e >> 8
            s, r = e & 15, (e >> 4) & 15
            if s:
                if s != 1:
                    _corrupt(br.offset + (pos >> 3), "a refinement coefficient wider than 1 bit")
                s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                pos += 1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                    pos += r
                break
            # skip already-nonzero coefficients (refining each) and r zeros
            while k <= se:
                i = base + k
                c = coef[i]
                if c:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                        coef[i] = c + (p1 if c >= 0 else m1)
                    pos += 1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > se:
                    _corrupt(br.offset + (pos >> 3), "a refinement run past the band's end")
                coef[base + k] = s
            k += 1
    if eobrun > 0:
        for k in range(k, se + 1):
            i = base + k
            c = coef[i]
            if c:
                if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                    coef[i] = c + (p1 if c >= 0 else m1)
                pos += 1
        eobrun -= 1
    return pos, eobrun


def _idct_1d(x, axis: int):
    """jidctint.c's 1-D islow transform along `axis` (exact in int64),
    before the final descale: the eight outputs in order."""
    t = [np.take(x, i, axis=axis) for i in range(8)]
    z1 = (t[2] + t[6]) * _F_0_541
    tmp2 = z1 - t[6] * _F_1_847
    tmp3 = z1 + t[2] * _F_0_765
    tmp0 = (t[0] + t[4]) << _CONST_BITS
    tmp1 = (t[0] - t[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = t[7], t[5], t[3], t[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F_1_175
    o0 = o0 * _F_0_298
    o1 = o1 * _F_2_053
    o2 = o2 * _F_3_072
    o3 = o3 * _F_1_501
    z1 = z1 * -_F_0_899
    z2 = z2 * -_F_2_562
    z3 = z3 * -_F_1_961 + z5
    z4 = z4 * -_F_0_390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return [tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
            tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3]


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-transform blocks: coef [n, 64] (natural order)
    and qtable [64] → [n, 8, 8] u8 samples, as jpeg_idct_islow."""
    blocks = (coef.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (down axis 1) into the int workspace
    ws = np.stack([_descale(r, _CONST_BITS - _PASS1_BITS)
                   for r in _idct_1d(blocks, 1)], axis=1)
    # pass 2: rows, descaled by another PASS1_BITS + 3 and range-limited
    out = np.stack([_descale(c, _CONST_BITS + _PASS1_BITS + 3)
                    for c in _idct_1d(ws, 2)], axis=2)
    return _RANGE_LIMIT[out & 1023]


def _upsample_h2(x: np.ndarray, width: int) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample on the first `width` columns of each
    row, as int64 (ends replicated: equal to the C code's special cases)."""
    x = x[:, :width].astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * width), np.int64)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _upsample_h2v2(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample over the component's real samples
    [height, width]: each output row weighs its nearer input row 3:1 with
    the next nearer (rows clamped at the edges, as jdmainct.c pads the
    context rows), then columns likewise, rounding with 8 and 7."""
    x = x[:height, :width].astype(np.int64)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    cols = np.empty((2 * height, width), np.int64)
    cols[0::2] = 3 * x + up
    cols[1::2] = 3 * x + down
    left = np.concatenate([cols[:, :1], cols[:, :-1]], axis=1)
    right = np.concatenate([cols[:, 1:], cols[:, -1:]], axis=1)
    out = np.empty((2 * height, 2 * width), np.int64)
    out[:, 0::2] = (3 * cols + left + 8) >> 4
    out[:, 1::2] = (3 * cols + right + 7) >> 4
    return out


def _upsample_v2(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """jdsample.c h1v2_fancy_upsample over the component's real samples
    [height, width]: each output row weighs its nearer input row 3:1 with
    the next nearer (rows clamped at the edges), rounding with 1 above and
    2 below."""
    x = x[:height, :width].astype(np.int64)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * height, width), np.int64)
    out[0::2] = (3 * x + up + 1) >> 2
    out[1::2] = (3 * x + down + 2) >> 2
    return out


def _full_plane(c: _Component, samples: np.ndarray, hmax: int, vmax: int,
                width: int, height: int) -> np.ndarray:
    """The component's samples ([bh*8, bw*8] u8) brought to the image's full
    [height, width], by the upsampler jdsample.c's jinit_upsampler picks
    for the ratio: fancy (triangle) for 2:1 horizontally, vertically or
    both, box replication otherwise."""
    ex, ey = hmax // c.h, vmax // c.v
    if (ex, ey) == (1, 1):
        return samples[:height, :width]
    if (ex, ey) == (1, 2):  # h1v2 fancy at any width
        out = _upsample_v2(samples, c.width, c.height)
    elif (ex, ey) in ((2, 1), (2, 2)) and c.width > 2:  # fancy only over 2 wide
        if ey == 1:
            out = _upsample_h2(samples[:c.height], c.width)
        else:
            out = _upsample_h2v2(samples, c.width, c.height)
    else:  # box replication (h2v1_upsample, h2v2_upsample, int_upsample)
        out = np.repeat(np.repeat(samples[:c.height, :c.width], ex, axis=1), ey, axis=0)
    return out[:height, :width]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    y = y.astype(np.int64)
    cb, cr = cb.astype(np.intp), cr.astype(np.intp)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _ycck_to_cmyk(y, cb, cr, k) -> np.ndarray:
    """jdcolor.c ycck_cmyk_convert: YCbCr → RGB, inverted, K as stored
    (the inverted CMYK samples of an Adobe file)."""
    return np.concatenate([255 - _ycc_to_rgb(y, cb, cr), k[..., None]], axis=-1)


def _cmyk_to_rgb(cmyk) -> np.ndarray:
    """Pillow's cmyk2rgb on the inverted Adobe samples ("CMYK;I")."""
    c = 255 - cmyk.astype(np.int64)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - ((t + (t >> 8)) >> 8), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → [h, w, 4] u8 RGBA, as Pillow's convert("RGBA") gives it
    (module docstring). Raises ValueError on what it does not decode."""
    data = bytes(data)
    if not data.startswith(b"\xff\xd8"):
        _corrupt(0, "no SOI marker")
    qtables: dict[int, np.ndarray] = {}
    dc_tables: dict[int, _Huffman] = {}
    ac_tables: dict[int, _Huffman] = {}
    comps: list[_Component] = []
    frame = None
    restart = 0
    # arithmetic conditioning by table id: DC (L, U), AC Kx (DAC segments)
    dc_cond: dict[int, tuple[int, int]] = {}
    ac_cond: dict[int, int] = {}
    jfif = False
    adobe = None
    scans = 0
    pos = 2
    while True:
        code, mpos = _markers(data, pos)
        if code == 0xD9:  # EOI
            break
        if code in _REFUSED_SOF:
            _refuse(_REFUSED_SOF[code] + " JPEG")
        if code in _REFUSED_OTHER:
            _refuse(_REFUSED_OTHER[code])
        if code == 0x01 or 0xD0 <= code <= 0xD8:
            _corrupt(mpos, f"a stray 0xFF{code:02X} marker")
        body, pos = _payload(data, mpos)
        if code in _SOF:
            if frame is not None:
                _corrupt(mpos, "a second frame header")
            if len(body) < 6:
                _corrupt(mpos, "a short frame header")
            precision, height, width, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                _refuse(f"{precision}-bit sample precision")
            if height == 0:
                _refuse("a DNL marker (image height given after the first scan)")
            if width == 0 or nf not in (1, 3, 4) or len(body) < 6 + 3 * nf:
                _corrupt(mpos, f"a frame of {width}x{height} with {nf} components")
            for i in range(nf):
                c = _Component()
                c.cid, hv, c.tq = body[6 + 3 * i:9 + 3 * i]
                c.h, c.v = hv >> 4, hv & 15
                c.qtable = None
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or c.tq > 3:
                    _corrupt(mpos, f"component {i} sampling {c.h}x{c.v} table {c.tq}")
                comps.append(c)
            frame = _Frame(code, width, height)
        elif code == 0xC4:  # DHT
            i = 0
            while i < len(body):
                if i + 17 > len(body):
                    _corrupt(mpos, "a short Huffman table")
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                if tc > 1 or th > 3 or i + 17 + n > len(body):
                    _corrupt(mpos, f"a Huffman table of class {tc} id {th}")
                table = _Huffman(counts, body[i + 17:i + 17 + n], mpos)
                (ac_tables if tc else dc_tables)[th] = table
                i += 17 + n
        elif code == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or i + 1 + size > len(body):
                    _corrupt(mpos, f"a quantisation table of precision {pq} id {tq}")
                vals = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = vals
                qtables[tq] = q
                i += 1 + size
        elif code == 0xCC:  # DAC
            if len(body) % 2:
                _corrupt(mpos, "a DAC segment of odd length")
            for i in range(0, len(body), 2):
                index, val = body[i], body[i + 1]
                if index >= 32 or (index < 16 and val & 15 > val >> 4):
                    _corrupt(mpos, f"a DAC entry {index}: {val}")
                if index < 16:
                    dc_cond[index] = (val & 15, val >> 4)
                else:
                    ac_cond[index - 16] = val
        elif code == 0xDD:  # DRI
            if len(body) < 2:
                _corrupt(mpos, "a short restart interval")
            (restart,) = struct.unpack(">H", body[:2])
        elif code == 0xE0 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif code == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif code == 0xDA:  # SOS
            if frame is None:
                _corrupt(mpos, "a scan before the frame header")
            if scans == 0:
                _setup(comps, frame, jfif, adobe)
            pos = _scan(data, mpos, body, pos, frame, comps, qtables, dc_tables,
                        ac_tables, restart, dc_cond, ac_cond)
            scans += 1
        elif 0xE0 <= code <= 0xEF or code == 0xFE:
            pass  # APPn, COM
        else:
            _corrupt(mpos, f"an unknown marker 0xFF{code:02X}")
    if frame is None or scans == 0:
        _corrupt(pos, "no image data before EOI")
    return _output(comps, frame, jfif, adobe)


def _setup(comps, frame, jfif, adobe) -> None:
    """Checks the colour space and sampling before the first scan, and
    sizes each component's block grid (padded to whole MCUs; a lossless
    frame's blocks are samples)."""
    width, height = frame.width, frame.height
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    factors = ", ".join(f"{k.h}x{k.v}" for k in comps)
    if any(hmax % c.h or vmax % c.v for c in comps):
        # jdsample.c jinit_upsampler: JERR_FRACT_SAMPLE_NOTIMPL
        _refuse(f"sampling factors {factors} (a ratio that is not a whole number)")
    if frame.lossless and (len(comps) == 4 and adobe not in (None, 0) or
                           len(comps) == 3 and not _is_rgb(comps, jfif, adobe, True)):
        # jdcolor.c: no colour conversion in lossless mode
        # (JERR_CONVERSION_NOTIMPL)
        _refuse(f"lossless {'YCCK' if len(comps) == 4 else 'YCbCr'} (libjpeg-turbo "
                "converts no colour in lossless mode)")
    unit = 1 if frame.lossless else 8
    mcux, mcuy = -(-width // (unit * hmax)), -(-height // (unit * vmax))
    for c in comps:
        c.width = -(-width * c.h // hmax)
        c.height = -(-height * c.v // vmax)
        c.bw, c.bh = mcux * c.h, mcuy * c.v
        c.coef = None if frame.lossless else [0] * (c.bw * c.bh * 64)
        c.plane = None


def _scan(data, mpos, body, pos, frame, comps, qtables, dc_tables, ac_tables,
          restart, dc_cond, ac_cond) -> int:
    """Reads one scan (its header `body`, its entropy data from pos) into
    the components' coefficients (a lossless scan: their samples); returns
    the offset of the next marker."""
    width, height = frame.width, frame.height
    if not body or len(body) < 1 + 2 * body[0] + 3:
        _corrupt(mpos, "a short scan header")
    ns = body[0]
    by_id = {c.cid: i for i, c in enumerate(comps)}
    scomps, dcs, acs = [], [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            _corrupt(mpos, f"a scan of unknown component id {cid}")
        scomps.append(by_id[cid])
        dcs.append(t >> 4)
        acs.append(t & 15)
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if frame.lossless:  # Ss is the predictor, Al the point transform
        bad = not 1 <= ss <= 7 or se or ah or al > 7
    elif frame.progressive:
        bad = (ss > se or se > 63 or al > 13 or (ss == 0 and se != 0)
               or (ss > 0 and ns != 1))
    else:
        bad = ss != 0 or se != 63 or ah or al
    if bad or not 1 <= ns <= 4 or len(set(scomps)) != ns:
        _corrupt(mpos, f"a scan with Ss={ss} Se={se} Ah={ah} Al={al} over {ns} components")
    if ns > 1 and sum(comps[ci].h * comps[ci].v for ci in scomps) > 10:
        # jdinput.c per_scan_setup: JERR_BAD_MCU_SIZE (D_MAX_BLOCKS_IN_MCU)
        factors = ", ".join(f"{comps[ci].h}x{comps[ci].v}" for ci in scomps)
        _refuse(f"sampling factors {factors} in one scan (an MCU of more than 10 blocks)")
    if frame.lossless:
        if any(d not in dc_tables for d in dcs):
            _corrupt(mpos, f"a scan with undefined Huffman tables {dcs}")
        intervals, end = _entropy_data(data, pos)
        _lossless_scan(intervals, mpos, comps, scomps, [dc_tables[d].lookup for d in dcs],
                       ss, al, restart, frame)
        return end
    for ci in scomps:  # jdinput.c latch_quant_tables: at a component's first scan
        c = comps[ci]
        if c.qtable is None:
            if c.tq not in qtables:
                _corrupt(mpos, f"quantisation table {c.tq} is not defined")
            c.qtable = qtables[c.tq].copy()
    need_dc = ss == 0 and ah == 0
    need_ac = ss > 0 or not frame.progressive
    dc_tabs, ac_tabs = [], []
    for d, t in zip(dcs, acs):
        if frame.arithmetic:  # any table id 0-15, conditioned by DAC or default
            dc_tabs.append((d, dc_cond.get(d, (_DC_L, _DC_U))) if need_dc else None)
            ac_tabs.append((t, ac_cond.get(t, _AC_K)) if need_ac else None)
            continue
        if (need_dc and d not in dc_tables) or (need_ac and t not in ac_tables):
            _corrupt(mpos, f"a scan with undefined Huffman tables {d}/{t}")
        dc_tabs.append(dc_tables[d].lookup if need_dc else None)
        ac_tabs.append(ac_tables[t].lookup if need_ac else None)
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcus = _scan_blocks(comps, scomps, -(-width // (8 * hmax)), -(-height // (8 * vmax)))
    intervals, end = _entropy_data(data, pos)
    _decode_scan(intervals, mcus, restart, [comps[ci].coef for ci in scomps], dc_tabs,
                 ac_tabs, ss, se, ah, al, frame)
    return end


def _lossless_scan(intervals, mpos, comps, scomps, lookups, psv, pt, restart, frame):
    """One lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): the sample
    differences of each MCU row, then per iMCU row each component's rows
    undifferenced (predictor `psv`) into its plane, (sample << pt) as the
    8-bit JSAMPLE it is stored in."""
    one = len(scomps) == 1
    units = [(1, 1) if one else (comps[ci].h, comps[ci].v) for ci in scomps]
    if one:
        cols, rows = comps[scomps[0]].width, comps[scomps[0]].height
    else:
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        cols, rows = -(-frame.width // hmax), -(-frame.height // vmax)
    if restart % cols:  # jddiffct.c start_input_pass: JERR_BAD_RESTART
        _corrupt(mpos, f"a lossless restart interval of {restart} MCUs, not a whole "
                 f"number of MCU rows of {cols}")
    per = restart // cols if restart else rows
    if len(intervals) != -(-rows // per):
        _corrupt(intervals[-1][0], f"{len(intervals)} restart intervals where "
                 f"{-(-rows // per)} are due")
    diffs = [np.zeros((rows * v, cols * h), np.int64) for h, v in units]
    row_bytes = cols * sum(h * v for h, v in units) * 4 + 8
    for ii, (offset, body) in enumerate(intervals):
        br = _BitReader(offset, body, row_bytes)
        win, pos = br.win, 0
        for my in range(ii * per, min((ii + 1) * per, rows)):
            for mx in range(cols):
                for (h, v), d, lookup in zip(units, diffs, lookups):
                    for y in range(my * v, my * v + v):
                        for x in range(mx * h, mx * h + h):
                            e = lookup[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                            if not e:
                                _corrupt(offset + (pos >> 3),
                                         "a bit pattern that is no Huffman code")
                            pos += e >> 8
                            s = e & 0xFF
                            if s == 16:
                                r = 32768
                            elif s:
                                r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                                if r < 1 << (s - 1):
                                    r += (-1 << s) + 1
                                pos += s
                            else:
                                r = 0
                            d[y, x] = r
            _check_end(br, pos)
    for si, ci in enumerate(scomps):
        c = comps[ci]
        c.plane = (_undifference(diffs[si], c, 1 if one else c.v, per, psv,
                                 1 << (8 - pt - 1)) << pt).astype(np.uint8)


def _undifference(diff, c, mcu_rows_high, per, psv, initial) -> np.ndarray:
    """jdlossls.c's undifferencers over the component's real samples, an
    iMCU row (c.v rows) at a time as jddiffct.c runs them: the first row of
    the scan, and the first of an iMCU row in which a restart interval
    began, takes the first-row rule (`initial`, then the left sample);
    every other row's first sample the one above, the rest the predictor.
    Sums are modulo 2^16."""
    out = np.zeros((c.height, c.width), np.int64)
    diff = diff.tolist()
    rows = out.tolist()
    first = False
    for top in range(0, c.height, c.v):
        # the MCU rows decoded for this iMCU row (one, or c.v of one sample row)
        mrows = range(top // mcu_rows_high, -(-min(top + c.v, c.height) // mcu_rows_high))
        if any(m % per == 0 for m in mrows):
            first = True
        for y in range(top, min(top + c.v, c.height)):
            d, row = diff[y], rows[y]
            if first:
                ra = (d[0] + initial) & 0xFFFF
                row[0] = ra
                for x in range(1, c.width):
                    ra = row[x] = (d[x] + ra) & 0xFFFF
                first = False
                continue
            up = rows[y - 1]
            ra = row[0] = (d[0] + up[0]) & 0xFFFF
            for x in range(1, c.width):
                rb, rc = up[x], up[x - 1]
                if psv == 1:
                    p = ra
                elif psv == 2:
                    p = rb
                elif psv == 3:
                    p = rc
                elif psv == 4:
                    p = ra + rb - rc
                elif psv == 5:
                    p = ra + ((rb - rc) >> 1)
                elif psv == 6:
                    p = rb + ((ra - rc) >> 1)
                else:
                    p = (ra + rb) >> 1
                ra = row[x] = (d[x] + p) & 0xFFFF
    return np.array(rows, np.int64).reshape(c.height, c.width)


def _output(comps, frame, jfif, adobe) -> np.ndarray:
    width, height = frame.width, frame.height
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if frame.lossless:
            if c.plane is None:
                _corrupt(0, f"component {c.cid} has no scan")
            # jdsample.c: no fancy upsampling without a DCT, only replication
            ex, ey = hmax // c.h, vmax // c.v
            planes.append(np.repeat(np.repeat(c.plane, ex, axis=1), ey, axis=0)
                          [:height, :width])
            continue
        if c.qtable is None:
            _corrupt(0, f"component {c.cid} has no scan")
        coef = np.asarray(c.coef, np.int64).reshape(-1, 64)
        natural = np.empty_like(coef)
        natural[:, _ZIGZAG] = coef
        samples = _idct_islow(natural, c.qtable).reshape(c.bh, c.bw, 8, 8).transpose(
            0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_full_plane(c, samples, hmax, vmax, width, height))
    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    if len(comps) == 1:
        out[..., :3] = planes[0][..., None]
    elif len(comps) == 4:
        # jdapimin.c: four components are YCCK under an Adobe marker with
        # any transform but 0, CMYK otherwise
        cmyk = (np.stack(planes, axis=-1) if adobe in (None, 0) else _ycck_to_cmyk(*planes))
        out[..., :3] = _cmyk_to_rgb(cmyk)
    elif _is_rgb(comps, jfif, adobe, frame.lossless):
        out[..., :3] = np.stack(planes, axis=-1)
    else:
        out[..., :3] = _ycc_to_rgb(*planes)
    return out


def _is_rgb(comps, jfif: bool, adobe, lossless: bool = False) -> bool:
    """jdapimin.c default_decompress_parms for three components: with no
    marker, a lossless frame is taken for RGB whatever its ids."""
    if jfif:
        return False
    if adobe is not None:
        return adobe == 0
    return lossless or [c.cid for c in comps] == [82, 71, 66]  # 'R', 'G', 'B'
