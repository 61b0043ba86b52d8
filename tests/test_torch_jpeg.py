"""The port's JPEG decoder (renderer_tpu_torch/assets/jpeg.py) and its two
callers, on the CPU, against Pillow (present here, absent on the card's
machine).

- decode_jpeg equals `Image.open(...).convert("RGBA")` bit for bit in every
  mode Pillow writes: 4:4:4 / 4:2:2 / 4:2:0, baseline and progressive,
  restart markers (by blocks and by rows), grey, CMYK, `keep_rgb`, 16-bit
  quantisation tables (SOF1), optimised Huffman tables, APPn and COM
  segments; at quality 50 and 95 and at sizes that are not whole MCUs.
- It equals Pillow's decode too on what Pillow reads but does not write,
  made by tests/torch_jpeg_writer.py: the sampling layouts 4:4:0, 4:1:1,
  4:1:0 and other whole-number ratios (each takes libjpeg-turbo's h1v2
  fancy upsampler or box replication), YCCK (Adobe transform 2, and any
  other but 0, as libjpeg-turbo reads it), arithmetic coding (SOF9 and
  SOF10: grey, 4:2:0 / 4:2:2 / 4:4:4 / 4:1:1, CMYK and YCCK; sequential and
  progressive with spectral selection and successive approximation; with
  and without DAC conditioning and restart intervals) and lossless (SOF3:
  predictors 1-7, point transforms 0 and 2, grey, RGB and CMYK, restart
  intervals, subsampled and one-scan-a-component frames, sums modulo 2^16).
- Every variant it does not decode, and truncated or corrupt data, raise
  ValueError naming the variant or the offset; every variant it refuses
  is one Pillow refuses too.
- assets/image.decode_image dispatches by content.
- make_ntex on a JPEG writes the JAX tool's .ntex bytes; a GLB with an
  embedded JPEG (Huffman, arithmetic-coded or lossless) loads to the JAX
  loader's textures (every mip).
- tests/golden/torch-jpeg-vectors.npz (chip_smoke.py phase 11's vectors)
  decodes to the Pillow decode it stores. Rewrite it here, with Pillow:

    python -m tests.test_torch_jpeg regen
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from tests import torch_parity  # noqa: F401 — one torch thread a worker

VECTORS = Path(__file__).parent / "golden" / "torch-jpeg-vectors.npz"
# Pillow's save options of each mode (Pillow's subsampling 2 is 4:2:0)
Q16 = [[100 + 7 * i for i in range(64)], [300 + 2 * i for i in range(64)]]
MODES = {
    "444": ("RGB", dict(subsampling=0)),
    "422": ("RGB", dict(subsampling=1)),
    "420": ("RGB", dict(subsampling=2)),
    "444-progressive": ("RGB", dict(subsampling=0, progressive=True)),
    "422-progressive": ("RGB", dict(subsampling=1, progressive=True)),
    "420-progressive": ("RGB", dict(subsampling=2, progressive=True)),
    "restart-blocks": ("RGB", dict(subsampling=2, restart_marker_blocks=2)),
    "restart-rows-progressive": ("RGB", dict(subsampling=1, restart_marker_rows=1,
                                             progressive=True)),
    "grey": ("L", {}),
    "grey-progressive": ("L", dict(progressive=True)),
    "cmyk": ("CMYK", {}),
    "cmyk-progressive": ("CMYK", dict(progressive=True)),
    "keep-rgb": ("RGB", dict(keep_rgb=True)),
    "dqt-16bit": ("RGB", dict(qtables=Q16, subsampling=2)),
    "optimized": ("RGB", dict(optimize=True, subsampling=1)),
    "app-com": ("RGB", dict(comment=b"a comment", icc_profile=b"\0" * 300)),
}
SIZES = [(37, 53), (1, 17)]  # (width, height): neither is whole MCUs
BIG = 512  # the two large vectors, 512×512 4:2:0, baseline and progressive
# the layouts of WRITTEN (below) that the vectors file carries for the card
WRITTEN_VECTORS = ("ycck", "411", "440")
# the arithmetic-coded (ARITH_LAYOUTS, ARITH_CODING) and lossless
# (LOSSLESS_COLOURS, predictor, Pt, restart) files it carries
ARITH_VECTORS = (("420", "sequential"), ("420", "progressive-dac-restart"),
                 ("ycck", "progressive"), ("grey", "sequential-restart"))
LOSSLESS_VECTORS = (("grey", 7, 0, 0), ("rgb", 4, 2, 23), ("cmyk", 1, 0, 0))


def _pixels(w: int, h: int, seed: int) -> np.ndarray:
    """u8 [h, w, 4]: gradients, a hard edge and noise, so every frequency
    and the clamps of the colour conversion are exercised."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    np.where((x // 5 + y // 7) % 2, 250.0, 10.0), (x * 3 + y * 5) % 256], -1)
    img += rng.normal(0, 25, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _texture(side: int) -> np.ndarray:
    """u8 [side, side, 3]: a brick-like texture with mild noise (the large
    vectors, and the base colour of chip_smoke.py's GLB)."""
    rng = np.random.default_rng(8)
    y, x = np.mgrid[0:side, 0:side].astype(np.float64)
    row = y // 32
    mortar = ((y % 32) < 3) | (((x + 32 * (row % 2)) % 64) < 3)
    base = np.stack([150 + 40 * np.sin(x / 37), 70 + 30 * np.cos(y / 23), 50 + 0 * x], -1)
    img = np.where(mortar[..., None], 200.0, base) + rng.normal(0, 4, (side, side, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(mode: str, w: int, h: int, quality: int, seed: int = 0) -> bytes:
    from PIL import Image

    pil_mode, opts = MODES[mode]
    px = _pixels(w, h, seed)
    im = Image.fromarray(px if pil_mode == "CMYK" else
                         px[..., 0] if pil_mode == "L" else px[..., :3], pil_mode)
    buf = io.BytesIO()
    # Pillow scales explicit tables by a quality and then clamps them to
    # 8 bits, so the 16-bit tables go in unscaled
    im.save(buf, "JPEG", **opts, **({} if "qtables" in opts else {"quality": quality}))
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _segments(data: bytes):
    """(marker, payload) of each segment before the first SOS, then the
    markers found in the rest (RSTn, SOS, EOI...) with empty payloads."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((data[pos + 1], data[pos + 4:pos + 2 + n]))
        pos += 2 + n
    rest = data[pos:]
    out += [(rest[i + 1], b"") for i in range(len(rest) - 1)
            if rest[i] == 0xFF and rest[i + 1] not in (0x00, 0xFF)]
    return out


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_equals_pillow(mode, w, h, quality):
    from renderer_tpu_torch.assets.jpeg import decode_jpeg

    data = _encode(mode, w, h, quality, seed=w * 100 + h)
    markers = [m for m, _ in _segments(data)]
    # the file really is in the variant the mode names
    sof = {0xC0, 0xC1, 0xC2} & set(markers)
    assert sof == ({0xC2} if "progressive" in mode else
                   {0xC1} if mode == "dqt-16bit" else {0xC0}), markers
    if mode.startswith("restart"):
        assert 0xDD in markers and (0xD0 in markers or w < 16)
    if mode == "dqt-16bit":
        assert any(m == 0xDB and p[0] >> 4 == 1 for m, p in _segments(data))
    if mode == "optimized" or "progressive" in mode:
        assert markers.count(0xC4) >= 2
    got = decode_jpeg(data)
    want = _pillow(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


def _replace_first(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def _sof_offset(data: bytes) -> int:
    found = [i for code in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)
             if (i := data.find(bytes([0xFF, code]))) >= 0]
    if not found:
        raise AssertionError("no SOF")
    return min(found)


def _with_sof(code: int):
    def fn(data):
        i = _sof_offset(data)
        return data[:i + 1] + bytes([code]) + data[i + 2:]
    return fn


def _set_byte(rel: int, value: int):
    """Sets the byte `rel` bytes after the SOF marker's 0xFF."""
    def fn(data):
        i = _sof_offset(data) + rel
        return data[:i] + bytes([value]) + data[i + 1:]
    return fn


def _scan_garbage(data: bytes) -> bytes:
    """The first scan's entropy data replaced by all-ones bits (no Huffman
    code is all ones)."""
    sos = data.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    return data[:start] + b"\xff\x00" * 40 + b"\xff\xd9"


def _insert_before_sos(segment: bytes):
    return lambda data: _replace_first(data, b"\xff\xda", segment + b"\xff\xda")


def _sampling(*factors: int):
    """Sets the three components' h<<4|v bytes of the frame header."""
    def fn(data):
        for k, f in enumerate(factors):
            data = _set_byte(11 + 3 * k, f)(data)
        return data
    return fn


def _swap_rst(data: bytes) -> bytes:
    i = data.index(b"\xff\xd0", data.index(b"\xff\xda"))
    return data[:i + 1] + b"\xd1" + data[i + 2:]


def _lossless_file(colour: str, **kw):
    return lambda: _lossless(colour, 4, 0, 37, 53, **kw)


def _arith_file(layout: str, coding: str):
    return lambda: _arith(layout, coding, 37, 53, 75)


def _sof3_to(code: int):
    def fn(data):
        i = data.index(b"\xff\xc3")
        return data[:i + 1] + bytes([code]) + data[i + 2:]
    return fn


def _set_dri(n: int):
    def fn(data):
        i = data.index(b"\xff\xdd")
        return data[:i + 4] + struct.pack(">H", n) + data[i + 6:]
    return fn


# (mode the file is made in, or a function that makes it; edit; message the
# ValueError must carry); the SOF's component table starts 10 bytes after
# its 0xFF: id, h<<4|v, tq
REFUSALS = {
    "arithmetic-lossless-sof11": (_lossless_file("grey"), _sof3_to(0xCB),
                                  "arithmetic-coded lossless"),
    "arithmetic-12-bit": (_arith_file("420", "sequential"), _set_byte(4, 12),
                          "12-bit sample precision"),
    "lossless-ycbcr": (_lossless_file("ycc"), lambda d: d, "lossless YCbCr"),
    "lossless-ycck": (_lossless_file("ycck"), lambda d: d, "lossless YCCK"),
    "lossless-12-bit": (_lossless_file("grey"), _set_byte(4, 12), "12-bit sample precision"),
    "lossless-restart-not-whole-rows": (_lossless_file("grey", restart=37), _set_dri(5),
                                        "not a whole number of MCU rows"),
    "hierarchical-sof5": ("420", _with_sof(0xC5), "hierarchical"),
    "hierarchical-dhp": ("420", _insert_before_sos(b"\xff\xde\x00\x02"), "hierarchical"),
    "hierarchical-exp": ("420", _insert_before_sos(b"\xff\xdf\x00\x03\x11"), "hierarchical"),
    "hierarchical-arithmetic-sof13": ("420", _with_sof(0xCD), "hierarchical arithmetic"),
    "jpeg-ls": ("420", _with_sof(0xF7), "JPEG-LS"),
    "dnl-height-0": ("420", lambda d: _set_byte(5, 0)(_set_byte(6, 0)(d)), "a DNL marker"),
    "12-bit": ("420", _set_byte(4, 12), "12-bit sample precision"),
    "sampling-fractional": ("422", _sampling(0x31, 0x21, 0x21),
                            "sampling factors 3x1, 2x1, 2x1 .a ratio that is not a whole"),
    "sampling-mcu-over-10": ("420", _sampling(0x44, 0x11, 0x11),
                             "sampling factors 4x4, 1x1, 1x1 in one scan .an MCU of more"),
    "truncated-half": ("420", lambda d: d[:len(d) // 2], "corrupt or truncated"),
    "truncated-no-eoi": ("420", lambda d: d[:-2], "corrupt or truncated"),
    "truncated-header": ("420", lambda d: d[:40], "corrupt or truncated"),
    "truncated-progressive": ("420-progressive", lambda d: d[:len(d) * 2 // 3],
                              "corrupt or truncated"),
    "no-huffman-code": ("420", _scan_garbage, "no Huffman code"),
    "restart-out-of-order": ("restart-blocks", _swap_rst, "restart marker RST1"),
    "not-a-jpeg": ("420", lambda d: b"GIF89a" + d[6:], "no SOI"),
}
# the refusals of data that is not corrupt: variants Pillow refuses as well
# (it raises OSError or its subclass UnidentifiedImageError)
PILLOW_REFUSES = ("arithmetic-lossless-sof11", "arithmetic-12-bit", "lossless-ycbcr",
                  "lossless-ycck", "lossless-12-bit", "lossless-restart-not-whole-rows",
                  "hierarchical-sof5", "hierarchical-dhp", "hierarchical-exp",
                  "hierarchical-arithmetic-sof13", "jpeg-ls", "dnl-height-0", "12-bit",
                  "sampling-fractional", "sampling-mcu-over-10")


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refuses(case):
    from renderer_tpu_torch.assets.jpeg import decode_jpeg

    mode, edit, message = REFUSALS[case]
    data = edit(mode() if callable(mode) else _encode(mode, 37, 53, 75))
    with pytest.raises(ValueError, match=message):
        decode_jpeg(data)
    if case in PILLOW_REFUSES:
        with pytest.raises(OSError):
            _pillow(data)


# -- layouts Pillow reads but does not write (tests/torch_jpeg_writer.py) -----

# name -> (sampling factors, colour: "ycc" under JFIF, "ycck" / "rgb" under
# an Adobe marker with that transform byte)
WRITTEN = {
    "440": ([(1, 2), (1, 1), (1, 1)], "ycc", None),
    "411": ([(4, 1), (1, 1), (1, 1)], "ycc", None),
    "410": ([(4, 2), (1, 1), (1, 1)], "ycc", None),
    "311": ([(3, 1), (1, 1), (1, 1)], "ycc", None),
    "1x4": ([(1, 4), (1, 1), (1, 1)], "ycc", None),
    "420-chroma-2x1": ([(2, 2), (2, 1), (2, 1)], "ycc", None),
    "420-chroma-1x2": ([(2, 2), (1, 2), (1, 2)], "ycc", None),
    "rgb-411": ([(4, 1), (1, 1), (1, 1)], "rgb", 0),
    "ycck": ([(1, 1)] * 4, "ycck", 2),
    "ycck-420": ([(2, 2), (1, 1), (1, 1), (2, 2)], "ycck", 2),
    "ycck-transform-1": ([(2, 1), (1, 1), (1, 1), (1, 1)], "ycck", 1),
}


def _written(name: str, w: int, h: int, quality: int, seed: int = 0) -> bytes:
    from tests.torch_jpeg_writer import encode, rgb_to_ycc

    factors, colour, adobe = WRITTEN[name]
    px = _pixels(w, h, seed)
    if colour == "ycck":  # Adobe's inverted CMYK: YCC of 255 - C, M, Y; K as is
        planes = np.concatenate([rgb_to_ycc(255 - px[..., :3]), px[..., 3:]], axis=-1)
    else:
        planes = rgb_to_ycc(px[..., :3]) if colour == "ycc" else px[..., :3]
    return encode(planes, factors, quality=quality, jfif=colour == "ycc", adobe=adobe)


@pytest.mark.parametrize("w,h", SIZES + [(9, 2)])
@pytest.mark.parametrize("name", sorted(WRITTEN))
def test_written_layout_decodes_equal_to_pillow(name, w, h):
    pytest.importorskip("PIL")
    from renderer_tpu_torch.assets.jpeg import decode_jpeg

    data = _written(name, w, h, 85, seed=w * 100 + h)
    factors = WRITTEN[name][0]
    sof = _sof_offset(data)
    assert data[sof + 1] == 0xC0 and [data[sof + 11 + 3 * k] for k in range(len(factors))] \
        == [(fh << 4) | fv for fh, fv in factors]
    got = decode_jpeg(data)
    want = _pillow(data)
    assert got.shape == want.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


# -- arithmetic-coded and lossless files (tests/torch_jpeg_writer.py) --------

# name -> (sampling factors, colour: "grey", "ycc" under JFIF, "cmyk" / "ycck"
# under an Adobe marker with transform 0 / 2)
ARITH_LAYOUTS = {
    "grey": ([(1, 1)], "grey"),
    "420": ([(2, 2), (1, 1), (1, 1)], "ycc"),
    "422": ([(2, 1), (1, 1), (1, 1)], "ycc"),
    "444": ([(1, 1)] * 3, "ycc"),
    "411": ([(4, 1), (1, 1), (1, 1)], "ycc"),
    "cmyk": ([(1, 1)] * 4, "cmyk"),
    "ycck": ([(2, 2), (1, 1), (1, 1), (2, 2)], "ycck"),
}
# name -> encode_arithmetic's options (the scan script from the component
# count: progression(n), spectral selection and successive approximation)
ARITH_CODING = {
    "sequential": {},
    "sequential-dac": {"dac": {("dc", 0): (2, 6), ("dc", 1): (0, 3), ("ac", 0): 12,
                               ("ac", 1): 2}},
    "sequential-restart": {"restart": 2},
    "progressive": {"scans": True},
    "progressive-dac-restart": {"scans": True, "restart": 3,
                                "dac": {("dc", 0): (1, 4), ("ac", 0): 20, ("ac", 1): 1}},
}
# colour -> (the planes stored from RGBA pixels, the markers)
LOSSLESS_COLOURS = {"grey": {}, "rgb": {"adobe": 0}, "cmyk": {},
                    "ycc": {"jfif": True}, "ycck": {"adobe": 2}}


def _stored(colour: str, px: np.ndarray) -> np.ndarray:
    """The components a file of `colour` stores for RGBA pixels `px`."""
    from tests.torch_jpeg_writer import rgb_to_ycc

    if colour == "grey":
        return px[..., :1]
    if colour == "ycck":  # Adobe's inverted CMYK: YCC of 255 - C, M, Y; K as is
        return np.concatenate([rgb_to_ycc(255 - px[..., :3]), px[..., 3:]], axis=-1)
    return {"ycc": rgb_to_ycc(px[..., :3]), "rgb": px[..., :3], "cmyk": px}[colour]


def _arith(layout: str, coding: str, w: int, h: int, quality: int, seed: int = 0) -> bytes:
    from tests.torch_jpeg_writer import encode_arithmetic, progression

    factors, colour = ARITH_LAYOUTS[layout]
    opts = dict(ARITH_CODING[coding])
    if opts.get("scans"):
        opts["scans"] = progression(len(factors))
    return encode_arithmetic(_stored(colour, _pixels(w, h, seed)), factors, quality=quality,
                             jfif=colour == "ycc",
                             adobe={"cmyk": 0, "ycck": 2}.get(colour), **opts)


def _lossless(colour: str, predictor: int, pt: int, w: int, h: int, seed: int = 0,
              **kw) -> bytes:
    from tests.torch_jpeg_writer import encode_lossless

    planes = _stored(colour, _pixels(w, h, seed))
    factors = kw.pop("factors", [(1, 1)] * planes.shape[2])
    return encode_lossless(planes, factors, predictor, pt, **LOSSLESS_COLOURS[colour], **kw)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("coding", sorted(ARITH_CODING))
@pytest.mark.parametrize("layout", sorted(ARITH_LAYOUTS))
def test_arithmetic_decodes_equal_to_pillow(layout, coding, w, h):
    pytest.importorskip("PIL")
    from renderer_tpu_torch.assets.jpeg import decode_jpeg

    data = _arith(layout, coding, w, h, 80, seed=w * 100 + h)
    markers = [m for m, _ in _segments(data)]
    assert (0xCA if "progressive" in coding else 0xC9) in markers
    assert (0xCC in markers) == ("dac" in coding) and (0xDD in markers) == ("restart" in coding)
    got = decode_jpeg(data)
    want = _pillow(data)
    assert got.shape == want.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("colour", ["grey", "rgb", "cmyk"])
def test_lossless_decodes_equal_to_pillow(colour, predictor, pt):
    """Each predictor and point transform, for each component count Pillow
    reads losslessly (1, 3 as RGB, 4 as CMYK)."""
    pytest.importorskip("PIL")
    from renderer_tpu_torch.assets.jpeg import decode_jpeg

    data = _lossless(colour, predictor, pt, 37, 53, seed=predictor)
    assert data[_sof_offset(data) + 1] == 0xC3
    got = decode_jpeg(data)
    want = _pillow(data)
    assert got.shape == want.shape == (53, 37, 4)
    np.testing.assert_array_equal(got, want)
    if colour == "grey":  # lossless up to the point transform
        np.testing.assert_array_equal(got[..., 0], _pixels(37, 53, predictor)[..., 0] >> pt << pt)


# name -> (colour, predictor, Pt, encode_lossless options at width w)
LOSSLESS_VARIANTS = {
    "grey-restart-rows": ("grey", 4, 0, lambda w: {"restart": w}),
    "rgb-restart-two-rows": ("rgb", 6, 1, lambda w: {"restart": 2 * w}),
    "rgb-420": ("rgb", 7, 0, lambda w: {"factors": [(2, 2), (1, 1), (1, 1)]}),
    "rgb-422-one-scan-a-component": ("rgb", 5, 0, lambda w: {
        "factors": [(2, 1), (1, 1), (1, 1)], "interleaved": False}),
    "rgb-440-one-scan-a-component-restart": ("rgb", 2, 0, lambda w: {
        "factors": [(1, 2), (1, 1), (1, 1)], "interleaved": False, "restart": w}),
    "cmyk-420-restart": ("cmyk", 3, 2, lambda w: {
        "factors": [(2, 2), (1, 1), (1, 1), (2, 2)], "restart": -(-w // 2)}),
}


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("name", sorted(LOSSLESS_VARIANTS))
def test_lossless_variant_decodes_equal_to_pillow(name, w, h):
    """Restart intervals (the first-row rule again after each), subsampled
    components (replicated, not fancy-upsampled) and one scan a
    component."""
    pytest.importorskip("PIL")
    from renderer_tpu_torch.assets.jpeg import decode_jpeg

    colour, predictor, pt, opts = LOSSLESS_VARIANTS[name]
    data = _lossless(colour, predictor, pt, w, h, seed=w + h, **opts(w))
    assert (0xDD in [m for m, _ in _segments(data)]) == ("restart" in name)
    got = decode_jpeg(data)
    want = _pillow(data)
    assert got.shape == want.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("predictor", [1, 4])
def test_lossless_sums_modulo_2_16(predictor):
    """Samples that jump by 2^15 and more code differences of size 15 and
    16 (32768, with no extra bits), summed modulo 2^16 and stored as their
    low 8 bits, as libjpeg-turbo stores them."""
    pytest.importorskip("PIL")
    from renderer_tpu_torch.assets.jpeg import decode_jpeg
    from tests.torch_jpeg_writer import encode_lossless

    samples = _pixels(23, 17, 5)[..., :1].astype(np.int64)
    samples[3:9, 4:12] += 32768
    samples[12] += 40000
    data = encode_lossless(samples, [(1, 1)], predictor)
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, _pillow(data))
    np.testing.assert_array_equal(got[..., 0], samples[..., 0] & 0xFF)


def test_dac_in_a_huffman_frame_is_ignored():
    """A DAC segment conditions arithmetic tables only: a Huffman frame
    that carries one decodes as without it (as Pillow decodes it)."""
    from renderer_tpu_torch.assets.jpeg import decode_jpeg

    data = _encode("420", 37, 53, 75)
    with_dac = _insert_before_sos(b"\xff\xcc\x00\x04\x00\x11")(data)
    np.testing.assert_array_equal(decode_jpeg(with_dac), decode_jpeg(data))
    np.testing.assert_array_equal(decode_jpeg(with_dac), _pillow(with_dac))


def test_decode_image_dispatches_by_content():
    from renderer_tpu_torch.assets import png
    from renderer_tpu_torch.assets.image import decode_image

    jpg = _encode("420", 37, 53, 75)
    np.testing.assert_array_equal(decode_image(jpg), _pillow(jpg))
    rgba = _pixels(9, 7, 3)
    np.testing.assert_array_equal(decode_image(png.encode_png(rgba)), rgba)
    with pytest.raises(ValueError, match="not a PNG or JPEG image .it starts 47 49 46"):
        decode_image(b"GIF89a\x01\x00")
    with pytest.raises(ValueError, match="not a PNG or JPEG image"):
        decode_image(b"")


@pytest.mark.parametrize("mode", ["420", "grey-progressive"])
def test_make_ntex_on_a_jpeg_equals_the_jax_tool(tmp_path, mode):
    from renderer_tpu_torch.tools import make_ntex
    from tools import make_ntex as jmake_ntex

    data = _encode(mode, 45, 30, 80)
    paths = []
    for sub in ("port", "jax"):
        (tmp_path / sub).mkdir()
        paths.append(tmp_path / sub / "wall.jpg")
        paths[-1].write_bytes(data)
    assert make_ntex.main(["--silent", str(paths[0])]) == 0
    assert jmake_ntex.main(["--silent", str(paths[1])]) == 0
    got, want = (p.with_suffix(".ntex").read_bytes() for p in paths)
    assert len(got) > 1024 and got == want


# -- a GLB with an embedded JPEG, through both loaders ------------------------

def _jpeg_glb(jpeg: bytes, mime: str) -> bytes:
    """The loader fixture (tests/fixtures/strided.gltf) as one GLB whose
    embedded image is `jpeg` (a bufferView in the BIN chunk, declared as
    `mime`)."""
    from tests.make_loader_fixture import BIN_PATH, GLTF_PATH

    gltf = json.loads(GLTF_PATH.read_text())
    binc = bytearray(BIN_PATH.read_bytes())
    binc += b"\0" * (-len(binc) % 4)
    gltf["bufferViews"].append({"buffer": 0, "byteOffset": len(binc),
                                "byteLength": len(jpeg)})
    binc += jpeg
    binc += b"\0" * (-len(binc) % 4)
    del gltf["buffers"][0]["uri"]
    gltf["buffers"][0]["byteLength"] = len(binc)
    gltf["images"][0] = {"bufferView": len(gltf["bufferViews"]) - 1, "mimeType": mime}
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(binc), 0x004E4942) + bytes(binc))
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body


def _load(pkg, loader, path):
    registry, builder = pkg.MaterialRegistry(), pkg.VertexLibraryBuilder()
    kw = {"device": "cpu"} if pkg.__name__ == "renderer_tpu_torch" else {}
    return loader.load_gltf(path, builder, registry, **kw)


@pytest.mark.parametrize("mime", ["image/jpeg", "image/png"])
def test_glb_with_an_embedded_jpeg_loads_like_jax(tmp_path, mime):
    """Every mip of the embedded JPEG's texture equals the JAX loader's
    (Pillow's decode); the declared mimeType is ignored by both."""
    import renderer_tpu as jrt
    import renderer_tpu_torch as trt
    from renderer_tpu.assets import gltf_loader as jgl
    from renderer_tpu_torch.assets import gltf_loader as tgl

    path = tmp_path / "jpeg.glb"
    path.write_bytes(_jpeg_glb(_encode("420-progressive", 37, 53, 90), mime))
    want, got = _load(jrt, jgl, path), _load(trt, tgl, path)
    assert len(got.textures) == len(want.textures) == 1
    a, b = want.textures[0], got.textures[0]
    assert (a.kind, a.wrap_s, a.wrap_t) == (b.kind, b.wrap_s, b.wrap_t)
    assert len(a.mips) == len(b.mips) > 1 and a.mips[0].shape == (53, 37, 4)
    for x, y in zip(a.mips, b.mips, strict=True):
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("kind", ["arithmetic-progressive", "lossless"])
def test_glb_with_an_arithmetic_or_lossless_jpeg_loads_like_jax(tmp_path, kind):
    """The JAX loader (Pillow) and the port's read an embedded
    arithmetic-coded or lossless JPEG to the same texture, every mip."""
    import renderer_tpu as jrt
    import renderer_tpu_torch as trt
    from renderer_tpu.assets import gltf_loader as jgl
    from renderer_tpu_torch.assets import gltf_loader as tgl

    data = (_arith("420", "progressive-dac-restart", 37, 53, 90) if kind != "lossless"
            else _lossless("rgb", 4, 0, 37, 53, restart=74))
    path = tmp_path / "jpeg.glb"
    path.write_bytes(_jpeg_glb(data, "image/jpeg"))
    want, got = _load(jrt, jgl, path), _load(trt, tgl, path)
    assert len(got.textures) == len(want.textures) == 1
    a, b = want.textures[0], got.textures[0]
    assert len(a.mips) == len(b.mips) > 1 and a.mips[0].shape == (53, 37, 4)
    for x, y in zip(a.mips, b.mips, strict=True):
        np.testing.assert_array_equal(y, x)


def test_glb_with_a_truncated_jpeg_is_refused(tmp_path):
    from renderer_tpu_torch.assets import gltf_loader as tgl
    import renderer_tpu_torch as trt

    data = _encode("420", 37, 53, 90)
    path = tmp_path / "cut.glb"
    path.write_bytes(_jpeg_glb(data[:len(data) // 2], "image/jpeg"))
    with pytest.raises(tgl.GltfLoadingError, match="embedded image 0: JPEG: corrupt"):
        _load(trt, tgl, path)


# -- the card's vectors --------------------------------------------------------

def test_vectors_decode_to_their_stored_pixels():
    """Every entry of the vectors file decodes to the Pillow decode it
    stores (small images) or to its SHA-256 (the two 512×512 ones); each
    stored decode is Pillow's."""
    from renderer_tpu_torch.assets.jpeg import decode_jpeg

    z = np.load(VECTORS)
    names = [k[:-len("_jpeg")] for k in z.files if k.endswith("_jpeg")]
    assert (set(MODES) | {f"written-{n}" for n in WRITTEN_VECTORS}
            | {"big-baseline-420", "big-progressive-420"}
            | {_arith_vector(*v)[0] for v in ARITH_VECTORS}
            | {_lossless_vector(*v)[0] for v in LOSSLESS_VECTORS}) == set(names)
    for name in names:
        data = z[f"{name}_jpeg"].tobytes()
        got = decode_jpeg(data)
        if name.startswith("big-"):
            assert got.shape == (BIG, BIG, 4)
            assert hashlib.sha256(got.tobytes()).hexdigest() == str(z[f"{name}_sha256"])
            assert hashlib.sha256(_pillow(data).tobytes()).hexdigest() == \
                str(z[f"{name}_sha256"])
        else:
            np.testing.assert_array_equal(got, z[f"{name}_rgba"], err_msg=name)
            np.testing.assert_array_equal(_pillow(data), z[f"{name}_rgba"], err_msg=name)


def _arith_vector(layout: str, coding: str) -> tuple[str, bytes]:
    return f"arith-{layout}-{coding}", _arith(layout, coding, 23, 17, 75, seed=1)


def _lossless_vector(colour: str, predictor: int, pt: int, restart: int) -> tuple[str, bytes]:
    name = f"lossless-{colour}-p{predictor}-pt{pt}" + (f"-restart{restart}" if restart else "")
    return name, _lossless(colour, predictor, pt, 23, 17, seed=1, restart=restart)


def regen() -> None:
    """Rewrites VECTORS with Pillow: every mode at 23×17, quality 75, with
    Pillow's RGBA decode, the WRITTEN_VECTORS layouts (tests/
    torch_jpeg_writer.py) likewise as "written-<name>", the ARITH_VECTORS
    and LOSSLESS_VECTORS files at 23×17 as "arith-<layout>-<coding>" and
    "lossless-<colour>-p<predictor>-pt<Pt>[-restart<n>]", and the 512×512
    texture as baseline and progressive 4:2:0 JPEGs, quality 90, with the
    SHA-256 of Pillow's decode."""
    from PIL import Image

    out = {}
    for name in sorted(MODES):
        data = _encode(name, 23, 17, 75, seed=1)
        out[f"{name}_jpeg"] = np.frombuffer(data, np.uint8)
        out[f"{name}_rgba"] = _pillow(data)
    for name in WRITTEN_VECTORS:
        data = _written(name, 23, 17, 75, seed=1)
        out[f"written-{name}_jpeg"] = np.frombuffer(data, np.uint8)
        out[f"written-{name}_rgba"] = _pillow(data)
    for name, data in ([_arith_vector(*v) for v in ARITH_VECTORS]
                       + [_lossless_vector(*v) for v in LOSSLESS_VECTORS]):
        out[f"{name}_jpeg"] = np.frombuffer(data, np.uint8)
        out[f"{name}_rgba"] = _pillow(data)
    tex = Image.fromarray(_texture(BIG))
    for name, progressive in (("big-baseline-420", False), ("big-progressive-420", True)):
        buf = io.BytesIO()
        tex.save(buf, "JPEG", quality=90, subsampling=2, progressive=progressive)
        data = buf.getvalue()
        out[f"{name}_jpeg"] = np.frombuffer(data, np.uint8)
        out[f"{name}_sha256"] = np.array(hashlib.sha256(_pillow(data).tobytes()).hexdigest())
    np.savez_compressed(VECTORS, **out)
    print(f"wrote {VECTORS} ({VECTORS.stat().st_size} bytes, {len(out) // 2} images)")


if __name__ == "__main__":
    if sys.argv[1:] != ["regen"]:
        raise SystemExit("usage: python -m tests.test_torch_jpeg regen")
    regen()
