"""Pillow's RGBA resize in numpy, bit for bit: `resize(rgba, w, h, filter)`
equals `PIL.Image.fromarray(rgba).resize((w, h), LANCZOS | BILINEAR)`.

The card's machine has no Pillow, and make_ntex's mip chain must equal the
JAX tool's, which takes it from Pillow. What Pillow does (its Resample.c
and Convert.c, for an 8-bit RGBA image and a whole-image box):

- RGBA is resized as premultiplied "RGBa": each colour channel becomes
  MULDIV255(c, a) = (t + (t >> 8)) >> 8 with t = c·a + 128, and back
  after the resize, c = clip8(255·c / a) for 0 < a < 255 (unchanged for
  a of 0 or 255).
- Each axis gets its coefficients in double precision: a filter of
  support `support·max(in/out, 1)` centred at `(x + 0.5)·in/out`, taps
  from round(center - support) to round(center + support) clipped to the
  image, each weight `filter((tap - center + 0.5) / max(in/out, 1))`,
  normalised by their sum, then turned into fixed point with 22 fraction
  bits, rounding half away from zero.
- The horizontal pass runs first, into an 8-bit image, then the vertical
  pass; each output is (2^21 + Σ pixel·weight) >> 22, clipped to 0-255.
  An axis whose size does not change is not resampled.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: float) -> float:
    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    if -3.0 <= x < 3.0:
        return sinc(x) * sinc(x / 3)
    return 0.0


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    if x < 1.0:
        return 1.0 - x
    return 0.0


FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_bilinear, 1.0)}


def coefficients(in_size: int, out_size: int, filter_name: str):
    """(first tap [out], fixed-point weights [out, ksize] i64) of one axis;
    weights past a row's last tap are 0."""
    fn, support = FILTERS[filter_name]
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        for x, w in enumerate(k):
            if w < 0:
                weights[xx, x] = int(-0.5 + w * (1 << PRECISION_BITS))
            else:
                weights[xx, x] = int(0.5 + w * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, weights


def _pass(img: np.ndarray, out_size: int, filter_name: str, axis: int) -> np.ndarray:
    """One axis of the resize: u8 [..] → u8 with `axis` resampled."""
    first, weights = coefficients(img.shape[axis], out_size, filter_name)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    last = img.shape[axis] - 1
    extra = (1,) * (src.ndim - 1)
    for k in range(weights.shape[1]):
        taps = np.minimum(first + k, last)  # past a row's last tap the weight is 0
        acc += src[taps] * weights[:, k].reshape((-1,) + extra)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def premultiply(rgba: np.ndarray) -> np.ndarray:
    """RGBA → RGBa (Pillow's rgbA2rgba)."""
    out = rgba.copy()
    t = rgba[..., :3].astype(np.int32) * rgba[..., 3:4].astype(np.int32) + 128
    out[..., :3] = ((t >> 8) + t) >> 8
    return out


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """RGBa → RGBA (Pillow's rgba2rgbA)."""
    out = rgba.copy()
    a = rgba[..., 3:4].astype(np.int32)
    partial = (a != 0) & (a != 255)
    c = rgba[..., :3].astype(np.int32)
    div = np.clip((255 * c) // np.where(partial, a, 1), 0, 255)
    out[..., :3] = np.where(partial, div, c).astype(np.uint8)
    return out


def resize(rgba: np.ndarray, width: int, height: int, filter_name: str) -> np.ndarray:
    """u8 [h, w, 4] → u8 [height, width, 4], equal to Pillow's
    `Image.resize((width, height), LANCZOS | BILINEAR)` of the RGBA image
    ("lanczos" or "bilinear")."""
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"resize: need u8 [h, w, 4], got {rgba.dtype} {rgba.shape}")
    if filter_name not in FILTERS:
        raise ValueError(f"resize: unknown filter {filter_name!r}")
    if (height, width) == rgba.shape[:2]:
        return rgba.copy()
    img = premultiply(rgba)
    if width != img.shape[1]:
        img = _pass(img, width, filter_name, axis=1)
    if height != img.shape[0]:
        img = _pass(img, height, filter_name, axis=0)
    return unpremultiply(img)
