"""Texture filtering semantics pins, on the port's CPU path (the twin of
tests/test_srgb_filter_order.py, held to the same numpy oracle):

1. sRGB decode order — this engine decodes the FILTERED value instead of
   decoding each bilinear tap (hardware / the reference sampler decode before
   filtering). These tests pin that the implementation is exactly
   decode-after-filter and quantify the deviation: negligible on smooth
   gradients, bounded-by-analysis on worst-case (full-contrast checkerboard)
   content. See raster/shade.py and PARITY.md known gaps.

2. Per-axis mip LOD — non-square textures must select the mip from
   texel-space derivatives per axis, not a single max-dimension size.
"""

import numpy as np
import torch

from tests import torch_parity  # noqa: F401 — one torch thread a worker
import renderer_tpu_torch as rt
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.materials.atlas import build_atlas
from renderer_tpu_torch.materials.registry import Texture, TextureKind
from renderer_tpu_torch.raster.shade import make_sampler


def _materials_for(textures):
    reg = rt.MaterialRegistry()
    for t in textures:
        reg.register_texture(t)
    at = build_atlas(reg)
    return reg, from_numpy_arrays({"atlas": at.data, "atlas_table": at.table,
                                   "atlas_srgb": at.srgb}, device="cpu")


def _srgb_decode(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _np_bilinear(img_u8, uv, decode_per_tap):
    """Repeat-wrap bilinear of one mip, numpy oracle. img [h,w,4] u8."""
    h, w = img_u8.shape[:2]
    c = img_u8.astype(np.float64) / 255.0
    if decode_per_tap:
        c = np.concatenate([_srgb_decode(c[..., :3]), c[..., 3:]], axis=-1)
    uvf = uv - np.floor(uv)
    uf = uvf[..., 0] * w - 0.5
    vf = uvf[..., 1] * h - 0.5
    iu = np.floor(uf).astype(int)
    iv = np.floor(vf).astype(int)
    fu = (uf - iu)[..., None]
    fv = (vf - iv)[..., None]

    def tap(dx, dy):
        return c[(iv + dy) % h, (iu + dx) % w]

    out = (
        tap(0, 0) * (1 - fu) * (1 - fv)
        + tap(1, 0) * fu * (1 - fv)
        + tap(0, 1) * (1 - fu) * fv
        + tap(1, 1) * fu * fv
    )
    if not decode_per_tap:
        out = np.concatenate([_srgb_decode(out[..., :3]), out[..., 3:]], axis=-1)
    return out


def _sample(materials, slot, uv, duv_scale=1e-4, srgb_per_tap=False):
    hw = uv.shape[:2]
    slots = torch.full(hw, slot, dtype=torch.int32)
    tiny = torch.full(hw + (2,), duv_scale, dtype=torch.float32)
    sampler = make_sampler(
        materials, torch.as_tensor(uv, dtype=torch.float32),
        torch.zeros(hw, dtype=torch.float32), trilinear=False,
        duv_dx=tiny, duv_dy=tiny, aniso=1, srgb_per_tap=srgb_per_tap,
    )
    return np.asarray(sampler(slots))


class TestSrgbFilterOrder:
    def _uv_grid(self, n=16):
        # sample positions that land between texels (worst case for filtering)
        u = (np.arange(n) + 0.37) / n
        v = (np.arange(n) + 0.61) / n
        return np.stack(np.meshgrid(u, v, indexing="xy"), axis=-1)

    def test_gradient_deviation_is_negligible(self):
        g = np.linspace(0, 255, 32).astype(np.uint8)
        img = np.dstack([np.tile(g, (32, 1))] * 3 + [np.full((32, 32), 255, np.uint8)])
        tex = Texture([np.ascontiguousarray(img)], TextureKind.SRGB_COLOR, "grad")
        _reg, mats = _materials_for([tex])
        uv = self._uv_grid()
        got = _sample(mats, tex.slot, uv)
        after = _np_bilinear(img, uv, decode_per_tap=False)
        before = _np_bilinear(img, uv, decode_per_tap=True)
        # the implementation IS decode-after-filter…
        np.testing.assert_allclose(got, after, atol=2e-3)
        # …and on smooth content that is within ~1 u8 step of the hardware
        # decode-before-filter result
        assert np.abs(after[..., :3] - before[..., :3]).max() < 1.5 / 255.0

    def test_checkerboard_worst_case_is_the_analytic_bound(self):
        img = np.zeros((8, 8, 4), np.uint8)
        img[:, :, 3] = 255
        img[::2, ::2, :3] = 255
        img[1::2, 1::2, :3] = 255
        tex = Texture([img], TextureKind.SRGB_COLOR, "checker")
        _reg, mats = _materials_for([tex])
        uv = self._uv_grid(8)
        got = _sample(mats, tex.slot, uv)
        after = _np_bilinear(img, uv, decode_per_tap=False)
        before = _np_bilinear(img, uv, decode_per_tap=True)
        np.testing.assert_allclose(got, after, atol=2e-3)
        # worst case: encoded mean 0.5 decodes to 0.214 vs the true linear
        # mean 0.5 → max deviation ≈ 0.29 in linear space. Pin the bound so
        # the documented deviation stays what the docs claim.
        dev = np.abs(after[..., :3] - before[..., :3]).max()
        assert 0.2 < dev <= 0.2864, dev  # 0.5 - decode(0.5) = 0.2863


class TestSrgbPerTapExactMode:
    """srgb_per_tap=True (RenderConfig.exact_sampler) must be EXACTLY the
    hardware decode-before-filter order (descriptors.rs:90-105 + the
    VK_FORMAT_*_SRGB sampling rules), even on worst-case content where the
    fast path's documented deviation is at its bound."""

    def _uv_grid(self, n=16):
        u = (np.arange(n) + 0.37) / n
        v = (np.arange(n) + 0.61) / n
        return np.stack(np.meshgrid(u, v, indexing="xy"), axis=-1)

    def test_checkerboard_matches_decode_before_filter(self):
        img = np.zeros((8, 8, 4), np.uint8)
        img[:, :, 3] = 255
        img[::2, ::2, :3] = 255
        img[1::2, 1::2, :3] = 255
        tex = Texture([img], TextureKind.SRGB_COLOR, "checker")
        _reg, mats = _materials_for([tex])
        uv = self._uv_grid(8)
        got = _sample(mats, tex.slot, uv, srgb_per_tap=True)
        before = _np_bilinear(img, uv, decode_per_tap=True)
        np.testing.assert_allclose(got, before, atol=2e-3)
        # and it genuinely differs from the fast path on this content
        after = _np_bilinear(img, uv, decode_per_tap=False)
        assert np.abs(got[..., :3] - after[..., :3]).max() > 0.2

    def test_linear_textures_identical_in_both_modes(self):
        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, (8, 8, 4), np.uint8).astype(np.uint8)
        tex = Texture([img], TextureKind.LINEAR_COLOR, "lin")
        _reg, mats = _materials_for([tex])
        uv = self._uv_grid(8)
        a = _sample(mats, tex.slot, uv, srgb_per_tap=False)
        b = _sample(mats, tex.slot, uv, srgb_per_tap=True)
        np.testing.assert_array_equal(a, b)

    def test_aniso16_taps_stay_inside_footprint(self):
        """16-tap anisotropy (the reference device's max_sampler_anisotropy):
        a half-black/half-white sRGB texture sampled with a purely horizontal
        footprint inside one half must not leak the other half's color, and
        a footprint spanning both halves must average them in LINEAR space
        (per-tap decode)."""
        img = np.zeros((16, 16, 4), np.uint8)
        img[:, :, 3] = 255
        img[:, 8:, :3] = 255  # right half white
        tex = Texture([img], TextureKind.SRGB_COLOR, "half")
        _reg, mats = _materials_for([tex])
        hw = (4, 4)
        slots = torch.full(hw, tex.slot, dtype=torch.int32)

        def sample_at(u, major_u):
            uv = np.full(hw + (2,), 0.5, np.float32)
            uv[..., 0] = u
            dx = np.broadcast_to(
                np.array([major_u, 0], np.float32), hw + (2,)
            ).copy()
            dy = np.broadcast_to(
                np.array([0, 1 / 64], np.float32), hw + (2,)
            ).copy()
            sampler = make_sampler(
                mats, torch.as_tensor(uv), torch.zeros(hw, dtype=torch.float32),
                trilinear=False, duv_dx=torch.as_tensor(dx), duv_dy=torch.as_tensor(dy),
                aniso=16, srgb_per_tap=True,
            )
            return np.asarray(sampler(slots))[0, 0]

        # footprint u ∈ [0.125, 0.375]: fully inside the black half
        inside = sample_at(0.25, 0.25)
        assert inside[:3].max() < 0.02, inside
        # footprint u ∈ [0.375, 0.625]: half black, half white → linear mean
        # ≈ 0.5 (per-tap decode; encoded-space averaging would give 0.21)
        span = sample_at(0.5, 0.25)
        assert 0.35 < span[0] < 0.65, span


class TestPerAxisMipLod:
    def test_non_square_texture_uses_per_axis_derivatives(self):
        # mip0 16x4 red, mip1 8x2 green, mip2 4x1 blue
        def solid(h, w, rgb):
            m = np.zeros((h, w, 4), np.uint8)
            m[..., :3] = rgb
            m[..., 3] = 255
            return m

        tex = Texture(
            [solid(4, 16, (255, 0, 0)), solid(2, 8, (0, 255, 0)),
             solid(1, 4, (0, 0, 255))],
            TextureKind.LINEAR_COLOR, "mips",
        )
        _reg, mats = _materials_for([tex])
        hw = (4, 4)
        uv = np.full(hw + (2,), 0.5, np.float32)
        slots = torch.full(hw, tex.slot, dtype=torch.int32)

        def sample_with(duv_dx, duv_dy):
            sampler = make_sampler(
                mats, torch.as_tensor(uv),
                torch.zeros(hw, dtype=torch.float32), trilinear=False,
                duv_dx=torch.as_tensor(np.broadcast_to(duv_dx, hw + (2,)).copy()),
                duv_dy=torch.as_tensor(np.broadcast_to(duv_dy, hw + (2,)).copy()),
                aniso=1,
            )
            return np.asarray(sampler(slots))[0, 0, :3]

        # one screen pixel per texel on BOTH axes → mip 0, even though the
        # v-axis UV derivative (1/4) is large relative to the 16-wide u axis
        np.testing.assert_allclose(
            sample_with(np.array([1 / 16, 0]), np.array([0, 1 / 4])),
            [1, 0, 0], atol=1e-3,
        )
        # 2 texels per pixel on both axes → mip 1
        np.testing.assert_allclose(
            sample_with(np.array([2 / 16, 0]), np.array([0, 2 / 4])),
            [0, 1, 0], atol=1e-3,
        )
