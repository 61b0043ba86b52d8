"""The port's twin of tests/test_zorder.py: its CPU path held to the same
oracles and invariants.

Opaque nearest-first z-ordering (RenderConfig.opaque_z_buckets) and the
raster kernel's early-depth rejection must be pure WORK-skipping levers:
bit-identical images/depth for any bucket count, including exact
equal-depth (coplanar) ties, which must keep the reference's
later-submission-wins semantics (pipelines.rs:152-158 GREATER_OR_EQUAL +
draw order)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from tests.torch_parity import cpu_renderer  # (and one torch thread a worker)
import renderer_tpu_torch as rt
from renderer_tpu_torch.core import math3d
from renderer_tpu_torch.raster import binning, pipeline, raster_kernel, setup

TILES_X, TILES_Y, TILE_W, TILE_H = 2, 4, 128, 16
W, H = TILES_X * TILE_W, TILES_Y * TILE_H


def _setup_random(seed: int, n: int, coplanar_pairs: int = 6):
    """Random overlapping triangles with a few EXACT coplanar duplicate
    pairs (identical vertices, different stream ids — the hardest depth-tie
    case: the later one must win everywhere it covers)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, n).astype(np.float32)
    for k in range(coplanar_pairs):
        pts[n - 1 - k] = pts[k]  # exact duplicate, later in the stream
        z[n - 1 - k] = z[k]
    clip = np.zeros((3 * n, 4), np.float32)
    clip[:, :2] = pts.reshape(-1, 2)
    clip[:, 2] = np.repeat(z, 3)
    clip[:, 3] = 1.0
    tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    td = setup.triangle_setup(torch.as_tensor(clip), torch.as_tensor(tri_v), n, W, H)
    return td, n


def _raster(td, n, zbuckets, sample_positions=((0.5, 0.5),)):
    binned, s, c, ov, rov, _pd, _rd = binning.bin_triangle_classes(
        td, (0, n),
        tiles_x=TILES_X, tiles_y=TILES_Y, tile_w=TILE_W, tile_h=TILE_H,
        pair_capacity=1 << 13, row_capacity=1 << 13, zbuckets=zbuckets,
    )
    assert int(np.asarray(ov).sum()) == 0 and int(rov) == 0
    depth, tid = raster_kernel.rasterize_binned(
        binned, s[0], c[0],
        padded_height=H, padded_width=W, tile_h=TILE_H, tile_w=TILE_W,
        sample_positions=sample_positions,
    )
    return np.asarray(depth), np.asarray(tid)


def test_zbuckets_bit_identical_including_ties():
    """zbuckets=16 (nearest-first) must reproduce zbuckets=1 (submission
    order) bit-for-bit — depth AND winner ids — on scenes with heavy
    overlap and exact coplanar duplicates."""
    for seed in (3, 11, 42):
        td, n = _setup_random(seed, 72)
        d1, t1 = _raster(td, n, 1)
        d16, t16 = _raster(td, n, 16)
        np.testing.assert_array_equal(d1, d16)
        np.testing.assert_array_equal(t1, t16)
        assert (t1 >= 0).mean() > 0.3  # the scene actually covers


def test_coplanar_tie_later_submission_wins():
    """Two EXACTLY coplanar full-coverage triangles: the later-submitted id
    must own every covered sample under both orderings (the reference's
    draw-order tie rule)."""
    big = np.array([[-2.0, -2.0], [-2.0, 3.0], [3.0, -2.0]], np.float32)
    clip = np.zeros((6, 4), np.float32)
    clip[:3, :2] = big
    clip[3:, :2] = big
    clip[:, 2] = 0.5
    clip[:, 3] = 1.0
    tri_v = np.arange(6, dtype=np.int32).reshape(2, 3)
    td = setup.triangle_setup(torch.as_tensor(clip), torch.as_tensor(tri_v), 2, W, H)
    for zb in (1, 16):
        _, tid = _raster(td, 2, zb)
        covered = tid >= 0
        assert covered.mean() > 0.8
        assert (tid[covered] == 1).all(), f"zbuckets={zb}: earlier id won a tie"


def test_zbuckets_msaa_samples_bit_identical():
    """Per-sample outputs under MSAA positions must also be invariant (the
    early-depth floor is the min over ALL samples)."""
    td, n = _setup_random(7, 48)
    spos = pipeline.STANDARD_SAMPLE_POSITIONS[4]
    d1, t1 = _raster(td, n, 1, spos)
    d16, t16 = _raster(td, n, 16, spos)
    np.testing.assert_array_equal(d1, d16)
    np.testing.assert_array_equal(t1, t16)


def test_full_frame_zbuckets_bit_identical():
    """End to end through render_frame (opaque + masked + blended + MSAA):
    opaque_z_buckets must not change a single output byte — the
    order-dependent masked/blended classes are never bucketed."""
    from dataclasses import replace

    from tests.test_torch_alpha_modes import quad

    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    back = quad(builder, 2.0, half=2.0)
    mid = quad(builder, 1.4, half=1.0)
    near = quad(builder, 0.9, half=0.6)
    masked = quad(builder, 1.2, half=0.5)
    blended = quad(builder, 0.7, half=0.4)
    builder.build()
    m_o = registry.create_material(
        "o", rt.PbrMaterialParameters(base_color_factor=(0.8, 0.3, 0.2, 1)))
    m_m = registry.create_material(
        "m", rt.PbrMaterialParameters(base_color_factor=(0.2, 0.9, 0.3, 0.6),
                                      alpha_cutoff=0.5,
                                      alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE))
    m_b = registry.create_material(
        "b", rt.PbrMaterialParameters(base_color_factor=(0.1, 0.4, 0.9, 0.5),
                                      alpha_mode=rt.AlphaMode.BLENDED))

    def make_scene():
        scene = rt.Scene()
        # overdraw stack far->near: submission order is the z-order worst
        # case, the exact shape the bucketing reorders
        for mesh in (back, mid, near):
            assert scene.queue_mesh(mesh, m_o, None, math3d.IDENTITY)
        assert scene.queue_mesh(masked, m_m, None, math3d.IDENTITY)
        assert scene.queue_mesh(blended, m_b, None, math3d.IDENTITY)
        return scene

    base = rt.RenderConfig(width=128, height=96, tile_h=16, msaa_samples=4,
                           opaque_z_buckets=1).validate()
    img1 = np.asarray(
        cpu_renderer(registry, base).render_frame(make_scene(), debug_mode=0))
    cfg16 = replace(base, opaque_z_buckets=16).validate()
    img16 = np.asarray(
        cpu_renderer(registry, cfg16).render_frame(make_scene(), debug_mode=0))
    np.testing.assert_array_equal(img1, img16)
