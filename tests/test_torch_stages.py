"""The port's device stages against the JAX package's on identical numpy
inputs (JAX on the CPU, op by op; the port's torch ops on the CPU).

Tolerances and why:
- unpack_frame: exact (bit reinterpretation, slicing and the same cofactor
  products).
- run_vertex_stage: ≤ 8 ULP of each vector's magnitude. The einsum
  contractions sum their 3-4 products in a library-chosen order.
- triangle_setup (fed the same clip positions): ≤ 4 ULP of each value's
  own magnitude — the same elementwise IEEE ops in the same order.
- bin_triangle_classes (fed the JAX setup output): exactly equal binned
  buffer, starts, counts and stats.
- post: the tonemapped f32 within 4 ULP (pow/division implementations),
  the u8 output within 1 step.
- shade: ≤ 2^-12 absolute on the HDR color (sRGB pow, log2 mip selection
  and sin hash differ by a few ULP between the two libraries; a LOD that
  lands on an integer can switch mip there), on ≥ 99.9% of samples within
  2^-18.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.raster import binning as jbin
from renderer_tpu.raster import post as jpost
from renderer_tpu.raster import raster_kernel as jrk
from renderer_tpu.raster import setup as jsetup
from renderer_tpu.raster import shade as jshade
from renderer_tpu.raster import vertex_stage as jvs
from renderer_tpu.scene import draw_stream as jds
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.raster import binning as tbin
from renderer_tpu_torch.raster import post as tpost
from renderer_tpu_torch.raster import setup as tsetup
from renderer_tpu_torch.raster import shade as tshade
from renderer_tpu_torch.raster import vertex_stage as tvs
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS
from renderer_tpu_torch.scene import draw_stream as tds
from tests.torch_parity import SCENES, degenerate_triangles, host_inputs


def to_torch(d):
    return from_numpy_arrays(d, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_ulp(a, b, n, scale=None, what=""):
    """|a - b| ≤ n ULP of `scale` (default: each element's own magnitude)."""
    a, b = _np(a).astype(np.float32), _np(b).astype(np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if scale is None:
        scale = np.maximum(np.abs(a), np.abs(b))
    ulp = np.spacing(np.asarray(scale, np.float32)).astype(np.float64)
    err = np.abs(a.astype(np.float64) - b.astype(np.float64))
    worst = float(np.max(err / np.maximum(ulp, np.finfo(np.float32).tiny)))
    assert worst <= n, f"{what}: {worst:.1f} ULP > {n}"


def _vec_scale(x):
    """Per-vector magnitude (max |component|), broadcast over the vector."""
    x = np.abs(_np(x))
    return np.broadcast_to(x.max(axis=-1, keepdims=True), x.shape)


@pytest.fixture(scope="module", params=SCENES)
def frame_case(request):
    geom, mats, blob, static, config = host_inputs(request.param)
    jframe = jds.unpack_frame({"blob": jnp.asarray(blob)},
                              morph_k=static["morph_k"], joint_cap=static["joint_cap"])
    tframe = tds.unpack_frame({"blob": to_torch(blob)},
                              morph_k=static["morph_k"], joint_cap=static["joint_cap"])
    jgeom = {k: jnp.asarray(v) for k, v in geom.items()}
    jv = jvs.run_vertex_stage(jgeom, jframe, static["skin_start"],
                              morph_k=static["morph_k"])
    return dict(name=request.param, geom=geom, mats=mats, static=static,
                config=config, jframe=jframe, tframe=tframe, jgeom=jgeom, jv=jv)


def test_unpack_frame_exact(frame_case):
    jf, tf = frame_case["jframe"], frame_case["tframe"]
    for k, v in jf.items():
        if v is None or k == "ui":
            assert tf.get(k) is None, k
            continue
        a, b = np.asarray(v), tf[k].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_vertex_stage(frame_case):
    c = frame_case
    tv = tvs.run_vertex_stage(to_torch(c["geom"]), c["tframe"],
                              c["static"]["skin_start"], morph_k=c["static"]["morph_k"])
    for k in ("clip", "uv", "normal", "tangent"):
        a = np.asarray(c["jv"][k])
        _assert_ulp(a, tv[k], 8, scale=_vec_scale(a), what=k)
    assert np.array_equal(np.asarray(c["jv"]["draw"]), tv["draw"].numpy())


@pytest.mark.parametrize("skin_start", [None, 40, 64])
def test_vertex_stage_skin_and_morph(skin_start):
    """Synthetic skinned + morphed stream: the morph taps before skinning,
    skinning only past skin_start (None: per-draw `skinned` flag)."""
    rng = np.random.default_rng(5)
    ve, v, d, j, k, b = 64, 48, 4, 12, 2, 20
    f32 = np.float32
    geom = {
        "positions": rng.normal(size=(v, 3)).astype(f32),
        "normals": rng.normal(size=(v, 3)).astype(f32),
        "tangents": rng.normal(size=(v, 4)).astype(f32),
        "uvs": rng.uniform(size=(v, 2)).astype(f32),
        "joints": rng.integers(0, 4, size=(v, 4)).astype(np.int32),
        "weights": rng.dirichlet(np.ones(4), size=v).astype(f32),
        "morph_pos": np.concatenate([np.zeros((1, 3), f32),
                                     rng.normal(size=(b - 1, 3)).astype(f32)]),
        "morph_nrm": np.concatenate([np.zeros((1, 3), f32),
                                     rng.normal(size=(b - 1, 3)).astype(f32)]),
        "morph_row0": np.where(rng.uniform(size=v) < 0.5, 0,
                               rng.integers(1, b - k, size=v)).astype(np.int32),
        "morph_step": np.ones(v, np.int32),
        "exp_src": rng.integers(0, v, size=ve).astype(np.int32),
        "exp_draw": np.sort(rng.integers(0, d, size=ve)).astype(np.int32),
    }
    transforms = rng.normal(size=(d, 3, 4)).astype(f32)
    frame = {
        "transforms": transforms,
        "normal_mats": rng.normal(size=(d, 3, 3)).astype(f32),
        "joints_offset": np.array([0, 4, 4, 8], np.int32),
        "joint_palette": rng.normal(size=(j, 3, 4)).astype(f32),
        "skinned": np.array([0, 1, 0, 1], np.int32),
        "morph_weights": rng.uniform(size=(d, k)).astype(f32),
        "proj_view": rng.normal(size=(4, 4)).astype(f32),
    }
    jv = jvs.run_vertex_stage({kk: jnp.asarray(vv) for kk, vv in geom.items()},
                              {kk: jnp.asarray(vv) for kk, vv in frame.items()},
                              skin_start, morph_k=k)
    tv = tvs.run_vertex_stage(to_torch(geom), to_torch(frame), skin_start, morph_k=k)
    for key in ("clip", "normal", "tangent", "uv"):
        a = np.asarray(jv[key])
        _assert_ulp(a, tv[key], 8, scale=_vec_scale(a), what=key)
    if skin_start is None:
        # a mesh rank's slice of the stream gives the whole stream's bits
        # (every contraction written out in a fixed order; the card test
        # test_vertex_stage_slice_equals_the_whole_stream holds the same)
        tgeom = to_torch(geom)
        for lo, hi in ((0, 24), (24, 40), (40, 64)):
            part = tvs.run_vertex_stage(dict(tgeom, exp_src=tgeom["exp_src"][lo:hi],
                                             exp_draw=tgeom["exp_draw"][lo:hi]),
                                        to_torch(frame), None, morph_k=k)
            for key, v in part.items():
                assert torch.equal(v, tv[key][lo:hi]), (lo, hi, key)


def _setup_both(c):
    cfg = c["config"]
    pad = 0.5 if cfg.msaa_samples > 1 else 0.0
    jt = jsetup.triangle_setup(c["jv"]["clip"], c["jgeom"]["tri_v"],
                               c["jframe"]["num_tris"], cfg.width, cfg.height,
                               bbox_pad=pad)
    tt = tsetup.triangle_setup(to_torch(np.asarray(c["jv"]["clip"])),
                               to_torch(c["geom"]["tri_v"]), c["tframe"]["num_tris"],
                               cfg.width, cfg.height, bbox_pad=pad)
    return jt, tt


def test_triangle_setup(frame_case):
    jt, tt = _setup_both(frame_case)
    _assert_ulp(np.asarray(jt), tt, 4, what="setup rows")


def test_binning_exact(frame_case):
    c = frame_case
    cfg = c["config"]
    jt, _ = _setup_both(c)
    jf, tf = c["jframe"], c["tframe"]
    jb = jbin.bin_triangle_classes(
        jt, (0, jf["n_opaque"], jf["n_opaque"] + jf["n_masked"], jf["num_tris"]),
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, pair_capacity=1 << 11, row_capacity=1 << 11,
        zbuckets=cfg.opaque_z_buckets)
    tb = tbin.bin_triangle_classes(
        to_torch(np.asarray(jt)),
        (0, tf["n_opaque"], tf["n_opaque"] + tf["n_masked"], tf["num_tris"]),
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, pair_capacity=1 << 11, row_capacity=1 << 11,
        zbuckets=cfg.opaque_z_buckets)
    names = ("binned", "starts", "counts", "overflow", "row_overflow",
             "pair_demand", "row_demand")
    for name, a, b in zip(names, jb, tb):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_binning_overflow_exact():
    """Capacities far below demand: the truncation, overflow and demand
    stats must match too (the sandbox scene at 1/8 of its pair demand)."""
    geom, _, blob, static, cfg = host_inputs("sandbox-static")
    jf = jds.unpack_frame({"blob": jnp.asarray(blob)}, morph_k=0,
                          joint_cap=static["joint_cap"])
    jv = jvs.run_vertex_stage({k: jnp.asarray(v) for k, v in geom.items()}, jf,
                              static["skin_start"])
    jt = jsetup.triangle_setup(jv["clip"], jnp.asarray(geom["tri_v"]),
                               jf["num_tris"], cfg.width, cfg.height, bbox_pad=0.5)
    bounds = (0, int(jf["n_opaque"]), int(jf["n_opaque"] + jf["n_masked"]),
              int(jf["num_tris"]))
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
              tile_h=cfg.tile_h, pair_capacity=128, row_capacity=256,
              zbuckets=16)
    jb = jbin.bin_triangle_classes(jt, bounds, **kw)
    tb = tbin.bin_triangle_classes(to_torch(np.asarray(jt)), bounds, **kw)
    assert int(np.asarray(jb[3]).sum()) > 0 and int(np.asarray(jb[4])) > 0
    for a, b in zip(jb, tb):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_post():
    rng = np.random.default_rng(3)
    hdr = np.concatenate([rng.uniform(0, 1, (4, 24, 32, 3)),
                          rng.exponential(2.0, (4, 24, 32, 3))]).astype(np.float32)
    for x in (hdr[0], hdr):
        ja = np.asarray(jpost.srgb_encode(jpost.aces(jnp.asarray(x) * jpost.EXPOSURE)))
        ta = tpost.srgb_encode(tpost.aces(torch.from_numpy(x) * tpost.EXPOSURE))
        _assert_ulp(ja, ta, 4, what="tonemapped")
        ju = np.asarray(jpost.tonemap(jnp.asarray(x))).astype(int)
        tu = tpost.tonemap(torch.from_numpy(x)).numpy().astype(int)
        assert np.abs(ju - tu).max() <= 1


@pytest.mark.parametrize("srgb_per_tap,aniso", [(True, 16), (False, 4)])
def test_shade(frame_case, srgb_per_tap, aniso):
    """shade_interpolated and base_alpha on the scene's sample-0 visibility
    (the JAX kernel's tid map), default sampler and fast_sampler()."""
    c = frame_case
    cfg = c["config"]
    jt, _ = _setup_both(c)
    jf = c["jframe"]
    jb = jbin.bin_triangle_classes(
        jt, (0, jf["num_tris"]), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, pair_capacity=1 << 11)
    spos = STANDARD_SAMPLE_POSITIONS[cfg.msaa_samples]
    _, tid = jrk.rasterize_binned(
        jb[0], jb[1][0], jb[2][0], padded_height=cfg.padded_height,
        padded_width=cfg.padded_width, sample_positions=spos, interpret=True)
    tid = np.asarray(tid)[:, : cfg.height, : cfg.width]
    tid = np.stack([tid[0], np.roll(tid[0], 1, axis=1)])  # a [C,H,W] stack
    tv = tvs.run_vertex_stage(to_torch(c["geom"]), c["tframe"],
                              c["static"]["skin_start"])
    jmats = {k: jnp.asarray(v) for k, v in c["mats"].items()}
    tmats = to_torch(c["mats"])
    kw = dict(width=cfg.width, height=cfg.height)
    jit_ = jshade.interpolants(jnp.asarray(tid), c["jgeom"], c["jv"], **kw)
    tit = tshade.interpolants(torch.from_numpy(tid), to_torch(c["geom"]), tv, **kw)
    args = (cfg.trilinear, aniso, srgb_per_tap)
    jc = np.asarray(jshade.shade_interpolated(jit_, c["jv"], jf, jmats, *args))
    tc = tshade.shade_interpolated(tit, tv, c["tframe"], tmats, *args).numpy()
    err = np.abs(jc - tc)
    assert err.max() <= 2.0**-12, err.max()
    assert (err <= 2.0**-18).mean() >= 0.999
    ja, jco = jshade.base_alpha(jit_, jf, jmats, *args)
    ta, tco = tshade.base_alpha(tit, c["tframe"], tmats, *args)
    assert np.abs(np.asarray(ja) - ta.numpy()).max() <= 2.0**-12
    assert np.array_equal(np.asarray(jco), tco.numpy())


@pytest.mark.parametrize("bbox_pad", [0.0, 0.5])
def test_degenerate_triangles_are_invalid(bbox_pad):
    """Point and collinear triangles (tests/torch_parity.degenerate_triangles:
    the sandbox scene's 48 zero-index padding triangles, column 792 among
    them, and hand-made ones) leave triangle_setup invalid, their columns
    all zero, so no stage can rasterize them; the valid controls stay
    valid. The JAX package's eager setup agrees on the valid row. (Its
    jitted frame does not: there XLA contracts setup.cross into FMAs and
    16 of the point triangles pass det > 0, ROADMAP queue 3.)"""
    clip, tri_v, n, w, h, degenerate, control = degenerate_triangles("cpu")
    assert len(degenerate) == 48 + 7 and 792 in degenerate
    assert tri_v[792].tolist() == [400, 400, 400]
    td = tsetup.triangle_setup(clip, tri_v, n, w, h, bbox_pad=bbox_pad)
    assert torch.equal(td[:, degenerate], torch.zeros_like(td[:, degenerate]))
    assert td[tsetup.VALID_ROW, control].tolist() == [1.0, 1.0]
    jt = jsetup.triangle_setup(jnp.asarray(clip.numpy()), jnp.asarray(tri_v.numpy()),
                               n, w, h, bbox_pad=bbox_pad)
    np.testing.assert_array_equal(np.asarray(jt)[tsetup.VALID_ROW],
                                  td[tsetup.VALID_ROW].numpy())
