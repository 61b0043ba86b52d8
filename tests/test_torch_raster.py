"""The plain PyTorch versions of kernels K1 (rasterize_binned) and K2
(rasterize_layers) against the JAX package's Pallas kernels in interpret
mode, on the same binned buffers (JAX binning of the same setup output).

Tolerance and why: XLA:CPU contracts plane evaluations a·px + b·py + c into
an FMA inside the interpreted kernels (DESIGN.md Round-3 (3)); the port
rounds every product and sum (and the CUDA kernels are built without
contraction, so they equal the plain versions exactly on the card). So:
- triangle ids / layer ids / aux counts are equal on ≥ 99.9% of samples,
  and every mismatching sample lies in the rounding band of an edge of one
  of the two triangles involved;
- depths are bit-equal wherever the ids are, except where the JAX value is
  exactly the contracted fma(a, px, b·py) + c of the same depth plane and
  the port's the uncontracted sum.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from renderer_tpu.raster import binning as jbin
from renderer_tpu.raster import layers as jlayers
from renderer_tpu.raster import raster_kernel as jrk
from renderer_tpu.raster import setup as jsetup
from renderer_tpu.raster import vertex_stage as jvs
from renderer_tpu.scene import draw_stream as jds
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.raster import layers as tlayers
from renderer_tpu_torch.raster import pipeline as tpipeline
from renderer_tpu_torch.raster import raster_kernel as trk
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS
from tests.torch_parity import host_inputs


def to_torch(d):
    return from_numpy_arrays(d, device="cpu")


TILE_H, TILE_W = 32, 128


def _bins_from_scene():
    """Setup + bins of the static mini-sandbox (all three classes)."""
    geom, _, blob, static, cfg = host_inputs("sandbox-static")
    jf = jds.unpack_frame({"blob": jnp.asarray(blob)},
                          joint_cap=static["joint_cap"])
    jv = jvs.run_vertex_stage({k: jnp.asarray(v) for k, v in geom.items()}, jf,
                              static["skin_start"])
    td = jsetup.triangle_setup(jv["clip"], jnp.asarray(geom["tri_v"]),
                               jf["num_tris"], cfg.width, cfg.height, bbox_pad=0.5)
    n_o, n_m = int(jf["n_opaque"]), int(jf["n_masked"])
    bounds = (0, n_o, n_o + n_m, int(jf["num_tris"]))
    return td, bounds, cfg.padded_height, cfg.padded_width


def _bins_from_soup(seed=0, n=160, h=96, w=256):
    """Random clip-space triangle soup — random sizes and windings, depths
    across the near plane, a few crossing w = 0 — through JAX setup."""
    rng = np.random.default_rng(seed)
    clip = np.empty((3 * n, 4), np.float32)
    clip[:, 3] = rng.uniform(0.3, 2.0, 3 * n)
    clip[rng.uniform(size=3 * n) < 0.03, 3] *= -0.5
    centers = np.repeat(rng.uniform(-1.0, 1.0, (n, 2)), 3, axis=0)
    spread = np.repeat(rng.uniform(0.02, 0.8, (n, 1)), 3, axis=0)
    clip[:, :2] = (centers + spread * rng.normal(size=(3 * n, 2))) * clip[:, 3:4]
    clip[:, 2] = rng.uniform(-0.1, 1.1, 3 * n) * clip[:, 3]
    tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    td = jsetup.triangle_setup(jnp.asarray(clip), jnp.asarray(tri_v), n, w, h,
                               bbox_pad=0.5)
    return td, (0, n // 2, 3 * n // 4, n), h, w


@pytest.fixture(scope="module", params=["scene", "soup"])
def bins(request):
    td, bounds, hp, wp = (_bins_from_scene() if request.param == "scene"
                          else _bins_from_soup())
    b = jbin.bin_triangle_classes(
        td, bounds, tiles_x=wp // TILE_W, tiles_y=hp // TILE_H, tile_w=TILE_W,
        tile_h=TILE_H, pair_capacity=1 << 12, row_capacity=1 << 12, zbuckets=16)
    assert int(np.asarray(b[3]).sum()) == 0 and int(np.asarray(b[4])) == 0
    return dict(jax=b[:3], torch=to_torch(tuple(np.asarray(x) for x in b[:3])),
                hp=hp, wp=wp)


def _coords(sample_positions, hp, wp):
    """f32 sample coordinates [S, Hp, Wp] as the kernels form them:
    (tile origin + in-pixel offset) + pixel index."""
    ys, xs = np.mgrid[0:hp, 0:wp]
    f = np.float32
    px = np.stack([(f(xs // TILE_W * TILE_W) + f(dx)) + f(xs % TILE_W)
                   for dx, _ in sample_positions]).astype(f)
    py = np.stack([(f(ys // TILE_H * TILE_H) + f(dy)) + f(ys % TILE_H)
                   for _, dy in sample_positions]).astype(f)
    return px, py


def _planes(binned, tids):
    """Binned plane rows [16, ...] of triangle ids `tids` (≥ 0)."""
    b = np.asarray(binned)
    col_of = {}
    for j in range(b.shape[1]):
        col_of.setdefault(int(b[15, j]), j)
    cols = np.array([col_of[int(t)] for t in tids.ravel()], np.int64)
    return b[:, cols].reshape((16,) + tids.shape)


def _on_edge_band(rows, px, py):
    """Is the sample within f32 rounding of one of the triangle's edges?"""
    near = np.zeros(px.shape, bool)
    for e in range(3):
        a, b, c = (rows[3 * e + i].astype(np.float64) for i in range(3))
        val = a * px + b * py + c
        mag = np.abs(a * px) + np.abs(b * py) + np.abs(c)
        near |= np.abs(val) <= 2.0**-20 * mag
    return near


def _contracted(rows, px, py):
    """The depth plane as XLA:CPU contracts it: fma(a, px, b·py) + c."""
    a, b, c = rows[9], rows[10], rows[11]
    bpy = (b * py).astype(np.float32).astype(np.float64)
    fma = (a.astype(np.float64) * px + bpy).astype(np.float32)
    return (fma + c).astype(np.float32)


def _check_ids(jt, tt, binned, px, py, what):
    mism = jt != tt
    assert mism.mean() <= 1e-3, f"{what}: {mism.mean():.4%} of ids differ"
    if mism.any():
        for tids in (jt[mism], tt[mism]):
            live = tids >= 0
            rows = _planes(binned, tids[live])
            assert _on_edge_band(rows, px[mism][live], py[mism][live]).all(), what
    return ~mism


def _check_depth(jz, tz, tids, binned, px, py, what):
    """Bit-equal, or the JAX value is the contracted evaluation of the same
    plane while the port's is the plain one."""
    diff = jz.view(np.int32) != tz.view(np.int32)
    if not diff.any():
        return
    assert (tids[diff] >= 0).all(), what
    rows = _planes(binned, tids[diff])
    np.testing.assert_array_equal(jz[diff], _contracted(rows, px[diff], py[diff]),
                                  err_msg=what)
    plain = ((rows[9] * px[diff]).astype(np.float32)
             + (rows[10] * py[diff]).astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(tz[diff], (plain + rows[11]).astype(np.float32),
                                  err_msg=what)


@pytest.mark.parametrize("msaa", [1, 4])
def test_k1_plain_matches_pallas(bins, msaa):
    spos = STANDARD_SAMPLE_POSITIONS[msaa]
    kw = dict(padded_height=bins["hp"], padded_width=bins["wp"], tile_h=TILE_H,
              tile_w=TILE_W, sample_positions=spos)
    jb, tb = bins["jax"], bins["torch"]
    jz, jt = (np.asarray(x) for x in jrk.rasterize_binned(
        jb[0], jb[1][0], jb[2][0], interpret=True, **kw))
    tz, tt = (x.numpy() for x in trk.rasterize_binned(tb[0], tb[1][0], tb[2][0], **kw))
    assert (jt >= 0).mean() > 0.02  # the case covers real work
    px, py = _coords(spos, bins["hp"], bins["wp"])
    same = _check_ids(jt, tt, jb[0], px, py, "K1 tid")
    _check_depth(jz[same], tz[same], tt[same], jb[0], px[same], py[same], "K1 depth")


@pytest.mark.parametrize("mode", ["masked", "blended"])
@pytest.mark.parametrize("msaa,layers", [(1, 2), (1, 4), (4, 2), (4, 4)])
def test_k2_plain_matches_pallas(bins, mode, msaa, layers):
    spos = STANDARD_SAMPLE_POSITIONS[msaa]
    kw = dict(padded_height=bins["hp"], padded_width=bins["wp"], tile_h=TILE_H,
              tile_w=TILE_W, sample_positions=spos)
    cls = 1 if mode == "masked" else 2
    jb, tb = bins["jax"], bins["torch"]
    # the floor: the opaque class's visibility depth (as the pipeline feeds it)
    floor = np.asarray(jrk.rasterize_binned(jb[0], jb[1][0], jb[2][0],
                                            interpret=True, **kw)[0])
    jz, jt, jaux = (np.asarray(x) for x in jlayers.rasterize_layers(
        jb[0], jb[1][cls], jb[2][cls], jnp.asarray(floor), mode=mode,
        n_layers=layers, interpret=True, **kw))
    tz, tt, taux = (x.numpy() for x in tlayers.rasterize_layers(
        tb[0], tb[1][cls], tb[2][cls], to_torch(floor), mode=mode,
        n_layers=layers, **kw))
    assert (jt >= 0).mean() > 0.01
    if layers == 2:
        assert jaux.max() > layers, "the case must overflow the capture"
    px, py = _coords(spos, bins["hp"], bins["wp"])
    mism = jaux != taux
    assert mism.mean() <= 1e-3, f"aux differs on {mism.mean():.4%}"
    pxk = np.broadcast_to(px[:, None], jt.shape)
    pyk = np.broadcast_to(py[:, None], jt.shape)
    same = _check_ids(jt, tt, jb[0], pxk, pyk, f"K2 {mode} lt")
    _check_depth(jz[same], tz[same], tt[same], jb[0], pxk[same], pyk[same],
                 f"K2 {mode} lz")


def test_cpu_tensors_take_the_plain_version(bins):
    """A CPU tensor never reaches a kernel: the launch counters stay put and
    the result is the plain version's."""
    kw = dict(padded_height=bins["hp"], padded_width=bins["wp"], tile_h=TILE_H,
              tile_w=TILE_W)
    b, s, c = bins["torch"]
    before = tpipeline.launch_counts()
    z, t = trk.rasterize_binned(b, s[0], c[0], **kw)
    pz, pt = trk.rasterize_binned_plain(b, s[0], c[0], **kw)
    out = tlayers.rasterize_layers(b, s[2], c[2], z, mode="blended", n_layers=2, **kw)
    ref = tlayers.rasterize_layers_plain(b, s[2], c[2], z, mode="blended",
                                         n_layers=2, **kw)
    assert tpipeline.launch_counts() == before
    assert z.equal(pz) and t.equal(pt)
    assert all(x.equal(y) for x, y in zip(out, ref))
