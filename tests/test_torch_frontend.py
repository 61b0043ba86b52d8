"""The raster front end's plain versions (renderer_tpu_torch/raster/setup.py
`triangle_setup_plain` and binning.py `bin_triangle_classes_plain`, what
the entry points run on the CPU) against the JAX package's
`triangle_setup` (renderer_tpu/raster/setup.py:57) and
`bin_triangle_classes` (renderer_tpu/raster/binning.py:141) on the same
numpy inputs: the crafted cases of tests/torch_frontend_cases.py (points
and collinear triangles, w crossing 0 and w = 0 exactly, ±inf and NaN,
vertices on tile edges at pixel centres) at tiles of 128×32 and 384×24,
one- and double-sided, and binned with 1, 2 and 3 classes, z-buckets 1 and
16, a band (tile_row_lo 1, row_stride 2) and pair and row truncation
(fc.PARITY_BINS). Also
the dispatch: CPU tensors run the plain versions, and the wrappers of
kernels F1-F4 refuse inputs they do not take.

Tolerances: setup ≤ 4 ULP of each value's own magnitude (the same
elementwise IEEE ops in the same order; the values come out equal), with
NaN and the infinities at the same places; binning, fed the JAX setup's
output, exactly equal — binned buffer, starts, counts, overflows and
demands. On the card, F1-F4 are held to these plain versions bit for bit
(tests/test_torch_cuda_kernels.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.raster import binning as jbin
from renderer_tpu.raster import setup as jsetup
from renderer_tpu_torch.raster import binning, pipeline, setup
from tests import torch_frontend_cases as fc
from tests import torch_parity  # noqa: F401 (one torch thread a worker)

OUTPUTS = ("binned", "starts", "counts", "overflow", "row_overflow", "pair_demand",
           "row_demand")


def _setup_args(inp: dict, double_sided: bool) -> tuple:
    return (inp["num_tris"], inp["width"], inp["height"]), dict(
        bbox_pad=0.5, double_sided=double_sided)


@functools.lru_cache(maxsize=None)
def _jax_setup(case: str, tiles: tuple, double_sided: bool) -> np.ndarray:
    inp = fc.setup_inputs(case, tiles)
    args, kw = _setup_args(inp, double_sided)
    return np.asarray(jsetup.triangle_setup(jnp.asarray(inp["clip"]),
                                            jnp.asarray(inp["tri_v"]), *args, **kw))


def _assert_setup_close(got: np.ndarray, want: np.ndarray, n_ulp: int) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), "NaN at other values"
    inf = np.isinf(want)
    assert np.array_equal(got[inf], want[inf]), "infinities differ"
    fin = ~nan & ~inf
    g, w = got[fin].astype(np.float64), want[fin].astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float32)).astype(np.float64)
    worst = np.max(np.abs(g - w) / np.maximum(ulp, np.finfo(np.float32).tiny), initial=0.0)
    assert worst <= n_ulp, f"{worst:.1f} ULP > {n_ulp}"


@pytest.mark.parametrize("double_sided", [False, True])
@pytest.mark.parametrize("case", fc.CASES)
@pytest.mark.parametrize("tiles", fc.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_setup_plain_matches_jax(tiles, case, double_sided):
    inp = fc.setup_inputs(case, tiles)
    args, kw = _setup_args(inp, double_sided)
    got = setup.triangle_setup_plain(torch.from_numpy(inp["clip"]),
                                     torch.from_numpy(inp["tri_v"]), *args, **kw)
    want = _jax_setup(case, tiles, double_sided)
    _assert_setup_close(got.numpy(), want, 4)
    valid = want[setup.VALID_ROW] > 0
    assert 0 < valid.sum() < inp["num_tris"] and not valid[inp["num_tris"]:].any()


@pytest.mark.parametrize("case", fc.CASES)
@pytest.mark.parametrize("tiles,config", fc.PARITY_BINS,
                         ids=[f"{t[0]}x{t[1]}-{c}" for t, c in fc.PARITY_BINS])
def test_binning_plain_matches_jax(tiles, config, case):
    td = _jax_setup(case, tiles, False)
    bounds, kw = fc.bin_config(config, tiles, td.shape[1])
    want = jbin.bin_triangle_classes(jnp.asarray(td), bounds, **kw)
    got = binning.bin_triangle_classes_plain(torch.from_numpy(td.copy()), bounds, **kw)
    for name, g, w in zip(OUTPUTS, got, want, strict=True):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        assert g.numpy().tobytes() == w.tobytes(), name
    overflow, row_overflow = np.asarray(want[3]), int(want[4])
    assert (overflow.sum() > 0) == (config == "pair-truncation"), overflow
    assert (row_overflow > 0) == (config == "row-truncation"), row_overflow
    assert int(np.asarray(want[2]).sum()) > 0


def test_cpu_tensors_run_the_plain_versions():
    """On CPU tensors the entry points return the plain versions' outputs
    and launch nothing; a one-element bound tensor counts as its value."""
    inp = fc.setup_inputs("soup", fc.TILES[0])
    clip, tri_v = torch.from_numpy(inp["clip"]), torch.from_numpy(inp["tri_v"])
    before = pipeline.launch_counts()
    for ds in (False, True):
        args, kw = _setup_args(inp, ds)
        td = setup.triangle_setup(clip, tri_v, *args, **kw)
        assert torch.equal(td.view(torch.int32),
                           setup.triangle_setup_plain(clip, tri_v, *args, **kw).view(torch.int32))
    bounds, kw = fc.bin_config("three-classes", fc.TILES[0], td.shape[1])
    bounds = tuple(torch.tensor(b, dtype=torch.int32) for b in bounds)
    got = binning.bin_triangle_classes(td, bounds, **kw)
    want = binning.bin_triangle_classes_plain(td, bounds, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    b, s, c, ov = binning.bin_triangles(td, 0, bounds[-1], **{
        k: v for k, v in kw.items() if k != "zbuckets"})
    one = binning.bin_triangle_classes_plain(td, (0, bounds[-1]), **{
        k: v for k, v in kw.items() if k != "zbuckets"})
    assert torch.equal(b, one[0]) and torch.equal(s, one[1][0]) and torch.equal(c, one[2][0])
    assert int(ov) == int(one[3][0] + one[4])
    assert pipeline.launch_counts() == before


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad,match", [
    (dict(clip=_meta((9, 3))), "clip must have shape"),
    (dict(clip=_meta((9, 4), torch.float64)), "clip must be a torch.float32"),
    (dict(tri_v=_meta((3, 3), torch.int64)), "tri_v must be a torch.int32"),
    (dict(tri_v=_meta((3, 4), torch.int32)), "tri_v must have shape"),
    (dict(num_tris=_meta((), torch.float32)), "num_tris must be one int32 or int64"),
    (dict(clip=_meta((0, 4))), "triangles over no vertices"),
    ({}, "unsupported device meta"),
])
def test_setup_wrapper_refuses(bad, match):
    """F1's wrapper checks its inputs before it launches (on tensors off
    the CPU; here on the meta device, which it then refuses)."""
    args = dict(clip=_meta((9, 4)), tri_v=_meta((3, 3), torch.int32), num_tris=3)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        setup.triangle_setup(args["clip"], args["tri_v"], args["num_tris"], 64, 32)


@pytest.mark.parametrize("bad,match", [
    (dict(tri_data=_meta((16, 8))), "tri_data must have shape"),
    (dict(tri_data=_meta((24, 8), torch.float64)), "tri_data must be a torch.float32"),
    (dict(bounds=(0, 1, 2, 3, 8)), "4 classes; the kernels take 1..3"),
    (dict(bounds=(0, _meta((2,), torch.int32), 8)), r"bounds\[1\] must be one int32"),
    (dict(tri_data=_meta((24, 0))), "sizes"),
    (dict(pair_capacity=0), "sizes"),
    (dict(row_stride=0), "sizes"),
    ({}, "unsupported device meta"),
])
def test_binning_wrapper_refuses(bad, match):
    """F2-F4's wrapper (binning_steps) checks its inputs before it
    allocates or launches."""
    args = dict(tri_data=_meta((24, 8)), bounds=(0, 4, 8), pair_capacity=64, row_stride=1)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        binning.bin_triangle_classes(args["tri_data"], args["bounds"], tiles_x=2, tiles_y=2,
                                     tile_w=128, tile_h=32, pair_capacity=args["pair_capacity"],
                                     row_stride=args["row_stride"])


def test_tile_edges_case_meets_a_reciprocal_flip():
    """The "tile-edges" case at 384×24 has a valid triangle whose bbox
    bottom, divided truly by the tile height, floors to another tile row
    than its product with the f32 reciprocal of 24 — the product that the
    JAX package's jitted binning (XLA, a constant divisor) and torch on the
    card (a Python divisor) compute, and that the plain version writes out
    (binning._reciprocal). So the parity test above and the card test that
    holds the plain version on the card to the CPU's meet the difference."""
    tiles, py = fc.RECIPROCAL_FLIP
    inp = fc.setup_inputs("tile-edges", tiles)
    td = _jax_setup("tile-edges", tiles, False)
    ymax = td[setup.BBOX_ROWS[3]]
    hit = (td[setup.VALID_ROW] > 0) & (ymax == np.float32(py) + np.float32(0.5))
    assert hit.any() and inp["height"] == 144
    x = ymax[hit] - np.float32(0.5)
    th = np.float32(tiles[1])
    assert (np.floor(x / th) != np.floor(x * (np.float32(1) / th))).all()
