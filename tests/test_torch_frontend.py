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


# -- F2 spans' and F4 scan's edges (fc.EDGE_CASES) ------------------------------

def test_edge_cases_straddle_the_kernels_paths():
    """fc.SPANS_GATE_MIN is csrc/frontend.cu's, and the edge cases take
    both of F2 spans' paths (narrow, wide) and F4 scan's key counts below,
    at and past its threads (SCAN_THREADS) and past its keys a pass
    (SCAN_KEYS)."""
    import re
    from pathlib import Path

    src = (Path(binning.__file__).parents[1] / "csrc" / "frontend.cu").read_text()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("SPANS_GATE_MIN", "SCAN_THREADS", "SCAN_KEYS")}
    assert const["SPANS_GATE_MIN"] == fc.SPANS_GATE_MIN
    assert {n >= fc.SPANS_GATE_MIN for n, *_ in fc.EDGE_CASES.values()} == {True, False}
    keys = {int(name.split("-")[1]) for name in fc.EDGE_CASES if name.startswith("keys-")}
    threads = const["SCAN_THREADS"]
    assert {threads - 1, threads, threads + 1, const["SCAN_KEYS"] + 1} <= keys


@functools.lru_cache(maxsize=None)
def _jax_edge_setup(name: str) -> np.ndarray:
    inp = fc.edge_inputs(name)
    args, kw = _setup_args(inp, False)
    return np.asarray(jsetup.triangle_setup(jnp.asarray(inp["clip"]),
                                            jnp.asarray(inp["tri_v"]), *args, **kw))


@pytest.mark.parametrize("name", fc.EDGE_CASES)
def test_binning_plain_matches_jax_on_kernel_edges(name):
    """The plain binning against the JAX package on the cases that put F2
    spans' and F4 scan's edges where the kernels change path: triangle
    counts that are not multiples of 4, one short of and one past 4 × 256;
    key counts 1023-1025, 2048, 2049 and 4097 (F4 scan's 1024 threads and
    4096 keys a pass); a band of every third tile row; z-buckets 1 and 16;
    a run of invalid triangles over whole groups of 4 and a whole block.
    Every output equal; the run is invalid and the soup has valid
    triangles and binned pairs."""
    td = _jax_edge_setup(name)
    bounds, kw = fc.edge_bins(name)
    want = jbin.bin_triangle_classes(jnp.asarray(td), bounds, **kw)
    got = binning.bin_triangle_classes_plain(torch.from_numpy(td.copy()), bounds, **kw)
    for out, g, w in zip(OUTPUTS, got, want, strict=True):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, out
        assert g.numpy().tobytes() == w.tobytes(), out
    n_keys = len(bounds) - 1
    n_keys *= kw["tiles_x"] * (kw.get("local_tiles_y") or kw["tiles_y"])
    assert np.asarray(want[1]).size == n_keys
    if name.startswith("keys-"):
        assert n_keys == int(name.split("-")[1])
    lo, hi = fc.EDGE_RUN[td.shape[1]]
    valid = td[setup.VALID_ROW] > 0
    assert not valid[lo:hi].any() and valid[:lo].any() and valid[hi:].any()
    assert int(np.asarray(want[2]).sum()) > 0


# -- the block-boundary case ("blocks": tests/torch_frontend_cases.py) --------

BLOCK_JAX_VARIANTS = ("base", "band", "rows-truncated", "pairs-truncated")


@functools.lru_cache(maxsize=None)
def _block_variants() -> dict:
    items = binning.EXPAND_ITEMS
    return {v["name"]: v for v in fc.block_variants(items["F2 rows"], items["F3 pairs"])}


@functools.lru_cache(maxsize=None)
def _jax_block_setup() -> np.ndarray:
    inp = fc.block_inputs()
    args, kw = _setup_args(inp, False)
    return np.asarray(jsetup.triangle_setup(jnp.asarray(inp["clip"]),
                                            jnp.asarray(inp["tri_v"]), *args, **kw))


@pytest.mark.parametrize("variant", BLOCK_JAX_VARIANTS)
def test_binning_plain_matches_jax_on_block_edges(variant):
    """The plain binning against the JAX package on the "blocks" case
    (several thousand rows and pairs, a long run of triangles without
    rows, rows and pairs cut by the capacities inside a tall triangle's
    rows and a wide row's pairs): every output equal, and the row and pair
    demands those of the case's construction (fc.block_demands), on which
    the card tests' placement of block edges rests."""
    v = _block_variants()[variant]
    td = _jax_block_setup()
    want = jbin.bin_triangle_classes(jnp.asarray(td), v["bounds"], **v["kw"])
    got = binning.bin_triangle_classes_plain(torch.from_numpy(td.copy()), v["bounds"], **v["kw"])
    for name, g, w in zip(OUTPUTS, got, want, strict=True):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        assert g.numpy().tobytes() == w.tobytes(), name
    d = fc.block_demands(fc.block_layout(), v["bounds"], v["kw"])
    assert (int(want[6]), int(want[5])) == (d["row_demand"], d["pair_demand"])
    assert (int(want[4]) > 0) == (variant == "rows-truncated")
    assert (int(np.asarray(want[3]).sum()) > 0) == (variant == "pairs-truncated")


def test_block_case_meets_every_block_edge():
    """What the "blocks" case and its variants put where, in the items of
    F2 rows' and F3's blocks (binning.EXPAND_ITEMS): a run of triangles
    without rows longer than a block; at least three blocks of live rows
    and of live pairs; a tall triangle's rows and a wide row's pairs across
    a block's edge; each variant's edge at its residue; the truncations in
    the middle half of a block past three blocks."""
    items_r, items_p = binning.EXPAND_ITEMS["F2 rows"], binning.EXPAND_ITEMS["F3 pairs"]
    layout = fc.block_layout()
    kinds = "".join(kind for kind, _x, _y in layout)
    assert kinds.startswith("Z" * fc.BLOCK_PREFIX) and fc.BLOCK_PREFIX > items_r
    v = _block_variants()
    assert tuple(v) == fc.BLOCK_VARIANTS
    d = fc.block_demands(layout, v["base"]["bounds"], v["base"]["kw"])
    assert d["live_rows"] >= 3 * items_r and d["live_pairs"] >= 3 * items_p
    assert d["live_rows"] < fc.BLOCK_CAPACITY and d["live_pairs"] < fc.BLOCK_CAPACITY
    # a slot's block: its merge position // items; a source whose slots
    # lie in two blocks straddles an edge
    tall = np.array([layout[t][0] == "T" for t in d["row_tri"]])
    row_block = d["row_pos"] // items_r
    assert any(len(set(row_block[d["row_tri"] == t])) > 1
               for t in np.unique(d["row_tri"][tall]))
    wide = np.array([layout[d["row_tri"][r]][0] == "W" for r in d["pair_row"]])
    pair_block = d["pair_pos"] // items_p
    assert any(len(set(pair_block[d["pair_row"] == r])) > 1
               for r in np.unique(d["pair_row"][wide]))
    n = len(layout)
    for name, var in v.items():
        e = fc.block_demands(layout, var["bounds"], var["kw"], var["front"])
        rc, pc = var["kw"]["row_capacity"], var["kw"]["pair_capacity"]
        tc = n + var["front"] + var["back"]
        where = {"rows-dead-start": (tc + e["live_rows"], items_r),
                 "rows-live-end": (int(e["row_pos"][-1]) + 1, items_r),
                 "pairs-live-end": (e["live_rows"] + e["live_pairs"], items_p),
                 "pairs-dead-start": (rc + e["live_pairs"], items_p)}
        what, _, delta = name.partition(" ")
        if what in where:
            pos, items = where[what]
            assert (pos - int(delta)) % items == 0, name
            assert pos > 3 * items and e["live_rows"] < rc and e["live_pairs"] < pc, name
        if what == "pairs-dead-start":
            assert rc - e["live_rows"] >= items_p, name
        if what == "rows-truncated":
            assert e["row_demand"] > rc == e["live_rows"] > 3 * items_r
            t = int(e["row_tri"][-1])
            assert layout[t][0] == "T" and 0 < e["row_demand"] - rc
            assert (e["row_tri"] == t).sum() == 3
            assert items_r // 4 <= int(e["row_pos"][-1]) % items_r < 3 * items_r // 4
        if what == "pairs-truncated":
            assert e["pair_demand"] > pc == e["live_pairs"] > 3 * items_p
            r = int(e["pair_row"][-1])
            assert layout[e["row_tri"][r]][0] == "W" and (e["pair_row"] == r).sum() == 2
            assert items_p // 4 <= int(e["pair_pos"][-1]) % items_p < 3 * items_p // 4


def test_expand_items_mirror_the_kernels():
    """binning.EXPAND_ITEMS is csrc/frontend.cu's ROWS_ITEMS and
    PAIRS_ITEMS, which the block-edge variants are placed by."""
    import re
    from pathlib import Path

    src = (Path(binning.__file__).parents[1] / "csrc" / "frontend.cu").read_text()
    got = {name: int(re.search(rf"constexpr int {const} = (\d+);", src).group(1))
           for name, const in (("F2 rows", "ROWS_ITEMS"), ("F3 pairs", "PAIRS_ITEMS"))}
    assert got == binning.EXPAND_ITEMS


@pytest.mark.parametrize("tc,local_tiles_y,row_capacity,tiles_x", [
    (2**27, 16, 64, 2),          # rows: 2^27 × 16 = 2^31
    (8, 2, 2**28, 8),            # pairs: 2^28 × 8 = 2^31
])
def test_binning_wrapper_refuses_demands_that_could_wrap(tc, local_tiles_y, row_capacity,
                                                        tiles_x):
    """F2 rows and F3 merge int32 cumsums that must not wrap: the wrapper
    refuses sizes whose row demand (triangles × tile rows) or pair demand
    (row capacity × tile columns) could reach 2^31, and takes one less."""
    kw = dict(tiles_x=tiles_x, tiles_y=local_tiles_y, tile_w=128, tile_h=32,
              pair_capacity=64, row_capacity=row_capacity, local_tiles_y=local_tiles_y)
    with pytest.raises(ValueError, match="could pass 2"):
        binning.bin_triangle_classes(_meta((24, tc)), (0, 4), **kw)
    if tc > 8:
        tc -= 1
    else:
        kw["row_capacity"] -= 1
    with pytest.raises(ValueError, match="unsupported device meta"):
        binning.bin_triangle_classes(_meta((24, tc)), (0, 4), **kw)


# -- F1's and F4 scatter's edges (fc.setup_edges, fc.SCATTER_CASES) ----------

def _kernel_constants(*names: str) -> dict:
    import re
    from pathlib import Path

    src = (Path(binning.__file__).parents[1] / "csrc" / "frontend.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in names}


def test_setup_and_scatter_tiles_mirror_the_kernels():
    """setup.TILE and fc.SETUP_TILE are csrc/frontend.cu's SETUP_THREADS
    (F1's triangles a block); binning.SCATTER_COLS its SCATTER_THREADS ×
    SCATTER_PER_NARROW and × SCATTER_PER_WIDE (F4 scatter's columns a
    block on its two paths), binning.SCATTER_WIDE_MIN its SCATTER_WIDE_MIN
    (where the wide path starts) and binning.SCATTER_PROBES its
    SCATTER_PROBES, which the edge cases are placed by."""
    const = _kernel_constants("SETUP_THREADS", "SCATTER_THREADS", "SCATTER_PER_NARROW",
                              "SCATTER_PER_WIDE", "SCATTER_WIDE_MIN", "SCATTER_PROBES", "ALIGN")
    assert const["SETUP_THREADS"] == setup.TILE == fc.SETUP_TILE
    assert binning.SCATTER_COLS == {
        path: const["SCATTER_THREADS"] * const[f"SCATTER_PER_{path.upper()}"]
        for path in ("narrow", "wide")}
    assert const["SCATTER_WIDE_MIN"] == binning.SCATTER_WIDE_MIN
    assert const["SCATTER_PROBES"] == binning.SCATTER_PROBES
    assert const["ALIGN"] == binning.ALIGN


@functools.lru_cache(maxsize=None)
def _scatter_outputs(name: str) -> tuple:
    inp = fc.scatter_inputs()
    args, kw = _setup_args(inp, False)
    td = np.asarray(jsetup.triangle_setup(jnp.asarray(inp["clip"]),
                                          jnp.asarray(inp["tri_v"]), *args, **kw))
    bounds, bkw = fc.scatter_bins(name)
    want = [np.asarray(w) for w in jbin.bin_triangle_classes(jnp.asarray(td), bounds, **bkw)]
    got = binning.bin_triangle_classes_plain(torch.from_numpy(td.copy()), bounds, **bkw)
    return want, got


def test_edge_cases_straddle_f1_and_f4_scatter():
    """F1's cases put triangle counts one short of, at and one past a block
    (setup.TILE) and R blocks (R: the blocks resident at once; the CPU's
    stand-in fc.NOMINAL_RESIDENT), past a warp and past two rounds of R
    blocks, and cut num_tris inside a block. The "scatter" cases (the plain binning's
    starts and counts) have, for F4 scatter's tiles of columns on either
    path (binning.SCATTER_COLS), a group longer than a tile, a group whose
    live columns end at a tile's edge, and more than 256 empty groups
    starting inside a tile that has live columns on both sides of them;
    binned rows of a length that is not a multiple of 4, the pairs cut
    inside a group, no live pair at all, and binned columns one short of
    and at the wide path's binning.SCATTER_WIDE_MIN; and the key counts of fc.EDGE_CASES lie on both sides of F4
    scatter's 16 × SCATTER_PROBES, past which its search narrows in
    rounds."""
    tile = setup.TILE
    for resident in (fc.NOMINAL_RESIDENT, 300, 1000):
        edges = fc.setup_edges(resident)
        counts = {n for n, _num in edges.values()}
        r = resident * tile
        assert {1, 33, tile - 1, tile, tile + 1, r - 1, r, r + 1} <= counts
        assert max(counts) > 2 * r
        assert any(num < n and num // tile == (n - 1) // tile for n, num in edges.values())
    live = {}
    for name in fc.SCATTER_CASES:
        want, got = _scatter_outputs(name)
        starts, counts = want[1].ravel(), want[2].ravel()
        live[name] = (starts, counts, want[0].shape[1], int(want[5]))
    starts, counts, p_total, _ = live["scatter"]
    assert p_total % 4 == 0
    nonempty = np.flatnonzero(counts)
    gaps = [(a, b) for a, b in zip(nonempty, nonempty[1:]) if b - a > 256]
    for cols in binning.SCATTER_COLS.values():
        assert (counts > cols).any()
        assert ((starts + counts) % cols == 0)[counts > 0].any()
        assert any(starts[a + 1] % cols and starts[a] // cols == starts[b] // cols
                   == starts[a + 1] // cols for a, b in gaps), gaps
    assert live["scatter-odd"][2] % 4 and live["scatter-cut"][2] % 4
    assert fc.SCATTER_WIDE_MIN == binning.SCATTER_WIDE_MIN
    assert live["scatter-narrow-edge"][2] == binning.SCATTER_WIDE_MIN - 1
    assert live["scatter-wide-edge"][2] == binning.SCATTER_WIDE_MIN
    starts, counts, _, demand = live["scatter-cut"]
    cap = fc.SCATTER_CASES["scatter-cut"][0]
    assert demand > cap == counts.sum() and counts[1] < 1500
    assert live["scatter-none"][1].sum() == 0 and live["scatter-none"][3] == 0
    keys = {int(name.split("-")[1]) for name in fc.EDGE_CASES if name.startswith("keys-")}
    assert min(keys) <= 16 * binning.SCATTER_PROBES < max(keys)


@pytest.mark.parametrize("name", fc.SCATTER_CASES)
def test_binning_plain_matches_jax_on_scatter_edges(name):
    """The plain binning against the JAX package on the "scatter" cases
    (tests/torch_frontend_cases.py): every output equal."""
    want, got = _scatter_outputs(name)
    for out, g, w in zip(OUTPUTS, got, want, strict=True):
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, out
        assert g.numpy().tobytes() == w.tobytes(), out


@functools.lru_cache(maxsize=None)
def _longest_setup_edge() -> dict:
    return fc.setup_edge_inputs(max(n for n, _ in fc.setup_edges(fc.NOMINAL_RESIDENT).values()), 0)


@pytest.mark.parametrize("name", fc.setup_edges(fc.NOMINAL_RESIDENT))
def test_setup_plain_matches_jax_on_f1_edges(name):
    """The plain setup against the JAX package on F1's cases (triangle
    counts at its blocks' and R blocks' edges, R the CPU's stand-in
    fc.NOMINAL_RESIDENT, num_tris cutting inside a block): ≤ 4 ULP, as the
    setup parity test above; the triangles from num_tris on are zero. A
    case's triangles are the first n of the longest case's
    (fc.setup_edge_inputs), and setup works a triangle at a time, so the
    JAX package's setup of the longest case's triangles, with the case's
    num_tris, is its reference for the first n (one shape to compile)."""
    n, num = fc.setup_edges(fc.NOMINAL_RESIDENT)[name]
    inp = fc.setup_edge_inputs(n, num)
    longest = _longest_setup_edge()
    assert np.array_equal(inp["clip"], longest["clip"][:3 * n])
    args, kw = _setup_args(inp, False)
    got = setup.triangle_setup_plain(torch.from_numpy(inp["clip"]),
                                     torch.from_numpy(inp["tri_v"]), *args, **kw).numpy()
    want = np.asarray(jsetup.triangle_setup(jnp.asarray(longest["clip"]),
                                            jnp.asarray(longest["tri_v"]), *args, **kw))[:, :n]
    _assert_setup_close(got, want, 4)
    valid = want[setup.VALID_ROW] > 0
    assert not want[:, num:].any() and (valid.any() or n == 1)
