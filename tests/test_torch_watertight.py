"""The port's twin of tests/test_watertight.py: its CPU path held to the same
oracles and invariants.

Watertightness property test: two triangles sharing an edge (with
DUPLICATED vertices, so each triangle computes the shared edge from its own
vertex order — the hard case for cracks) must tile the quad with no holes
at ANY orientation. This is the Vulkan fill-rule guarantee the raster
kernels reimplement via the ±eps boundary band + top-left ownership
(raster_kernel.py; reference relies on the hardware rasterizer,
pipelines.rs fixed state)."""

import numpy as np
import pytest

from tests.torch_parity import cpu_renderer  # (and one torch thread a worker)
import renderer_tpu_torch as rt
from renderer_tpu_torch.core import math3d

W, H = 96, 64


@pytest.fixture(scope="module")
def renderer_and_assets():
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    # unit quad split along the diagonal, 6 independent vertices
    corners = {
        "a": (-0.5, -0.5), "b": (0.5, -0.5), "c": (0.5, 0.5), "d": (-0.5, 0.5)
    }

    def vert(k):
        x, y = corners[k]
        return (x, y, 0.0)

    # winding matches apps/triangle.py's front-facing sense (clockwise in
    # math axes); shared diagonal a-c appears in both with opposite order
    tri_keys = [("a", "c", "b"), ("a", "d", "c")]
    pos = np.array([vert(k) for tri in tri_keys for k in tri], np.float32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (6, 1))
    t = np.tile(np.array([[1, 0, 0, 1]], np.float32), (6, 1))
    uv = np.zeros((6, 2), np.float32)
    mesh = builder.add_mesh(pos, uv, n, t, np.arange(6, dtype=np.uint32))
    builder.build()
    material = registry.create_material(
        "flat", rt.PbrMaterialParameters(base_color_factor=(0, 1, 0, 1))
    )
    renderer = cpu_renderer(registry, rt.RenderConfig(width=W, height=H))
    return renderer, mesh, material


def _hole_pixels(covered):
    """Background pixels whose full 8-neighborhood is covered (cracks)."""
    interior_bg = ~covered.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                interior_bg &= np.roll(np.roll(covered, dy, 0), dx, 1)
    interior_bg[0, :] = interior_bg[-1, :] = False
    interior_bg[:, 0] = interior_bg[:, -1] = False
    return np.argwhere(interior_bg)


def test_edge_through_pixel_centers_never_cracks():
    """Adversarial exact-tie case: a 4-triangle diamond fan whose spokes run
    EXACTLY along pixel-center rows/columns (half-pixel aligned center).
    Every pixel on a spoke evaluates a shared edge to exactly 0 for two
    triangles at once — the ±eps band + top-left ownership must assign each
    exactly once (dropping the band leaves a 1-px crack down each spoke)."""
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    # center at clip (1/W, 1/H) = half a pixel off the image center → lands
    # exactly ON a pixel center
    cx, cy = 1.0 / W, 1.0 / H
    m = (cx, cy)
    a, b, c, d = (cx - 0.5, cy), (cx, cy - 0.5), (cx + 0.5, cy), (cx, cy + 0.5)
    fan = [(m, b, a), (m, c, b), (m, d, c), (m, a, d)]  # demo winding sense
    pos = np.array([(x, y, 0.8) for tri in fan for (x, y) in tri], np.float32)
    k = pos.shape[0]
    n = np.tile(np.array([[0, 0, 1]], np.float32), (k, 1))
    t = np.tile(np.array([[1, 0, 0, 1]], np.float32), (k, 1))
    uv = np.zeros((k, 2), np.float32)
    mesh = builder.add_mesh(pos, uv, n, t, np.arange(k, dtype=np.uint32))
    builder.build()
    material = registry.create_material(
        "flat", rt.PbrMaterialParameters(base_color_factor=(0, 1, 0, 1))
    )
    renderer = cpu_renderer(registry, rt.RenderConfig(width=W, height=H))
    scene = rt.Scene()
    scene.queue_mesh(mesh, material, None, math3d.IDENTITY)
    img = renderer.render_frame(scene, debug_mode=1)
    covered = img.sum(axis=-1) > 0
    assert covered.sum() > 400
    holes = _hole_pixels(covered)
    assert holes.size == 0, f"cracks along fan spokes at {holes[:8]}"


def test_fill_rule_exact_tie_unit():
    """Surgical kernel-level fill-rule test: two hand-built triangles whose
    shared edge planes are EXACT f32 negations (the property triangle_setup
    guarantees for shared mesh edges) with e == 0.0 exactly along pixel row
    32. The ±eps band + top-left ownership must give that row to exactly
    one triangle; dropping the band (e > eps only) leaves the row uncovered
    — the crack class the random black-box test can't reliably hit (the
    band is ~1e-4 px wide)."""
    import torch

    from renderer_tpu_torch.raster import binning, raster_kernel
    from renderer_tpu_torch.raster.setup import EPS_ROW, ROWS, VALID_ROW

    w, h = 128, 64
    tc = 8  # padded triangle capacity
    td = np.zeros((ROWS, tc), np.float32)

    eps = np.float32(1e-4)

    def tri(col, e0, e1, e2, z_c):
        # pre-fold the ±eps band into C per edge ownership, exactly as
        # triangle_setup stores its planes (setup.py module docstring)
        for r, (a, b, c) in zip((0, 3, 6), (e0, e1, e2)):
            own = (a > 0.0) or (a == 0.0 and b > 0.0)
            td[r : r + 3, col] = (a, b,
                                  np.float32(c) + (eps if own else -eps))
        td[9:12, col] = (0.0, 0.0, z_c)   # constant depth plane
        td[12:15, col] = (0.0, 0.0, 1.0)  # 1/w > 0 everywhere
        td[15:19, col] = (0.0, 0.0, w, h)  # bbox = full screen
        td[VALID_ROW, col] = 1.0
        td[EPS_ROW, col] = eps

    wide_open = [(1.0, 0.0, 1000.0), (-1.0, 0.0, 1000.0)]
    # tri 0 covers py >= 32.5 via edge (a=0, b=1, c=-32.5): a==0, b>0 → it
    # OWNS the e==0 boundary. tri 1's shared edge is the exact negation
    # (a=0, b=-1, c=+32.5): ownership False at the boundary.
    tri(0, (0.0, 1.0, -32.5), *wide_open, z_c=0.5)
    tri(1, (0.0, -1.0, 32.5), *wide_open, z_c=0.5)

    cfg = dict(tiles_x=1, tiles_y=2, tile_w=128, tile_h=32)
    binned, starts, counts, _ = binning.bin_triangles(
        torch.as_tensor(td), 0, 2, pair_capacity=1 << 10, **cfg
    )
    depth, tid = raster_kernel.rasterize_binned(
        binned, starts, counts, padded_height=h, padded_width=w,
        tile_h=32, tile_w=128,
    )
    tid = np.asarray(tid[0])
    # pixel centers at py = row + 0.5; the shared edge sits at py = 32.5
    assert (tid[33:] == 0).all(), "tri 0 must own py > 32.5"
    assert (tid[:32] == 1).all(), "tri 1 must own py < 32.5"
    # the exact-tie row: covered by EXACTLY the owning triangle, no crack
    assert (tid[32] == 0).all(), (
        f"boundary row must go to the owning triangle, got {np.unique(tid[32])}"
    )


def test_shared_edge_never_cracks(renderer_and_assets):
    renderer, mesh, material = renderer_and_assets
    rng = np.random.default_rng(42)
    for trial in range(8):
        angle = float(rng.uniform(0, np.pi))
        axis = rng.normal(size=3)
        axis[2] = abs(axis[2]) + 1.0  # keep mostly screen-facing
        q = math3d.quat_from_axis_angle(axis / np.linalg.norm(axis),
                                        angle * 0.4)
        offset = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
        offset[2] = 0.8  # demo-scene depth, default camera (apps/triangle.py)
        scene = rt.Scene()
        scene.queue_mesh(
            mesh, material, None,
            math3d.trs(translation=offset, rotation=q),
        )
        img = renderer.render_frame(scene, debug_mode=1)
        covered = img.sum(axis=-1) > 0
        assert covered.sum() > 200, f"trial {trial}: quad off screen"
        # a crack along the shared diagonal = a background pixel whose full
        # 8-neighborhood is covered
        interior_bg = ~covered.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    interior_bg &= np.roll(np.roll(covered, dy, 0), dx, 1)
        # exclude the image border (roll wraps)
        interior_bg[0, :] = interior_bg[-1, :] = False
        interior_bg[:, 0] = interior_bg[:, -1] = False
        holes = np.argwhere(interior_bg)
        assert holes.size == 0, (
            f"trial {trial} (angle {angle:.3f}): crack pixels at {holes[:5]}"
        )


def test_rolled_kernel_matches_unrolled_bitexact():
    """The port's visibility (its plain version on the CPU, which K1 equals
    bit for bit on the card) against the JAX kernel's production driver —
    the sub-chunk walk unrolled as on the TPU, in interpret mode — on random
    plane soup at 4 MSAA sample positions (the JAX test holds its rolled
    interpret-mode driver to the same unrolled one): the winning ids
    exactly, the depths within 1 ULP at their magnitude (< 1), since XLA:CPU
    contracts the plane's a·px + b·py into an FMA inside the kernel and the
    port rounds each product (tests/test_torch_raster.py)."""
    import jax.numpy as jnp
    import torch

    from renderer_tpu.raster import binning as jbinning
    from renderer_tpu.raster import raster_kernel as jraster
    from renderer_tpu_torch.raster import binning, raster_kernel
    from renderer_tpu_torch.raster.setup import EPS_ROW, VALID_ROW
    from tests.test_binning_and_skinning import _fake_tri_data

    rng = np.random.default_rng(31)
    tiles_x, tiles_y, tile_w, tile_h = 2, 2, 128, 32
    n, tc = 300, 512  # > CHUNK so the chunk loop runs more than once
    td = _fake_tri_data(rng, n, tc, tiles_x, tiles_y, tile_w, tile_h)
    # random edge/depth/1w planes scaled so a fair share of pixels get
    # covered and depth-contested
    for r in range(15):
        td[r, :n] = (rng.normal(size=n) * 0.02).astype(np.float32)
    td[2, :n] += 2.0   # edge C offsets: keep many triangles open
    td[5, :n] += 2.0
    td[8, :n] += 2.0
    td[11, :n] = rng.uniform(0.0, 1.0, n)  # depth plane C in range
    td[14, :n] = 1.0   # 1/w positive
    td[EPS_ROW, :n] = 1e-5
    td[VALID_ROW, :n] = 1.0

    grid = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                pair_capacity=4096)
    binned, starts, counts, ov = binning.bin_triangles(torch.as_tensor(td), 0, n, **grid)
    jb, js, jc, jov = jbinning.bin_triangles(jnp.asarray(td), 0, n, **grid)
    assert int(ov) == int(jov) == 0
    spos = ((0.25, 0.25), (0.75, 0.25), (0.25, 0.75), (0.75, 0.75))
    kw = dict(padded_height=tiles_y * tile_h, padded_width=tiles_x * tile_w,
              tile_h=tile_h, tile_w=tile_w, sample_positions=spos)
    z_port, t_port = raster_kernel.rasterize_binned(binned, starts, counts, **kw)
    z_unroll, t_unroll = jraster.rasterize_binned(jb, js, jc, unroll=True, interpret=True,
                                                  **kw)
    assert (t_port.numpy() >= 0).sum() > 500, "scene degenerate"
    np.testing.assert_array_equal(t_port.numpy(), np.asarray(t_unroll))
    np.testing.assert_allclose(z_port.numpy(), np.asarray(z_unroll), rtol=0, atol=2.0**-23)


def test_huge_extent_shared_edge_stays_watertight(renderer_and_assets):
    """ROADMAP guard-band concern, quantified: vertices projecting far
    off-screen grow the edge-plane coefficients ~quadratically, and the
    folded eps band grows with them (setup.py eps = 4ulp·(|C| + dim·|AB|)).
    The band's width in PIXELS stays ~1.2e-7·extent, so watertightness
    holds to ~10^6-px extents without any guard-band clip. Pin the working
    range: a shared-edge quad scaled so its vertices land 10^4-10^6 px
    off-screen must still tile every visible pixel (the shared diagonal
    crosses the whole viewport)."""
    renderer, mesh, material = renderer_and_assets
    for scale in (100.0, 1e4, 1e5):
        scene = rt.Scene()
        scene.queue_mesh(
            mesh, material, None,
            math3d.trs(translation=np.array([0, 0, 0.8], np.float32),
                       scale=np.array([scale, scale, 1.0], np.float32)),
        )
        img = renderer.render_frame(scene, debug_mode=1)
        covered = img.sum(axis=-1) > 0
        bg = np.argwhere(~covered)
        assert bg.size == 0, (
            f"scale {scale:g}: {len(bg)} uncovered pixels (first {bg[:5]}) — "
            "the eps band broke down at this extent"
        )
