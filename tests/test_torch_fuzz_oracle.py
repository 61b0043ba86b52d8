"""The port's twin of tests/test_fuzz_oracle.py: its CPU path held to the same
oracles and invariants.

Randomized triangle-soup fuzz vs the independent numpy oracle: N random
single-triangle meshes (random screen positions, depths, windings) rendered
in draw-id debug mode must match the oracle's per-pixel WINNER — coverage,
back-face culling, reverse-Z GREATER_OR_EQUAL depth resolution, and
later-draw-wins ties, all at once (the reference gets these from fixed
hardware state, pipelines.rs:112-158; here every piece is reimplemented, so
the black-box product of all of them is fuzzed against per-pixel barycentric
loops that share no code with the kernels). The MSAA4 case additionally
fuzzes per-sample coverage at the standard positions, the shade-once
candidate dedup, and the tonemap-then-AVERAGE resolve."""

import numpy as np
import pytest

from tests.torch_parity import cpu_renderer  # (and one torch thread a worker)
import renderer_tpu_torch as rt
from renderer_tpu_torch.core import math3d
from tests import np_reference

W, H = 128, 96
N_TRIS = 24


@pytest.fixture(scope="module")
def soup():
    """Random soup + everything the oracle needs: f16-quantized clip
    triangles in the renderer's sorted dispatch order."""
    rng = np.random.default_rng(11)
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    tris_f64 = []
    meshes = []
    for i in range(N_TRIS):
        p = np.empty((3, 3), np.float32)
        p[:, 0] = rng.uniform(-0.7, 0.7, 3)
        p[:, 1] = rng.uniform(-0.7, 0.7, 3)
        p[:, 2] = rng.uniform(0.4, 2.0, 3)  # in front of the demo camera
        uv = np.zeros((3, 2), np.float32)
        nrm = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
        tan = np.tile(np.array([[1, 0, 0, 1]], np.float32), (3, 1))
        meshes.append(builder.add_mesh(p, uv, nrm, tan,
                                       np.arange(3, dtype=np.uint32)))
        # oracle sees the f16-quantized positions the library stores
        tris_f64.append(p.astype(np.float16).astype(np.float64))
    builder.build()
    material = registry.create_material(
        "fuzz", rt.PbrMaterialParameters(base_color_factor=(1, 1, 1, 1))
    )

    def make_scene():
        scene = rt.Scene()
        for m in meshes:
            assert scene.queue_mesh(m, material, None, math3d.IDENTITY)
        return scene

    scene = make_scene()
    # oracle order = the renderer's sorted dispatch order (distinct meshes →
    # no instance merge → debug_id = sorted draw index)
    order = sorted(range(N_TRIS), key=lambda i: scene.draws[i].sort_key())
    proj, view = scene.camera.proj_view(W, H, scene.world_space)
    pv = proj @ view
    clip = np.stack([
        (pv @ np.vstack([tris_f64[i].T, np.ones(3)])).T for i in order
    ])
    return registry, make_scene, clip


def _debug_palette(n: int = N_TRIS) -> np.ndarray:
    """The vertex stage's hashed draw color (shade.draw_debug_colors, f32
    parity), linear — tonemapping is applied per test to match the resolve
    order."""
    import torch

    from renderer_tpu_torch.raster import shade

    return np.asarray(
        shade.draw_debug_colors(torch.arange(n, dtype=torch.int32))
    ).astype(np.float64)


def _aces(x):
    return np.clip((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14),
                   0, 1)


def _srgb_u8(linear):
    enc = np.where(linear <= 0.0031308, linear * 12.92,
                   1.055 * np.maximum(linear, 1e-9) ** (1 / 2.4) - 0.055)
    return np.round(np.clip(enc, 0, 1) * 255).astype(np.uint8)


def test_random_triangle_soup_matches_oracle(soup):
    registry, make_scene, clip = soup
    renderer = cpu_renderer(
        registry, rt.RenderConfig(width=W, height=H, msaa_samples=1)
    )
    img = np.asarray(renderer.render_frame(make_scene(), debug_mode=2))

    tid_ref, _, _ = np_reference.rasterize(clip, W, H)
    palette = _debug_palette()
    covered = tid_ref >= 0
    # single-sample: tonemap whole pixels through the SHARED oracle helper
    lin = np.zeros((H, W, 3))
    lin[covered] = palette[tid_ref[covered]]
    expected = np_reference.aces_srgb_u8(lin)

    # Pixel-exact winner agreement away from triangle boundaries: edge
    # pixels legitimately differ (fill-rule band vs the oracle's >= 0 test),
    # and the hash colors may differ by 1 u8 step (f32 vs f64 sin). Demand
    # 98% of ALL pixels match within 1 step — a wrong depth test, winding,
    # or draw-order bug flips entire triangle interiors, not edge slivers.
    match = (np.abs(img.astype(int) - expected.astype(int)) <= 1).all(axis=-1)
    assert match.mean() > 0.98, f"winner agreement {match.mean():.4f}"
    # sanity: the soup covers a meaningful area with many distinct winners
    # (~half the draws are back-face culled; several more hide behind others)
    assert covered.mean() > 0.2
    assert len(np.unique(tid_ref[covered])) > 5


@pytest.mark.parametrize("msaa", [2, 4, 8])
def test_random_triangle_soup_matches_oracle_msaa(soup, msaa):
    """MSAA 2/4/8: per-sample winner at the Vulkan standard sample locations
    for that count, ACES per sample, AVERAGE resolve, then sRGB encode
    (post.tonemap order). The reference library is parameterized over any
    supported attachment_sample_count (pipelines.rs:20-27).
    msaa_shade_candidates=msaa makes the shade-once dedup exact for every
    pixel, so only the fill-rule boundary band may disagree."""
    from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS

    registry, make_scene, clip = soup
    renderer = cpu_renderer(
        registry,
        rt.RenderConfig(width=W, height=H, msaa_samples=msaa,
                        msaa_shade_candidates=msaa),
    )
    img = np.asarray(renderer.render_frame(make_scene(), debug_mode=2))

    palette = _debug_palette()
    mapped_sum = np.zeros((H, W, 3))
    for off in STANDARD_SAMPLE_POSITIONS[msaa]:
        tid_s, _, _ = np_reference.rasterize(clip, W, H, sample_offset=off)
        m = np.zeros((H, W, 3))
        cov = tid_s >= 0
        m[cov] = _aces(palette[tid_s[cov]] * 0.8)
        mapped_sum += m
    expected = _srgb_u8(mapped_sum / msaa)

    # sRGB-encoding a multi-sample average amplifies small per-sample
    # differences near black — allow 2 u8 steps.
    match = (np.abs(img.astype(int) - expected.astype(int)) <= 2).all(axis=-1)
    assert match.mean() > 0.98, (
        f"msaa{msaa} resolve agreement {match.mean():.4f}"
    )


def test_random_blended_stack_matches_compositing_oracle():
    """Randomized blended compositing: N translucent quads at random depths,
    alphas, sizes and offsets over an opaque backdrop must match an exact
    per-pixel src-alpha compositing oracle applied in the renderer\'s sorted
    draw order (the reference blends in submission order with depth test
    GREATER_OR_EQUAL and depth WRITE inherited from the opaque pipeline —
    an accepted translucent fragment occludes later-drawn farther ones,
    pipeline_parameters.rs + renderer.rs:433-441). Pixels within 1 px of
    any quad edge are excluded
    (fill-rule boundary band); everything else must match exactly.
    overflow_policy=\'sync\' re-renders at grown blend_layers if the random
    stack exceeds the configured depth, so truncation can\'t skew the test."""
    from tests.test_torch_alpha_modes import quad

    rng = np.random.default_rng(5)
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    n_blend = 8
    halves = rng.uniform(0.12, 0.35, n_blend)
    zs = rng.uniform(0.8, 1.9, n_blend)
    back = quad(builder, 2.2, half=4.0)
    meshes = [
        quad(builder, float(zs[i]), half=float(halves[i]))
        for i in range(n_blend)
    ]
    builder.build()

    backdrop = registry.create_material(
        "bg", rt.PbrMaterialParameters(base_color_factor=(0.9, 0.1, 0.1, 1))
    )
    rgba = np.column_stack([
        rng.uniform(0.05, 0.95, (n_blend, 3)), rng.uniform(0.2, 0.9, n_blend)
    ]).astype(np.float32)
    mats = [
        registry.create_material(
            f"b{i}",
            rt.PbrMaterialParameters(base_color_factor=tuple(rgba[i]),
                                     alpha_mode=rt.AlphaMode.BLENDED),
        )
        for i in range(n_blend)
    ]
    offsets = rng.uniform(-0.4, 0.4, (n_blend, 2)).astype(np.float32)

    scene = rt.Scene()
    assert scene.queue_mesh(back, backdrop, None, math3d.IDENTITY)
    for i in range(n_blend):
        t = math3d.trs(translation=np.array([*offsets[i], 0.0], np.float32))
        assert scene.queue_mesh(meshes[i], mats[i], None, t)
    renderer = cpu_renderer(
        registry, rt.RenderConfig(width=W, height=H, msaa_samples=1),
        overflow_policy="sync",
    )
    img = np.asarray(renderer.render_frame(scene, debug_mode=1))

    # oracle: project each quad\'s rect (translation-only transforms keep it
    # axis-aligned; quad() f16-quantizes the stored positions), composite in
    # the renderer\'s sorted draw order
    proj, view = scene.camera.proj_view(W, H, scene.world_space)
    pv = (proj @ view).astype(np.float64)
    yy, xx = np.mgrid[0:H, 0:W]
    cx, cy = xx + 0.5, yy + 0.5
    color = np.zeros((H, W, 3))
    color[:] = (0.9, 0.1, 0.1)
    zbuf = np.zeros((H, W))  # reverse-Z running depth (backdrop ~ far)
    boundary = np.zeros((H, W), bool)
    order = sorted(range(1, n_blend + 1),
                   key=lambda k: scene.draws[k].sort_key())
    for k in order:
        i = k - 1
        h = np.float64(np.float16(np.float32(halves[i])))
        z = np.float64(np.float16(np.float32(zs[i])))
        ox, oy = np.float64(offsets[i][0]), np.float64(offsets[i][1])
        corners = np.array([
            [-h + ox, -h + oy, z, 1.0], [h + ox, h + oy, z, 1.0]
        ])
        clip = corners @ pv.T
        sx = (clip[:, 0] / clip[:, 3] * 0.5 + 0.5) * W
        sy = (clip[:, 1] / clip[:, 3] * 0.5 + 0.5) * H
        x0, x1 = sorted(sx)
        y0, y1 = sorted(sy)
        inside = (cx > x0) & (cx < x1) & (cy > y0) & (cy < y1)
        near_edge = (
            ((np.abs(cx - x0) < 1.0) | (np.abs(cx - x1) < 1.0)) &
            (cy > y0 - 1.0) & (cy < y1 + 1.0)
        ) | (
            ((np.abs(cy - y0) < 1.0) | (np.abs(cy - y1) < 1.0)) &
            (cx > x0 - 1.0) & (cx < x1 + 1.0)
        )
        boundary |= near_edge
        # reverse-Z GE test vs the running depth; accepted fragments WRITE
        # depth (later-drawn farther translucents get rejected)
        zq = clip[0, 2] / clip[0, 3]
        accept = inside & (zq >= zbuf)
        zbuf[accept] = zq
        a = np.float64(rgba[i, 3])
        color[accept] = (
            color[accept] * (1 - a) + rgba[i, :3].astype(np.float64) * a
        )

    expected = np_reference.aces_srgb_u8(color)
    ok = (np.abs(img.astype(int) - expected.astype(int)) <= 1).all(axis=-1)
    interior = ~boundary
    assert interior.mean() > 0.5
    frac = ok[interior].mean()
    assert frac > 0.999, f"blended compositing agreement {frac:.5f}"


def test_random_masked_stack_matches_a2c_oracle():
    """Randomized alpha-to-coverage: masked quads with random flat alphas
    spanning every MSAA4 coverage regime (fail-cutoff, 1..4 samples covered:
    sample s passes iff alpha > (s+0.5)/4 AND alpha > cutoff) at random
    depths must match a per-sample oracle — nearest passing fragment wins
    per sample (reverse-Z GE), failing fragments never occlude, resolve is
    ACES-per-sample then AVERAGE (main.frag:59-62 cutoff discard + the a2c
    pipeline state, pipeline_parameters.rs:227-233)."""
    from renderer_tpu_torch.raster.pipeline import MSAA4_POSITIONS
    from tests.test_torch_alpha_modes import quad

    rng = np.random.default_rng(17)
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    n_mask = 10
    halves = rng.uniform(0.12, 0.4, n_mask)
    zs = rng.uniform(0.8, 1.9, n_mask)
    back = quad(builder, 2.2, half=4.0)
    meshes = [quad(builder, float(zs[i]), half=float(halves[i]))
              for i in range(n_mask)]
    builder.build()

    cutoff = 0.3
    backdrop = registry.create_material(
        "bg", rt.PbrMaterialParameters(base_color_factor=(0.2, 0.2, 0.9, 1))
    )
    alphas = rng.uniform(0.15, 1.0, n_mask)
    mats = [
        registry.create_material(
            f"m{i}",
            rt.PbrMaterialParameters(
                base_color_factor=(1, 1, 1, float(alphas[i])),
                alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE,
                alpha_cutoff=cutoff,
            ),
        )
        for i in range(n_mask)
    ]
    offsets = rng.uniform(-0.4, 0.4, (n_mask, 2)).astype(np.float32)

    scene = rt.Scene()
    assert scene.queue_mesh(back, backdrop, None, math3d.IDENTITY)
    for i in range(n_mask):
        t = math3d.trs(translation=np.array([*offsets[i], 0.0], np.float32))
        assert scene.queue_mesh(meshes[i], mats[i], None, t)
    renderer = cpu_renderer(
        registry,
        rt.RenderConfig(width=W, height=H, msaa_samples=4,
                        msaa_shade_candidates=4),
        overflow_policy="sync",
    )
    img = np.asarray(renderer.render_frame(scene, debug_mode=2))

    # sanity: the random alphas exercise ≥3 distinct coverage regimes
    floors = np.array([0.125, 0.375, 0.625, 0.875])
    regimes = {int((alphas[i] > np.maximum(floors, cutoff)).sum())
               for i in range(n_mask)}
    assert len(regimes) >= 3, regimes

    # expected: per-sample nearest passing fragment, debug-hash color,
    # ACES per sample then AVERAGE then sRGB (post.tonemap)
    palette = _debug_palette(n_mask + 1)
    proj, view = scene.camera.proj_view(W, H, scene.world_space)
    pv = (proj @ view).astype(np.float64)
    yy, xx = np.mgrid[0:H, 0:W]
    order = sorted(range(1, n_mask + 1),
                   key=lambda k: scene.draws[k].sort_key())
    mapped_sum = np.zeros((H, W, 3))
    boundary = np.zeros((H, W), bool)
    for s, (offx, offy) in enumerate(MSAA4_POSITIONS):
        sx_p, sy_p = xx + offx, yy + offy
        win = np.zeros((H, W), int)  # backdrop debug id = sorted index 0
        zbuf = np.zeros((H, W))
        a2c_floor = (s + 0.5) / 4.0
        for idx, k in enumerate(order):
            i = k - 1
            if not (alphas[i] > cutoff and alphas[i] > a2c_floor):
                continue
            h = np.float64(np.float16(np.float32(halves[i])))
            z = np.float64(np.float16(np.float32(zs[i])))
            ox, oy = np.float64(offsets[i][0]), np.float64(offsets[i][1])
            corners = np.array([
                [-h + ox, -h + oy, z, 1.0], [h + ox, h + oy, z, 1.0]
            ])
            clip = corners @ pv.T
            rx = np.sort((clip[:, 0] / clip[:, 3] * 0.5 + 0.5) * W)
            ry = np.sort((clip[:, 1] / clip[:, 3] * 0.5 + 0.5) * H)
            inside = ((sx_p > rx[0]) & (sx_p < rx[1]) &
                      (sy_p > ry[0]) & (sy_p < ry[1]))
            boundary |= (
                ((np.abs(sx_p - rx[0]) < 1.5) | (np.abs(sx_p - rx[1]) < 1.5))
                & (sy_p > ry[0] - 1.5) & (sy_p < ry[1] + 1.5)
            ) | (
                ((np.abs(sy_p - ry[0]) < 1.5) | (np.abs(sy_p - ry[1]) < 1.5))
                & (sx_p > rx[0] - 1.5) & (sx_p < rx[1] + 1.5)
            )
            zq = clip[0, 2] / clip[0, 3]
            accept = inside & (zq >= zbuf)
            zbuf[accept] = zq
            win[accept] = 1 + idx  # sorted index of this masked draw
        mapped_sum += _aces(palette[win] * 0.8)
    expected = _srgb_u8(mapped_sum / 4.0)

    ok = (np.abs(img.astype(int) - expected.astype(int)) <= 2).all(axis=-1)
    interior = ~boundary
    assert interior.mean() > 0.3
    frac = ok[interior].mean()
    assert frac > 0.999, f"masked a2c agreement {frac:.5f}"


def test_random_ui_rect_stack_matches_compositing_oracle():
    """Randomized UI overlay: translucent rects with random integer corners,
    colors, alphas, and clip rects composite in submission order (painter's
    algorithm) into the linear HDR buffer before tonemap — matched EXACTLY
    against a numpy oracle (imgui_support.rs:107-169 + imgui.vert/frag;
    clip passes iff clip.x0 < px ≤ clip.x1 at pixel centers,
    imgui.frag:28-33). Integer rect corners mean pixel centers (.5) never
    land on an edge, so every pixel is compared — no exclusion band.
    overflow_policy='sync' lets the UI layer count grow to the random
    stack's true depth (the ui_demand_max feedback)."""
    from renderer_tpu_torch.ui import DrawList
    from tests.test_torch_alpha_modes import quad

    rng = np.random.default_rng(23)
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    bg = quad(builder, 2.0)
    builder.build()
    red = registry.create_material(
        "red", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
    )
    scene = rt.Scene()
    scene.queue_mesh(bg, red, None, math3d.IDENTITY)
    renderer = cpu_renderer(
        registry, rt.RenderConfig(width=W, height=H, msaa_samples=1),
        overflow_policy="sync",
    )
    baseline = np.asarray(renderer.render_frame(scene, debug_mode=1))

    n_rects = 12
    ui = DrawList()
    cmds = []
    for _ in range(n_rects):
        x0, y0 = int(rng.integers(0, W - 8)), int(rng.integers(0, H - 8))
        x1 = int(rng.integers(x0 + 4, min(x0 + 70, W) + 1))
        y1 = int(rng.integers(y0 + 4, min(y0 + 60, H) + 1))
        rgba_u8 = rng.integers(0, 256, 4)
        rgba_u8[3] = rng.integers(30, 230)
        clip = None
        if rng.random() < 0.5:
            cx0, cy0 = int(rng.integers(0, W - 4)), int(rng.integers(0, H - 4))
            clip = (cx0, cy0, int(rng.integers(cx0 + 2, W + 1)),
                    int(rng.integers(cy0 + 2, H + 1)))
            ui.push_clip_rect(*clip)
        ui.add_rect_filled((x0, y0), (x1, y1), tuple(int(v) for v in rgba_u8))
        if clip is not None:
            ui.pop_clip_rect()
        cmds.append(((x0, y0, x1, y1), clip, rgba_u8))
    img = np.asarray(renderer.render_frame(scene, debug_mode=1, ui=ui))
    stats = renderer.frame_stats()
    assert stats["overflow_ui"] == 0 and stats["ui_saturated_px"] == 0

    # base linear color from the baseline render: flat red quad over clear
    # black at msaa1/debug-1 means every baseline pixel is exactly one of
    # the two colors
    red_u8 = np_reference.aces_srgb_u8(np.array([1.0, 0, 0]))
    is_red = (baseline == red_u8).all(axis=-1)
    assert is_red.any() and (~is_red).any()
    assert ((baseline == 0).all(axis=-1) | is_red).all()
    color = np.zeros((H, W, 3))
    color[is_red] = (1.0, 0, 0)

    yy, xx = np.mgrid[0:H, 0:W]
    cx, cy = xx + 0.5, yy + 0.5
    for (x0, y0, x1, y1), clip, rgba_u8 in cmds:
        inside = (cx > x0) & (cx < x1) & (cy > y0) & (cy < y1)
        if clip is not None:
            inside &= ((cx > clip[0]) & (cx <= clip[2]) &
                       (cy > clip[1]) & (cy <= clip[3]))
        a = rgba_u8[3] / 255.0
        rgb = rgba_u8[:3] / 255.0
        color[inside] = color[inside] * (1 - a) + rgb * a
    expected = np_reference.aces_srgb_u8(color)

    diff = np.abs(img.astype(int) - expected.astype(int)).max()
    frac = (np.abs(img.astype(int) - expected.astype(int)) <= 1).all(-1).mean()
    assert frac == 1.0, f"ui compositing agreement {frac:.5f} (maxdiff {diff})"
