"""Card-only checks of the hand-written CUDA kernels: each kernel equals its
plain PyTorch version EXACTLY on the card (ids, counts and the bits of every
depth — the kernels are built without FMA contraction), and the port's
Renderer on the card reproduces the golden images. The shading kernels S1,
S2 and S3 are held to their plain versions within 2^-12 absolute, ≥ 99.9%
of values within 2^-18, NaN where the plain version has NaN, and cutoffs
equal (the differing counts are printed; on the scenes they are 0); the
tests of S1's compaction, S2's alpha-only sampler, S3 and the fused S3
(the UI shade with its composite) hold them bit for bit. The vertex stage
gives a slice of the vertex stream the whole stream's bits (the mesh's
bit-equality with one device rests on it). The candidate kernels C1-C3
(csrc/candidates.cu) equal their plain versions bit for bit, NaN where
NaN, on crafted and 1080p inputs, on frames' calls and from a graph. The
front end's F1-F4 (csrc/frontend.cu) equal triangle_setup_plain and
bin_triangle_classes_plain bit for bit, NaN included, on the crafted cases
of tests/torch_frontend_cases.py (the "blocks" case's edges of F2 rows' and
F3's blocks too), on frames' calls and from a graph, and the plain binning
on the card equals the CPU's.

These need an NVIDIA GPU with nvcc; without one every test skips. This file
imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import contextlib
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import renderer_tpu_torch as trt
from renderer_tpu_torch import kernels
from renderer_tpu_torch.assets import demo_scenes
from renderer_tpu_torch.raster import (
    binning,
    candidates,
    layers,
    pipeline,
    raster_kernel,
    setup,
    shade,
    ui_stage,
)
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS
from renderer_tpu_torch.tools.shade_check import compare, recorded_shading, run_shading
from tests import torch_candidate_cases as cand_cases
from tests import torch_frontend_cases as fe_cases
from tests.torch_bins import (
    CASES,
    UI_CASES,
    H,
    W,
    crafted_bins,
    crafted_floor,
    ui_config,
    ui_drawlist,
)
from tests.torch_parity import build_scene

GOLDEN = Path(__file__).parent / "golden" / "goldens.npz"
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def soup_bins(device, n=4000, h=288, w=512, seed=0):
    """Random clip-space soup (sizes from sub-pixel to half the screen,
    depths across the near plane, some crossing w = 0) → setup → bins."""
    rng = np.random.default_rng(seed)
    clip = np.empty((3 * n, 4), np.float32)
    clip[:, 3] = rng.uniform(0.3, 2.0, 3 * n)
    clip[rng.uniform(size=3 * n) < 0.02, 3] *= -0.5
    centers = np.repeat(rng.uniform(-1.0, 1.0, (n, 2)), 3, axis=0)
    spread = np.repeat(rng.uniform(0.002, 0.5, (n, 1)), 3, axis=0)
    clip[:, :2] = (centers + spread * rng.normal(size=(3 * n, 2))) * clip[:, 3:4]
    clip[:, 2] = rng.uniform(-0.1, 1.1, 3 * n) * clip[:, 3]
    tri_v = torch.arange(3 * n, dtype=torch.int32, device=device).reshape(n, 3)
    td = setup.triangle_setup(torch.from_numpy(clip).to(device), tri_v, n, w, h,
                              bbox_pad=0.5)
    b, s, c, ov, row_ov, _, _ = binning.bin_triangle_classes(
        td, (0, n // 2, 3 * n // 4, n), tiles_x=w // 128, tiles_y=h // 32,
        tile_w=128, tile_h=32, pair_capacity=1 << 18, row_capacity=1 << 18,
        zbuckets=16)
    assert int(ov.sum()) == 0 and int(row_ov) == 0
    return b, s, c, h, w


def pipeline_launches():
    from renderer_tpu_torch.raster import pipeline

    return pipeline.launch_counts()


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("msaa", [1, 4, 8])
def test_k1_kernel_equals_plain(cuda, msaa):
    b, s, c, h, w = soup_bins(cuda)
    kw = dict(padded_height=h, padded_width=w,
              sample_positions=STANDARD_SAMPLE_POSITIONS[msaa])
    before = pipeline.launch_counts()["k1"]
    z, t = raster_kernel.rasterize_binned(b, s[0], c[0], **kw)
    torch.cuda.synchronize()
    assert pipeline.launch_counts()["k1"] == before + 1
    pz, pt = raster_kernel.rasterize_binned_plain(b, s[0], c[0], **kw)
    assert (t >= 0).float().mean() > 0.2
    assert _bits_equal(t, pt) and _bits_equal(z, pz)


@pytest.mark.parametrize("mode", ["masked", "blended"])
@pytest.mark.parametrize("msaa,n_layers", [(1, 1), (1, 4), (4, 2), (4, 3),
                                           (4, 16), (8, 4)])
def test_k2_kernel_equals_plain(cuda, mode, msaa, n_layers):
    b, s, c, h, w = soup_bins(cuda)
    kw = dict(padded_height=h, padded_width=w,
              sample_positions=STANDARD_SAMPLE_POSITIONS[msaa])
    floor, _ = raster_kernel.rasterize_binned(b, s[0], c[0], **kw)
    cls = 1 if mode == "masked" else 2
    before = pipeline.launch_counts()[mode]
    out = layers.rasterize_layers(b, s[cls], c[cls], floor, mode=mode,
                                  n_layers=n_layers, **kw)
    torch.cuda.synchronize()
    assert pipeline.launch_counts()[mode] == before + 1
    ref = layers.rasterize_layers_plain(b, s[cls], c[cls], floor, mode=mode,
                                        n_layers=n_layers, **kw)
    assert int(ref[2].max()) > 1
    for got, want in zip(out, ref):
        assert _bits_equal(got, want)


# The kernels' footprint rejection must be exact: tests/torch_bins.py's
# cases put edges exactly through sample positions and footprint corners,
# edges with a == 0, sub-pixel triangles, 1/w crossing 0 and whole-tile
# triangles in depth order (the depth skip), with both staging paths. K1 at
# every pixels-a-thread choice; K2 at every tests-a-thread choice (layer
# counts 1, 4, 8, 16 × 1, 4, 8 samples).
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("msaa", [1, 4, 8])
def test_k1_exact_on_crafted_cases(cuda, case, msaa):
    b, s, c = crafted_bins(case, cuda)
    kw = dict(padded_height=H, padded_width=W,
              sample_positions=STANDARD_SAMPLE_POSITIONS[msaa])
    z, t = raster_kernel.rasterize_binned(b, s, c, **kw)
    pz, pt = raster_kernel.rasterize_binned_plain(b, s, c, **kw)
    assert int((pt >= 0).sum()) > 0
    assert _bits_equal(t, pt) and _bits_equal(z, pz)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["masked", "blended"])
@pytest.mark.parametrize("n_layers", [1, 4, 8, 16])
@pytest.mark.parametrize("msaa", [1, 4, 8])
def test_k2_exact_on_crafted_cases(cuda, case, mode, n_layers, msaa):
    b, s, c = crafted_bins(case, cuda)
    floor = crafted_floor(msaa, cuda)
    kw = dict(mode=mode, n_layers=n_layers, padded_height=H, padded_width=W,
              sample_positions=STANDARD_SAMPLE_POSITIONS[msaa])
    out = layers.rasterize_layers(b, s, c, floor, **kw)
    ref = layers.rasterize_layers_plain(b, s, c, floor, **kw)
    assert int(ref[2].max()) >= 1
    for got, want in zip(out, ref):
        assert _bits_equal(got, want)


# K2's UI launch (raster/ui_stage.py): blended mode at z = 0.5 over a zero
# floor, on double-sided setup planes. Every accept ties the running depth
# (z >= cur_z at equality), and aux counts each one, so the deep stacks
# check the kernel's depth skip stays strict at equal depth.
@pytest.mark.parametrize("case", UI_CASES)
@pytest.mark.parametrize("n_layers", [1, 4, 8, 16])
@pytest.mark.parametrize("msaa", [1, 4])
def test_k2_ui_launch_exact(cuda, case, n_layers, msaa):
    dl, _registry = ui_drawlist(case)
    cfg = ui_config(n_layers)
    ui = {k: torch.from_numpy(v).to(cuda) for k, v in dl.pack().items()}
    spos = STANDARD_SAMPLE_POSITIONS[msaa]
    b, s, c, ov = ui_stage.bin_ui(ui, config=cfg, local_tiles_y=cfg.tiles_y,
                                  tile_row_offset=0, n_samples=msaa)
    assert int(ov) == 0
    before = pipeline.launch_counts()["ui"]
    lt, _ov, aux = ui_stage.rasterize_ui(ui, config=cfg, local_tiles_y=cfg.tiles_y,
                                         tile_row_offset=0, sample_positions=spos)
    torch.cuda.synchronize()
    assert pipeline.launch_counts()["ui"] == before + 1
    floor = torch.zeros((msaa, cfg.padded_height, cfg.padded_width), device=cuda)
    kw = dict(mode="blended", n_layers=n_layers, padded_height=cfg.padded_height,
              padded_width=cfg.padded_width, sample_positions=spos)
    out = layers.rasterize_layers(b, s, c, floor, launch_key="ui", **kw)
    ref = layers.rasterize_layers_plain(b, s, c, floor, **kw)
    assert _bits_equal(lt, ref[1]) and _bits_equal(aux, ref[2])
    for got, want in zip(out, ref):
        assert _bits_equal(got, want)
    if case == "deep-stack":
        assert int(ref[2].max()) > n_layers


def test_wrappers_check_their_inputs(cuda):
    b, s, c, h, w = soup_bins(cuda, n=64)
    kw = dict(padded_height=h, padded_width=w)
    with pytest.raises(ValueError):
        raster_kernel.rasterize_binned(b.double(), s[0], c[0], **kw)
    with pytest.raises(ValueError):
        raster_kernel.rasterize_binned(b, s[0].long(), c[0], **kw)
    with pytest.raises(ValueError):
        raster_kernel.rasterize_binned(b, s[0].cpu(), c[0], **kw)
    with pytest.raises(ValueError):
        layers.rasterize_layers(b, s[1], c[1], torch.zeros(1, h, w, device=cuda),
                                mode="masked", n_layers=17, **kw)


@pytest.mark.parametrize("key", ["mini-sandbox-msaa4", "mini-sandbox-perfwin"])
def test_renderer_on_card_matches_sandbox_goldens(cuda, key):
    """The whole mini-sandbox (skinned character, three alpha classes, the
    HUD or the "Performance stats" window through K2's UI launch)."""
    sandbox = demo_scenes.mini_sandbox_scene(0.4)
    ui = demo_scenes.mini_sandbox_ui(sandbox.registry,
                                     "perfwin" if key.endswith("perfwin") else "hud")
    r = trt.Renderer(sandbox.registry, trt.RenderConfig(width=160, height=96,
                                                         msaa_samples=4), device=cuda)
    before = pipeline_launches()
    img = r.render_frame(sandbox.scene, 0, ui=ui)
    moved = {k: v - before[k] for k, v in pipeline_launches().items()}
    assert all(moved[k] > 0 for k in ("ui", "shade", "alpha", "ui_composite", "cand_extract",
                                      "cand_merge", "cand_resolve")), moved
    expected = np.load(Path(__file__).parent / "golden" / "sandbox-golden.npz")[key]
    diff = np.abs(img.astype(int) - expected.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.005


@pytest.mark.parametrize("case", ["triangle-msaa4", "alpha-layers", "triangle-mode3"])
def test_renderer_on_card_matches_goldens(cuda, case):
    if case == "alpha-layers":
        registry, scene = demo_scenes.alpha_layers_scene()
        cfg, mode = trt.RenderConfig(width=160, height=96), 1
    else:
        registry, scene = demo_scenes.triangle_scene()
        msaa = 4 if case == "triangle-msaa4" else 1
        cfg, mode = trt.RenderConfig(width=160, height=96, msaa_samples=msaa), 3
    r = trt.Renderer(registry, cfg, device=cuda)
    before = pipeline.launch_counts()["shade"]
    img = r.render_frame(scene, mode)
    assert pipeline.launch_counts()["shade"] > before
    expected = np.load(GOLDEN)[case]
    diff = np.abs(img.astype(int) - expected.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.005


def _switch_frames(device, name, **cfg_fields):
    from dataclasses import replace

    registry, scene, cfg = build_scene("renderer_tpu_torch", name)
    r = trt.Renderer(registry, replace(cfg, **cfg_fields).validate(),
                     overflow_policy="off", device=device)
    return r.render_frame(scene, 0), r.frame_stats()


def test_bf16_shading_on_the_card(cuda):
    """tests/test_torch_switches.py's bf16 frame on the card: stats equal to
    the CPU's, pixels within the golden tolerance, coverage equal to the
    card's f32 frame."""
    fields = dict(width=96, height=64, srgb_per_tap=False, aniso_samples=4)
    b16, stats = _switch_frames(cuda, "sandbox-static", bf16_shading=True, **fields)
    f32, _ = _switch_frames(cuda, "sandbox-static", **fields)
    want, want_stats = _switch_frames("cpu", "sandbox-static", bf16_shading=True,
                                      **fields)
    assert stats == want_stats
    diff = np.abs(b16.astype(int) - want.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.005
    np.testing.assert_array_equal(f32.sum(axis=-1) > 0, b16.sum(axis=-1) > 0)


def test_shade_strips_bit_equal_on_the_card(cuda):
    """Strip-mapped shading (shade_strip_elems 1) bit-equal to unstripped
    on the card, the twin of tests/test_torch_switches.py's."""
    plain, _ = _switch_frames(cuda, "strip-quads", shade_strip_elems=0)
    striped, _ = _switch_frames(cuda, "strip-quads", shade_strip_elems=1)
    assert plain.std() > 10
    np.testing.assert_array_equal(plain, striped)


# -- the multi-frame path: the frame captured as one CUDA graph ------------

def _sandbox_batch(cuda, times=(0.1, 0.4, 0.7)):
    """A "sync" renderer on the card over the mini-sandbox (three alpha
    classes, the skinned character re-skinned at each game time) at
    160×96, 4×MSAA, and one scene a time."""
    sandbox = demo_scenes.MiniSandbox()
    r = trt.Renderer(sandbox.registry, trt.RenderConfig(width=160, height=96,
                                                         msaa_samples=4),
                     overflow_policy="sync", device=cuda)
    return r, [sandbox.build_scene(t) for t in times]


def test_eager_frame_syncs_nowhere(cuda):
    """No host sync inside a frame (the condition of its graph capture): one
    eager frame under torch.cuda.set_sync_debug_mode("error"), after a
    first frame has uploaded the geometry and the materials."""
    r, (scene, *_) = _sandbox_batch(cuda)
    r.render_frame(scene)
    r.overflow_policy = "off"  # "auto" and "sync" read stats on the host
    torch.cuda.synchronize()
    before = {k: pipeline.launch_counts()[k] for k in shade.LAUNCHES}
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = r.render_frame_device(scene)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert img.shape == (96, 160, 3) and img.device.type == "cuda"
    assert all(pipeline.launch_counts()[k] > before[k] for k in before), pipeline.launch_counts()


def test_graph_replays_equal_eager_frames(cuda):
    r, scenes = _sandbox_batch(cuda)
    imgs, stats = r.render_frames_device(scenes)
    assert r.frame_graphs.graph is not None
    replay = r.frame_graphs.graph.captured.launches
    assert replay["shade"] > 0 and replay["alpha"] > 0, replay
    imgs, stats = imgs.cpu().numpy(), stats.cpu().numpy()
    assert len({im.tobytes() for im in imgs}) == len(scenes)  # re-skinned
    for k, scene in enumerate(scenes):
        np.testing.assert_array_equal(imgs[k], r.render_frame(scene))
        assert list(r.frame_stats().values()) == stats[k].tolist()


def test_replays_add_the_capture_launch_counts(cuda):
    """Each replay adds the launches its capture counted (K1 and both K2
    scene modes once a frame, S1 for the solid and the blended candidates,
    S2 for the masked alpha test); a second batch of the same key replays
    the graph without capturing again."""
    from renderer_tpu_torch.raster import pipeline

    r, scenes = _sandbox_batch(cuda)
    r.render_frames_device(scenes)
    graph = r.frame_graphs.graph
    assert graph.captured.launches == {"k1": 1, "masked": 1, "blended": 1, "ui": 0,
                                       "shade": 2, "alpha": 1, "ui_shade": 0,
                                       "ui_composite": 0, "cand_extract": 3,
                                       "cand_merge": 1, "cand_resolve": 1, "setup": 1,
                                       "bin_spans": 1, "bin_rows": 1, "bin_pairs": 1,
                                       "bin_scan": 1, "bin_scatter": 1}
    assert graph.replay_ms() == []  # the tracer was off: no timing events
    before = pipeline.launch_counts()
    r.profiler = trt.Profiler(enabled=True)  # attached: the tracer is on
    r.render_frames_device(scenes + scenes[:1])
    assert r.frame_graphs.graph is graph
    after = pipeline.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: 4 * v for k, v in graph.captured.launches.items()}
    assert len(graph.replay_ms()) == 4 and min(graph.replay_ms()) > 0.0


@pytest.mark.parametrize("paced", ["device", "host"])
def test_stage_timings_on_the_card(cuda, paced):
    from renderer_tpu_torch.engine import stats

    r, (scene, *_) = _sandbox_batch(cuda)
    r.render_frame(scene)
    timings = stats.device_stage_timings(r, scene, iters=2, paced=paced)
    assert len(timings) == 10 and "FULL FRAME (fused, msaa4)" in timings
    assert all(v > 0.0 for v in timings.values()), timings


@pytest.mark.parametrize("captured", [False, True])
def test_degenerate_triangles_are_invalid_on_the_card(cuda, captured):
    """tests/torch_parity.degenerate_triangles on the card: every point and
    collinear triangle leaves setup invalid (its column all zero) and the
    controls valid, eager and replayed from a captured CUDA graph, and the
    card's setup equals the CPU's bit for bit."""
    from renderer_tpu_torch.raster import pipeline
    from tests.torch_parity import degenerate_triangles

    clip, tri_v, n, w, h, degenerate, control = degenerate_triangles(cuda)

    def run():
        return setup.triangle_setup(clip, tri_v, n, w, h, bbox_pad=0.5)

    if captured:
        graph = pipeline.CapturedGraph(run, cuda)
        graph.out.zero_()
        graph.replay()
        td = graph.out
    else:
        td = run()
    td = td.cpu()
    assert torch.equal(td[:, degenerate], torch.zeros_like(td[:, degenerate]))
    assert td[setup.VALID_ROW, control].tolist() == [1.0, 1.0]
    cpu = setup.triangle_setup(clip.cpu(), tri_v.cpu(), n, w, h, bbox_pad=0.5)
    assert _bits_equal(td, cpu)


# -- the mesh and the host library (parallel/mesh.py, tools/native.py) -----

def test_mesh_on_the_card_over_gloo(cuda, tmp_path):
    """Four ranks sharing the card over gloo with CUDA tensors
    (tests/torch_mesh_ranks.CASES: sp=4 and sp=2, contiguous and
    interleaved, dp=2 × sp=2) against the single-device frame: stats
    equal, pixel agreement > 0.999, and every rank's bands through K1 and
    both K2 modes."""
    from renderer_tpu_torch.parallel import mesh as pmesh
    from tests import torch_mesh_ranks as ranks

    kernels.load()  # built once here, not by four ranks at once
    outs = pmesh.spawn(ranks.run_cases, 4, "triangle", "cuda", store_dir=tmp_path)
    singles = ranks.singles("triangle")
    for case in ranks.CASES:
        img, stats = outs[0]["cases"][case]
        got = [(img[b], stats[b]) for b in range(2)] if case[0] == "dp2sp2" else [(img, stats)]
        for (gi, gs), (wi, ws) in zip(got, singles):
            np.testing.assert_array_equal(gs, ws, err_msg=str(case))
            assert ranks.agreement(gi, wi) > 0.999, case
    for o in outs:
        np.testing.assert_array_equal(o["combined"],
                                      ranks.expected_combine(o["combined"].shape[0]))
        assert o["launches"]["k1"] > 0 and o["launches"]["masked"] > 0, o["launches"]


def test_native_prologue_feeds_a_card_frame(cuda):
    """The mini-sandbox's host prologue (queue_animated's one native call,
    frame_view's native sort) against its numpy plain version: the same
    draw stream, and the same frame on the card. (At some game times the
    joint palettes differ in the last bit, the reference's own drift
    between its library and its numpy path: tests/test_torch_native.py.)"""
    from renderer_tpu_torch.scene import draw_stream
    from renderer_tpu_torch.tools import native

    assert native.status()["path"] == "native"
    frames = []
    for ctx in (contextlib.nullcontext, native.plain):
        sandbox = demo_scenes.MiniSandbox()
        with ctx():
            scene = sandbox.build_scene(0.4)
            fv = draw_stream.frame_view(scene)
            r = trt.Renderer(sandbox.registry, trt.RenderConfig(
                width=160, height=96, msaa_samples=4), device=cuda)
            frames.append((fv, r.render_frame(scene)))
    (fa, ia), (fb, ib) = frames
    np.testing.assert_array_equal(fa.order, fb.order)
    np.testing.assert_array_equal(fa.pdf, fb.pdf)
    np.testing.assert_array_equal(fa.pdi, fb.pdi)
    np.testing.assert_array_equal(ia, ib)


# -- the shading kernels S1, S2, S3 (csrc/shade.cu) ------------------------

def assert_shading_close(got, want, what=""):
    """shade_check.compare (the shading kernels' tolerance against their
    plain versions), with the count of values whose bits differ printed."""
    counts = compare(got, want)
    print(f"{what}: {counts['differing']} values differ in bits")


@pytest.mark.parametrize("scene", ["B", "C"])
def test_shading_kernels_equal_plain_on_scenes(cuda, scene):
    """Every shading call of a 4×MSAA frame of chip_smoke.py's scene B (all
    three alpha classes) and C (the mini-sandbox with its "Performance
    stats" window) at 320×192: S1, S2 and the fused S3 against their plain
    versions, cutoffs equal, and S3 on the fused S3's layers."""
    cfg = trt.RenderConfig(width=320, height=192, msaa_samples=4)
    if scene == "B":
        registry, sc = demo_scenes.patch_wall_scene()
        r = trt.Renderer(registry, cfg, overflow_policy="sync", device=cuda)
        ui = None
    else:
        frames = demo_scenes.SandboxFrames()
        r = trt.Renderer(frames.registry, cfg, profiler=frames.profiler,
                         overflow_policy="sync", device=cuda)
        sc, ui = frames.next()
    r.render_frame(sc, 0, ui=ui)  # grows the capacities
    with recorded_shading() as calls:
        r.render_frame(sc, 0, ui=ui)
    kinds = {kind for kind, _, _ in calls}
    assert kinds == ({"S1", "S2"} if scene == "B" else {"S1", "S2", "S3C"}), kinds
    calls += [("S3", args[1:], kw) for kind, args, kw in calls if kind == "S3C"]
    for i, (kind, args, kw) in enumerate(calls):
        got = run_shading(kind, args, kw, plain=False)
        want = run_shading(kind, args, kw, plain=True)
        assert_shading_close(got, want, f"scene {scene} call {i} {kind}")
        if kind == "S2":
            assert torch.equal(got[1], want[1])  # cutoffs


def _crafted_inputs(cuda, crafted):
    """S1/S2 inputs on the card from tests/torch_parity.py's "sandbox-static"
    scene with a stack of two random candidate maps (valid ids, -1 and -2),
    broken as `crafted` says."""
    from renderer_tpu_torch.raster import vertex_stage
    from renderer_tpu_torch.scene import draw_stream
    from tests.torch_parity import degenerate_triangles

    registry, scene, cfg = build_scene("renderer_tpu_torch", "sandbox-static")
    r = trt.Renderer(registry, cfg, overflow_policy="off", device=cuda)
    fv = draw_stream.frame_view(scene)
    gs, geom = r._geometry(scene, fv.order, fv.geom_key)
    frame = draw_stream.unpack_frame(r._frame_arrays(scene, fv, gs),
                                     morph_k=gs.morph_k, joint_cap=r._joint_cap(scene))
    vs = vertex_stage.run_vertex_stage(geom, frame, gs.skin_start)
    mats = dict(r._materials())
    geom = dict(geom)
    gen = torch.Generator().manual_seed(7)
    n_t = gs.num_tris
    tid = torch.randint(-2, n_t, (2, 64, 96), generator=gen, dtype=torch.int32)
    if crafted == "nan-derivatives":
        vs = dict(vs)
        uv = vs["uv"].clone()
        uv[::5] = float("nan")
        uv[1::7, 0] = float("inf")
        clip = vs["clip"].clone()
        clip[2::11, 3] = 0.0  # w = 0: a zero denominator
        vs["uv"], vs["clip"] = uv, clip
    elif crafted == "degenerate":
        clip, tri_v, _n, _w, _h, degenerate, _control = degenerate_triangles(cuda)
        n_extra = clip.shape[0] - vs["clip"].shape[0]
        vs = {k: torch.cat([v, v[:1].expand(n_extra, *v.shape[1:])]) for k, v in vs.items()}
        vs["clip"] = clip
        geom["tri_v"] = tri_v.contiguous()
        ids = torch.from_numpy(np.asarray(degenerate, np.int32))
        tid = ids[torch.randint(0, len(ids), (2, 64, 96), generator=gen)]
    elif crafted == "out-of-range":
        tex = mats["tex_indices"].clone()
        tex.view(-1)[::3] = -1
        tex.view(-1)[1::7] = -7
        tex.view(-1)[2::5] = 1 << 20
        tex.view(-1)[4::9] = 2**31 - 1
        mats["tex_indices"] = tex
        n_tex = mats["atlas_table"].shape[0]
        mats["atlas_wrap"] = torch.tensor([[5, -1], [1, 2]], dtype=torch.int32,
                                          device=cuda).repeat(n_tex // 2 + 1, 1)[:n_tex]
    row0 = torch.zeros((64, 1), device=cuda)
    return tid.to(cuda), row0, geom, vs, frame, mats, cfg


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("crafted", ["nan-derivatives", "degenerate", "out-of-range",
                                     "bf16"])
def test_shading_kernels_on_crafted_inputs(cuda, crafted, mode):
    """S1 and S2 against their plain versions on NaN and infinite UV
    derivatives and a w = 0 vertex, degenerate (point and collinear)
    triangles, texture slots out of range (negative, past the table) with
    unknown address modes, and bf16 shading; every debug mode, both
    samplers."""
    tid, row0, geom, vs, frame, mats, cfg = _crafted_inputs(cuda, crafted)
    frame = dict(frame)
    frame["debug_mode"] = torch.full((), mode, dtype=torch.int32, device=cuda)
    dt = torch.bfloat16 if crafted == "bf16" else torch.float32
    for trilinear, aniso, per_tap in ((True, 16, True), (True, 4, False), (False, 1, False)):
        kw = dict(width=96, height=64, trilinear=trilinear, aniso=aniso,
                  srgb_per_tap=per_tap, compute_dtype=dt)
        for kind in ("S1", "S2"):
            args = (tid, row0, geom, vs, frame, mats)
            got = run_shading(kind, args, kw, plain=False)
            want = run_shading(kind, args, kw, plain=True)
            assert_shading_close(got, want, f"{crafted} mode {mode} {kind} {kw}")


# -- S1's compacted persistent blocks and S2's alpha-only sampler ----------

def _assert_bits_equal(got: tuple, want: tuple, what: str = "") -> None:
    """Every output value bit-equal to the plain version's, NaN at the same
    values."""
    for g, w in zip(got, want, strict=True):
        nan = torch.isnan(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape)
        assert torch.equal(torch.isnan(g), nan), f"{what}: NaN at other values"
        bad = (g.view(torch.int32) != w.view(torch.int32)) & ~nan
        assert not bad.any(), f"{what}: {int(bad.sum())} values differ in bits"


def _random_atlas(mats: dict, seed: int) -> dict:
    """The materials with every atlas texel random (all 256 byte values in
    every channel) and every other texture sRGB."""
    mats = dict(mats)
    gen = torch.Generator().manual_seed(seed)
    atlas = mats["atlas"]
    mats["atlas"] = torch.randint(-2**31, 2**31 - 1, atlas.shape, generator=gen,
                                  dtype=torch.int32).to(atlas.device)
    n_tex = mats["atlas_table"].shape[0]
    mats["atlas_srgb"] = (torch.arange(n_tex, dtype=torch.int32) % 2).to(atlas.device)
    return mats


# (3, 61, 96): 17,568 elements, a multiple of neither 256 nor S1's span
COVERAGE_SHAPE = (3, 61, 96)
SAMPLERS = ((True, 16, True), (True, 4, False), (False, 1, False))


def _coverage_tid(coverage: str, n_tris: int) -> torch.Tensor:
    """A candidate stack of COVERAGE_SHAPE: "none" (no covered element),
    "one-lane-a-warp" (element e covered where e % 32 == 5, so each warp
    S1 scans holds one covered lane), "full" (every element), "ragged" (8%
    covered at random, the rest -1 and -2)."""
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, n_tris, COVERAGE_SHAPE, generator=gen, dtype=torch.int32)
    bg = torch.randint(-2, 0, COVERAGE_SHAPE, generator=gen, dtype=torch.int32)
    if coverage == "none":
        return bg
    if coverage == "full":
        return ids
    if coverage == "one-lane-a-warp":
        lane = (torch.arange(ids.numel()) % 32 == 5).reshape(COVERAGE_SHAPE)
    else:
        lane = torch.rand(COVERAGE_SHAPE, generator=gen) < 0.08
    return torch.where(lane, ids, bg)


def _eager_and_replayed(cuda, fn):
    """fn()'s outputs run eagerly and from a CUDA graph it was captured in."""
    from renderer_tpu_torch.raster.pipeline import CapturedGraph

    eager = fn()
    g = CapturedGraph(fn, cuda)
    for t in (g.out if isinstance(g.out, tuple) else (g.out,)):
        t.fill_(float("nan"))
    g.replay()
    torch.cuda.synchronize()
    replayed = g.out
    return ((eager if isinstance(eager, tuple) else (eager,)),
            (replayed if isinstance(replayed, tuple) else (replayed,)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coverage", ["none", "one-lane-a-warp", "full", "ragged"])
def test_s1_compaction_bit_equal(cuda, coverage, dtype):
    """S1 (persistent blocks that compact the covered elements of each
    span) against shade_stack_plain bit for bit on a strip with no covered
    element, one covered lane in each warp, a fully covered strip and a
    ragged 8% cover, at an element count that is a multiple of neither 256
    nor the span: every debug mode, f32 and bf16, the exact and both fast
    samplers, on a random atlas with sRGB and linear textures; eagerly and
    replayed from a captured graph."""
    _tid, _row0, geom, vs, frame, mats, _cfg = _crafted_inputs(cuda, "as-is")
    mats = _random_atlas(mats, seed=5)
    tid = _coverage_tid(coverage, geom["tri_v"].shape[0]).to(cuda)
    row0 = torch.full((COVERAGE_SHAPE[1], 1), 3.0, device=cuda)
    before = pipeline.launch_counts()["shade"]
    for mode in range(7):
        fr = dict(frame)
        fr["debug_mode"] = torch.full((), mode, dtype=torch.int32, device=cuda)
        for trilinear, aniso, per_tap in SAMPLERS:
            kw = dict(width=96, height=64, trilinear=trilinear, aniso=aniso,
                      srgb_per_tap=per_tap, compute_dtype=dtype)
            args = (tid, row0, geom, vs, fr, mats)
            want = (shade.shade_stack_plain(*args, **kw),)
            eager, replayed = _eager_and_replayed(
                cuda, lambda args=args, kw=kw: shade.shade_stack(*args, **kw))
            what = f"{coverage} mode {mode} {kw}"
            _assert_bits_equal(eager, want, what + " eager")
            _assert_bits_equal(replayed, want, what + " replayed")
            if coverage == "none":
                assert not eager[0].any()
    assert pipeline.launch_counts()["shade"] > before


# S2's stacks: _coverage_tid's four, and "deep-planes-empty": the ragged
# stack's three planes over eight more that are all -2, as the patch wall's
# masked stack holds past the layers its pixels fill
S2_COVERAGE = ("none", "one-lane-a-warp", "full", "ragged", "deep-planes-empty")


def _s2_tid(coverage: str, n_tris: int) -> torch.Tensor:
    if coverage != "deep-planes-empty":
        return _coverage_tid(coverage, n_tris)
    ragged = _coverage_tid("ragged", n_tris)
    return torch.cat([ragged, torch.full((8, *ragged.shape[1:]), -2, dtype=torch.int32)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coverage", S2_COVERAGE)
def test_s2_alpha_only_bit_equal(cuda, coverage, dtype):
    """S2 (persistent blocks that compact the covered elements of each span,
    the alpha channel alone) against alpha_stack_plain bit for bit at every
    element, on sRGB textures, whose alpha must stay linear, with random
    texels, NaN and infinite UV derivatives and a w = 0 vertex: a stack
    with no covered element, one covered lane in each warp, full cover, a
    ragged 8% cover and deep planes all -2, at counts that are multiples of
    neither 256 nor the span; every sampler; eagerly and replayed from a
    captured graph (outputs pre-filled with NaN). The uncovered elements'
    alpha and cutoff are +0.0 in bits, in both versions."""
    _tid, _row0, geom, vs, frame, mats, _cfg = _crafted_inputs(cuda, "nan-derivatives")
    mats = _random_atlas(mats, seed=9)
    mats["atlas_srgb"] = torch.ones_like(mats["atlas_srgb"])
    tid = _s2_tid(coverage, geom["tri_v"].shape[0]).to(cuda)
    row0 = torch.zeros((tid.shape[1], 1), device=cuda)
    before = pipeline.launch_counts()["alpha"]
    for trilinear, aniso, per_tap in SAMPLERS:
        kw = dict(width=96, height=64, trilinear=trilinear, aniso=aniso,
                  srgb_per_tap=per_tap, compute_dtype=dtype)
        args = (tid, row0, geom, vs, frame, mats)
        want = shade.alpha_stack_plain(*args, **kw)
        eager, replayed = _eager_and_replayed(
            cuda, lambda args=args, kw=kw: shade.alpha_stack(*args, **kw))
        what = f"{coverage} {kw}"
        _assert_bits_equal(eager, want, what + " eager")
        _assert_bits_equal(replayed, want, what + " replayed")
        for out in (*want, *eager, *replayed):
            assert not out.view(torch.int32)[tid < 0].any(), what
        if coverage != "none":
            a = want[0][tid >= 0]
            assert torch.isnan(a).any() and (a[~torch.isnan(a)] < 1).any(), what
    assert pipeline.launch_counts()["alpha"] > before


def test_shade_info_on_the_card(cuda):
    """kernels.shade_info: every shading kernel's registers and the blocks
    an SM its launches assume; the grid of S1, S2 and the fused S3
    (persistent blocks) is SMs × those blocks."""
    for kernel, bf16, per_tap in (("s1", False, True), ("s1", True, False),
                                  ("s2", False, False), ("s2", True, False),
                                  ("s3", False, False), ("s3c", False, False)):
        info = kernels.shade_info(kernel, bf16, per_tap)
        assert 0 < info["registers"] <= 255 and info["blocks_per_sm"] >= 1, info
        assert info["sms"] == torch.cuda.get_device_properties(0).multi_processor_count
        persistent = kernel in ("s1", "s2", "s3c")
        assert info["grid_cap"] == (info["sms"] * info["blocks_per_sm"] if persistent else 0)
        # S3 samples with the byte's value in registers and queues nothing:
        # no shared memory; S2 holds its queue alone
        assert (info["shared_bytes"] == 0 if kernel == "s3" else info["shared_bytes"] > 0)
    report = kernels.ptxas_report()
    assert any("shade_kernel" in k for k in report) and any("alpha_kernel" in k for k in report)


# -- S3 and the fused S3 (the UI shade and its composite) ------------------

# (h, w): 5,856 pixels a layer, a multiple of neither 32 nor 256
UI_SHAPE = (61, 96)
UI_COVERAGE = ("none", "one-lane-a-warp", "window", "full", "ragged")
# triangle 0 (which every uncovered element shades): as drawn, a negative
# and a signed-zero vertex colour, a NaN and an infinite one, and vertices
# too far out for the kernel to skip its uncovered elements' shade
UI_TRIANGLE0 = ("as-is", "negative-colour", "non-finite-colour", "far")


def _ui_inputs(cuda, tri0: str, seed: int = 0):
    """Crafted UI shading inputs on the card: 64 triangles over UI_SHAPE
    (uv past [0, 1], some clockwise), eight commands of tex_kind 1, 2, 0
    and 3 with clip rects that cut through quads and one that holds
    nothing, slots out of range, the font's registry's materials on a
    random atlas (sRGB and linear textures), and triangle 0 as `tri0`
    says."""
    dl, registry = ui_drawlist("glyphs")
    mats = _random_atlas(dict(trt.Renderer(registry, ui_config(), device=cuda)._materials()),
                         seed=seed + 11)
    h, w = UI_SHAPE
    rng = np.random.default_rng(seed)
    n_t, n_c = 64, 8
    pos = np.stack([rng.uniform(-10, w + 10, 3 * n_t), rng.uniform(-10, h + 10, 3 * n_t)],
                   -1).astype(np.float32)
    uv = rng.uniform(-0.5, 1.5, (3 * n_t, 2)).astype(np.float32)
    col = rng.uniform(0.0, 1.0, (3 * n_t, 4)).astype(np.float32)
    tris = np.arange(3 * n_t, dtype=np.int32).reshape(n_t, 3)
    if tri0 == "negative-colour":
        col[:3, :3] = [[-0.5, 0.25, -0.0], [0.75, -0.125, -0.0], [-1.0, 0.5, -0.0]]
    elif tri0 == "non-finite-colour":
        col[0, 0], col[1, 1], col[2, 2] = np.nan, np.inf, -np.inf
    elif tri0 == "far":
        pos[:3] = [[3e7, 5.0], [-2e7, 40.0], [10.0, 4e7]]
    n_tex = mats["atlas_table"].shape[0]
    clip = np.array([[-1, -1, w + 1, h + 1], [10.5, 5.5, 60.5, 40.5], [0, 0, w / 2, h],
                     [-1, -1, w + 1, h + 1], [30.2, 20.7, 31.8, 50.1], [5, 5, 5, 5],
                     [-1, 30.5, w + 1, h + 1], [0, 0, w, h]], np.float32)
    ui = {"tris": tris, "pos": pos, "uv": uv, "col": col,
          "tri_cmd": rng.integers(0, n_c, n_t).astype(np.int32),
          "clip": clip,
          "tex_kind": np.array([1, 2, 0, 3, 1, 2, 2, 1], np.int32),
          "tex_slot": np.array([0, 1, 0, n_tex - 1, -1, n_tex + 3, 2 % n_tex, 1 % n_tex],
                               np.int32)}
    ui["tri_cmd"][0] = 1  # triangle 0 is an RGBA quad's under a clip rect
    ui = {k: torch.from_numpy(v).to(cuda) for k, v in ui.items()}
    row0 = torch.full((h, 1), 3.0, device=cuda)
    return ui, mats, row0


def _ui_layers(coverage: str, lead: tuple, n_tris: int, seed: int = 1) -> torch.Tensor:
    """Layer ids [*lead, h, w] of UI_SHAPE: "none" (no element covered),
    "one-lane-a-warp" (element e covered where e % 32 == 5), "window" (a
    rectangle covered in every layer, nothing elsewhere, as a UI window),
    "full" (every element), "ragged" (8% at random)."""
    shape = (*lead, *UI_SHAPE)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, n_tris, shape, generator=gen, dtype=torch.int32)
    bg = torch.randint(-2, 0, shape, generator=gen, dtype=torch.int32)
    if coverage == "none":
        return bg
    if coverage == "full":
        return ids
    if coverage == "one-lane-a-warp":
        lane = (torch.arange(ids.numel()) % 32 == 5).reshape(shape)
    elif coverage == "window":
        lane = torch.zeros(shape, dtype=torch.bool)
        lane[..., 9:47, 13:71] = True
    else:
        lane = torch.rand(shape, generator=gen) < 0.08
    return torch.where(lane, ids, bg)


def _hdr_samples(cuda, n: int, seed: int = 2) -> list:
    """n HDR samples of UI_SHAPE: values in [-1, 2), many of them −0.0 and
    +0.0, some NaN (two payloads) and ±inf."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        hdr = torch.rand((*UI_SHAPE, 3), generator=gen) * 3 - 1
        pick = torch.rand(hdr.shape, generator=gen)
        hdr[pick < 0.2] = -0.0
        hdr[(pick >= 0.2) & (pick < 0.3)] = 0.0
        hdr[(pick >= 0.3) & (pick < 0.31)] = float("inf")
        hdr[(pick >= 0.31) & (pick < 0.32)] = float("-inf")
        bits = hdr.view(torch.int32)
        bits[(pick >= 0.32) & (pick < 0.33)] = 0x7FC00000
        bits[(pick >= 0.33) & (pick < 0.34)] = -0x3F_FFFF  # a NaN with a payload
        out.append(hdr.to(cuda))
    return out


@pytest.mark.parametrize("ui_msaa", [False, True])
@pytest.mark.parametrize("tri0", UI_TRIANGLE0)
@pytest.mark.parametrize("coverage", UI_COVERAGE)
def test_s3c_fused_composite_bit_equal(cuda, coverage, tri0, ui_msaa):
    """The fused S3 (ui_stage.shade_composite_ui) against its plain version
    bit for bit, eagerly and replayed from a captured graph (the samples
    reset to the inputs before the replay): every coverage of UI_COVERAGE,
    triangle 0 as UI_TRIANGLE0 says, layers [K, h, w] into 4 samples and
    [S, K, h, w] (ui_msaa), HDR samples holding −0.0, NaN and ±inf."""
    ui, mats, row0 = _ui_inputs(cuda, tri0)
    lead = (4, 4) if ui_msaa else (4,)
    lt = _ui_layers(coverage, lead, ui["tris"].shape[0]).to(cuda)
    inputs = _hdr_samples(cuda, 4)
    want = [t.clone() for t in inputs]
    ui_stage.shade_composite_ui_plain(want, lt, ui, mats, row0=row0)
    got = [t.clone() for t in inputs]
    before = pipeline.launch_counts()["ui_composite"]
    ui_stage.shade_composite_ui(got, lt, ui, mats, config=None, row0=row0)
    assert pipeline.launch_counts()["ui_composite"] == before + 1
    _assert_bits_equal(tuple(got), tuple(want), f"{coverage} {tri0} eager")

    from renderer_tpu_torch.raster.pipeline import CapturedGraph

    work = [t.clone() for t in inputs]
    g = CapturedGraph(lambda: ui_stage.shade_composite_ui(work, lt, ui, mats, config=None,
                                                          row0=row0), cuda)
    for w_, t in zip(work, inputs):
        w_.copy_(t)
    g.replay()
    torch.cuda.synchronize()
    _assert_bits_equal(tuple(work), tuple(want), f"{coverage} {tri0} replayed")
    if coverage == "none" and tri0 in ("as-is", "negative-colour"):
        # no live layer: only −0.0 under a colour >= +0 and NaN payloads change
        for g_, t in zip(got, inputs):
            same = (g_.view(torch.int32) == t.view(torch.int32)) | torch.isnan(t) | (t == 0)
            assert same.all()


@pytest.mark.parametrize("tri0", UI_TRIANGLE0)
@pytest.mark.parametrize("coverage", UI_COVERAGE)
def test_s3_every_element_bit_equal(cuda, coverage, tri0):
    """S3 (ui_stage.shade_ui_layer: every element shaded, rgb unmasked)
    against shade_ui_layer_plain bit for bit on the fused S3's crafted
    inputs; eagerly and replayed from a captured graph whose outputs were
    filled with NaN."""
    ui, mats, row0 = _ui_inputs(cuda, tri0)
    lt = _ui_layers(coverage, (4,), ui["tris"].shape[0]).to(cuda)
    want = ui_stage.shade_ui_layer_plain(lt, ui, mats, row0=row0)
    before = pipeline.launch_counts()["ui_shade"]
    eager, replayed = _eager_and_replayed(
        cuda, lambda: ui_stage.shade_ui_layer(lt, ui, mats, config=None, row0=row0))
    assert pipeline.launch_counts()["ui_shade"] > before
    _assert_bits_equal(eager, want, f"{coverage} {tri0} eager")
    _assert_bits_equal(replayed, want, f"{coverage} {tri0} replayed")


def test_vertex_stage_slice_equals_the_whole_stream(cuda):
    """The vertex stage on a slice of the expanded vertex stream (a mesh
    rank's, skin_start=None) gives the bits of the same vertices
    transformed with the whole stream, on the mini-sandbox's skinned
    character: the mesh's frames are bit-equal to one device's
    (chip_smoke.py phase 10)."""
    from renderer_tpu_torch.parallel import mesh as pmesh
    from renderer_tpu_torch.raster import vertex_stage
    from renderer_tpu_torch.scene.draw_stream import unpack_frame

    sandbox = demo_scenes.MiniSandbox()
    r = trt.Renderer(sandbox.registry, trt.RenderConfig(width=320, height=192),
                     overflow_policy="off", device=cuda)
    gs, geom, frame, _mats, jc = pmesh.frame_inputs(r, sandbox.build_scene(1.0))
    f = unpack_frame(frame, morph_k=gs.morph_k, joint_cap=jc)
    whole = vertex_stage.run_vertex_stage(geom, f, None, morph_k=gs.morph_k)
    single = vertex_stage.run_vertex_stage(geom, f, gs.skin_start, morph_k=gs.morph_k)
    ve = geom["exp_src"].shape[0]
    used = torch.zeros(ve, dtype=torch.bool, device=cuda)
    used[geom["tri_v"][:int(f["num_tris"])].long().flatten()] = True
    for n in (2, 4, 3):
        bounds = [ve * i // n for i in range(n + 1)]
        parts = []
        for lo, hi in zip(bounds, bounds[1:]):
            lgeom = dict(geom, exp_src=geom["exp_src"][lo:hi], exp_draw=geom["exp_draw"][lo:hi])
            parts.append(vertex_stage.run_vertex_stage(lgeom, f, None, morph_k=gs.morph_k))
        for k, v in whole.items():
            got = torch.cat([p[k] for p in parts])
            assert torch.equal(got.view(torch.int32) if got.is_floating_point() else got,
                               v.view(torch.int32) if v.is_floating_point() else v), (n, k)
            assert torch.equal(got[used], single[k][used]), (n, k)


@pytest.mark.parametrize("scene,replay", [("triangle", False), ("mini-sandbox", False),
                                          ("patch-wall", True)])
def test_bench_on_the_card(cuda, scene, replay):
    """tools/bench.run as it stands (3 warm-up frames, 3 passes) at the
    golden size: the card named, no drops, CUDA-event frame intervals, the
    last eager frame bit-equal to render_frame and each replayed frame to
    the eager frame of its scene (the CPU runs: tests/test_torch_bench.py)."""
    import io
    import json

    from renderer_tpu_torch.tools import bench

    out = io.StringIO()
    result = bench.run(4, scene=scene, replay=replay, device=cuda, width=W, height=H,
                       out=out)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line == result.line and not result.dropped
    assert line["device"]["name"] == torch.cuda.get_device_name(0)
    assert line["measures"] != "CPU run, not a device number"
    assert len(line["passes_fps"]) == 3 and line["frame_ms"]["n"] == 3
    if replay:
        assert result.images.shape[0] == 4
        for img, (sc, _) in zip(result.images, result.frames, strict=True):
            assert torch.equal(img, result.renderer.render_frame_device(sc, 0))
    else:
        sc, ui = result.frames[-1]
        np.testing.assert_array_equal(result.images.cpu().numpy(),
                                      result.renderer.render_frame(sc, 0, ui=ui))


# -- the candidate kernels C1-C3 (csrc/candidates.cu) -----------------------

def _candidate_calls(inp: dict, dev, case: str, msaa: int):
    """The loops of one frame on `inp` (torch_candidate_cases.loop_inputs)
    as render_shard makes them: (kind, args, kwargs) of C1 on the masked
    slots, C2, C1 on the merged solid ids (counting at MSAA > 1), C1 on the
    blended slots and C3, with alphas, cutoffs and shades from the case."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    s, k, h, w = inp["lt_m"].shape
    lt_m, lt_b = t(inp["lt_m"]), t(inp["lt_b"])
    cands_m = candidates.extract_candidates_plain(lt_m.reshape(s * k, h, w), inp["n_masked"])
    alpha, cutoff = (t(a) for a in cand_cases.alpha_cutoff(case, msaa, inp["n_masked"], h, w))
    solid_tid, solid_z = t(inp["solid_tid"]), t(inp["solid_z"])
    clamp = torch.zeros((h, w), dtype=torch.bool, device=dev)
    calls = [("C1", (lt_m.reshape(s * k, h, w), inp["n_masked"]), {}),
             ("C2", (lt_m, t(inp["lz_m"]), cands_m, alpha, cutoff, solid_tid.clone(),
                     solid_z.clone(), clamp.clone()), {})]
    candidates.masked_merge_plain(lt_m, t(inp["lz_m"]), cands_m, alpha, cutoff,
                                  solid_tid, solid_z, clamp)
    calls.append(("C1", (solid_tid, inp["n_solid"]), {"count": msaa > 1}))
    cands_s = candidates.extract_candidates_plain(solid_tid, inp["n_solid"])
    slots_b = lt_b.reshape(s * lt_b.shape[1], h, w)
    cands_b = candidates.extract_candidates_plain(slots_b, inp["n_blended"])
    calls.append(("C1", (slots_b, inp["n_blended"]), {}))
    shaded_s = t(cand_cases.shades(case, inp["n_solid"], h, w, seed=3))
    shaded_b = t(cand_cases.shades(case, inp["n_blended"], h, w))
    calls.append(("C3", (solid_tid, cands_s, shaded_s, clamp, lt_b, cands_b, shaded_b), {}))
    calls.append(("C3", (solid_tid, cands_s, shaded_s, clamp), {}))
    return calls


CANDIDATE_COUNTERS = {"C1": "cand_extract", "C2": "cand_merge", "C3": "cand_resolve"}


def _assert_candidates_equal(calls, what: str) -> None:
    """Each call through its kernel (one launch) and its plain version: 0
    values differing in bits, NaN where NaN."""
    from renderer_tpu_torch.tools.candidate_check import compare, run_candidates

    for i, (kind, args, kw) in enumerate(calls):
        before = pipeline.launch_counts()[CANDIDATE_COUNTERS[kind]]
        got = run_candidates(kind, args, kw, plain=False)
        assert pipeline.launch_counts()[CANDIDATE_COUNTERS[kind]] == before + 1
        want = run_candidates(kind, args, kw, plain=True)
        counts = compare(got, want)
        assert counts["differing"] == 0, (what, i, kind, counts)


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("msaa", [1, 2, 4, 8])
@pytest.mark.parametrize("case", cand_cases.CASES)
def test_candidate_kernels_bit_equal_on_crafted_inputs(cuda, case, msaa, k):
    """C1-C3 against their plain versions on the crafted cases at 64×128
    (every MSAA count, 1-16 layers: up to 128 slots and 23 candidates)."""
    inp = cand_cases.loop_inputs(case, msaa, k, 64, 128, seed=msaa * 100 + k)
    _assert_candidates_equal(_candidate_calls(inp, cuda, case, msaa), f"{case} {msaa} {k}")


def test_candidate_kernels_bit_equal_at_1080p(cuda):
    """Random inputs at scene B's sizes: 1088×1920, 4×MSAA, 8 masked and 4
    blended layers, 11 / 4 / 7 candidates."""
    inp = cand_cases.loop_inputs("random", 4, 8, 1088, 1920, seed=7)
    _, _, n_b = cand_cases.candidate_counts(4, 4)
    inp["lt_b"] = inp["lt_b"][:, :4]
    inp["n_blended"] = n_b
    assert (inp["n_masked"], inp["n_solid"], n_b) == (11, 4, 7)
    _assert_candidates_equal(_candidate_calls(inp, cuda, "random", 4), "1080p")


def test_candidate_kernels_raise_past_their_limits(cuda):
    """129 slots, 24 candidates, 9 solid candidates and non-contiguous
    inputs raise ValueError before any launch."""
    z = torch.zeros((129, 8, 8), dtype=torch.int32, device=cuda)
    before = {k: pipeline.launch_counts()[k] for k in candidates.LAUNCHES}
    with pytest.raises(ValueError):
        candidates.extract_candidates(z, 4)
    with pytest.raises(ValueError):
        candidates.extract_candidates(z[:128], 24)
    with pytest.raises(ValueError):
        candidates.extract_candidates(z[:8, :, ::2], 4)
    lt = z[:16].reshape(4, 4, 8, 8)
    f = torch.zeros((4, 4, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        candidates.masked_merge(lt, f, z[:24], f[0, :1].expand(24, 8, 8).contiguous(),
                                f[0, :1].expand(24, 8, 8).contiguous(), z[:4], f[0],
                                torch.zeros((8, 8), dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):  # 9 × 16 = 144 slots
        lt9 = torch.zeros((9, 16, 8, 8), dtype=torch.int32, device=cuda)
        candidates.masked_merge(lt9, lt9.float(), z[:4], f[0], f[0], z[:9],
                                lt9[:, 0].float(), torch.zeros((8, 8), dtype=torch.bool,
                                                               device=cuda))
    clamp = torch.zeros((8, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        candidates.resolve(z[:4], z[:9], torch.zeros((9, 8, 8, 4), device=cuda), clamp)
    with pytest.raises(ValueError):
        candidates.resolve(z[:4], z[:4], torch.zeros((4, 8, 8, 4), device=cuda), clamp,
                           lt, z[:24], torch.zeros((24, 8, 8, 4), device=cuda))
    assert {k: pipeline.launch_counts()[k] for k in candidates.LAUNCHES} == before


def test_merge_info_on_the_card(cuda):
    """C2's launch (kernels.merge_info): at frame B's 4 samples × 8 layers
    and 11 candidates, 8 warps a block, each with its stage of 43 rows × 32
    pixels of ids, its matches and pass counts; fewer warps as the slots
    grow; a persistent grid of SMs × the blocks an SM holds, no more blocks
    than the tiles need; no spill in any instantiation."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    frame_b = kernels.merge_info(4, 8, 11, 1088 * 1920)
    assert frame_b["threads"] == 256 and frame_b["blocks_per_sm"] >= 1, frame_b
    assert frame_b["sms"] == sms and frame_b["grid"] == sms * frame_b["blocks_per_sm"]
    assert frame_b["dynamic_shared_bytes"] == 8 * (43 * 4 + 43) * 32
    widest = kernels.merge_info(8, 16, 23, 100)  # 151 rows: 4 warps, 4 tiles
    assert widest["threads"] == 128 and widest["grid"] == 1, widest
    report = {k: v for k, v in kernels.ptxas_report().items() if "12merge_kernel" in k}
    assert len(report) == 6 and not any(v["spill_stores"] for v in report.values()), report


def test_candidate_kernels_replay_from_a_graph(cuda):
    """C1 → C2 → C1 (counting) → C1 → C3 captured into one CUDA graph
    (pipeline.CapturedGraph): a replay into outputs overwritten first
    gives the eager run's bits, which equal the plain versions'."""
    from renderer_tpu_torch.raster.pipeline import CapturedGraph

    inp = cand_cases.loop_inputs("random", 4, 8, 256, 384, seed=3)
    calls = _candidate_calls(inp, cuda, "random", 4)
    (_, (slots_m, n_m), _), (_, (lt_m, lz_m, _, alpha, cutoff, tid0, z0, _), _) = calls[:2]
    _, (_, n_s), _ = calls[2]
    _, (slots_b, n_b), _ = calls[3]
    _, (_, _, shaded_s, _, lt_b, _, shaded_b), _ = calls[4]
    base_tid, base_z = torch.from_numpy(inp["solid_tid"]).to(cuda), torch.from_numpy(
        inp["solid_z"]).to(cuda)

    def frame(ext=candidates.extract_candidates, merge=candidates.masked_merge,
              resolve=candidates.resolve):
        tid, z = base_tid.clone(), base_z.clone()
        clamp = torch.zeros(tid.shape[1:], dtype=torch.bool, device=cuda)
        cands = ext(slots_m, n_m)
        merge(lt_m, lz_m, cands, alpha, cutoff, tid, z, clamp)
        cs, distinct = ext(tid, n_s, count=True)
        cb = ext(slots_b, n_b)
        hdr = resolve(tid, cs, shaded_s, clamp, lt_b, cb, shaded_b)
        return cands, tid, z, cs, distinct, cb, hdr, clamp

    eager = frame()
    want = frame(candidates.extract_candidates_plain, candidates.masked_merge_plain,
                 candidates.resolve_plain)
    g = CapturedGraph(frame, cuda)
    for out in g.out:
        out.fill_(True if out.dtype == torch.bool else -7)
    g.replay()
    torch.cuda.synchronize()
    from renderer_tpu_torch.tools.candidate_check import compare

    assert compare(eager, want)["differing"] == 0
    assert compare(g.out, eager)["differing"] == 0
    assert g.launches["cand_extract"] == 3 and g.launches["cand_merge"] == 1
    assert g.launches["cand_resolve"] == 1


@pytest.mark.parametrize("scene", ["B", "C"])
def test_candidate_kernels_equal_plain_on_scenes(cuda, scene):
    """Every C1-C3 call of a 4×MSAA frame of chip_smoke.py's scene B and C
    at 320×192 (tools/candidate_check), bit-equal to the plain versions."""
    from renderer_tpu_torch.tools.candidate_check import recorded_candidates

    cfg = trt.RenderConfig(width=320, height=192, msaa_samples=4)
    if scene == "B":
        registry, sc = demo_scenes.patch_wall_scene()
        r = trt.Renderer(registry, cfg, overflow_policy="sync", device=cuda)
        ui = None
    else:
        frames = demo_scenes.SandboxFrames()
        r = trt.Renderer(frames.registry, cfg, profiler=frames.profiler,
                         overflow_policy="sync", device=cuda)
        sc, ui = frames.next()
    r.render_frame(sc, 0, ui=ui)  # grows the capacities
    with recorded_candidates() as calls:
        r.render_frame(sc, 0, ui=ui)
    assert [kind for kind, _, _ in calls] == ["C1", "C2", "C1", "C1", "C3"]
    _assert_candidates_equal(calls, f"scene {scene}")


# -- the front end F1-F4 (csrc/frontend.cu) -------------------------------

FRONTEND_COUNTERS = ("setup", "bin_spans", "bin_rows", "bin_pairs", "bin_scan", "bin_scatter")


def _front_setup_args(dev, case: str, tiles: tuple, double_sided: bool):
    """triangle_setup's arguments of a crafted case on `dev`, num_tris a
    0-d int32 tensor there (as the pipeline passes it)."""
    inp = fe_cases.setup_inputs(case, tiles)
    num = torch.tensor(inp["num_tris"], dtype=torch.int32, device=dev)
    args = (torch.from_numpy(inp["clip"]).to(dev), torch.from_numpy(inp["tri_v"]).to(dev),
            num, inp["width"], inp["height"])
    return args, dict(bbox_pad=0.5, double_sided=double_sided)


def _front_bounds(bounds: tuple, dev) -> tuple:
    """The pipeline's mix: the first bound a number, the others 0-d int32
    tensors on the card."""
    return (bounds[0],) + tuple(torch.tensor(b, dtype=torch.int32, device=dev)
                                for b in bounds[1:])


def _assert_frontend_equal(kind: str, args: tuple, kw: dict, what: str) -> None:
    """One call through the kernels (each counter once) and through the
    plain version: 0 values differing in bits, NaN included."""
    from renderer_tpu_torch.raster import pipeline
    from renderer_tpu_torch.tools.frontend_probe import compare, run_frontend

    before = pipeline.launch_counts()
    got = run_frontend(kind, args, kw, plain=False)
    torch.cuda.synchronize()
    after = pipeline.launch_counts()
    moved = {k: after[k] - before[k] for k in FRONTEND_COUNTERS}
    want_moved = {k: int((k == "setup") == (kind == "F1")) for k in FRONTEND_COUNTERS}
    assert moved == want_moved, (what, moved)
    want = run_frontend(kind, args, kw, plain=True)
    counts = compare(got, want)
    assert counts["differing"] == 0, (what, kind, counts)


@pytest.mark.parametrize("double_sided", [False, True])
@pytest.mark.parametrize("case", fe_cases.CASES)
@pytest.mark.parametrize("tiles", fe_cases.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_f1_setup_bit_equal_on_crafted_cases(cuda, tiles, case, double_sided):
    args, kw = _front_setup_args(cuda, case, tiles, double_sided)
    _assert_frontend_equal("F1", args, kw, case)


@pytest.mark.parametrize("config", fe_cases.BIN_CONFIGS)
@pytest.mark.parametrize("case", fe_cases.CASES)
@pytest.mark.parametrize("tiles", fe_cases.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_f2_f4_binning_bit_equal_on_crafted_cases(cuda, tiles, case, config):
    """F2-F4 on the card's plain setup of each case: the binned buffer,
    starts, counts, overflows and demands bit-equal to the plain version,
    under truncation and in a band too."""
    args, kw = _front_setup_args(cuda, case, tiles, False)
    td = setup.triangle_setup_plain(*args, **kw)
    bounds, bkw = fe_cases.bin_config(config, tiles, td.shape[1])
    _assert_frontend_equal("BIN", (td, _front_bounds(bounds, cuda)), bkw, f"{case} {config}")


@pytest.mark.parametrize("config", fe_cases.BIN_CONFIGS)
@pytest.mark.parametrize("tiles", fe_cases.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_binning_plain_on_the_card_equals_the_cpu(cuda, tiles, config):
    """The plain version on the card against the plain version on the CPU,
    at 384×24 tiles too: it multiplies by the tile size's f32 reciprocal
    (binning._reciprocal) where it divided by the Python number, which
    torch on the card turns into that product and torch on the CPU into a
    true quotient ("tile-edges" meets the difference,
    tests/torch_frontend_cases.RECIPROCAL_FLIP)."""
    for case in fe_cases.CASES:
        args, kw = _front_setup_args("cpu", case, tiles, False)
        td = setup.triangle_setup_plain(*args, **kw)
        bounds, bkw = fe_cases.bin_config(config, tiles, td.shape[1])
        want = binning.bin_triangle_classes_plain(td, bounds, **bkw)
        got = binning.bin_triangle_classes_plain(td.to(cuda), _front_bounds(bounds, cuda),
                                                 **bkw)
        assert all(_bits_equal(g.cpu(), w) for g, w in zip(got, want, strict=True)), case


@pytest.mark.parametrize("scene", ["A", "B", "C"])
def test_frontend_kernels_equal_plain_on_scenes(cuda, scene):
    """Every setup and binning call of a 320×192 frame of chip_smoke.py's
    scenes (C with its UI window: the UI pass's double-sided setup and
    single-class binning too), bit-equal to the plain versions."""
    from renderer_tpu_torch.tools.frontend_probe import frame_calls

    cfg = trt.RenderConfig(width=320, height=192, msaa_samples=4)
    ui = None
    if scene == "A":
        registry, sc = demo_scenes.stress_scene()
        r = trt.Renderer(registry, trt.RenderConfig(width=320, height=192,
                                                    max_triangles=1 << 21), device=cuda)
    elif scene == "B":
        registry, sc = demo_scenes.patch_wall_scene()
        r = trt.Renderer(registry, cfg, overflow_policy="sync", device=cuda)
    else:
        frames = demo_scenes.SandboxFrames()
        r = trt.Renderer(frames.registry, cfg, profiler=frames.profiler,
                         overflow_policy="sync", device=cuda)
        sc, ui = frames.next()
    calls = frame_calls(r, sc, ui)
    assert [kind for kind, _, _ in calls] == ["F1", "BIN"] * (2 if scene == "C" else 1)
    for i, (kind, args, kw) in enumerate(calls):
        _assert_frontend_equal(kind, args, kw, f"scene {scene} call {i}")


def test_frontend_kernels_replay_from_a_graph(cuda):
    """Setup, then binning of its output with device-side bounds, captured
    into one CUDA graph (pipeline.CapturedGraph): a replay into outputs
    overwritten first gives the eager run's bits, which equal the plain
    versions'."""
    from renderer_tpu_torch.raster.pipeline import CapturedGraph

    args, kw = _front_setup_args(cuda, "soup", fe_cases.TILES[0], False)
    bounds, bkw = fe_cases.bin_config("three-classes", fe_cases.TILES[0], fe_cases.N_TRIS)
    bounds = _front_bounds(bounds, cuda)

    def front(setup_fn=setup.triangle_setup, bin_fn=binning.bin_triangle_classes):
        td = setup_fn(*args, **kw)
        return (td, *bin_fn(td, bounds, **bkw))

    eager = front()
    want = front(setup.triangle_setup_plain, binning.bin_triangle_classes_plain)
    g = CapturedGraph(front, cuda)
    for out in g.out:
        out.fill_(-7)
    g.replay()
    torch.cuda.synchronize()
    assert all(_bits_equal(a, b) for a, b in zip(eager, want, strict=True))
    assert all(_bits_equal(a, b) for a, b in zip(g.out, eager, strict=True))
    assert {k: g.launches[k] for k in FRONTEND_COUNTERS} == dict.fromkeys(FRONTEND_COUNTERS, 1)


def _edge_setup(dev, name: str) -> torch.Tensor:
    inp = fe_cases.edge_inputs(name)
    num = torch.tensor(inp["num_tris"], dtype=torch.int32, device=dev)
    return setup.triangle_setup_plain(torch.from_numpy(inp["clip"]).to(dev),
                                      torch.from_numpy(inp["tri_v"]).to(dev), num,
                                      inp["width"], inp["height"], bbox_pad=0.5)


@pytest.mark.parametrize("bound_kind", ["numbers", "int32", "int64"])
@pytest.mark.parametrize("name", fe_cases.EDGE_CASES)
def test_f2_spans_f4_scan_edges_bit_equal(cuda, name, bound_kind):
    """F2-F4 on the cases at F2 spans' and F4 scan's edges
    (tests/torch_frontend_cases.EDGE_CASES: triangle counts off a multiple
    of 4 and of 4 × 256, key counts 1023-1025, 2048, 2049 and 4097, a band
    of every third tile row, z-buckets 1 and 16, a run of invalid
    triangles over whole groups and a block), with the class bounds as
    numbers, as int32 and as int64 tensors on the card: bit-equal to the
    plain version."""
    td = _edge_setup(cuda, name)
    bounds, kw = fe_cases.edge_bins(name)
    if bound_kind != "numbers":
        dtype = torch.int32 if bound_kind == "int32" else torch.int64
        bounds = tuple(torch.tensor(b, dtype=dtype, device=cuda) for b in bounds)
    _assert_frontend_equal("BIN", (td, bounds), kw, f"{name} {bound_kind}")


@functools.lru_cache(maxsize=None)
def _block_variants() -> dict:
    items = binning.EXPAND_ITEMS
    return {v["name"]: v for v in fe_cases.block_variants(items["F2 rows"], items["F3 pairs"])}


@pytest.mark.parametrize("variant", fe_cases.BLOCK_VARIANTS)
def test_f2_f4_block_edges_bit_equal(cuda, variant):
    """F2-F4 on the "blocks" case (tests/torch_frontend_cases.py: a run of
    triangles without rows longer than a block, thousands of rows and
    pairs, tall triangles' rows and wide rows' pairs across blocks' edges)
    with the live counts, the starts of the dead slots and the truncations
    of its variants placed at, before and after the edges of F2 rows' and
    F3's blocks (binning.EXPAND_ITEMS) or inside a block: bit-equal to the
    plain version, eager and replayed from a captured graph into outputs
    overwritten first. The demands are those of the case's construction,
    which placed the edges."""
    from renderer_tpu_torch.raster.pipeline import CapturedGraph

    v = _block_variants()[variant]
    inp = fe_cases.block_inputs()
    num = torch.tensor(inp["num_tris"], dtype=torch.int32, device=cuda)
    td = setup.triangle_setup_plain(torch.from_numpy(inp["clip"]).to(cuda),
                                    torch.from_numpy(inp["tri_v"]).to(cuda), num,
                                    inp["width"], inp["height"], bbox_pad=0.5)
    td = torch.cat([td.new_zeros((td.shape[0], v["front"])), td,
                    td.new_zeros((td.shape[0], v["back"]))], 1).contiguous()
    bounds = _front_bounds((v["bounds"][0], *(b + v["front"] for b in v["bounds"][1:])), cuda)
    _assert_frontend_equal("BIN", (td, bounds), v["kw"], variant)
    want = binning.bin_triangle_classes_plain(td, bounds, **v["kw"])
    d = fe_cases.block_demands(fe_cases.block_layout(), v["bounds"], v["kw"], v["front"])
    assert (int(want[6]), int(want[5])) == (d["row_demand"], d["pair_demand"])
    g = CapturedGraph(lambda: binning.bin_triangle_classes(td, bounds, **v["kw"]), cuda)
    for out in g.out:
        out.fill_(-7)
    g.replay()
    torch.cuda.synchronize()
    assert all(_bits_equal(a, b) for a, b in zip(g.out, want, strict=True))


def test_frontend_wrappers_check_their_inputs(cuda):
    """F1's and F2-F4's wrappers raise on inputs the kernels do not take;
    a bound on the CPU counts as its value."""
    args, kw = _front_setup_args(cuda, "soup", fe_cases.TILES[0], False)
    clip, tri_v, num, w, h = args
    for bad in ((clip.double(), tri_v), (clip[:, :3], tri_v), (clip, tri_v.long()),
                (clip, tri_v[:, :2])):
        with pytest.raises(ValueError):
            setup.triangle_setup(*bad, num, w, h)
    with pytest.raises(ValueError):
        setup.triangle_setup(clip, tri_v, num.float(), w, h)
    td = setup.triangle_setup(*args, **kw)
    bounds, bkw = fe_cases.bin_config("three-classes", fe_cases.TILES[0], td.shape[1])
    for bad_td, bad_bounds in ((td.double(), bounds), (td[:16], bounds),
                               (td, (0, 10, 20, 30, bounds[-1]))):
        with pytest.raises(ValueError):
            binning.bin_triangle_classes(bad_td, bad_bounds, **bkw)
    cpu_bounds = tuple(torch.tensor(b, dtype=torch.int32) for b in bounds)
    got = binning.bin_triangle_classes(td, cpu_bounds, **bkw)
    want = binning.bin_triangle_classes_plain(td, bounds, **bkw)
    assert all(_bits_equal(a, b) for a, b in zip(got, want, strict=True))


# -- F1's and F4 scatter's edges (tests/torch_frontend_cases.py) --------------

@pytest.mark.parametrize("double_sided", [False, True])
@pytest.mark.parametrize("name", fe_cases.setup_edges(fe_cases.NOMINAL_RESIDENT))
def test_f1_setup_edges_bit_equal(cuda, name, double_sided):
    """F1 on triangle counts at and around a warp, a block (setup.TILE) and
    R blocks, where R is the blocks of F1 this card holds at once
    (setup.setup_launch: past R blocks the grid takes a second wave), and
    past two rounds of R blocks, with num_tris a device value cutting
    inside a block: bit-equal to the plain version,
    launched once, eager and replayed from a captured graph into an output
    overwritten first."""
    from renderer_tpu_torch.raster.pipeline import CapturedGraph

    resident = setup.setup_launch(1, double_sided)["resident"]
    n, num = fe_cases.setup_edges(resident)[name]
    assert setup.setup_launch(n, double_sided)["grid"] == -(-n // setup.TILE)
    inp = fe_cases.setup_edge_inputs(n, num)
    args = (torch.from_numpy(inp["clip"]).to(cuda), torch.from_numpy(inp["tri_v"]).to(cuda),
            torch.tensor(num, dtype=torch.int32, device=cuda), inp["width"], inp["height"])
    kw = dict(bbox_pad=0.5, double_sided=double_sided)
    _assert_frontend_equal("F1", args, kw, name)
    want = setup.triangle_setup_plain(*args, **kw)
    assert not want[:, num:].any()
    g = CapturedGraph(lambda: (setup.triangle_setup(*args, **kw),), cuda)
    for out in g.out:
        out.fill_(-7)
    g.replay()
    torch.cuda.synchronize()
    assert _bits_equal(g.out[0], want)


def test_f1_takes_tri_v_views_and_refuses_a_misaligned_clip(cuda):
    """F1 on a tri_v view (its rows from the second on) and on an int64
    num_tris: bit-equal to the plain version. A clip view whose data is not 16-byte aligned (F1 reads
    a vertex's row in one 16-byte load) raises ValueError and launches
    nothing; its aligned copy runs."""
    n, num = 3 * setup.TILE + 7, 2 * setup.TILE + 3
    inp = fe_cases.setup_edge_inputs(n + 1, num)
    clip = torch.from_numpy(inp["clip"]).to(cuda)
    tri_v = torch.from_numpy(inp["tri_v"]).to(cuda)[1:]
    assert tri_v.is_contiguous()
    num64 = torch.tensor(num, dtype=torch.int64, device=cuda)
    args = (clip, tri_v, num64, inp["width"], inp["height"])
    _assert_frontend_equal("F1", args, dict(bbox_pad=0.5), "tri_v view")
    buf = torch.empty(clip.numel() + 1, dtype=torch.float32, device=cuda)
    buf[1:] = clip.reshape(-1)
    shifted = buf[1:].view(-1, 4)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = pipeline.launch_counts()["setup"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        setup.triangle_setup(shifted, tri_v, num64, inp["width"], inp["height"])
    assert pipeline.launch_counts()["setup"] == before
    got = setup.triangle_setup(shifted.clone(), tri_v, num64, inp["width"], inp["height"])
    want = setup.triangle_setup_plain(clip, tri_v, num64, inp["width"], inp["height"])
    assert _bits_equal(got, want)


@pytest.mark.parametrize("bound_kind", ["numbers", "int32"])
@pytest.mark.parametrize("name", fe_cases.SCATTER_CASES)
def test_f4_scatter_edges_bit_equal(cuda, name, bound_kind):
    """F2-F4 on the "scatter" cases (tests/torch_frontend_cases.py: a
    group longer than F4 scatter's tile of columns, one ending at a tile's
    edge, 476 empty groups starting inside a tile with live columns on
    both sides, binned rows not a multiple of 4 long, the pairs cut inside
    a group, no live pair at all), the bounds as numbers and as int32
    tensors on the card: bit-equal to the plain version, eager and
    replayed from a captured graph into outputs overwritten first."""
    from renderer_tpu_torch.raster.pipeline import CapturedGraph

    inp = fe_cases.scatter_inputs()
    num = torch.tensor(inp["num_tris"], dtype=torch.int32, device=cuda)
    td = setup.triangle_setup_plain(torch.from_numpy(inp["clip"]).to(cuda),
                                    torch.from_numpy(inp["tri_v"]).to(cuda), num,
                                    inp["width"], inp["height"], bbox_pad=0.5)
    bounds, kw = fe_cases.scatter_bins(name)
    if bound_kind == "int32":
        bounds = tuple(torch.tensor(b, dtype=torch.int32, device=cuda) for b in bounds)
    _assert_frontend_equal("BIN", (td, bounds), kw, f"{name} {bound_kind}")
    want = binning.bin_triangle_classes_plain(td, bounds, **kw)
    g = CapturedGraph(lambda: binning.bin_triangle_classes(td, bounds, **kw), cuda)
    for out in g.out:
        out.fill_(-7)
    g.replay()
    torch.cuda.synchronize()
    assert all(_bits_equal(a, b) for a, b in zip(g.out, want, strict=True))
