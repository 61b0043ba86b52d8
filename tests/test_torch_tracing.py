"""The port's tracer (renderer_tpu_torch/engine/profiling.py): the span
tree of a frame at its stage boundaries, spans on torch.profiler's
timeline, the counters, set-up records, and the matching of device events
to manifests. CPU at golden size (160×96); the `cuda` tests run on the
card: a graph's capture manifest against the eager frame's, and a traced
replay window attributed op for op."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import renderer_tpu_torch as trt
from renderer_tpu_torch.assets import demo_scenes
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.raster import pipeline
from renderer_tpu_torch.scene import draw_stream
from tests import torch_parity  # noqa: F401 — one torch thread a worker

PROLOGUE = ("prologue.draws", "prologue.geometry", "prologue.blob", "prologue.materials")
STAGES = ("unpack", "vertex", "setup", "binning", "raster.opaque", "raster.masked",
          "candidates.masked", "shade.alpha", "merge", "raster.blended",
          "candidates.solid", "shade.solid", "candidates.blended", "shade.blended",
          "resolve", "ui", "tonemap", "stats")


@pytest.fixture(scope="module")
def traced():
    """The mini-sandbox with its HUD at 160×96, its geometry and materials
    on the device already: one frame under a CPU torch.profiler session
    with a Profiler attached that keeps its records; the counters' change
    over it."""
    sandbox = demo_scenes.MiniSandbox()
    prof = trt.Profiler(enabled=True, trace_events=1000)
    r = trt.Renderer(sandbox.registry, trt.RenderConfig(width=160, height=96, msaa_samples=1),
                     profiler=prof, overflow_policy="off", device="cpu")
    scene = sandbox.build_scene(0.25)
    dl = demo_scenes.mini_sandbox_ui(sandbox.registry, "hud")
    fv = draw_stream.frame_view(scene)
    r._geometry(scene, fv.order, fv.geom_key)
    r._materials()
    before = dict(profiling.COUNTERS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        r.render_frame_device(scene, ui=dl)
    moved = {k: v - before[k] for k, v in profiling.COUNTERS.items()}
    return SimpleNamespace(renderer=r, scene=scene, dl=dl, prof=prof, moved=moved,
                           events=[e.name for e in tp.events()])


def test_a_frames_spans_nest_under_frame_and_pipeline(traced):
    recs = traced.prof.records()
    by_path = {r.path: r for r in recs}
    frame = by_path["frame"]
    assert frame.parent is None
    for name in PROLOGUE:
        assert by_path[f"frame/{name}"].parent is frame, name
    pipe = by_path["frame/pipeline"]
    assert pipe.parent is frame
    for name in STAGES:
        rec = by_path[f"frame/pipeline/{name}"]
        assert rec.parent is pipe and rec.name == name
        assert pipe.start <= rec.start <= rec.end <= pipe.end
    # one frame id for every span of the frame, and a new one for the next
    assert {r.frame for r in recs} == {frame.frame} and frame.frame > 0
    # the policy "off" reads nothing back: no overflow span
    assert "frame/overflow" not in by_path
    # the aggregated tree keeps its shape: (depth, name) in first-seen order
    tree = [(s.depth, s.name) for s in traced.prof.report()]
    assert tree[0] == (0, "frame") and (2, "shade.alpha") in tree


def test_the_spans_are_on_the_profilers_timeline(traced):
    names = set(traced.events)
    assert f"{profiling.prefix()}frame" in names
    for name in STAGES:
        assert f"{profiling.prefix()}frame/pipeline/{name}" in names, name


def test_the_chrome_trace_holds_each_spans_parent(traced, tmp_path):
    n = traced.prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert n == len(events) == len(traced.prof.records())
    alpha = next(e for e in events if e["name"] == "shade.alpha")
    assert alpha["args"]["parent"] == "frame/pipeline"
    assert alpha["args"]["path"] == "frame/pipeline/shade.alpha"


def test_the_upload_counters_equal_the_blob_and_ui_bytes(traced):
    r, sc = traced.renderer, traced.scene
    fv = draw_stream.frame_view(sc)
    gs, _ = r._geometry(sc, fv.order, fv.geom_key)
    blob = draw_stream.pack_frame_blob(
        fv, sc.joint_palette, r._proj_view(sc),
        (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris, 0),
        morph_k=gs.morph_k, joint_cap=r._joint_cap(sc))
    ui = traced.dl.pack()
    want = blob.nbytes + sum(np.ascontiguousarray(v).nbytes for v in ui.values())
    assert traced.moved["upload_bytes"] == want
    assert traced.moved["uploads"] == 1 + len(ui)
    assert traced.moved["reads"] == traced.moved["read_bytes"] == 0
    assert traced.moved["capacity_grows"] == traced.moved["capacity_shrinks"] == 0


def test_with_tracing_off_a_span_is_the_shared_null_context():
    profiling.trace_device(False)
    assert not profiling.tracing()
    frames = profiling._frames
    s = profiling.span("frame", frame=True)
    assert s is profiling._NULL_SPAN
    assert trt.Profiler(enabled=False).span("x") is profiling._NULL_SPAN
    with s, profiling.span("pipeline"):
        assert profiling._stack == []
    assert profiling._frames == frames


def test_set_up_spans_are_kept_with_tracing_off():
    profiling.trace_device(False)
    assert not profiling.tracing()
    with profiling.setup_span("setup.test") as outer, profiling.setup_span("setup.inner"):
        pass
    kept = profiling.setup_spans()
    inner = next(r for r in reversed(kept) if r.name == "setup.inner")
    assert inner.parent is outer and inner.path == "setup.test/setup.inner"
    assert profiling.setup_seconds("setup.test") >= outer.seconds > 0.0


def test_the_launch_counters_are_the_registrys():
    assert set(pipeline.LAUNCH_KEYS) <= set(profiling.COUNTERS)
    before = pipeline.launch_counts()
    assert list(before) == list(pipeline.LAUNCH_KEYS)
    pipeline.add_launches({k: 2 for k in before})
    assert {k: profiling.COUNTERS[k] - before[k] for k in before} == dict.fromkeys(before, 2)
    pipeline.add_launches({k: -2 for k in before})
    assert pipeline.launch_counts() == before


# -- manifests ----------------------------------------------------------------

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, device=CPU, id=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id, thread=1,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def _graph(*ops):
    return profiling.Manifest(list(ops))


def _frame_events(lost_kernel=False):
    """An eager frame: the blob upload in its prologue span, then two
    kernels in pipeline spans."""
    p = profiling.prefix()
    out = [
        _ev(f"{p}frame", 0, 100, annotation=True),
        _ev(f"{p}frame/prologue.blob", 1, 10, annotation=True),
        _ev("cudaMemcpyAsync", 2, 3, id=10),
        _ev(f"{p}frame/pipeline", 20, 90, annotation=True),
        _ev(f"{p}frame/pipeline/vertex", 21, 40, annotation=True),
        _ev("cudaLaunchKernel", 22, 23, id=11),
        _ev(f"{p}frame/pipeline/shade.alpha", 41, 60, annotation=True),
        _ev("cudaLaunchKernel", 42, 43, id=12),
        _ev(f"{p}frame/pipeline", 22, 60, device=CUDA, annotation=True),  # a device copy
        _ev("Memcpy HtoD (Pinned -> Device)", 5, 6, device=CUDA, id=10),
        _ev("vert_kernel", 30, 40, device=CUDA, id=11),
        _ev("alpha_kernel", 40, 60, device=CUDA, id=12),
    ]
    return out[:-1] if lost_kernel else out


def test_a_sessions_ops_take_the_span_open_at_their_launch():
    assert profiling._ops_of(_frame_events(), None) == [
        ("Memcpy HtoD (Pinned -> Device)", "frame/prologue.blob"),
        ("vert_kernel", "frame/pipeline/vertex"), ("alpha_kernel", "frame/pipeline/shade.alpha")]


def test_a_launch_whose_device_op_the_trace_lost_gives_none():
    assert profiling._ops_of(_frame_events(lost_kernel=True), None) is None


def test_ops_launched_outside_every_span_are_left_out():
    """A session's own first ops, which the profiler may lose."""
    events = [_ev("cudaLaunchKernel", -9, -8, id=20), _ev("cudaLaunchKernel", -7, -6, id=21),
              _ev("warm_kernel", -5, -4, device=CUDA, id=21)] + _frame_events()
    assert [n for n, _ in profiling._ops_of(events, None)] == [
        "Memcpy HtoD (Pinned -> Device)", "vert_kernel", "alpha_kernel"]


def test_a_warm_ups_paths_are_relative_to_its_span():
    p = profiling.prefix()
    root = "batch/replay/setup.capture_warmup"
    events = [_ev(f"{p}{root}", 0, 50, annotation=True),
              _ev("cudaMemsetAsync", 1, 2, id=3),
              _ev(f"{p}{root}/pipeline/vertex", 5, 20, annotation=True),
              _ev("cudaLaunchKernel", 6, 7, id=4),
              _ev("Memset (Device)", 8, 9, device=CUDA, id=3),
              _ev("vertex_kernel", 9, 12, device=CUDA, id=4)]
    assert profiling._ops_of(events, root) == [("Memset (Device)", ""),
                                                  ("vertex_kernel", "pipeline/vertex")]


def _frame_manifest():
    return profiling.Manifest([("h2d", "frame/prologue.blob"),
                               ("vert", "frame/pipeline/vertex"),
                               ("s2", "frame/pipeline/shade.alpha")])


def _window(names, t=0.0):
    out = []
    for name in names:
        out.append((name, t, t + 1.0))
        t += 2.0
    return out


def test_whole_frames_are_attributed_and_loose_work_is_not():
    ops = _window(["h2d", "vert", "s2", "clone", "h2d", "vert", "s2"])
    a = profiling.attribute(ops[::-1], 2, [_frame_manifest()])  # any order in
    assert a.ok and a.frames == 2 and a.note == ""
    assert a.seconds == {"frame/prologue.blob": 2.0, "frame/pipeline/vertex": 2.0,
                         "frame/pipeline/shade.alpha": 2.0}
    assert a.unattributed_s == 1.0 and a.busy_s == 7.0
    assert a.stage_seconds("shade.alpha", "vertex") == 4.0
    assert a.stage_seconds("pipeline") == 4.0


def test_a_frame_that_does_not_match_leaves_the_window_null():
    ops = _window(["h2d", "vert", "s2", "h2d", "vert", "s1"])
    a = profiling.attribute(ops, 2, [_frame_manifest()])
    assert not a.ok and a.frames == 1
    assert "device event 3" in a.note
    assert not profiling.attribute(ops, 2, []).ok


def test_the_windows_first_call_may_lack_its_first_ops():
    """The profiler misses the device work of its first moments: the first
    call matches by its last ops, if at least half of them are there."""
    a = profiling.attribute(_window(["vert", "s2", "h2d", "vert", "s2"]), 2,
                            [_frame_manifest()])
    assert a.ok and a.lost_at_start == 1 and a.unattributed_s == 0.0
    assert a.seconds == {"frame/prologue.blob": 1.0, "frame/pipeline/vertex": 2.0,
                         "frame/pipeline/shade.alpha": 2.0}
    # two of its three ops lost: more than half
    assert not profiling.attribute(_window(["s2", "h2d", "vert", "s2"]), 2,
                                   [_frame_manifest()]).ok
    # past the first call, nothing may be missing
    assert not profiling.attribute(_window(["h2d", "vert", "s2", "vert", "s2"]), 2,
                                   [_frame_manifest()]).ok


def test_graph_replays_are_matched_a_frame_each():
    """A batch: its blob upload, then a frame a replay with the copies
    around it, which no manifest holds."""
    graph = _graph(("vert", "pipeline/vertex"), ("s2", "pipeline/shade.alpha"))
    ops = _window(["h2d", "dtod", "vert", "s2", "copy", "dtod", "vert", "s2", "copy"])
    a = profiling.attribute(ops, 2, [graph])
    assert a.ok and a.frames == 2
    assert a.seconds == {"pipeline/vertex": 2.0, "pipeline/shade.alpha": 2.0}
    assert a.unattributed_s == 5.0 and a.busy_s == 9.0


@pytest.mark.parametrize("fault", ["renamed", "dropped"])
def test_a_replay_that_does_not_match_its_graph_leaves_the_window_null(fault):
    graph = _graph(("vert", "pipeline/vertex"), ("s2", "pipeline/shade.alpha"),
                   ("s1", "pipeline/shade.solid"))
    second = ["vert", "s9", "s1"] if fault == "renamed" else ["vert", "s1"]
    a = profiling.attribute(_window(["vert", "s2", "s1", "copy"] + second), 2, [graph])
    assert not a.ok and a.frames == 1 and "device event" in a.note


def test_the_longest_matching_manifest_wins():
    short = _frame_manifest()
    long = profiling.Manifest(short.ops + [("d2h", "frame/overflow")])
    ops = _window(["h2d", "vert", "s2", "d2h", "h2d", "vert", "s2"])
    a = profiling.attribute(ops, 2, [short, long])
    assert a.ok and a.seconds["frame/overflow"] == 1.0 and a.unattributed_s == 0.0


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def device_traced():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    profiling.trace_device(True)
    yield torch.device("cuda")
    profiling.trace_device(False)


def _card_renderer(dev):
    sandbox = demo_scenes.MiniSandbox()
    r = trt.Renderer(sandbox.registry, trt.RenderConfig(width=160, height=96, msaa_samples=4),
                     overflow_policy="off", device=dev)
    return r, [sandbox.build_scene(t) for t in (0.1, 0.4, 0.7)]


@pytest.mark.cuda
def test_the_capture_manifest_is_the_eager_frames_pipeline(device_traced):
    r, scenes = _card_renderer(device_traced)
    r.render_frames_device(scenes)
    graph = r.frame_graphs.graph.captured.manifest
    assert graph is not None and len(graph.ops) > 100
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tp:
        # ops outside every span first: a session after the process's first
        # loses its first device ops
        x = torch.zeros(8, device=device_traced)
        for _ in range(8):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(profiling.SETTLE_S)
        r.render_frame_device(scenes[0])
        torch.cuda.synchronize()
    eager = profiling._ops_of(tp.events(), None)
    assert eager is not None
    mine = [(n, p[len("frame/"):]) for n, p in eager if p.startswith("frame/pipeline")]
    first = next((k for k, (a, b) in enumerate(zip(mine, graph.ops)) if a != b), None)
    assert len(mine) == len(graph.ops) and first is None, (
        len(mine), len(graph.ops), first, mine[first:first + 3] if first is not None else None,
        graph.ops[first:first + 3] if first is not None else None)


@pytest.mark.cuda
def test_a_traced_replay_windows_frames_are_attributed(device_traced):
    r, scenes = _card_renderer(device_traced)
    r.render_frames_device(scenes)  # the capture and the graph's manifest
    assert profiling.manifests() == [r.frame_graphs.graph.captured.manifest]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tp:
        r.render_frames_device(scenes)
        torch.cuda.synchronize()
    ops = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in tp.events()
           if e.device_type == CUDA and not e.name.startswith(profiling.prefix())]
    a = profiling.attribute(ops, len(scenes))
    assert a.ok, a.note
    # left out: the blob upload and the copies between replays
    assert 0.0 < a.unattributed_s < 0.1 * a.busy_s
    assert a.stage_seconds("shade.alpha") > 0.0 and a.stage_seconds("vertex") > 0.0
