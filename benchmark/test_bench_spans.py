"""The readers of the program's spans (benchmark/spans.py): on a traced
window with the program's spans in it every earlier reader reads what it
reads without them, and each new reader reads its synthetic window.

Importing benchmark/spans.py switches the program's device tracing on for
the whole process; this module switches it off again at once, and on only
around each of its own tests, so that the other tests of the folder run
untraced."""

import importlib
import json
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans, trace
from benchmark.cell import load_module
from renderer_tpu_torch.engine import profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("prologue_host_ms.interactive", "issue_host_ms.interactive", "alpha_ms_per_frame",
       "shade_ms_per_frame", "vertex_ms_per_frame", "unattributed_device_pct.flythrough",
       "setup_capture_s")
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

profiling.trace_device(False)


@pytest.fixture(autouse=True)
def device_tracing():
    """The program's device tracing as a traced run has it, during the test."""
    spans.switch_on()
    yield
    profiling.trace_device(False)


def reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"benchmark.metrics.{name}")


def _ev(name, start_us, end_us, device=CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


#: one eager frame's device ops (name, start µs, end µs) and the span each
#: was launched in
FRAME = (("Memcpy HtoD (Pinned -> Device)", 0, 5, "frame/prologue.blob"),
         ("void at::native::vectorized_elementwise_kernel<4>", 10, 30, "frame/pipeline/vertex"),
         ("void rf::setup_kernel<128>", 40, 60, "frame/pipeline/setup"),
         ("void rt::binned_kernel<1, 1>", 70, 120, "frame/pipeline/raster.opaque"),
         ("void rs::alpha_kernel<false>", 130, 230, "frame/pipeline/shade.alpha"),
         ("void at::native::CatArrayBatchedCopy", 230, 240, "frame/pipeline/shade.alpha"),
         ("void rc::merge_kernel<24>", 250, 270, "frame/pipeline/merge"),
         ("void rs::shade_kernel<false, true>", 280, 400, "frame/pipeline/shade.solid"),
         ("void rc::resolve_kernel<16>", 410, 430, "frame/pipeline/resolve"))
PERIOD = 1000  # µs between frames


def raw_events(frames=2, with_spans=True):
    """A profiler's event list of `frames` eager frames: the harness's
    labels, every device op, and (with_spans) the program's spans under
    spans.PREFIX, each on the host and, spanning its ops, on the device."""
    out = []
    for f in range(frames):
        t = f * PERIOD
        out.append(_ev("bench.render_frame_device", t - 300, t + 200, annotation=True))
        out.append(_ev("bench.render_frame_device", t, t + 430, CUDA, annotation=True))
        for name, s, e, _ in FRAME:
            out.append(_ev(name, t + s, t + e, CUDA))
        if with_spans:
            paths = {"frame": (-290, 190)}
            for i, (_, s, e, path) in enumerate(FRAME):
                lo = -280 + 50 * i
                paths.setdefault("frame/pipeline", (lo, 180))
                paths[path] = (lo, lo + 40)
            for path, (s, e) in paths.items():
                out.append(_ev(spans.PREFIX + path, t + s, t + e, annotation=True))
                ops = [(s_, e_) for _, s_, e_, p in FRAME if p == path or p.startswith(path + "/")]
                if ops:
                    out.append(_ev(spans.PREFIX + path, t + ops[0][0], t + ops[-1][1], CUDA,
                                   annotation=True))
    return out


def window(events, frames=2):
    work = {"shade": [[("s", 4e9, 1e9)]], "candidates": [[("c", 1e8, 3e8)]],
            "raster": [[("r", 1e8, 2e8)]], "frontend": [[("f", 1e7, 1e8)]]}
    return trace.Window(trace.events_of(events), frames, host_s=[0.015, 0.016], work=work,
                        peaks={"flops_per_s": 5e13, "bytes_per_s": 3e12})


def test_every_earlier_reader_reads_the_same_with_the_programs_spans():
    earlier = [m["name"] for m in BENCH["per_layer"] if m["name"] not in NEW]
    assert len(earlier) == 10
    measured = {"interactive_frame_p95_ms": 15.5}
    plain, traced = window(raw_events(with_spans=False)), window(raw_events())
    for name in earlier:
        r = reader(name)
        assert r.read(traced, measured) == r.read(plain, measured), name
    a, b = plain.breakdown(), traced.breakdown()
    assert a["device_ops"] == b["device_ops"]
    assert [g[1] for g in a["idle_gaps"]] == [g[1] for g in b["idle_gaps"]]
    # a gap the harness's label named is named by the innermost program span
    named = [(x[0], y[0]) for x, y in zip(a["idle_gaps"], b["idle_gaps"])
             if x[0] == "bench.render_frame_device"]
    assert named and all(y.startswith(spans.PREFIX + "frame") for _, y in named)


@pytest.fixture
def manifests(monkeypatch):
    frame = profiling.Manifest([(n, p) for n, _, _, p in FRAME])
    monkeypatch.setattr(profiling, "_manifests", [frame])
    return frame


def test_the_device_readers_read_the_matched_frames(manifests):
    w = window(raw_events())
    ms = {name: reader(name).read(w, {}) for name in NEW}
    assert ms["alpha_ms_per_frame"] == pytest.approx(0.110)
    assert ms["shade_ms_per_frame"] == pytest.approx(0.120)
    assert ms["vertex_ms_per_frame"] == pytest.approx(0.020)
    assert ms["unattributed_device_pct.flythrough"] == 0.0


def test_work_outside_the_programs_calls_is_unattributed(manifests):
    events = raw_events() + [_ev("Memcpy DtoD (Device -> Device)", 600, 650, CUDA)]
    w = window(events)
    pct = reader("unattributed_device_pct.flythrough").read(w, {})
    assert pct == pytest.approx(100.0 * 50 / (2 * 365 + 50))
    assert reader("alpha_ms_per_frame").read(w, {}) == pytest.approx(0.110)


def test_a_window_that_does_not_match_reads_null(manifests, capsys):
    """An op of the second frame renamed (the first frame may lack its first
    ops: the profiler misses the start of a window)."""
    events = raw_events()
    k = next(k for k, e in enumerate(events) if e.name.startswith("void rs::alpha")
             and e.time_range.start >= PERIOD)
    events[k] = _ev("void at::native::other_kernel", events[k].time_range.start,
                    events[k].time_range.end, CUDA)
    w = window(events)
    assert reader("alpha_ms_per_frame").read(w, {}) is None
    assert reader("unattributed_device_pct.flythrough").read(w, {}) is None
    assert "no attribution" in capsys.readouterr().err


def test_the_host_readers_read_the_labels_of_the_frames():
    w = window(raw_events())
    # four prologue spans a frame would each be 40 µs; this frame has one
    assert reader("prologue_host_ms.interactive").read(w, {}) == pytest.approx(0.040)
    assert reader("issue_host_ms.interactive").read(w, {}) == pytest.approx(0.460)
    assert reader("prologue_host_ms.interactive").read(window(raw_events(with_spans=False)),
                                                        {}) is None


def test_setup_capture_s_sums_the_captures(monkeypatch):
    def rec(name, seconds):
        r = profiling.Record(name, None, 0)
        r.end = seconds
        return r

    kept = deque([rec("setup.kernels", 9.0), rec("setup.capture", 0.5),
                  rec("setup.instantiate", 0.25), rec("setup.capture", 0.5)])
    monkeypatch.setattr(profiling, "_setup", kept)
    assert reader("setup_capture_s").read(None, {}) == pytest.approx(1.25)
    monkeypatch.setattr(profiling, "_setup", deque())
    assert reader("setup_capture_s").read(None, {}) is None


def test_importing_the_readers_switched_device_tracing_on():
    profiling.trace_device(False)
    importlib.reload(spans)
    assert profiling.tracing() and profiling.prefix() == spans.PREFIX
    assert spans.PREFIX.startswith(trace.LABEL_PREFIX)
