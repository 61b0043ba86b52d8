"""The port's tracer: named spans, counters and set-up records.

`span(name)` marks a stage of the frame, the batch or set-up (the
reference's `profiling::scope!` facade, examples/sandbox/src/main.rs:
704-847). A span records its name, its path from the outermost open span
(`frame/pipeline/shade.alpha`), its parent, the frame id it shares with
the other spans of its frame or batch, and its host start and end. Spans
go to:

- every `Profiler` attached by an open span (`Profiler.span`), which sums
  them into the collapsible tree the sandbox's HUD shows (`report`,
  `snapshot`, `format`) and can keep the records for
  `export_chrome_trace`;
- torch.profiler's timeline, while a torch.profiler session is active: each
  span opens a range named `prefix() + path` (a `record_function`), beside
  the device events;
- the set-up record (`setup_spans`), for the spans opened with
  `setup_span`, which run once a session and are always kept.

With no Profiler attached, device tracing off and no torch.profiler
session, `span` returns one shared null context after a flag check and
torch's profiler flag.

`trace_device()` switches device tracing on. A CUDA graph's kernels run
no Python when replayed, so no span is open around them; instead each
graph captured from then on runs its frame once eagerly, before its
untraced warm-up, inside a short torch.profiler session of the tracer's
own, and keeps a capture manifest:
each device op in launch order with the span open when it was launched.
`attribute` maps a traced window's device events onto the manifests by
position, each name checked.

The counters (`COUNTERS`) are one registry: the kernel wrappers' launch
counters (`register_launches`, read by pipeline.launch_counts), host→device
uploads, device→host reads and capacity changes (the last three read by
tools/frame_profile.profile_frame, a frame's change in them).
"""

from __future__ import annotations

import sys
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

# one shared no-op context for disabled spans: nullcontext is stateless
# (enter returns None, exit returns False), so reusing a single instance is
# safe and keeps a disabled span at a flag check in the frame loop
_NULL_SPAN = nullcontext()

#: the default prefix of the spans' names on torch.profiler's timeline
PREFIX = "renderer/"

_profiler_on = torch._C._autograd._profiler_enabled
# a span's range on torch.profiler's timeline: the C++ context manager
# where torch has it (a seventh of record_function's host cost)
_record = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
           or torch.profiler.record_function)

_on = False  # spans record: device tracing is on or a Profiler is attached
_stack: list = []  # the open spans' Records
_sinks: list = []  # the attached Profilers
_device = False  # trace_device() was called
_prefix = PREFIX
_frames = 0  # the last frame id given out
_setup: deque = deque(maxlen=256)  # finished set-up Records
_manifests: list = []  # graph Manifests, in the order they were recorded

#: the counters of a frame's traffic and steadiness: host→device uploads and
#: their bytes, device→host reads and their bytes, capacity grows and shrinks
TRAFFIC = ("uploads", "upload_bytes", "reads", "read_bytes", "capacity_grows",
           "capacity_shrinks")
#: counters by name: TRAFFIC and the kernel launches (the keys of
#: register_launches)
COUNTERS: dict = dict.fromkeys(TRAFFIC, 0)


def register_launches(keys) -> None:
    """Adds a kernel wrapper's launch counters to the registry, at 0."""
    for k in keys:
        COUNTERS.setdefault(k, 0)


def count(key: str, n: int = 1) -> None:
    COUNTERS[key] += n


def add_counts(delta: dict) -> None:
    for k, v in delta.items():
        COUNTERS[k] += v


class Record:
    """One span: name, path, parent Record (None at the outermost), the
    frame id, and host start and end (time.perf_counter seconds)."""

    __slots__ = ("name", "path", "parent", "frame", "start", "end")

    def __init__(self, name: str, parent, frame: int) -> None:
        self.name, self.parent, self.frame = name, parent, frame
        self.path = name if parent is None else f"{parent.path}/{name}"
        self.start = self.end = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return f"Record({self.path!r}, frame={self.frame}, {1e3 * self.seconds:.3f} ms)"


class _Span:
    __slots__ = ("name", "sink", "frame", "setup", "rec", "rf")

    def __init__(self, name: str, sink, frame: bool, setup: bool) -> None:
        self.name, self.sink, self.frame, self.setup = name, sink, frame, setup

    def __enter__(self) -> Record:
        global _on, _frames
        parent = _stack[-1] if _stack else None
        if self.frame:
            _frames += 1
            fid = _frames
        else:
            fid = 0 if parent is None else parent.frame
        rec = self.rec = Record(self.name, parent, fid)
        if self.sink is not None:
            if self.sink in _sinks:  # already attached further out
                self.sink = None
            else:
                _sinks.append(self.sink)
                _on = True
        for s in _sinks:
            s._enter(rec)
        _stack.append(rec)
        self.rf = None
        if _profiler_on():
            self.rf = _record(_prefix + rec.path)
            self.rf.__enter__()
        rec.start = time.perf_counter()
        return rec

    def __exit__(self, *exc) -> bool:
        global _on
        rec = self.rec
        rec.end = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _stack.pop()
        for s in _sinks:
            s._exit(rec)
        if self.sink is not None:
            _sinks.remove(self.sink)
            _on = _device or bool(_sinks)
        if self.setup:
            _setup.append(rec)
        return False


def span(name: str, *, frame: bool = False):
    """A span named `name` under the innermost open one; `frame` starts a
    new frame id for it and the spans inside it."""
    if not _on and not _profiler_on():
        return _NULL_SPAN
    return _Span(name, None, frame, False)


def setup_span(name: str):
    """A span of set-up (a build, a load, a graph capture): recorded always,
    and kept in `setup_spans()`."""
    return _Span(name, None, False, True)


def tracing() -> bool:
    """Whether spans record (device tracing on, or a Profiler attached)."""
    return _on


def setup_spans() -> list:
    """The finished set-up spans of this process, oldest first (at most the
    last 256)."""
    return list(_setup)


def setup_seconds(name: str) -> float:
    """Host seconds of the set-up spans named `name`, summed."""
    return sum(r.seconds for r in _setup if r.name == name)


def prefix() -> str:
    """The prefix of the spans' names on torch.profiler's timeline."""
    return _prefix


@dataclass
class Span:
    name: str
    depth: int
    total_s: float = 0.0
    count: int = 0


class Profiler:
    def __init__(self, enabled: bool = True, trace_events: int = 0) -> None:
        """Aggregates the spans opened while it is attached (by its own
        `span`, and everything nested inside) by (depth, name).
        trace_events > 0 additionally retains the last N span Records for
        `export_chrome_trace` — the reference's profile-with-tracing
        subscriber drains raw spans the same way (examples/sandbox/src/
        main.rs:30-36,312-318); the aggregated tree (report/format) stays
        the default."""
        self.enabled = enabled
        self._spans: dict[tuple[int, str], Span] = {}
        self._depth = 0
        self._order: list[tuple[int, str]] = []
        self._keys: list[tuple[int, str]] = []
        self._events = deque(maxlen=trace_events) if trace_events else None

    def span(self, name: str, *, frame: bool = False):
        """A span that attaches this profiler while it is open (when
        enabled); otherwise the module's `span`."""
        if not self.enabled:
            return span(name, frame=frame)
        return _Span(name, self, frame, False)

    def _enter(self, rec: Record) -> None:
        key = (self._depth, rec.name)
        if key not in self._spans:
            self._spans[key] = Span(rec.name, self._depth)
            self._order.append(key)
        self._keys.append(key)
        self._depth += 1

    def _exit(self, rec: Record) -> None:
        self._depth -= 1
        s = self._spans[self._keys.pop()]
        s.total_s += rec.seconds
        s.count += 1
        if self._events is not None:
            self._events.append(rec)

    def records(self) -> list:
        """The retained span Records (trace_events), oldest first."""
        return list(self._events or ())

    def export_chrome_trace(self, path: str) -> int:
        """Write the retained span Records as Chrome trace-event JSON (load
        in chrome://tracing or https://ui.perfetto.dev) — requires
        `trace_events` at construction. Returns the number of events
        written. Complete ('X') events, each with its path, its parent's
        path and its frame id under "args"."""
        import json

        events = [
            {"name": r.name, "ph": "X", "ts": r.start * 1e6, "dur": r.seconds * 1e6,
             "pid": 0, "tid": 0,
             "args": {"path": r.path, "frame": r.frame,
                      "parent": None if r.parent is None else r.parent.path}}
            for r in self.records()
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(events)

    def reset(self) -> None:
        self._spans.clear()
        self._order.clear()
        if self._events is not None:
            self._events.clear()

    def snapshot(self, label: str) -> None:
        """Move the accumulated spans into a named section and reset — the
        sandbox splits its span tree into 'startup' and 'latest frame'
        sections this way (main.rs:315-319,532-542)."""
        if not hasattr(self, "sections"):
            self.sections: dict[str, list[Span]] = {}
        self.sections[label] = self.report()
        self._spans = {}
        self._order = []

    def report(self) -> list[Span]:
        return [self._spans[k] for k in self._order]

    def format(self) -> str:
        lines = []
        for label, spans in getattr(self, "sections", {}).items():
            lines.append(f"[{label}]")
            for s in spans:
                mean_us = 1e6 * s.total_s / max(s.count, 1)
                lines.append(f"  {'  ' * s.depth}{s.name}: {mean_us:.1f} µs ×{s.count}")
        for s in self.report():
            mean_us = 1e6 * s.total_s / max(s.count, 1)
            lines.append(f"{'  ' * s.depth}{s.name}: {mean_us:.1f} µs ×{s.count}")
        return "\n".join(lines)


# -- device tracing: manifests and attribution --------------------------------


@dataclass
class Manifest:
    """The device ops of a graph's eager run of its frame, in launch order,
    each (op name, path of the span open when it was launched, relative to
    the run's span)."""

    ops: list = field(default_factory=list)


def trace_device(on: bool = True, prefix: str = PREFIX) -> None:
    """Switch device tracing on (until it is switched off): spans record and
    sit on torch.profiler's timeline under `prefix`, and the graphs
    captured from now on keep their manifests (module docstring). Off, the
    manifests recorded so far are dropped.

    A manifest costs a torch.profiler session of the tracer's own, and on
    the H100 (torch 2.11, CUDA 12.8) every session after a process's first
    lost its first device ops, and some ran a stretched device clock: in a
    process held to one core whose two eager frames had been recorded, the
    next session read every kernel 4-22% long. So a process records one
    graph warm-up a capture and no eager frame."""
    global _device, _on, _prefix
    _device = on
    _on = on or bool(_sinks)
    _prefix = prefix
    if not on:
        _manifests.clear()


def manifests() -> list:
    """The graphs' manifests recorded so far."""
    return list(_manifests)


#: host seconds a session of the tracer's own waits after its first device
#: ops, which a session after the process's first loses
SETTLE_S = 0.02
#: the runtime calls that put work on the device, each matched by
#: correlation id to the device op it launched
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


class _Session:
    """A torch.profiler session of the tracer's own around one eager run of
    a graph's frame; on a clean exit its events become a Manifest. It
    starts with a few device ops of its own, launched outside every span
    (which a manifest leaves out), for the profiler to lose."""

    def __init__(self) -> None:
        self.root: str | None = None
        self.manifest: Manifest | None = None
        self.prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        x = torch.zeros(8, device="cuda")
        for _ in range(8):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        if exc_type is None:
            ops = _ops_of(self.prof.events(), self.root)
            if ops is None:
                print("[profiling] a graph's trace lacks device ops it launched; "
                      "no manifest kept", file=sys.stderr)
            else:
                self.manifest = Manifest(ops)
                _manifests.append(self.manifest)
        self.prof = None
        return False


def recording_graph():
    """Around an eager run of a graph's frame, outside its span (whose path
    the caller sets as the session's `root`): a session whose manifest holds
    the run's device ops, paths relative to the root. None when device
    tracing is off or a torch.profiler session is active."""
    if not _device or _profiler_on():
        return None
    return _Session()


def _ops_of(events, root: str | None):
    """(op name, span path) of a session's device events in device order:
    each takes the innermost span open on its launching thread when its
    runtime call (matched by correlation id) began. Ops launched outside
    every span (the session's own first ops) are left out. None where a
    launch inside a span has no device op in the trace (the profiler lost
    it)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, launches, device = [], {}, []
    for e in events:
        mine = e.name.startswith(_prefix)
        if e.device_type == cuda:
            if not mine and not getattr(e, "is_user_annotation", False):
                device.append(e)
        elif mine:
            spans.append((e.time_range.start, e.time_range.end, e.thread,
                          e.name[len(_prefix):]))
        elif e.name.startswith("cu"):
            launches[e.id] = e
    device.sort(key=lambda e: (e.time_range.start, e.time_range.end))

    def where(launch) -> str | None:
        """The launch's span path (relative to the root); None outside
        every span (the session's own first ops)."""
        t, best = launch.time_range.start, None
        for s in spans:
            if s[2] == launch.thread and s[0] <= t <= s[1] and (best is None or s[0] >= best[0]):
                best = s
        if best is None:
            return None
        path = best[3]
        if root is not None:
            path = "" if path == root else path[len(root) + 1:] if path.startswith(root + "/") else path
        return path

    ops = []
    for e in device:
        launch = launches.get(e.id)
        if launch is not None and (path := where(launch)) is not None:
            ops.append((e.name, path))
    ran = {e.id for e in device}
    lost = sorted((e.time_range.start, e.name) for i, e in launches.items()
                  if e.name.startswith(_LAUNCH_CALLS) and i not in ran
                  and where(e) is not None)
    if lost:
        print(f"[profiling] {len(lost)} launches without a device op in the trace, the "
              f"first {lost[:3]}", file=sys.stderr)
        return None
    return ops


@dataclass
class Attribution:
    """Device seconds of a window by the path of the span each op ran
    under (`seconds`), the seconds of the ops under no span: those no
    manifest covers, and those a graph's run launched outside every span
    (`unattributed_s`), the busy seconds (the union of every op), the
    frames the matched replays rendered, and `ok`: whether those are the
    window's frames (else `note` says where matching stopped).
    `lost_at_start`: the ops of the window's first replay missing from its
    trace."""

    seconds: dict
    unattributed_s: float
    busy_s: float
    frames: int
    ok: bool
    note: str = ""
    lost_at_start: int = 0

    def stage_seconds(self, *stages: str) -> float:
        """Seconds of the ops under any span named in `stages`, at any depth."""
        want = set(stages)
        return sum(s for path, s in self.seconds.items() if want & set(path.split("/")))


def _union_s(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def attribute(ops, frames: int, calls: list | None = None) -> Attribution:
    """Maps a window's device events `ops` ((name, start s, end s), any
    order; `frames` whole frames ran in it) onto the manifests `calls` (by
    default `manifests()`, a replay being one frame): from the first event
    on, the longest manifest whose
    names equal the next events' is matched there, and its paths attributed
    to them; an event where none matches is left unattributed (work
    launched outside them: a batch's copies between replays, the caller's
    own). A session after a process's first misses its first device ops,
    so the window's first matched frame may lack its first ops: there, a
    manifest's last ops (at least half of them) may match instead. The
    attribution is ok only where the matched replays are `frames` frames."""
    calls = sorted(manifests() if calls is None else calls, key=lambda m: -len(m.ops))
    ops = sorted(ops, key=lambda o: (o[1], o[2]))
    names = [o[0] for o in ops]
    seconds: dict = {}
    loose, matched, note, lost = [], 0, "", 0

    def at(i: int, m: Manifest, j: int) -> bool:
        """Whether m's ops from j on are the events from i on."""
        n = len(m.ops) - j
        return n > 0 and i + n <= len(ops) and all(
            names[i + k] == m.ops[j + k][0] for k in range(n))

    i = 0
    while i < len(ops):
        for m in calls:
            j = 0
            if not at(i, m, 0):
                if matched:
                    continue
                j = next((j for j in range(1, len(m.ops) // 2 + 1) if at(i, m, j)), 0)
                if not j:
                    continue
                lost = j
            for k in range(len(m.ops) - j):
                path = m.ops[j + k][1]
                if path:
                    seconds[path] = seconds.get(path, 0.0) + ops[i + k][2] - ops[i + k][1]
                else:
                    loose.append(ops[i + k][1:])
            matched += 1
            i += len(m.ops) - j
            break
        else:
            if matched and not note:
                note = f"after frame {matched}, no manifest matches device event {i} ({names[i]})"
            loose.append(ops[i][1:])
            i += 1
    ok = matched == frames and frames > 0
    if not ok:
        note = (f"the matched replays rendered {matched} frames of the window's {frames}; "
                f"{note or 'none matched'}" if calls else "no manifest was recorded")
    return Attribution(seconds, _union_s(loose), _union_s(o[1:] for o in ops),
                       matched, ok, "" if ok else note, lost)
