"""The traced window: torch.profiler over a few frames, reduced to device
events, and the readings the per-layer readers share.

Layer attribution rests on one convention of the program: a hand-written
kernel of a layer lives in that layer's C++ namespace (csrc/shade.cu `rs`,
csrc/candidates.cu `rc`, csrc/raster_kernel.cu and csrc/layers.cu `rt`,
csrc/frontend.cu `rf`), so its demangled name holds `<ns>::`. Every other
device event (PyTorch's kernels, copies, memsets) is a torch op."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

#: host labels the harness puts around its own calls; an idle gap on the
#: device is named by the label the host was inside
LABEL_PREFIX = "bench."


def label(name: str):
    """A host span of the harness's own (a no-op outside a profiler)."""
    return torch.profiler.record_function(name)


class Profiler:
    """torch.profiler on the host and the device from now until `stop`,
    which returns the window's events."""

    def __init__(self, device: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> list:
        self._prof.__exit__(None, None, None)
        return events_of(self._prof.events())


@dataclass(frozen=True)
class Event:
    name: str
    start: float  # seconds
    end: float
    device: bool


def events_of(function_events) -> list:
    """Device events (kernels, copies, memsets) and the harness's host
    labels of a profiler's event list, in seconds. The profiler also puts
    each host label on the device's timeline, spanning the work launched
    inside it; those are no device work and are left out."""
    out = []
    for e in function_events:
        label = e.name.startswith(LABEL_PREFIX)
        dev = e.device_type == torch.autograd.DeviceType.CUDA
        if dev != label:
            out.append(Event(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6, dev))
    return out


def union(intervals: list) -> list:
    """Merged [start, end] intervals of a list, in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


@dataclass
class Window:
    """The device side of a traced window: from its first device event's
    start to its last one's end; `frames` frames ran in it."""

    events: list
    frames: int
    host_s: list = field(default_factory=list)
    work: dict = field(default_factory=dict)
    peaks: dict | None = None

    def __post_init__(self):
        self.device = [e for e in self.events if e.device]
        self.labels = [e for e in self.events if not e.device]
        self.busy = union([(e.start, e.end) for e in self.device])
        self.start = self.busy[0][0] if self.busy else 0.0
        self.end = self.busy[-1][1] if self.busy else 0.0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def ns_time(self, ns: str) -> float:
        """Device seconds of the kernels in C++ namespace `ns`, their
        intervals merged."""
        pat = re.compile(rf"\b{re.escape(ns)}::")
        return sum(e - s for s, e in union([(x.start, x.end) for x in self.device
                                             if pat.search(x.name)]))

    def time_outside(self, namespaces: tuple) -> float:
        """Device seconds of every event in none of `namespaces`."""
        pats = [re.compile(rf"\b{re.escape(ns)}::") for ns in namespaces]
        return sum(e - s for s, e in union([(x.start, x.end) for x in self.device
                                             if not any(p.search(x.name) for p in pats)]))

    def roofline(self, work: str, ns: str) -> float | None:
        """Percent of the least time the chip could take for the work of
        `work` (benchmark/work/<work>.py, per frame, the mean of the checked
        frames times the window's frames; a step's least time the larger of
        its operations at the FP32 peak and its bytes at the bandwidth
        peak) over the device time of namespace `ns`. None where the
        namespace ran nothing, the work was not counted or the card has no
        peaks in the table."""
        t = self.ns_time(ns)
        frames = self.work.get(work)
        if not t or not frames or not self.peaks:
            return None
        per_frame = [sum(max(ops / self.peaks["flops_per_s"], b / self.peaks["bytes_per_s"])
                         for _name, ops, b in steps) for steps in frames]
        return 100.0 * sum(per_frame) / len(per_frame) * self.frames / t

    def breakdown(self) -> dict:
        """The device ops that took most time (by name, summed), and the
        longest idle gaps, each named by the host label it fell in."""
        by_name: dict = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        for (_, a), (b, _) in zip(self.busy, self.busy[1:]):
            mid = (a + b) / 2
            inside = [x for x in self.labels if x.start <= mid <= x.end]
            name = min(inside, key=lambda x: x.end - x.start).name if inside else "none"
            gaps.append((name, b - a))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:10]]}
