"""The program's own spans in a traced window (renderer_tpu_torch.engine.
profiling), for the per-layer readers that put time down to its stages.

Importing this module switches the program's device tracing on for the
whole process (`switch_on`), with its spans named under the harness's
label prefix (`PREFIX`). The readings rest on the order in which
benchmark/harness.py `run` works: it loads the readers of a traced run,
and so this module, before it builds the Cell, so that the graphs the
Cell captures keep their manifests; a graph captured before the import
keeps none, and its window reads null. It loads no reader in a run with
`--trace 0`, which runs as if this module did not exist. A test that
imports this module switches tracing off again where it is done
(benchmark/test_bench_spans.py). Under that prefix the harness's trace treats
each program span as it treats its own labels: the host copy is a label,
so `Window.breakdown` names each idle gap by the innermost program span,
and the copy the profiler puts on the device's timeline is left out of
the device events, so no existing reading moves.

Device time is put down to spans by the program's manifests
(profiling.attribute): the device events of the window, in order, are
matched name for name to a graph's manifest, a replay a frame; the copies
a batch makes between replays match none and count as unattributed. Where
the matched replays are not the window's frames, the attribution is null,
and standard error says why. Eager frames are not recorded (the program's
own profiler session would come before the harness's and skew it), so the
interactive cell has host readings only.

Against a program without device tracing every reading here is None."""

from __future__ import annotations

import sys

from benchmark import trace

#: the program's spans' prefix on torch.profiler's timeline: inside the
#: harness's label prefix
PREFIX = trace.LABEL_PREFIX + "renderer/"

try:
    from renderer_tpu_torch.engine import profiling as _profiling
except ImportError:  # pragma: no cover - the benchmark always has the program
    _profiling = None
if not hasattr(_profiling, "trace_device"):
    _profiling = None


def switch_on() -> None:
    """The program's device tracing on, its spans under PREFIX (at import)."""
    if _profiling is not None:
        _profiling.trace_device(True, prefix=PREFIX)


switch_on()

#: the attribution of each window read, by id (with the window, which keeps
#: its id from being reused)
_attributions: dict = {}


def host_ms(w, parent: str, stage: str) -> float | None:
    """Host ms a frame in the spans `parent/<stage>` (a stage name, or a
    prefix of names ending in "."), the labels of the window's frames."""
    want = PREFIX + parent + "/"
    total, found = 0.0, False
    for x in w.labels:
        if x.name.startswith(want):
            name = x.name[len(want):]
            if "/" not in name and (name == stage or stage.endswith(".")
                                    and name.startswith(stage)):
                total += x.end - x.start
                found = True
    return 1e3 * total / w.frames if found and w.frames else None


def attribution(w):
    """The program's attribution of the window's device events (None where
    the program has none, or it is not whole)."""
    if _profiling is None or not w.device:
        return None
    held = _attributions.get(id(w))
    if held is None or held[0] is not w:
        a = _profiling.attribute([(e.name, e.start, e.end) for e in w.device], w.frames)
        if not a.ok:
            print(f"benchmark: no attribution of the device events to spans: {a.note}",
                  file=sys.stderr)
        held = _attributions[id(w)] = (w, a if a.ok else None)
    return held[1]


def device_ms(w, *stages: str) -> float | None:
    """Device ms a frame in the spans named `stages` (at any depth)."""
    a = attribution(w)
    return None if a is None else 1e3 * a.stage_seconds(*stages) / w.frames


def unattributed_pct(w) -> float | None:
    """Percent of the busy device time under no span of the program."""
    a = attribution(w)
    return None if a is None or a.busy_s <= 0 else 100.0 * a.unattributed_s / a.busy_s


def setup_s(*names: str) -> float | None:
    """Host seconds of the program's set-up spans named `names`, summed;
    None where it recorded none of them."""
    if _profiling is None:
        return None
    spans = [r for r in _profiling.setup_spans() if r.name in names]
    return sum(r.seconds for r in spans) if spans else None
