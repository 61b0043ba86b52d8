"""The port's bench (renderer_tpu_torch/tools/bench.py) on the CPU, against
the JAX package's bench.py:

- run(..., device="cpu") prints one JSON line with every key of bench.py's
  line and the port's own, no drops, overflow_checked true, "cpu" as the
  device; the last timed frame equals Renderer.render_frame of the same
  scene and DrawList bit for bit (the triangle, and the mini-sandbox with
  its "Performance stats" window);
- without a card and without device="cpu" the bench exits non-zero and
  prints no JSON;
- a scene named explicitly never falls back (Sponza without its assets
  raises); "default" falls back to the triangle, as bench.py does;
- the port's verify of the default scene at 1920×1080 over 3 frames equals
  the last line of `python bench.py 3 --verify` (the JAX verifier, on the
  CPU) key for key.

On the CPU a frame of the mini-sandbox takes seconds, so these runs take
one warm-up frame and one pass (bench.WARMUP, bench.PASSES) and the
mini-sandbox the fast sampler; tests/test_torch_cuda_kernels.py runs the
bench as it stands on the card.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_parity  # noqa: F401 — one torch thread a worker

ROOT = Path(__file__).resolve().parents[1]
# bench.py's keys (bench.py:434-445) and the port's
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "dropped_pairs", "dropped_rows",
            "overflow_checked", "measures"}
KEYS = JAX_KEYS | {"scene", "frames", "passes_fps", "frame_ms", "dropped_other",
                   "shade_clamped_px", "device"}


@pytest.fixture
def bench(monkeypatch):
    from renderer_tpu_torch.tools import bench

    monkeypatch.setattr(bench, "WARMUP", 1)
    monkeypatch.setattr(bench, "PASSES", 1)
    return bench


@pytest.mark.parametrize("scene", ["triangle", "mini-sandbox"])
def test_cpu_run_prints_every_key_and_its_last_frame_is_render_frames(bench, scene):
    out = io.StringIO()
    result = bench.run(2, scene=scene, fast=scene == "mini-sandbox", device="cpu",
                       width=160, height=96, out=out)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == KEYS and line == result.line
    assert (line["dropped_pairs"], line["dropped_rows"], line["dropped_other"]) == (0, 0, 0)
    assert line["overflow_checked"] is True and not result.dropped
    assert line["device"] == {"name": "cpu", "power_limit_w": None,
                              "count": torch.cuda.device_count()}
    assert line["measures"] == "CPU run, not a device number"
    assert line["unit"] == "fps" and line["vs_baseline"] == line["value"] / 60.0
    assert line["scene"] == scene and line["frames"] == 2 and len(line["passes_fps"]) == 1
    assert line["value"] == line["passes_fps"][0] > 0
    assert line["frame_ms"]["n"] == 1 and line["frame_ms"]["median"] > 0
    assert "-96p" in line["metric"] and line["metric"].endswith(" eager frame loop")
    sc, ui = result.frames[-1]
    assert (ui is not None) == (scene == "mini-sandbox")
    want = result.renderer.render_frame(sc, 0, ui=ui)
    np.testing.assert_array_equal(result.images.cpu().numpy(), want)
    assert want.std() > 5.0


def test_without_a_card_the_bench_exits_nonzero_and_prints_no_json(bench):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "renderer_tpu_torch.tools.bench", "2",
                           "--scene", "triangle"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 2 and "{" not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.. is False"):
        bench.run(2, scene="triangle", out=io.StringIO())


def test_an_explicit_scene_never_falls_back(bench, capsys):
    from renderer_tpu_torch.apps import sandbox

    if sandbox.SPONZA.exists():
        pytest.skip("the Sponza assets are present")
    with pytest.raises(FileNotFoundError, match="Sponza.gltf"):
        bench.run(1, scene="sponza", device="cpu", width=160, height=96, out=io.StringIO())
    assert "falling back" not in capsys.readouterr().err
    got = bench.verify(1, scene="default", device="cpu", width=160, height=96)
    assert got["metric"] == "triangle-96p"
    assert "falling back to triangle" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unknown scene 'sandbox'"):
        bench.verify(1, scene="sandbox", device="cpu")


def test_verify_equals_the_jax_bench_verify():
    """bench.py's verifier unchanged, in a process of its own on the CPU
    (it writes nothing into the tree), against the port's in this one, on
    the same timeline (WARMUP 3 frames, then 3)."""
    from renderer_tpu_torch.tools import bench

    proc = subprocess.run([sys.executable, "bench.py", "3", "--verify"], cwd=ROOT,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = bench.verify(3, device="cpu")
    if got["metric"] != want["metric"]:
        pytest.skip(f"the JAX bench verified {want['metric']}, the port {got['metric']}")
    assert set(got) == set(want) and all(type(got[k]) is type(want[k]) for k in want)
    assert got == want
