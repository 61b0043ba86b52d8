"""The port's frame tools on the CPU (renderer_tpu_torch/tools): the frame
capture and the synthetic binning workload against the JAX package's tools,
stress_run and flythrough_run, and the two host probes.

Tolerances:
- frame_capture of the triangle scene at 160×96: capture.json equal and
  every dump's pixels equal. (K1's plain version rounds each product and
  sum where XLA:CPU contracts the plane evaluation in the interpreted
  kernel, tests/test_torch_raster.py; on this scene no pixel lies in that
  rounding band.)
- binning_scaling's workload: the clip arrays bit-equal (the same numpy
  stream), the triangle count, the setup rows and the binning demand equal.
"""

import io
import json

import numpy as np
import pytest
import torch

import renderer_tpu as jrt
import renderer_tpu_torch as trt
from renderer_tpu_torch.assets import demo_scenes, png
from renderer_tpu_torch.raster.pipeline import STAT_NAMES
from renderer_tpu_torch.tools import binning_scaling as tbs
from renderer_tpu_torch.tools import (
    flythrough_run,
    frame_capture,
    native,
    prologue_probe,
    startup_probe,
    stress_run,
)
from tests import torch_parity  # noqa: F401  (one torch thread)
from tests.torch_parity import H, W

# the cheapest sampler (one tap a sample, sRGB decoded after filtering):
# these tests check the tools, and tests/test_torch_stages.py holds the
# samplers to JAX's
CHEAP = dict(srgb_per_tap=False, aniso_samples=1)


def _pixels(path):
    """A dump as the array written: grey dumps 2-D, colour dumps RGB."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(path.read_bytes())))


def test_capture_triangle_equals_jax(tmp_path):
    from tools.frame_capture import capture as jax_capture

    jax_capture(tmp_path / "jax", "triangle",
                config=jrt.RenderConfig(width=W, height=H, **CHEAP))
    summary = frame_capture.capture(tmp_path / "port", "triangle",
                                    config=trt.RenderConfig(width=W, height=H, **CHEAP),
                                    device="cpu")
    want = json.loads((tmp_path / "jax" / "capture.json").read_text())
    got = json.loads((tmp_path / "port" / "capture.json").read_text())
    assert got == want
    assert {k: v for k, v in summary.items() if k not in ("dumps", "buffers")} == got
    assert got["stats"]["total_pairs"] == sum(got["pairs_per_class"]) > 0
    for name in frame_capture.DUMPS[:4]:
        a, b = _pixels(tmp_path / "jax" / name), _pixels(tmp_path / "port" / name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
        np.testing.assert_array_equal(summary["dumps"][name], b, err_msg=name)


def test_capture_of_the_mini_sandbox_writes_both_demand_maps(tmp_path):
    """All three alpha classes through the capture's own K1 and K2 calls:
    every dump decodes (assets/png.py) to the array written, and the
    demand and visibility dumps are what the re-run's buffers give."""
    cfg = trt.RenderConfig(width=W, height=H, **CHEAP)
    summary = frame_capture.capture(tmp_path, "sandbox", 0.4, config=cfg,
                                    sandbox=demo_scenes.MiniSandbox(), device="cpu")
    assert summary["layer_demand_maps"] == {"masked": "04-mask-demand.png",
                                            "blended": "05-blend-demand.png"}
    # total_pairs is the ragged pair demand: the binned pairs plus those
    # binning's per-pair extent test drops (none here)
    pairs, rows = (int(d) for d in summary["buffers"]["demand"])
    assert [summary["stats"]["total_pairs"], summary["stats"]["total_rows"]] == [pairs, rows]
    assert 0 < sum(summary["pairs_per_class"]) <= pairs
    assert len(summary["pairs_per_class"]) == 3 and min(summary["pairs_per_class"]) > 0
    assert summary["overflow_per_class"] == [0, 0, 0]
    for name, arr in summary["dumps"].items():
        decoded = png.decode_png((tmp_path / name).read_bytes())
        np.testing.assert_array_equal(decoded[..., 0] if arr.ndim == 2 else decoded[..., :3],
                                      arr, err_msg=name)
    assert sorted(summary["dumps"]) == list(frame_capture.DUMPS)
    buffers = summary["buffers"]
    for mode, name in (("masked", "04-mask-demand.png"), ("blended", "05-blend-demand.png")):
        cls, n_layers, (_lz, _lt, aux) = buffers[mode]
        demand = aux[0, :H, :W].numpy()
        assert demand.max() >= 1, mode
        np.testing.assert_array_equal(summary["dumps"][name],
                                      frame_capture._gray(demand, lo=0.0))
    _zs, ts = buffers["k1"]
    np.testing.assert_array_equal(summary["dumps"]["01-visibility.png"],
                                  frame_capture._hash_colors(ts[0, :H, :W].numpy()))


def test_binning_workload_equals_jax():
    from tools import binning_scaling as jbs

    jclip, jtri = jbs._make_tri_data(700, 1920, 1088, np.random.default_rng(5))
    tclip, ttri = tbs._make_tri_data(700, 1920, 1088, np.random.default_rng(5), device="cpu")
    assert np.asarray(jclip).tobytes() == tclip.numpy().tobytes()
    assert np.asarray(jtri).tobytes() == ttri.numpy().tobytes()

    grid = (tbs.GRID["tiles_x"], tbs.GRID["tiles_y"], tbs.GRID["tile_w"], tbs.GRID["tile_h"])
    jtd, jn = jbs.synthetic_tri_data(12000, *grid)
    ttd, tn = tbs.synthetic_tri_data(12000, *grid, device="cpu")
    assert tn == jn > 0
    np.testing.assert_array_equal(ttd.numpy(), np.asarray(jtd))
    from renderer_tpu.raster import binning as jbin
    from renderer_tpu_torch.raster import binning as tbin

    kw = dict(tbs.GRID, pair_capacity=1 << 15, row_capacity=1 << 15)
    jb = jbin.bin_triangle_classes(jtd, (0, jn), **kw)
    tb = tbin.bin_triangle_classes(ttd, (0, tn), **kw)
    for i in (2, 3, 4, 5, 6):  # counts, overflow, row overflow, demands
        np.testing.assert_array_equal(tb[i].numpy(), np.asarray(jb[i]))
    assert 0.75 * 12000 <= int(tb[5]) <= 1.25 * 12000


def test_binning_scaling_rows_on_the_cpu():
    rows = tbs.scaling(reps=1, device="cpu", capacities=(1 << 14,))
    (row,) = rows
    assert row["pair_capacity"] == 1 << 14 and row["overflow"] == 0
    assert abs(row["actual_pairs"] / (tbs.FILL * (1 << 14)) - 1) <= 0.25
    assert min(row["binning_ms"], row["binning_host_paced_ms"], row["sort_ms"]) > 0


def test_stress_run_reads_last_stats_after_its_loop(tmp_path):
    out = stress_run.main(1, str(tmp_path / "stress.png"), "cpu", width=W, height=H,
                          n_meshes=2, tris_per_mesh=128, pair_capacity=1 << 14,
                          row_capacity=1 << 14, **CHEAP)
    assert out["stats"]["total_pairs"] > 0 and out["stats"]["row_overflow"] == 0
    assert list(out["stats"]) == list(STAT_NAMES)
    img = png.decode_png((tmp_path / "stress.png").read_bytes())
    np.testing.assert_array_equal(img[..., :3], out["image"])


def test_renderer_last_stats_is_the_last_frame_without_a_copy():
    registry, scene = demo_scenes.triangle_scene()
    r = trt.Renderer(registry, trt.RenderConfig(width=W, height=H), device="cpu")
    assert r.last_stats is None
    r.render_frame_device(scene)
    assert isinstance(r.last_stats, torch.Tensor) and r.last_stats is r._last_stats
    assert r.last_stats.tolist() == list(r.frame_stats().values())


def test_flythrough_run_on_the_mini_sandbox():
    out = flythrough_run.main(sandbox=demo_scenes.MiniSandbox(), k=1, rounds=1, reps=1,
                              device="cpu", width=W, height=H, msaa_samples=1, **CHEAP)
    assert out["ms_per_frame"] > 0 and out["fps"] == pytest.approx(1000 / out["ms_per_frame"])
    assert out["stats"].shape == (1, len(STAT_NAMES))


def test_prologue_probe_prints_its_keys(capsys):
    out = prologue_probe.main(reps=3, sandbox=demo_scenes.MiniSandbox(), device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert set(out) == {"build_scene_us", "frame_view_us", "pack_blob_us", "camera_us",
                        "full_prologue_us", "draws", "scene_source", "host_library"}
    assert out["draws"] == 7 and out["scene_source"] == "MiniSandbox"
    assert out["host_library"] == native.status()["path"]
    assert all(out[k] > 0 for k in out if k.endswith("_us"))


def test_startup_probe_prints_its_stages(capsys):
    out = startup_probe.main("warm", device="cpu", width=W, height=H)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert out["cuda_init_s"] is None and out["kernel_build_s"] is None  # no card here
    assert out["nvcc_s"] is None
    for k in ("torch_import_s", "package_import_s", "load_gltf_s", "atlas_s",
              "first_frame_s"):
        assert out[k] > 0, k
    assert out["total_s"] == pytest.approx(sum(
        out[k] for k in ("torch_import_s", "package_import_s", "load_gltf_s",
                         "atlas_s", "first_frame_s")))
    with pytest.raises(ValueError, match="cold or warm"):
        startup_probe.main("lukewarm", device="cpu")
