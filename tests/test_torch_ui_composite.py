"""The fused UI shade and composite (ui_stage.shade_composite_ui, the fused
S3 on the card) on the CPU, where it runs its plain version.

- Against the JAX package: JAX's shade_ui_layer, then the pipeline's
  composite loop (renderer_tpu/raster/pipeline.py:513-528), op by op and
  not jitted, on the "Performance stats" window of sandbox-golden.npz at
  320×192, 4×MSAA, with ui_msaa off and on. The tolerance is
  tests/test_torch_ui.py's for the UI shade's alpha (2^-16, and 1e-6 on
  all but 2% of the pixels a live layer covers): XLA's batched dot rounds
  the uv sum differently, and the composite moves an alpha difference into
  hdr scaled by |rgb − hdr| ≤ 1.
- The plain version is exactly shade_ui_layer_plain followed by the loop
  the pipeline ran before the fusion, bit for bit, also on HDR values the
  loop treats specially (−0.0, NaN, ±inf), and it updates the samples in
  place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import renderer_tpu as jrt
from renderer_tpu.raster import ui_stage as jstage
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.raster import pipeline
from renderer_tpu_torch.raster import ui_stage as tstage
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS
from tests import torch_parity  # noqa: F401 — one torch thread a worker
from tests.test_sandbox_golden import _perf_window_drawlist

W, H = 320, 192
MSAA = 4


@pytest.fixture(scope="module")
def perf_case():
    """The golden's "Performance stats" window, packed, with the registry's
    materials as numpy."""
    registry = jrt.MaterialRegistry()
    packed = _perf_window_drawlist(registry).pack()
    cfg = jrt.RenderConfig(width=W, height=H, msaa_samples=MSAA, ui_layers=4)
    mats = {k: np.asarray(v) for k, v in jrt.Renderer(registry, cfg)._materials().items()}
    return packed, mats


def _hdr(seed: int, shape) -> list[np.ndarray]:
    """MSAA samples of HDR values in [0, 2), a few of them −0.0, NaN and ±inf."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(MSAA):
        h = (rng.random(shape, dtype=np.float32) * 2).astype(np.float32)
        flat = h.reshape(-1)
        idx = rng.choice(flat.size, 64, replace=False)
        flat[idx[:16]] = -0.0
        flat[idx[16:32]] = np.nan
        flat[idx[32:48]] = np.inf
        flat[idx[48:]] = -np.inf
        out.append(h)
    return out


def _layers(packed, ui_msaa: bool):
    """The UI's layer ids from both packages (equal), and the two configs."""
    jcfg = jrt.RenderConfig(width=W, height=H, msaa_samples=MSAA, ui_layers=4,
                            ui_msaa=ui_msaa)
    import renderer_tpu_torch as trt

    tcfg = trt.RenderConfig(width=W, height=H, msaa_samples=MSAA, ui_layers=4,
                            ui_msaa=ui_msaa)
    spos = STANDARD_SAMPLE_POSITIONS[MSAA if ui_msaa else 1]
    kw = dict(local_tiles_y=jcfg.tiles_y, tile_row_offset=0, sample_positions=spos)
    jlt, _, _ = jstage.rasterize_ui({k: jnp.asarray(v) for k, v in packed.items()},
                                    config=jcfg, interpret=True, **kw)
    tlt, _, _ = tstage.rasterize_ui(from_numpy_arrays(packed, device="cpu"), config=tcfg, **kw)
    assert np.array_equal(np.asarray(jlt), tlt.numpy())
    return (jlt if ui_msaa else jlt[0]), (tlt if ui_msaa else tlt[0]), jcfg, tcfg


def _loop(hdr: list, rgb, alpha, one: float = 1.0) -> list:
    """The pipeline's composite loop before the fusion (rebinding, as the
    JAX package's pipeline writes it), on either package's arrays."""
    hdr = list(hdr)
    per_sample = alpha.ndim == 4
    for k in range(alpha.shape[-3]):
        for s in range(len(hdr)):
            a_k = (alpha[s, k] if per_sample else alpha[k])[..., None]
            rgb_k = rgb[s, k] if per_sample else rgb[k]
            hdr[s] = hdr[s] * (one - a_k) + rgb_k * a_k
    return hdr


@pytest.mark.parametrize("ui_msaa", [False, True])
def test_composite_matches_jax(perf_case, ui_msaa):
    packed, mats = perf_case
    jlt, tlt, jcfg, tcfg = _layers(packed, ui_msaa)
    row0 = np.zeros((jcfg.padded_height, 1), np.float32)
    hdr = _hdr(5, (jcfg.padded_height, jcfg.padded_width, 3))
    jrgb, ja = jstage.shade_ui_layer(jlt, {k: jnp.asarray(v) for k, v in packed.items()},
                                     {k: jnp.asarray(v) for k, v in mats.items()},
                                     config=jcfg, row0=jnp.asarray(row0))
    want = [np.asarray(h) for h in _loop([jnp.asarray(h) for h in hdr], jrgb, ja)]
    got = [torch.from_numpy(h.copy()) for h in hdr]
    before = pipeline.launch_counts()["ui_composite"]
    tstage.shade_composite_ui(got, tlt, from_numpy_arrays(packed, device="cpu"),
                              from_numpy_arrays(mats, device="cpu"), config=tcfg,
                              row0=torch.from_numpy(row0))
    assert pipeline.launch_counts()["ui_composite"] == before  # the plain version launches nothing
    live = np.asarray(ja).max(axis=-3) > 0  # [.., H, W]: a live layer covers the pixel
    assert live.sum() > 1000
    for s, (g, w) in enumerate(zip(got, want, strict=True)):
        g = g.numpy()
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan)
        with np.errstate(invalid="ignore"):  # inf - inf where both are inf
            err = np.where((g == w) | nan, 0, np.abs(g - w))
        assert err.max() <= 2.0**-16, s
        lv = live[s] if ui_msaa else live
        assert (err[lv] <= 1e-6).mean() >= 0.98, s
        assert (err[~lv] == 0).all(), s  # no live layer: hdr comes back as JAX's


@pytest.mark.parametrize("ui_msaa", [False, True])
def test_plain_is_shade_then_loop_in_place(perf_case, ui_msaa):
    packed, mats = perf_case
    _jlt, tlt, _jcfg, tcfg = _layers(packed, ui_msaa)
    ui = from_numpy_arrays(packed, device="cpu")
    tmats = from_numpy_arrays(mats, device="cpu")
    row0 = torch.zeros((tcfg.padded_height, 1))
    hdr = [torch.from_numpy(h) for h in _hdr(6, (tcfg.padded_height, tcfg.padded_width, 3))]
    rgb, a = tstage.shade_ui_layer_plain(tlt, ui, tmats, row0=row0)
    want = _loop(hdr, rgb, a)
    got = [h.clone() for h in hdr]
    ptrs = [h.data_ptr() for h in got]
    tstage.shade_composite_ui_plain(got, tlt, ui, tmats, row0=row0)
    assert [h.data_ptr() for h in got] == ptrs
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    # the samples' −0.0 that the loop turns +0.0 under a layer of rgb ≥ +0
    neg0 = [(h.view(torch.int32) == -2**31) for h in hdr]
    assert any(((g.view(torch.int32) == 0) & n).any() for g, n in zip(got, neg0))


def test_composite_refuses_other_devices(perf_case):
    packed, mats = perf_case
    lt = torch.zeros((4, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tstage.shade_composite_ui([], lt, {}, {}, config=None, row0=None)
