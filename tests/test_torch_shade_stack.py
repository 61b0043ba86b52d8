"""The deferred-shading stage's entry points on the CPU (their plain
versions) against the JAX package, on identical numpy inputs at 160×96:
shade.shade_stack against shade_interpolated, shade.alpha_stack against
base_alpha, ui_stage.shade_ui_layer against the JAX shade_ui_layer. On the
card the same entry points launch kernels S1, S2 and S3 (csrc/shade.cu),
held to these plain versions by tests/test_torch_cuda_kernels.py.

Inputs: the "sandbox-static" scene's geometry and materials, its vertex
stage run once by the port and handed to both packages, and a stack of two
candidate maps rasterized by the port (MSAA samples 0 and 3) with -2
sentinels cut into it. Its materials are changed so that every texture slot
is sampled: material 0 takes the checker as its emissive texture (the lit
emissive branch), material 1 as every slot with no emissive factor (normal
mapping, roughness/metalness, occlusion).

Tolerance, as tests/test_torch_stages.py's shade: ≤ 2^-12 absolute on
every value, ≥ 99.9% within 2^-18 (sRGB pow, log2 mip selection and the
sin hash differ by a few ULP between the two libraries), cutoffs equal.
alpha_stack (S2) gives +0.0 alpha and cutoff at the uncovered (-1, -2)
elements, whose values no later step reads, where base_alpha shades
triangle 0: its alpha is compared with base_alpha's at the covered
elements, its cutoff in full with base_alpha's masked.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.raster import shade as jshade
from renderer_tpu.raster import ui_stage as jstage
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.raster import (
    binning,
    raster_kernel,
    setup,
    shade,
    ui_stage,
    vertex_stage,
)
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS, _shade_striped
from renderer_tpu_torch.scene import draw_stream
from tests.torch_parity import host_inputs

TEXTURED = 5  # the checker's texture slot in "sandbox-static"
# (trilinear, aniso, srgb_per_tap): RenderConfig's default (exact) sampler,
# fast_sampler(), and the one-tap trilinear and nearest-mip branches
SAMPLERS = {"exact": (True, 16, True), "fast": (True, 4, False),
            "trilinear": (True, 1, False), "nearest-mip": (False, 1, False)}
WRAPS = {"repeat": 0, "clamp": 1, "mirror": 2}


def _close(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    err = np.abs(want - got)
    assert err.max() <= 2.0**-12, err.max()
    assert (err <= 2.0**-18).mean() >= 0.999, (err <= 2.0**-18).mean()


@pytest.fixture(scope="module")
def case():
    geom, mats, blob, static, cfg = host_inputs("sandbox-static")
    mats = dict(mats)
    tex = mats["tex_indices"].copy()
    eo = mats["emissive_occlusion"].copy()
    tex[0, 4] = TEXTURED
    tex[1, 1:] = TEXTURED
    eo[1, :3] = 0.0
    mats["tex_indices"], mats["emissive_occlusion"] = tex, eo
    tgeom = from_numpy_arrays(geom, device="cpu")
    frame = draw_stream.unpack_frame({"blob": torch.from_numpy(blob)},
                                     morph_k=static["morph_k"],
                                     joint_cap=static["joint_cap"])
    vs = vertex_stage.run_vertex_stage(tgeom, frame, static["skin_start"])
    # the candidate stack: the port's K1 plain version at samples 0 and 3
    spos = STANDARD_SAMPLE_POSITIONS[cfg.msaa_samples]
    td = setup.triangle_setup(vs["clip"], tgeom["tri_v"], frame["num_tris"],
                              cfg.width, cfg.height, bbox_pad=0.5)
    b, s, c, _ov, _r, _p, _d = binning.bin_triangle_classes(
        td, (0, int(frame["num_tris"])), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, pair_capacity=1 << 12)
    _z, tid = raster_kernel.rasterize_binned(
        b, s[0], c[0], padded_height=cfg.padded_height,
        padded_width=cfg.padded_width, sample_positions=spos)
    stack = tid[[0, 3], : cfg.height, : cfg.width].contiguous()
    stack[1, ::7, ::5] = -2
    assert (stack >= 0).float().mean() > 0.1 and (stack == -1).any()
    return dict(cfg=cfg, geom=geom, mats=mats, tgeom=tgeom, frame=frame, vs=vs,
                tid=stack)


def _inputs(c, *, wrap=None, mode=0, uv_scale=None):
    """(torch args, JAX args) of one call: the same numpy data for both."""
    mats = dict(c["mats"])
    if wrap is not None:
        mats["atlas_wrap"] = np.full((mats["atlas_table"].shape[0], 2), wrap, np.int32)
    vs = dict(c["vs"])
    if uv_scale is not None:  # uvs across several periods (the wrap modes)
        vs["uv"] = vs["uv"] * uv_scale - 1.0
    frame = {"material_id": c["frame"]["material_id"].contiguous(),
             "debug_id": c["frame"]["debug_id"].contiguous(),
             "debug_mode": torch.tensor(mode, dtype=torch.int32)}
    tmats = from_numpy_arrays(mats, device="cpu")
    j = {k: {n: jnp.asarray(np.asarray(v)) for n, v in d.items()}
         for k, d in (("geom", c["geom"]), ("mats", mats),
                      ("vs", {n: t.numpy() for n, t in vs.items()}),
                      ("frame", {n: t.numpy() for n, t in frame.items()}))}
    return (c["tgeom"], vs, frame, tmats), (j["geom"], j["vs"], j["frame"], j["mats"])


def _jax_stage(sampler, tid, row0, geom, vs, frame, mats):
    """shade_interpolated and base_alpha of the JAX package, op by op (its
    jitted XLA contracts multiply-adds into FMAs, which moves the mip and
    texel coordinates by more than the tolerance)."""
    trilinear, aniso, per_tap = SAMPLERS[sampler]
    it = jshade.interpolants(tid, geom, vs, width=160, height=96, row0=row0)
    color = jshade.shade_interpolated(it, vs, frame, mats, trilinear, aniso, per_tap)
    return (color, *jshade.base_alpha(it, frame, mats, trilinear, aniso, per_tap))


def _compare(c, sampler, *, row0=None, **kw):
    (tgeom, vs, frame, tmats), jargs = _inputs(c, **kw)
    trilinear, aniso, per_tap = SAMPLERS[sampler]
    tid = c["tid"]
    if row0 is None:
        row0 = torch.zeros((tid.shape[1], 1))
    skw = dict(width=160, height=96, trilinear=trilinear, aniso=aniso,
               srgb_per_tap=per_tap)
    color = shade.shade_stack(tid, row0, tgeom, vs, frame, tmats, **skw)
    alpha, cutoff = shade.alpha_stack(tid, row0, tgeom, vs, frame, tmats, **skw)
    jc, ja, jco = _jax_stage(sampler, jnp.asarray(tid.numpy()),
                             jnp.asarray(row0.numpy()), *jargs)
    covered = (tid >= 0).numpy()
    _close(jc, color.numpy())
    _close(np.asarray(ja)[covered], alpha.numpy()[covered])
    np.testing.assert_array_equal(np.where(covered, np.asarray(jco), 0), cutoff.numpy())
    return color, alpha, cutoff


@pytest.mark.parametrize("sampler", ["exact", "fast"])
def test_stack_matches_jax(case, sampler):
    """Both samplers, lit mode, no wrap table; background (-1) and -2
    candidates shade to (0, 0, 0, 0), and their alpha and cutoff are +0.0
    (no later step reads them; base_alpha's value is compared at the
    covered elements)."""
    color, alpha, cutoff = _compare(case, sampler)
    neg = (case["tid"] < 0).numpy()
    assert (case["tid"] == -2).any()
    assert not color.numpy()[neg].any() and color.numpy()[~neg].any()
    for t in (alpha, cutoff):
        assert not t.numpy()[neg].view(np.int32).any()  # +0.0 in bits
    assert alpha.numpy()[~neg].any()


def test_alpha_stack_plain_is_base_alpha_where_covered(case):
    """alpha_stack_plain at 160×96, every sampler: the port's own base_alpha
    over interpolants bit for bit at the covered elements, +0.0 (in bits)
    alpha and cutoff at the -1 and -2 ones."""
    (tgeom, vs, frame, tmats), _ = _inputs(case)
    tid, row0 = case["tid"], torch.zeros((case["tid"].shape[1], 1))
    covered = tid >= 0
    it = shade.interpolants(tid, tgeom, vs, width=160, height=96, row0=row0)
    for trilinear, aniso, per_tap in SAMPLERS.values():
        alpha, cutoff = shade.alpha_stack_plain(
            tid, row0, tgeom, vs, frame, tmats, width=160, height=96,
            trilinear=trilinear, aniso=aniso, srgb_per_tap=per_tap)
        ba, bco = shade.base_alpha(it, frame, tmats, trilinear, aniso, per_tap)
        for got, want in ((alpha, ba), (cutoff, bco)):
            assert got.dtype == torch.float32 and got.shape == tid.shape
            assert torch.equal(got.view(torch.int32)[covered],
                               want.view(torch.int32)[covered])
            assert not got.view(torch.int32)[~covered].any()
        assert ba[~covered].any()  # base_alpha itself is not masked


@pytest.mark.parametrize("wrap", list(WRAPS))
def test_wrap_modes_match_jax(case, wrap):
    _compare(case, "trilinear", wrap=WRAPS[wrap], uv_scale=3.0)


@pytest.mark.parametrize("mode", range(7))
def test_debug_modes_match_jax(case, mode):
    color, _, _ = _compare(case, "nearest-mip", mode=mode)
    assert color.numpy()[..., :3].std() > 0.01


def test_two_strip_row0_matches_jax(case):
    """The stack shaded as two strips of 48 rows by pipeline._shade_striped
    (each strip one call with its own row0) equals the whole stack, which
    matches JAX."""
    (tgeom, vs, frame, tmats), _ = _inputs(case)
    row0 = torch.zeros((96, 1))
    color, _, _ = _compare(case, "trilinear", row0=row0)
    kw = dict(width=160, height=96, trilinear=True, aniso=1, srgb_per_tap=False)
    strips = _shade_striped(case["tid"], row0, 48, lambda tid, r0: shade.shade_stack(
        tid.contiguous(), r0, tgeom, vs, frame, tmats, **kw))
    assert torch.equal(strips, color)


def test_ui_shade_matches_jax():
    """shade_ui_layer on two of the four layers of tests/torch_bins.py's
    "glyphs" UI (its first 160 columns, the scene stack's shape) against
    the JAX package's."""
    import renderer_tpu as jrt
    from renderer_tpu_torch import Renderer
    from tests.torch_bins import H, W, ui_config, ui_drawlist

    dl, registry = ui_drawlist("glyphs")
    cfg = ui_config(4)
    packed = dl.pack()
    tui = from_numpy_arrays(packed, device="cpu")
    lt, ov, _aux = ui_stage.rasterize_ui(tui, config=cfg, local_tiles_y=cfg.tiles_y,
                                        tile_row_offset=0)
    assert int(ov) == 0
    mats = Renderer(registry, cfg, device="cpu")._materials()
    row0 = torch.zeros((cfg.padded_height, 1))
    lt = lt[0, :2, :, :160].contiguous()
    rgb, alpha = ui_stage.shade_ui_layer(lt, tui, mats, config=cfg, row0=row0)
    jrgb, ja = jstage.shade_ui_layer(
        jnp.asarray(lt.numpy()), {k: jnp.asarray(v) for k, v in packed.items()},
        {k: jnp.asarray(v.numpy()) for k, v in mats.items()},
        config=jrt.RenderConfig(width=W, height=H), row0=jnp.asarray(row0.numpy()))
    _close(jrgb, rgb.numpy())
    _close(ja, alpha.numpy())
    assert (alpha > 0).sum() > 1000


@pytest.mark.parametrize("broken", ["tid-dtype", "tid-strided", "row0-shape",
                                    "row0-dtype", "clip-shape", "draw-dtype",
                                    "table-mips", "wrap-rows", "factor-dtype",
                                    "compute-dtype", "debug-mode-size"])
def test_wrapper_checks_its_arguments(case, broken):
    """S1's wrapper raises on each broken argument before it loads the
    kernel library (so this runs on the CPU), and the entry point on a
    device that is neither the CPU nor CUDA."""
    (tgeom, vs, frame, tmats), _ = _inputs(case, wrap=0)
    tid, row0 = case["tid"], torch.zeros((96, 1))
    kw = dict(width=160, height=96, trilinear=True, aniso=4, srgb_per_tap=False,
              compute_dtype=torch.float32)
    vs, frame, tmats = dict(vs), dict(frame), dict(tmats)
    if broken == "tid-dtype":
        tid = tid.long()
    elif broken == "tid-strided":
        tid = tid[:, :, ::2]
    elif broken == "row0-shape":
        row0 = torch.zeros((95, 1))
    elif broken == "row0-dtype":
        row0 = row0.double()
    elif broken == "clip-shape":
        vs["clip"] = vs["clip"][:, :3].contiguous()
    elif broken == "draw-dtype":
        vs["draw"] = vs["draw"].long()
    elif broken == "table-mips":
        tmats["atlas_table"] = tmats["atlas_table"][:, :4].contiguous()
    elif broken == "wrap-rows":
        tmats["atlas_wrap"] = tmats["atlas_wrap"][:3]
    elif broken == "factor-dtype":
        tmats["base_color_factor"] = tmats["base_color_factor"].double()
    elif broken == "compute-dtype":
        kw["compute_dtype"] = torch.float16
    elif broken == "debug-mode-size":
        frame["debug_mode"] = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        shade._launch_scene("shade", tid, row0, tgeom, vs, frame, tmats, **kw)
    with pytest.raises(ValueError):
        shade.shade_stack(tid.to("meta"), row0, tgeom, vs, frame, tmats, **kw)


def test_recorded_shading_replays_a_frames_calls():
    """tools.shade_check on a CPU frame of the "alpha-layers" scene (one
    tap a sample, to keep it short): the frame's shading calls are recorded
    (solid and blended S1, the masked test's S2), the entry points are
    restored afterwards, and each call replayed equals its plain version."""
    from dataclasses import replace

    from renderer_tpu_torch import Renderer
    from renderer_tpu_torch.tools import shade_check
    from tests.torch_parity import build_scene

    registry, scene, cfg = build_scene("renderer_tpu_torch", "alpha-layers")
    cfg = replace(cfg, aniso_samples=1, srgb_per_tap=False).validate()
    r = Renderer(registry, cfg, overflow_policy="off", device="cpu")
    entry = shade.shade_stack
    with shade_check.recorded_shading() as calls:
        r.render_frame(scene)
    assert shade.shade_stack is entry
    assert sorted(kind for kind, _, _ in calls) == ["S1", "S1", "S2"]
    for kind, args, kw in calls:
        counts = shade_check.compare(shade_check.run_shading(kind, args, kw, plain=False),
                                     shade_check.run_shading(kind, args, kw, plain=True))
        assert counts["differing"] == 0 and counts["values"] > 0
