"""The port's multi-device path (renderer_tpu_torch/parallel/mesh.py) on
CPU ranks over gloo, on the triangle scene; tests/test_torch_mesh_skinned.py
runs the same checks on the skinned scene.

Four ranks are spawned once (a FileStore under tmp_path, so pytest-xdist
workers never share a port; one torch thread a rank). Each renders every
case of tests/torch_mesh_ranks.CASES: sp=4 and sp=2, contiguous and
interleaved, and dp=2 × sp=2. Each case is held against the port's
single-device frame and, for two cases a scene, against the JAX package's
sharded frame on a mesh of the 8 forced CPU devices (tests/conftest.py),
in interpret mode: stats exactly equal, pixel agreement > 0.999 (as
tests/test_multichip.py holds the JAX package's). Also: per_shard_config
against the JAX package's over a grid, _combine_shard_stats on hand-made
vectors, and every rank returning the same frame.
"""

import functools

import numpy as np
import pytest

from tests import torch_parity  # noqa: F401 — one torch thread a worker
from tests import torch_mesh_ranks as ranks

import renderer_tpu as jrt
import renderer_tpu_torch as trt
from renderer_tpu.parallel import mesh as jmesh
from renderer_tpu.raster import pipeline as jpipeline
from renderer_tpu_torch.parallel import mesh as tmesh
from renderer_tpu_torch.raster import pipeline as tpipeline

SCENE = "triangle"
# the JAX package's sharded frames this file renders: (mesh, interleave)
JAX_CASES = [("sp4", False), ("dp2sp2", True)]


def spawn_scene(name, store_dir):
    outs = tmesh.spawn(ranks.run_cases, 4, name, "cpu", store_dir=store_dir)
    return outs


def jax_frames(name, case, interleave):
    """The JAX package's sharded render of `case`: [(image, stats)] per
    frame it renders."""
    import jax
    import jax.numpy as jnp

    from renderer_tpu.scene import draw_stream

    renderer, scenes, modes = ranks.build_frames(jrt, name)
    fvs = [draw_stream.frame_view(s) for s in scenes]
    gs, geom = renderer._geometry(scenes[0], fvs[0].order, fvs[0].geom_key)
    frames = [renderer._frame_arrays(s, fv, gs, debug_mode=m)
              for s, fv, m in zip(scenes, fvs, modes)]
    mats = renderer._materials()
    jc = renderer._joint_cap(scenes[0])
    cfg = renderer.config
    interp = jpipeline.interpret_mode()
    if case == "dp2sp2":
        bcfg = jmesh.per_shard_config(cfg, 2) if interleave else cfg
        batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
        imgs, stats = jax.jit(functools.partial(
            jmesh.render_frames_batched, config=bcfg, mesh=jmesh.make_mesh_2d(2, 2),
            joint_cap=jc, morph_k=gs.morph_k, interleave=interleave,
            interpret=interp))(geom, batched, mats)
        return [(np.asarray(imgs[b]), np.asarray(stats[b])) for b in range(2)]
    n = {"sp4": 4, "sp2": 2}[case]
    img, stats = jmesh.jit_sharded_frame(
        cfg, jmesh.make_mesh(n), interpret=interp, morph_k=gs.morph_k, joint_cap=jc,
        interleave=interleave)(geom, frames[0], mats)
    return [(np.asarray(img), np.asarray(stats))]


def check_against(got, want, what):
    """Stats exactly equal, images of the same shape with agreement > 0.999."""
    for b, ((img, st), (wimg, wst)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(st, wst, err_msg=f"{what} frame {b} stats")
        assert img.shape == wimg.shape and img.dtype == np.uint8
        agree = ranks.agreement(img, wimg)
        assert agree > 0.999, f"{what} frame {b}: agreement {agree}"


def case_frames(outs, case):
    """The case's frames from rank 0: [(image, stats)]; every rank holds
    the same."""
    img, stats = outs[0]["cases"][case]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["cases"][case][0], img)
        np.testing.assert_array_equal(o["cases"][case][1], stats)
    if case[0] == "dp2sp2":
        assert img.shape == (2, ranks.H, ranks.W, 3) and stats.shape == (2, tpipeline.N_STATS)
        return [(img[b], stats[b]) for b in range(2)]
    assert img.shape == (ranks.H, ranks.W, 3) and stats.shape == (tpipeline.N_STATS,)
    return [(img, stats)]


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return spawn_scene(SCENE, tmp_path_factory.mktemp("store"))


@pytest.fixture(scope="module")
def singles():
    return ranks.singles(SCENE)


@pytest.mark.parametrize("case", ranks.CASES, ids=lambda c: f"{c[0]}-{'inter' if c[1] else 'contig'}")
def test_mesh_matches_the_single_device_frame(outs, singles, case):
    got = case_frames(outs, case)
    want = singles if case[0] == "dp2sp2" else singles[:1]
    check_against(got, want, f"{SCENE} {case}")
    assert (got[0][0].sum(-1) > 0).mean() > 0.02  # the scene covers pixels
    assert (got[0][1][:4] == 0).all()  # no overflow


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: f"{c[0]}-{'inter' if c[1] else 'contig'}")
def test_mesh_matches_the_jax_sharded_frame(outs, case):
    check_against(case_frames(outs, case), jax_frames(SCENE, *case), f"{SCENE} {case} vs JAX")


def test_combine_shard_stats_sums_counts_and_maxes_peaks(outs):
    want = ranks.expected_combine(tpipeline.N_STATS)
    for o in outs:
        np.testing.assert_array_equal(o["combined"], want)


def test_every_rank_ran_the_plain_kernels_path(outs):
    """On CPU tensors the kernel wrappers run their plain versions and count
    no launch."""
    for o in outs:
        assert all(v == 0 for v in o["launches"].values()), o["launches"]


@pytest.mark.parametrize("pairs", [1 << 10, 1 << 13, 1 << 14, 1 << 16, 1 << 18, 3 << 19])
@pytest.mark.parametrize("sp", [1, 2, 3, 4, 8])
def test_per_shard_config_equals_the_jax_package(pairs, sp):
    for headroom, floor in ((2.0, 1 << 14), (1.0, 1 << 10), (3.5, 1 << 12)):
        t = tmesh.per_shard_config(trt.RenderConfig(pair_capacity=pairs, row_capacity=pairs // 2 or 1),
                                   sp, headroom=headroom, floor=floor)
        j = jmesh.per_shard_config(jrt.RenderConfig(pair_capacity=pairs, row_capacity=pairs // 2 or 1),
                                   sp, headroom=headroom, floor=floor)
        assert (t.pair_capacity, t.row_capacity) == (j.pair_capacity, j.row_capacity)


def test_stat_split_follows_stat_names():
    assert tpipeline.STAT_NAMES == jpipeline.STAT_NAMES
    assert tpipeline.STAT_NAMES[9:13] == ("masked_demand_max", "blended_demand_max",
                                          "ui_demand_max", "shade_demand_max")


def test_mesh_shape_asserts():
    cfg = trt.RenderConfig(width=128, height=120, tile_h=16, tile_w=128)
    with pytest.raises(AssertionError, match="height"):
        tmesh._check_shape(cfg, 2, 8)
    cfg = trt.RenderConfig(width=128, height=128, tile_h=16, tile_w=128).validate()
    with pytest.raises(AssertionError, match="tiles_y"):
        tmesh._check_shape(cfg, 3, 9)
    with pytest.raises(AssertionError, match="VE"):
        tmesh._check_shape(cfg, 4, 6)
