"""The plain reference against the port's CPU path (the port's plain
versions) at 160×96, and the frozen work formulas against the arithmetic
chip_smoke.py applies to a record of the port's calls, on the same frame."""

import numpy as np
import pytest
import torch

import benchmark.reference.api as ref
from benchmark import small
from benchmark.cell import BENCH_ROOT, load_module
from benchmark.reference.renderer import PlainRenderer
from benchmark.scenes import scene as scene_mod

torch.set_num_threads(1)


def _frames(name: str, t: float = 1.3):
    """(port image, port stats, reference image, reference stats, probe,
    the port's config, the calls the port made) of one frame of cell
    `name` at the small size."""
    import renderer_tpu_torch as rt
    from renderer_tpu_torch.tools.candidate_check import recorded_candidates
    from renderer_tpu_torch.tools.frontend_probe import recorded_frontend
    from renderer_tpu_torch.tools.shade_check import recorded_shading

    _w, config, _tr, _e, _p = small.cell(name)
    gen = load_module(BENCH_ROOT / "scenes" / f"{config['scene']}.py", "gen")
    desc = gen.make(config["scene_params"], np.random.default_rng(2**32 + 7))
    pose = scene_mod.camera_pose(config["camera"], 0.4, t)
    reg, meshes, mats = scene_mod.build(desc, rt)
    port = rt.Renderer(reg, rt.RenderConfig(**config["render"]), overflow_policy="off",
                       device="cpu")
    sc = rt.Scene(world_space=rt.GLTF)
    scene_mod.queue(sc, desc, meshes, mats, pose)
    with recorded_shading() as sh, recorded_candidates() as ca, recorded_frontend() as fe:
        img = port.render_frame_device(sc)
    reg2, meshes2, mats2 = scene_mod.build(desc, ref)
    plain = PlainRenderer(reg2, ref.RenderConfig(**config["render"]), "cpu")
    sc2 = ref.Scene(world_space=ref.GLTF)
    scene_mod.queue(sc2, desc, meshes2, mats2, pose)
    probe = {}
    want, want_stats = plain.render(sc2, probe)
    return img, port.last_stats, want, want_stats, probe, plain.config, (sh, ca, fe)


@pytest.fixture(scope="module")
def patchwall():
    return _frames("patchwall.flythrough")


@pytest.fixture(scope="module")
def stress():
    return _frames("stress1m.flythrough")


@pytest.mark.parametrize("which", ["patchwall", "stress"])
def test_reference_equals_the_ports_plain_path(which, request):
    img, stats, want, want_stats, *_ = request.getfixturevalue(which)
    assert img.shape == want.shape == (96, 160, 3)
    assert torch.equal(img, want)
    assert torch.equal(stats, want_stats)
    assert img.float().std() > 1.0  # a frame with something in it


def test_candidate_work_equals_chip_smokes_on_the_recorded_calls(patchwall):
    import chip_smoke
    from benchmark.work import candidates

    *_, probe, cfg, (_sh, calls, _fe) = patchwall
    mine = candidates.count(probe, cfg)
    theirs = [chip_smoke.candidate_work(kind, args, kw) for kind, args, kw in calls]
    assert len(mine) == len(theirs) == 5
    assert sum(o for _, o, _ in mine) == sum(o for o, _ in theirs)
    assert sum(b for _, _, b in mine) == sum(b for _, b in theirs)


@pytest.mark.parametrize("which", ["patchwall", "stress"])
def test_frontend_work_equals_the_probes_on_the_recorded_calls(which, request):
    from renderer_tpu_torch.tools import frontend_probe

    from benchmark.work import frontend

    *_, probe, cfg, (_sh, _ca, calls) = request.getfixturevalue(which)
    theirs = {}
    for kind, args, kw in calls:
        outs = frontend_probe.run_frontend(kind, args, kw, plain=True)
        for step, b in frontend_probe.frontend_work(kind, args, kw, outs).items():
            theirs[step] = theirs.get(step, 0) + b
    mine = {step: b for step, _, b in frontend.count(probe, cfg)}
    library = {"cumsum of the row counts", "cumsum of the row spans",
               "stable sort of the keys"}
    assert mine == {k: v for k, v in theirs.items() if k not in library}


def test_shade_operations_equal_chip_smokes_on_the_recorded_calls(patchwall):
    """S1's operations agree with chip_smoke's, call for call summed; S2's
    are chip_smoke's (every element of its calls) scaled to the covered
    elements, since a masked slot left empty needs no alpha. The bytes
    differ by design (PERF.md: the frozen count leaves out the vertex,
    material and texel tensors chip_smoke counts in full by address)."""
    import chip_smoke
    from benchmark.work import shade

    *_, probe, cfg, (calls, _ca, _fe) = patchwall
    mine = {k: o for k, o, _ in shade.count(probe, cfg)}
    theirs = {}
    for kind, args, kw in calls:
        ops, _taps = chip_smoke.shade_work(kind.lower(), args, kw, (), {})
        theirs[kind] = theirs.get(kind, 0) + ops
    assert set(mine) == set(theirs) == {"S1", "S2"}
    assert mine["S1"] == theirs["S1"]
    cands_m = probe["cands_m"]
    covered = int((cands_m >= 0).sum())
    assert 0 < covered < cands_m.numel()
    assert mine["S2"] * cands_m.numel() == theirs["S2"] * covered
