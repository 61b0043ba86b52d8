"""The port's multi-device path on the skinned scene (the loader fixture's
two skins and morph weights, both animations playing): the checks of
tests/test_torch_mesh.py, with the vertex stage's skin_start=None path."""

import pytest

from tests import test_torch_mesh as base
from tests import torch_mesh_ranks as ranks

SCENE = "skinned"
JAX_CASES = [("sp4", True), ("sp2", False)]


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return base.spawn_scene(SCENE, tmp_path_factory.mktemp("store"))


@pytest.fixture(scope="module")
def singles():
    return ranks.singles(SCENE)


@pytest.mark.parametrize("case", ranks.CASES, ids=lambda c: f"{c[0]}-{'inter' if c[1] else 'contig'}")
def test_mesh_matches_the_single_device_frame(outs, singles, case):
    got = base.case_frames(outs, case)
    want = singles if case[0] == "dp2sp2" else singles[:1]
    base.check_against(got, want, f"{SCENE} {case}")
    assert (got[0][0].sum(-1) > 0).mean() > 0.05  # the fixture scene covers
    assert (got[0][1][:4] == 0).all()  # no overflow


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: f"{c[0]}-{'inter' if c[1] else 'contig'}")
def test_mesh_matches_the_jax_sharded_frame(outs, case):
    base.check_against(base.case_frames(outs, case), base.jax_frames(SCENE, *case),
                       f"{SCENE} {case} vs JAX")
