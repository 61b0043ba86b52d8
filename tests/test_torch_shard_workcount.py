"""The port's shard_workcount (renderer_tpu_torch/tools/shard_workcount.py)
on the CPU: its integer demands on the triangle scene (the JAX tool's
fallback scene without the Sponza assets) equal the JAX package's
tools/shard_workcount.py row for row, per-device pair and tile-row demand
at sp 2, 4 and 8, contiguous and interleaved, and the dp×sp rows."""

import pytest

from tests import torch_parity  # noqa: F401 — one torch thread a worker

from renderer_tpu_torch.tools import shard_workcount
from tools import shard_workcount as jshard_workcount


@pytest.fixture(scope="module")
def rows():
    return shard_workcount.main("triangle", "cpu"), jshard_workcount.main()


def test_demands_equal_the_jax_tool(rows):
    ours, theirs = rows
    assert ours == theirs
    assert [(r.get("sp"), r.get("layout")) for r in ours[1:7]] == [
        (sp, layout) for sp in (2, 4, 8) for layout in ("contiguous", "interleaved")]


def test_shards_partition_the_full_screen(rows):
    ours, _ = rows
    full = ours[0]["pairs_per_dev_max"]
    assert full > 0
    for r in ours[1:7]:
        assert r["pairs_sum"] == full
        assert r["pairs_per_dev_max"] * r["sp"] >= full


def test_unknown_scene_raises():
    with pytest.raises(ValueError, match="unknown scene"):
        shard_workcount.build("sponza", "cpu")
