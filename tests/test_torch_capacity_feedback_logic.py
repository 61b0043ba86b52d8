"""The port's twin of tests/test_capacity_feedback_logic.py: its CPU path held to the same
oracles and invariants.

Pure-logic property test of the Renderer's demand-fed capacity feedback
(_grow_capacities / _maybe_shrink_capacities / _streak_shrink) driven with
fabricated stats vectors — no rendering, no jit. The invariants the runtime
convergence story rests on (PARITY.md "known gaps", reference analog:
startup-only measure-then-allocate, arena/buffers.rs):

  G1  any reported overflow/demand beyond a capacity grows that capacity
      (or logs loudly at its ceiling) — dropped work is never silently
      accepted;
  S1  a capacity never shrinks below its configured floor;
  S2  a capacity never shrinks below the PEAK demand of the shrink window
      (an oscillating scene can't shrink under its own peak);
  S3  shrink requires `shrink_after` CONSECUTIVE fitting frames — one
      heavy frame resets the streak.
"""

import numpy as np
import pytest

from tests.torch_parity import cpu_renderer  # (and one torch thread a worker)
import renderer_tpu_torch as rt
from renderer_tpu_torch.raster import pipeline


def make_stats(total_pairs=0, masked=0, blended=0, ui=0, shade=0,
               overflow=(0, 0, 0, 0), clamped=0, total_rows=0,
               row_overflow=0):
    v = np.zeros(len(pipeline.STAT_NAMES), np.int64)
    v[0:4] = overflow
    v[7] = clamped
    v[pipeline.STAT_NAMES.index("total_pairs")] = total_pairs
    v[pipeline.STAT_NAMES.index("masked_demand_max")] = masked
    v[pipeline.STAT_NAMES.index("blended_demand_max")] = blended
    v[pipeline.STAT_NAMES.index("ui_demand_max")] = ui
    v[pipeline.STAT_NAMES.index("shade_demand_max")] = shade
    v[pipeline.STAT_NAMES.index("total_rows")] = total_rows
    v[pipeline.STAT_NAMES.index("row_overflow")] = row_overflow
    return v


@pytest.fixture()
def renderer():
    return cpu_renderer(
        rt.MaterialRegistry(),
        rt.RenderConfig(width=64, height=64, msaa_samples=4,
                        blend_layers=4, mask_layers=2, ui_layers=2),
        shrink_after=5,
    )


def test_overflow_always_grows_until_ceiling(renderer):
    from renderer_tpu_torch.engine.renderer import MAX_PAIR_CAPACITY

    cap0 = renderer.config.pair_capacity
    assert renderer._grow_capacities(make_stats(overflow=(100, 0, 0, 0)))
    assert renderer.config.pair_capacity > cap0  # G1
    # drive to the ceiling: growth must stop exactly there, never wrap
    for _ in range(40):
        renderer._grow_capacities(
            make_stats(overflow=(MAX_PAIR_CAPACITY, 0, 0, 0))
        )
    assert renderer.config.pair_capacity == MAX_PAIR_CAPACITY
    # at the ceiling growth must report False (no recompile loop), only log
    assert not renderer._grow_capacities(make_stats(overflow=(5, 0, 0, 0)))


def test_layer_demand_grows_to_pow2_bucket(renderer):
    assert renderer._grow_capacities(make_stats(blended=7))
    assert renderer.config.blend_layers == 8
    # demand at the new capacity: no further growth
    assert not renderer._grow_capacities(make_stats(blended=8))


def test_shrink_respects_floor_and_window_peak(renderer):
    # grow blend_layers to 16 first
    renderer._grow_capacities(make_stats(blended=13))
    assert renderer.config.blend_layers == 16
    # oscillating demand: EVERY shrink window (5 frames) contains a peak of
    # 5, so the capacity may settle at pow2(5) = 8 but never below it (S2)
    floor = 4  # the configured blend_layers floor
    pattern = [5, 1, 0, 2, 1]
    for frame in range(200):
        demand = pattern[frame % len(pattern)]
        renderer._maybe_shrink_capacities(make_stats(blended=demand))
        assert renderer.config.blend_layers >= floor  # S1
        assert renderer.config.blend_layers >= 8  # S2: window peak bucket
    assert renderer.config.blend_layers == 8  # converged to the peak bucket


def test_one_heavy_frame_resets_the_streak(renderer):
    renderer._grow_capacities(make_stats(total_pairs=0,
                                         overflow=(1 << 18, 0, 0, 0)))
    big = renderer.config.pair_capacity
    light = make_stats(total_pairs=1000)
    heavy = make_stats(total_pairs=big)  # fills the bucket exactly
    for _ in range(renderer.shrink_after - 1):
        renderer._maybe_shrink_capacities(light)
    renderer._maybe_shrink_capacities(heavy)  # S3: resets the streak
    for _ in range(renderer.shrink_after - 1):
        renderer._maybe_shrink_capacities(light)
    assert renderer.config.pair_capacity == big  # not yet
    renderer._maybe_shrink_capacities(light)
    assert renderer.config.pair_capacity < big  # now the full streak fit


def test_shade_candidates_never_shrink_while_clamped(renderer):
    renderer._grow_capacities(make_stats(shade=4))
    assert renderer.config.msaa_shade_candidates == 4
    # clean low demand but clamped pixels present → shrink must hold off
    for _ in range(3 * renderer.shrink_after):
        renderer._maybe_shrink_capacities(make_stats(shade=1, clamped=7))
    assert renderer.config.msaa_shade_candidates == 4
    # once clamp-free, the streak shrinks to the peak (floor = configured 3)
    for _ in range(renderer.shrink_after):
        renderer._maybe_shrink_capacities(make_stats(shade=1, clamped=0))
    assert renderer.config.msaa_shade_candidates == 3


def test_random_walk_invariants(renderer):
    """Long random walk mixing growth and shrink across EVERY knob: floors
    hold, overflow always reacts, and capacities stay pow-2/exact."""
    rng = np.random.default_rng(9)
    floors = dict(renderer._layer_floors)
    shade_floor = renderer._shade_floor
    for frame in range(400):
        stats = make_stats(
            total_pairs=int(rng.integers(0, 1 << 17)),
            masked=int(rng.integers(0, 6)),
            blended=int(rng.integers(0, 10)),
            ui=int(rng.integers(0, 4)),
            shade=int(rng.integers(0, 5)),
            overflow=(int(rng.integers(0, 2)) * int(rng.integers(0, 5000)),
                      0, 0, 0),
            clamped=int(rng.integers(0, 2)),
        )
        grew = renderer._grow_capacities(stats)
        if not grew:
            renderer._maybe_shrink_capacities(stats)
        c = renderer.config
        for field, floor in floors.items():
            assert getattr(c, field) >= floor
        assert c.msaa_shade_candidates >= shade_floor
        assert c.pair_capacity & (c.pair_capacity - 1) == 0  # pow-2
        assert c.msaa_shade_candidates <= c.msaa_samples


def test_row_overflow_grows_row_capacity(renderer):
    """G1 for the ragged-binning row axis: row_overflow grows row_capacity
    (and only it), like pair overflow grows pair_capacity."""
    cap0 = renderer.config.row_capacity
    pair0 = renderer.config.pair_capacity
    assert renderer._grow_capacities(make_stats(row_overflow=1000))
    assert renderer.config.row_capacity > cap0
    assert renderer.config.pair_capacity == pair0


def test_row_capacity_shrinks_on_streak(renderer):
    """S1-S3 for row_capacity: sustained small total_rows shrinks toward the
    demand's bucket; one heavy frame resets the streak."""
    from dataclasses import replace

    renderer.config = replace(renderer.config, row_capacity=1 << 20)
    for _ in range(renderer.shrink_after - 1):
        renderer._maybe_shrink_capacities(make_stats(total_rows=1000))
    heavy = make_stats(total_rows=1 << 19)
    renderer._maybe_shrink_capacities(heavy)  # S3: resets the streak
    assert renderer.config.row_capacity == 1 << 20
    for _ in range(renderer.shrink_after):
        renderer._maybe_shrink_capacities(make_stats(total_rows=1000))
    assert renderer.config.row_capacity < (1 << 20)
    assert renderer.config.row_capacity >= 1 << 14  # bucket floor
