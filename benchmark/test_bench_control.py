"""`correct` comes out false where it must: under the control (the
program's own bf16 shading) and under each fault the cells can have, each
planted in the timed path underneath a whole run of the harness (at the
small size, on the CPU, past the harness's look for a card). The control
at the cells' own size runs on the card (the `cuda` test)."""

import time

import pytest
import torch

from benchmark import harness, small

torch.set_num_threads(1)


def _run(name: str, control: bool = False, seed: int = 2**31 + 9):
    return harness.run(*small.cell(name), seed=seed, seconds=0.5, traced=False,
                       device="cpu", process_start=time.time(), control=control)


def test_a_sound_run_is_correct():
    res = _run("stress1m.flythrough")
    assert res["correct"] and res["attempted"] >= 2 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_the_control_is_not_correct():
    res = _run("stress1m.flythrough", control=True)
    assert not res["correct"]
    assert res["checks"]["px_differing"]["value"] > res["checks"]["px_differing"]["limit"]


def _patched(monkeypatch, name, fault):
    import renderer_tpu_torch as rt

    batched = rt.Renderer.render_frames_device
    eager = rt.Renderer.render_frame_device
    state = {}

    def frames(self, scenes, debug_mode=0):
        if fault == "unchanged" and "imgs" in state:
            return state["imgs"], state["stats"]  # the last batch again
        if fault == "half":
            half = scenes[: len(scenes) // 2]
            imgs, stats = batched(self, half + half[: len(scenes) - len(half)], debug_mode)
        else:
            imgs, stats = batched(self, scenes, debug_mode)
        if fault == "altered":
            imgs[:, 40, 80] ^= 1
        state.update(imgs=imgs, stats=stats)
        return imgs, stats

    def frame(self, scene, debug_mode=0, ui=None):
        img = eager(self, scene, debug_mode, ui)
        if fault == "altered":
            img[40, 80] ^= 1
        return img

    monkeypatch.setattr(rt.Renderer, "render_frames_device", frames)
    monkeypatch.setattr(rt.Renderer, "render_frame_device", frame)
    return _run(name)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, fault):
    res = _patched(monkeypatch, "stress1m.flythrough", fault)
    assert not res["correct"], res["checks"]


def test_an_altered_pixel_in_the_eager_path_is_not_correct(monkeypatch):
    res = _patched(monkeypatch, "patchwall.interactive", "altered")
    assert not res["correct"], res["checks"]


def test_each_part_of_a_batch_is_kept_at_an_offset_of_its_own():
    """At the cells' own batch of 60 in two parts: one frame kept in each
    half of every batch, the offsets varying from batch to batch."""
    from benchmark.cell import Keep

    keep = Keep(2**31 + 21, 60, 2)
    offsets = {0: set(), 1: set()}
    for block in range(40):
        kept = [(n % 60, keep.part(n)) for n in range(60 * block, 60 * block + 60)
                if keep.part(n) is not None]
        assert [part for _pos, part in kept] == [0, 1]
        assert kept[0][0] < 30 <= kept[1][0]
        for pos, part in kept:
            offsets[part].add(pos)
    assert len(offsets[0]) > 10 and len(offsets[1]) > 10


@pytest.mark.parametrize("seed", [2**31 + 31, 2**31 + 32, 2**31 + 33])
def test_half_a_batch_rendered_twice_is_not_correct_at_a_batch_of_eight(monkeypatch, seed):
    """The half fault at a batch where the kept frame's offset is drawn
    (8 frames, two parts of 4), on several seeds."""
    import renderer_tpu_torch as rt

    batched = rt.Renderer.render_frames_device

    def frames(self, scenes, debug_mode=0):
        half = scenes[: len(scenes) // 2]
        return batched(self, half + half, debug_mode)

    monkeypatch.setattr(rt.Renderer, "render_frames_device", frames)
    w, config, traffic, e2e, per_layer = small.cell("stress1m.flythrough")
    traffic.update(batch=8, keep_every=8)
    res = harness.run(w, config, traffic, e2e, per_layer, seed=seed, seconds=0.5,
                      traced=False, device="cpu", process_start=time.time())
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["patchwall.flythrough", "stress1m.flythrough"])
def test_half_a_batch_rendered_twice_fails_at_the_cells_size_on_the_card(
        card, monkeypatch, name):
    """The half fault at the cells' own batch, sizes and traffic, on three
    seeds."""
    import renderer_tpu_torch as rt

    from benchmark import run as run_mod

    batched = rt.Renderer.render_frames_device

    def frames(self, scenes, debug_mode=0):
        half = scenes[: len(scenes) // 2]
        return batched(self, half + half[: len(scenes) - len(half)], debug_mode)

    monkeypatch.setattr(rt.Renderer, "render_frames_device", frames)
    w, config, traffic, e2e, per_layer = run_mod.load_cell(name)
    for seed in (2**31 + 41, 2**31 + 42, 2**31 + 43):
        res = harness.run(w, config, traffic, e2e, per_layer, seed=seed, seconds=2.0,
                          traced=False, device=card, process_start=time.time())
        assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["patchwall.flythrough", "stress1m.flythrough"])
def test_the_control_fails_at_the_cells_size_on_the_card(card, name):
    from benchmark import run as run_mod

    w, config, traffic, e2e, per_layer = run_mod.load_cell(name)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        res = harness.run(w, config, traffic, e2e, per_layer, seed=seed, seconds=2.0,
                          traced=False, device=card, process_start=time.time(),
                          control=True)
        assert not res["correct"], res["checks"]


def test_a_traced_run_counts_the_work_of_its_frames(monkeypatch):
    """A traced run is judged as an untraced one, and the reference renders
    `check.work_frames` frames of the traced window for the work formulas:
    the checked frames and, evenly spaced, further ones."""
    from benchmark import cell as cell_mod

    counted = []
    check = cell_mod.check

    def spy(*args):
        readings, works = check(*args)
        counted.append({k: len(v) for k, v in works.items()})
        return readings, works

    monkeypatch.setattr(cell_mod, "check", spy)
    w, config, traffic, e2e, per_layer = small.cell("stress1m.flythrough")
    config["check"]["work_frames"] = 4
    traffic.update(profile_frames=6)
    res = harness.run(w, config, traffic, e2e, per_layer, seed=2**31 + 51, seconds=0.5,
                      traced=True, device="cpu", process_start=time.time())
    assert res["correct"] and "breakdown" in res, res["checks"]
    assert counted and set(counted[0].values()) == {4}, counted
