"""Cells shrunk to a size the CPU runs in seconds, for the benchmark's CPU
tests: the same configuration, traffic and metric entries as
BENCHMARK.json, at 160×96 and with a few small meshes."""

from __future__ import annotations

from benchmark import run as run_mod

SMALL_SCENES = {"patch_wall": {"n_patches": 6, "grid": 4},
                "stress_field": {"n_meshes": 4, "tris_per_mesh": 128, "extent": 40.0,
                                 "geometry_seed": 7}}


def cell(name: str) -> tuple:
    """(workload, configuration, traffic, end-to-end, per-layer) of `name`
    at the small size."""
    w, config, traffic, e2e, per_layer = run_mod.load_cell(name)
    config["render"].update(width=160, height=96, pair_capacity=1 << 14,
                            row_capacity=1 << 14)
    config["scene_params"] = dict(SMALL_SCENES[config["scene"]])
    traffic.update(batch=2, warmup_batches=2, warmup_frames=2, keep_every=2,
                   profile_frames=2)
    return w, config, traffic, e2e, per_layer
