"""The shading kernels S1-S3 and the fused S3 (csrc/shade.cu) against their
plain versions on the calls a real frame makes.

`recorded_shading()` records every call made to the shading stage's entry
points (shade.shade_stack, shade.alpha_stack, ui_stage.shade_ui_layer,
ui_stage.shade_composite_ui) while a frame renders — every candidate stack
and strip with its own row0, and a copy of the HDR samples the fused S3
updates in place, as they were before the call; `run_shading` runs one
recorded call again through its kernel or its plain version (the fused S3
on a fresh copy of those samples, which it returns), and `compare` holds
the two to the kernels' tolerance. Used by chip_smoke.py phase 12 and
tests/test_torch_cuda_kernels.py:

    with recorded_shading() as calls:
        renderer.render_frame(scene)
    for kind, args, kw in calls:
        compare(run_shading(kind, args, kw, plain=False),
                run_shading(kind, args, kw, plain=True))
"""

from __future__ import annotations

import contextlib

import torch

from renderer_tpu_torch.raster import shade, ui_stage

#: entry points recorded: (module, function name, kind)
ENTRY_POINTS = ((shade, "shade_stack", "S1"), (shade, "alpha_stack", "S2"),
                (ui_stage, "shade_ui_layer", "S3"),
                (ui_stage, "shade_composite_ui", "S3C"))
#: the tolerance against the plain versions: |Δ| ≤ MAX_ABS, and at most
#: OVER_SHARE of the values off by more than FINE
MAX_ABS, FINE, OVER_SHARE = 2.0**-12, 2.0**-18, 0.001


@contextlib.contextmanager
def recorded_shading(kinds: tuple | None = None):
    """Yields a list that receives (kind, args, kwargs) of every call made to
    the entry points inside the block (those of `kinds` alone, if given);
    the calls still run."""
    calls = []
    points = [p for p in ENTRY_POINTS if kinds is None or p[2] in kinds]
    originals = [getattr(mod, name) for mod, name, _ in points]

    def recorder(kind, fn):
        def call(*args, **kw):
            if kind == "S3C":  # the HDR samples as the call finds them
                calls.append((kind, ([t.clone() for t in args[0]], *args[1:]), kw))
            else:
                calls.append((kind, args, kw))
            return fn(*args, **kw)
        return call

    for (mod, name, kind), fn in zip(points, originals):
        setattr(mod, name, recorder(kind, fn))
    try:
        yield calls
    finally:
        for (mod, name, _), fn in zip(points, originals):
            setattr(mod, name, fn)


def run_shading(kind: str, args: tuple, kw: dict, plain: bool) -> tuple:
    """One recorded call through its entry point (the kernel, for CUDA
    tensors) or its plain version, as a tuple of outputs."""
    if kind == "S3C":
        hdr, lt, ui, mats = args
        out = tuple(t.clone() for t in hdr)
        if plain:
            ui_stage.shade_composite_ui_plain(list(out), lt, ui, mats, row0=kw["row0"])
        else:
            ui_stage.shade_composite_ui(list(out), lt, ui, mats, **kw)
    elif kind == "S3":
        lt, ui, mats = args
        out = (ui_stage.shade_ui_layer_plain(lt, ui, mats, row0=kw["row0"]) if plain
               else ui_stage.shade_ui_layer(lt, ui, mats, **kw))
    elif kind == "S1":
        out = (shade.shade_stack_plain if plain else shade.shade_stack)(*args, **kw)
    else:
        out = (shade.alpha_stack_plain if plain else shade.alpha_stack)(*args, **kw)
    return out if isinstance(out, tuple) else (out,)


def compare(got: tuple, want: tuple) -> dict:
    """Holds a kernel's outputs to its plain version's: the same shapes,
    NaN at the same values, |Δ| ≤ MAX_ABS, and more than FINE on at most
    OVER_SHARE of the values. Raises AssertionError when that fails;
    returns the counts (values, values whose bits differ, values off by
    more than FINE, NaN values, the largest |Δ|)."""
    out = {"values": 0, "differing": 0, "over_fine": 0, "nan": 0, "max_abs_err": 0.0}
    for g, w in zip(got, want, strict=True):
        nan = torch.isnan(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        assert torch.equal(torch.isnan(g), nan), "NaN at other values"
        d = (g - w).abs()[~nan]
        out["values"] += g.numel()
        out["nan"] += int(nan.sum())
        out["differing"] += int((g.view(torch.int32) != w.view(torch.int32)).sum())
        if d.numel():
            out["over_fine"] += int((d > FINE).sum())
            out["max_abs_err"] = max(out["max_abs_err"], float(d.max()))
    assert out["max_abs_err"] <= MAX_ABS and out["over_fine"] <= OVER_SHARE * out["values"], out
    return out
