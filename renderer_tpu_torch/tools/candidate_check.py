"""The candidate kernels C1-C3 (csrc/candidates.cu) against their plain
versions on the calls a real frame makes.

`recorded_candidates()` records every call made to the entry points of
raster/candidates.py while a frame renders, with a copy of the tensors C2
and C3 update in place (the solid ids and depths, the clamp mask) as the
call found them; `run_candidates` runs one recorded call again through its
kernel or its plain version on fresh copies of those tensors and returns
its outputs; `compare` counts the values whose bits differ. Used by
chip_smoke.py phase 12 and tests/test_torch_cuda_kernels.py:

    with recorded_candidates() as calls:
        renderer.render_frame(scene)
    for kind, args, kw in calls:
        compare(run_candidates(kind, args, kw, plain=False),
                run_candidates(kind, args, kw, plain=True))
"""

from __future__ import annotations

import contextlib

import torch

from renderer_tpu_torch.raster import candidates

#: entry points recorded, by kind: (function name, its plain version,
#: indices of the arguments the call updates in place)
ENTRY_POINTS = {"C1": ("extract_candidates", candidates.extract_candidates_plain, ()),
                "C2": ("masked_merge", candidates.masked_merge_plain, (5, 6, 7)),
                "C3": ("resolve", candidates.resolve_plain, (3,))}


def _fresh(args: tuple, inplace: tuple) -> tuple:
    return tuple(a.clone() if i in inplace else a for i, a in enumerate(args))


@contextlib.contextmanager
def recorded_candidates():
    """Yields a list that receives (kind, args, kwargs) of every call made to
    the entry points inside the block; the calls still run."""
    calls = []
    originals = {kind: getattr(candidates, name) for kind, (name, _, _) in ENTRY_POINTS.items()}

    def recorder(kind, inplace, fn):
        def call(*args, **kw):
            calls.append((kind, _fresh(args, inplace), dict(kw)))
            return fn(*args, **kw)
        return call

    for kind, (name, _, inplace) in ENTRY_POINTS.items():
        setattr(candidates, name, recorder(kind, inplace, originals[kind]))
    try:
        yield calls
    finally:
        for kind, (name, _, _) in ENTRY_POINTS.items():
            setattr(candidates, name, originals[kind])


def run_candidates(kind: str, args: tuple, kw: dict, plain: bool) -> tuple:
    """One recorded call through its entry point (the kernel, for CUDA
    tensors) or its plain version, on fresh copies of the tensors it
    updates in place: a tuple of its outputs (C2: the solid ids, depths and
    clamp mask; C3: the HDR samples and the clamp mask)."""
    name, plain_fn, inplace = ENTRY_POINTS[kind]
    args = _fresh(args, inplace)
    fn = plain_fn if plain else getattr(candidates, name)
    out = fn(*args, **kw)
    if kind == "C2":
        return args[5], args[6], args[7]
    if kind == "C3":
        return out, args[3]
    return out if isinstance(out, tuple) else (out,)


def compare(got: tuple, want: tuple) -> dict:
    """Counts of the outputs' values and of those whose bits differ (NaN
    where the plain version has NaN counts as equal; a NaN elsewhere, or a
    missing one, differs), and the largest |difference| of the values that
    differ (inf where one is not finite). Shapes and dtypes must match."""
    out = {"values": 0, "differing": 0, "nan": 0, "max_abs_err": 0.0}
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype)
        out["values"] += w.numel()
        if w.dtype == torch.float32:
            nan = torch.isnan(w)
            same = (g.view(torch.int32) == w.view(torch.int32)) | (nan & torch.isnan(g))
            out["nan"] += int(nan.sum())
        else:
            same = g == w
        differ = ~same
        out["differing"] += int(differ.sum())
        if differ.any():
            d = (g[differ].double() - w[differ].double()).abs()
            d = d.nan_to_num(nan=float("inf"), posinf=float("inf"))
            out["max_abs_err"] = max(out["max_abs_err"], float(d.max()))
    return out
