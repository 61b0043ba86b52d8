"""The candidate loops' plain versions (renderer_tpu_torch/raster/
candidates.py, what the entry points run on the CPU) against the JAX
package on the same numpy inputs (tests/torch_candidate_cases.py, 32×64
maps): extract_candidates_plain against `_extract_candidates`
(renderer_tpu/raster/pipeline.py:118) and the solid pass's count of
distinct ids (:452-461), select_plain against `_select` (:203), and
masked_merge_plain and resolve_plain against the phases they stand for,
rebuilt here from pipeline.py:407-439 (the masked merge) and :462-490 (the
solid select and the blended composite) with the JAX package's own
`_select` and `_extract_candidates`. Parametrised over MSAA 1, 2, 4, 8 and
1, 4, 16 layers, and over the crafted cases.

Tolerance: ids, counts, the clamp mask, the merged ids and depths and the
selected values are integers or copies, demanded equal bit for bit. The
composite is demanded bit for bit too, NaN where NaN (a NaN's sign and
payload are each library's own, and are not compared): the JAX side runs
eagerly, one XLA computation an operation, so no multiply-add is
contracted into an FMA; under jit XLA:CPU may contract hdr·(1 − a) + c·a,
which would move it by an ULP (ROADMAP.md, "Known divergences"). On the
card, kernels C1-C3 are held to these plain versions bit for bit
(tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.raster import pipeline as jpipe
from renderer_tpu_torch.raster import candidates
from tests import torch_parity  # noqa: F401 (one torch thread a worker)
from tests.torch_candidate_cases import CASES, alpha_cutoff, loop_inputs, shades

H, W = 32, 64
MSAA = (1, 2, 4, 8)
LAYERS = (1, 4, 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if got.dtype == np.float32:  # NaN where NaN (its sign and payload are the library's)
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan), "NaN at other values"
        got, want = got.view(np.int32)[~nan], want.view(np.int32)[~nan]
    assert np.array_equal(got, want), f"{int((got != want).sum())} values differ"


def _jax_extract(slots: np.ndarray, n: int):
    return np.asarray(jnp.stack(jpipe._extract_candidates([_j(t) for t in slots], n)))


def _jax_distinct(solid: np.ndarray):
    """pipeline.py:452-461, the distinct count of the solid ids."""
    solid_tid = [_j(t) for t in solid]
    distinct = jnp.zeros_like(solid_tid[0])
    for i, t in enumerate(solid_tid):
        is_new = t != -1
        for u in solid_tid[:i]:
            is_new &= t != u
        distinct += is_new.astype(jnp.int32)
    return np.asarray(distinct)


def _jax_merge(inp, cands, alphas, cutoffs):
    """pipeline.py:407-439 with the JAX package's _select."""
    msaa, k = inp["lt_m"].shape[:2]
    lt_m, lz_m = _j(inp["lt_m"]), _j(inp["lz_m"])
    solid_tid = [_j(t) for t in inp["solid_tid"]]
    solid_z = [_j(z) for z in inp["solid_z"]]
    cands = [_j(c) for c in cands]
    alphas, cutoffs = [_j(a) for a in alphas], [_j(c) for c in cutoffs]
    clamp_mask = jnp.zeros(inp["lt_m"].shape[2:], bool)
    for s in range(msaa):
        a2c_floor = (s + 0.5) / msaa if msaa > 1 else 0.0
        for kk in reversed(range(k)):
            t = lt_m[s][kk]
            alpha, unmatched_a = jpipe._select(t, cands, alphas)
            cutoff, _ = jpipe._select(t, cands, cutoffs)
            live = t >= 0
            clamp_mask |= live & unmatched_a
            passes = live & ~unmatched_a & (alpha > cutoff) & (alpha > a2c_floor)
            solid_tid[s] = jnp.where(passes, t, solid_tid[s])
            solid_z[s] = jnp.where(passes, lz_m[s][kk], solid_z[s])
    return (np.asarray(jnp.stack(solid_tid)), np.asarray(jnp.stack(solid_z)),
            np.asarray(clamp_mask))


def _jax_resolve(solid, cands_s, shaded_s, lt_b=None, cands_b=None, shaded_b=None):
    """pipeline.py:462-490 with the JAX package's _select."""
    msaa = solid.shape[0]
    solid_tid = [_j(t) for t in solid]
    cands_s = [_j(c) for c in cands_s]
    shaded_s = [_j(v) for v in shaded_s]
    clamp_mask = jnp.zeros(solid.shape[1:], bool)
    hdr = []
    for s in range(msaa):
        color, unmatched = jpipe._select(solid_tid[s], cands_s, shaded_s)
        covered_s = solid_tid[s] >= 0
        clamp_mask |= unmatched & covered_s
        hdr.append(jnp.where(covered_s[..., None], color[..., :3], 0.0))
    if lt_b is not None:
        cands_b = [_j(c) for c in cands_b]
        shaded_b = [_j(v) for v in shaded_b]
        for s in range(msaa):
            for k in range(lt_b.shape[1]):
                t = _j(lt_b[s, k])
                color_k, unmatched = jpipe._select(t, cands_b, shaded_b)
                live = (t >= 0) & ~unmatched
                clamp_mask |= (t >= 0) & unmatched
                a = jnp.where(live[..., None], color_k[..., 3:4], 0.0)
                hdr[s] = hdr[s] * (1.0 - a) + color_k[..., :3] * a
    return np.asarray(jnp.stack(hdr)), np.asarray(clamp_mask)


@pytest.mark.parametrize("k", LAYERS)
@pytest.mark.parametrize("msaa", MSAA)
def test_extract_candidates_matches_jax(msaa, k):
    inp = loop_inputs("random", msaa, k, H, W)
    for key, n in (("lt_m", inp["n_masked"]), ("lt_b", inp["n_blended"])):
        slots = inp[key].reshape(msaa * k, H, W)
        _bits_equal(candidates.extract_candidates(_t(slots), n), _jax_extract(slots, n))
    cands, distinct = candidates.extract_candidates(_t(inp["solid_tid"]), inp["n_solid"],
                                                    count=True)
    _bits_equal(cands, _jax_extract(inp["solid_tid"], inp["n_solid"]))
    _bits_equal(distinct, _jax_distinct(inp["solid_tid"]))


@pytest.mark.parametrize("case", CASES)
def test_extract_candidates_crafted(case):
    inp = loop_inputs(case, 4, 4, H, W)
    slots = inp["lt_m"].reshape(16, *inp["lt_m"].shape[2:])
    want = _jax_extract(slots, inp["n_masked"])
    _bits_equal(candidates.extract_candidates(_t(slots), inp["n_masked"]), want)
    cands, distinct = candidates.extract_candidates(_t(slots), inp["n_masked"], count=True)
    _bits_equal(cands, want)
    _bits_equal(distinct, _jax_distinct(slots))
    if case == "all-background":
        assert (want == -2).all() and (distinct.numpy() == 0).all()
    if case == "more-than-n":
        assert (distinct.numpy() == 16).all() and (want >= 0).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("channels", [0, 4])
def test_select_matches_jax(case, channels):
    inp = loop_inputs(case, 4, 4, H, W)
    n = inp["n_masked"]
    h, w = inp["lt_m"].shape[2:]
    slots = inp["lt_m"].reshape(16, h, w)
    cands = _jax_extract(slots, n)
    values = (shades(case, n, h, w) if channels else alpha_cutoff(case, 4, n, h, w)[0])
    for t in slots[:4]:
        got, unmatched = candidates.select_plain(_t(t), _t(cands), _t(values))
        want, want_un = jpipe._select(_j(t), [_j(c) for c in cands],
                                      [_j(v) for v in values])
        _bits_equal(got, want)
        _bits_equal(unmatched, want_un)


def _flush(v: np.ndarray) -> np.ndarray:
    """A denormal read as a zero of its sign, as XLA:CPU compares (torch and
    the kernels, built -ftz=false, keep it: ROADMAP.md, Known divergences)."""
    return np.where(np.abs(v) < np.finfo(np.float32).tiny, np.copysign(np.float32(0), v), v)


def _merge_case(case, msaa, k):
    """masked_merge on the case's inputs against the JAX merge. Where an
    alpha or cutoff is denormal ("pass-prefix" at MSAA 1: the floor 0's
    f32 neighbours), the JAX merge is held to the plain version on them
    flushed to zero."""
    inp = loop_inputs(case, msaa, k, H, W)
    h, w = inp["lt_m"].shape[2:]
    slots = inp["lt_m"].reshape(msaa * k, h, w)
    cands = _jax_extract(slots, inp["n_masked"])
    alpha, cutoff = alpha_cutoff(case, msaa, inp["n_masked"], h, w)

    def merge(a, co):
        solid_tid, solid_z = _t(inp["solid_tid"].copy()), _t(inp["solid_z"].copy())
        clamp = torch.zeros((h, w), dtype=torch.bool)
        out = candidates.masked_merge(_t(inp["lt_m"]), _t(inp["lz_m"]), _t(cands), _t(a),
                                      _t(co), solid_tid, solid_z, clamp)
        assert out is None  # in place
        return solid_tid, solid_z, clamp

    solid_tid, solid_z, clamp = merge(alpha, cutoff)
    flushed = _flush(alpha), _flush(cutoff)
    same = all(np.array_equal(f.view(np.int32), v.view(np.int32))
               for f, v in zip(flushed, (alpha, cutoff)))
    want = _jax_merge(inp, cands, alpha, cutoff)
    for got, w in zip((solid_tid, solid_z, clamp) if same else merge(*flushed), want):
        _bits_equal(got, w)
    return inp, solid_tid, clamp


@pytest.mark.parametrize("k", LAYERS)
@pytest.mark.parametrize("msaa", MSAA)
def test_masked_merge_matches_jax(msaa, k):
    inp, solid_tid, _ = _merge_case("random", msaa, k)
    assert not torch.equal(solid_tid, _t(inp["solid_tid"])), "no layer passed"


@pytest.mark.parametrize("case", CASES)
def test_masked_merge_crafted(case):
    inp, solid_tid, clamp = _merge_case(case, 4, 4)
    if case == "more-than-n":
        assert clamp.all()
    if case == "all-background":
        assert torch.equal(solid_tid, _t(inp["solid_tid"])) and not clamp.any()


@pytest.mark.parametrize("msaa", MSAA)
def test_masked_merge_pass_prefix(msaa):
    """The "pass-prefix" case at every MSAA count (the crafted tests run
    4×): alpha at each alpha-to-coverage floor and at its f32 neighbours,
    cutoff NaN, ±inf or equal to alpha; some samples take a layer and some
    keep their solid id."""
    inp, solid_tid, _ = _merge_case("pass-prefix", msaa, 4)
    moved = solid_tid != _t(inp["solid_tid"])
    assert moved.any() and not moved.all()


def _resolve_case(case, msaa, k, blended=True):
    inp = loop_inputs(case, msaa, k, H, W)
    h, w = inp["lt_m"].shape[2:]
    cands_s = _jax_extract(inp["solid_tid"], inp["n_solid"])
    shaded_s = shades(case, inp["n_solid"], h, w, seed=3)
    extra = {}
    if blended:
        slots = inp["lt_b"].reshape(msaa * k, h, w)
        extra = dict(lt_b=inp["lt_b"], cands_b=_jax_extract(slots, inp["n_blended"]),
                     shaded_b=shades(case, inp["n_blended"], h, w))
    clamp = torch.zeros((h, w), dtype=torch.bool)
    hdr = candidates.resolve(_t(inp["solid_tid"]), _t(cands_s), _t(shaded_s), clamp,
                             **{key: _t(v) for key, v in extra.items()})
    want_hdr, want_clamp = _jax_resolve(inp["solid_tid"], cands_s, shaded_s, **extra)
    _bits_equal(hdr, want_hdr)
    _bits_equal(clamp, want_clamp)
    return hdr, clamp


@pytest.mark.parametrize("k", LAYERS)
@pytest.mark.parametrize("msaa", MSAA)
def test_resolve_matches_jax(msaa, k):
    _resolve_case("random", msaa, k)


@pytest.mark.parametrize("blended", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_resolve_crafted(case, blended):
    hdr, clamp = _resolve_case(case, 4, 4, blended)
    bits = hdr.view(torch.int32)
    if case == "all-background":
        assert (bits == 0).all() and not clamp.any()  # +0.0 everywhere
    if case == "non-finite":
        assert torch.isnan(hdr).any()
        if blended:  # a -0.0 sample under layers that add +0.0 turns +0.0
            assert not (bits == torch.tensor(-0.0).view(torch.int32)).all()
    if case == "more-than-n":
        assert clamp.all()


def test_candidate_work_counts_what_the_data_needs():
    """chip_smoke.py's bound of C1-C3 on hand-counted 1×2-pixel inputs: the
    bytes the calls' data needs (each value read or written once) and the
    upper count of their operations."""
    import chip_smoke as cs

    # pixel 0 holds 5, 5, 7 (its one-candidate list fills at slot 0), pixel
    # 1 only background (never fills: all three slots read)
    slots = torch.tensor([[[5, -1]], [[5, -1]], [[7, -1]]], dtype=torch.int32)
    assert cs.candidate_work("C1", (slots, 1), {}) == (2 * 3 * 2, 4 * (1 + 3) + 4 * 2)
    # counting reads every slot: 3 × 2 slot values + 2 candidates + 2 counts
    assert cs.candidate_work("C1", (slots, 1), {"count": True}) == (
        2 * 3 * (1 + 1 + 1), 4 * 6 + 4 * 2 + 4 * 2)
    # C2, S = 1, K = 2: pixel 0's layers 5 (passes) and 9 (no candidate:
    # clamp), pixel 1 empty
    lt = torch.tensor([[[[5, -1]], [[9, -1]]]], dtype=torch.int32)
    lz = torch.ones((1, 2, 1, 2))
    cands = torch.tensor([[[5, -2]]], dtype=torch.int32)
    alpha, cutoff = torch.tensor([[[0.9, 0.0]]]), torch.tensor([[[0.5, 0.0]]])
    tid, z = torch.full((1, 1, 2), -1, dtype=torch.int32), torch.zeros((1, 1, 2))
    clamp = torch.zeros((1, 2), dtype=torch.bool)
    args = (lt, lz, cands, alpha, cutoff, tid, z, clamp)
    # lt 16 + cands 8 + alpha and cutoff of (5, pixel 0) 8 + one moved
    # sample 12 + one clamp byte
    assert cs.candidate_work("C2", args, {}) == (2 * 1 * 2 * (1 + 3), 16 + 8 + 8 + 12 + 1)
    # C3, S = 1: pixel 0 covered by candidate 0; one blended layer whose
    # pixel 0 matches candidate 1 and pixel 1 none (candidate 0 read)
    solid = torch.tensor([[[5, -1]]], dtype=torch.int32)
    shaded = torch.zeros((1, 1, 2, 4))
    lt_b = torch.tensor([[[[8, -1]]]], dtype=torch.int32)
    cands_b = torch.tensor([[[3, -2]], [[8, -2]]], dtype=torch.int32)
    shaded_b = torch.zeros((2, 1, 2, 4))
    ops, n_bytes = cs.candidate_work("C3", (solid, cands, shaded, clamp, lt_b, cands_b,
                                            shaded_b), {})
    # solid 8 + cands_s 8 + lt_b 8 + cands_b 16 + hdr 24 + rgb of (0, px 0)
    # 12 + rgba of (1, px 0) and (0, px 1) 32; no clamp
    assert (ops, n_bytes) == (2 * 1 + 2 * 1 * (2 + 10), 8 + 8 + 8 + 16 + 24 + 12 + 32)


def test_candidate_check_records_and_replays():
    """tools/candidate_check on the CPU: the three entry points recorded in
    call order with copies of the tensors C2 and C3 update in place as the
    calls found them, replayed equal to the calls' own results, and
    compare counting a flipped bit and a NaN moved elsewhere."""
    from renderer_tpu_torch.tools.candidate_check import (
        compare,
        recorded_candidates,
        run_candidates,
    )

    inp = loop_inputs("random", 4, 4, H, W)
    lt_m, lt_b = _t(inp["lt_m"]), _t(inp["lt_b"])
    tid, z = _t(inp["solid_tid"]), _t(inp["solid_z"])
    clamp = torch.zeros((H, W), dtype=torch.bool)
    alpha, cutoff = (_t(a) for a in alpha_cutoff("random", 4, inp["n_masked"], H, W))
    with recorded_candidates() as calls:
        cands = candidates.extract_candidates(lt_m.reshape(16, H, W), inp["n_masked"])
        candidates.masked_merge(lt_m, _t(inp["lz_m"]), cands, alpha, cutoff, tid, z, clamp)
        cs = candidates.extract_candidates(tid, 4)
        hdr = candidates.resolve(tid, cs, _t(shades("random", 4, H, W)), clamp)
    assert [kind for kind, _, _ in calls] == ["C1", "C2", "C1", "C3"]
    assert torch.equal(calls[1][1][5], _t(inp["solid_tid"]))  # as the call found it
    assert not torch.equal(calls[1][1][5], tid)
    for (kind, args, kw), result in zip(calls, ((cands,), (tid, z, clamp), (cs,),
                                                (hdr, clamp))):
        got = run_candidates(kind, args, kw, plain=False)
        assert compare(got, run_candidates(kind, args, kw, plain=True))["differing"] == 0
        if kind != "C2":  # C3's clamp is the merged one: the call's own result
            assert compare(got, result)["differing"] == 0
    bad = hdr.clone()
    bad.view(torch.int32)[0, 0, 0, 0] ^= 1
    bad[0, 0, 1, 0] = float("nan")
    counts = compare((bad,), (hdr,))
    assert counts["differing"] == 2 and counts["max_abs_err"] == float("inf")
