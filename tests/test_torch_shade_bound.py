"""chip_smoke.py's bound of the shading kernels, counted from the code on a
tiny stack on the CPU: the sampler filters only the channels each caller
uses, and chooses the mips once a sample and wraps the coordinates once a
tap, so the FP32 operations of a sample are 470 + 417 a channel with the
exact sampler (trilinear, 16 anisotropic taps, sRGB per tap) and its texel
reads 4 a mip-tap whatever the channels:

- S2 (masked alpha): one channel, 115 + 887 = 1002 operations a covered
  element (S2 shades those alone);
- S1 (full shade), lit: base colour 4, emissive 3, occlusion 1, normal 3 —
  11 channels, 115 + 60 + 4 × 470 + 11 × 417 = 6642 operations a covered
  element, 512 texel reads;
- S1 in debug mode 4 (roughness, metalness): two channels, 115 + 470 +
  834 = 1419;
- S3 (UI shade): one trilinear tap of four channels decoded after the
  filter, the earlier four-channel count less 4 an element (the
  coordinates wrapped once a tap, not once a mip);
- the fused S3 (UI shade and composite): its live elements alone (covered,
  inside the clip rect, tex_kind 1 or 2): 70 + 10 a sample they composite
  into, and one trilinear sample of R (font) or RGBA; its bytes the layer
  ids, row0 and the DrawList's tensors once, the HDR samples read once and
  written where their bits change.
"""

import torch

import chip_smoke as cs
import tests.torch_parity  # noqa: F401  (one torch thread a worker)

EXACT = dict(trilinear=True, aniso=16, srgb_per_tap=True)


def _four_channel_work(n, n_srgb, trilinear, aniso, per_tap):
    """The count before the sampler filtered only the channels used: four
    channels whatever the caller used, the mips chosen and the coordinates
    wrapped again at every tap and mip."""
    mips = 2 if trilinear else 1
    ops = n * (17 + 4 * aniso + 4 + aniso * (4 + (17 if trilinear else 2) + mips * 58))
    if not per_tap:
        ops += n_srgb * aniso * mips * 3 * (5 + 8)
    return ops, n * aniso * mips * 4


def _scene_args(tid, mode):
    """(tid, row0, geom, vs, frame, materials) of a shade_stack call: tiny
    tensors whose sizes alone matter to the count."""
    h = tid.shape[-2]
    geom = {"tri_v": torch.zeros((5, 3), dtype=torch.int32)}
    vs = {"clip": torch.zeros((7, 4)), "uv": torch.zeros((7, 2))}
    frame = {"debug_mode": torch.tensor(mode, dtype=torch.int32),
             "material_id": torch.zeros(2, dtype=torch.int32)}
    mats = {"atlas": torch.zeros((8, 8), dtype=torch.int32)}
    return (tid, torch.zeros((h, 1)), geom, vs, frame, mats)


def _tid():
    tid = torch.full((2, 3, 8), -1, dtype=torch.int32)
    tid.view(-1)[[0, 5, 6, 17, 40]] = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
    return tid  # 48 elements, 5 covered


def test_sampler_work_per_channel():
    for c in (1, 2, 3, 4):
        assert cs.sampler_work(1, 0, True, 16, True, c) == (470 + 417 * c, 128)
        assert cs.sampler_work(3, 0, False, 1, True, c) == (3 * (37 + 13 * c), 12)
    # one tap: the four-channel count less the second wrap of a trilinear
    # tap; more taps: less the mip choice and weights again at each further tap
    for tri, aniso, per_tap in ((True, 16, True), (True, 4, False), (False, 1, False),
                                (True, 1, False)):
        ops, taps = cs.sampler_work(10, 4, tri, aniso, per_tap)
        old_ops, old_taps = _four_channel_work(10, 4, tri, aniso, per_tap)
        saved = 10 * aniso * (4 if tri else 0) + 10 * (aniso - 1) * (5 if tri else 2)
        assert (ops, taps) == (old_ops - saved, old_taps)


def test_shade_work_counts_the_channels_used():
    tid = _tid()
    tensors = {}
    out = (torch.zeros((*tid.shape, 4)),)
    ops, taps = cs.shade_work("s1", _scene_args(tid, 0), EXACT, out, tensors)
    assert (ops, taps) == (5 * 6642, 5 * 4 * 128)
    ops, taps = cs.shade_work("s1", _scene_args(tid, 4), EXACT, out, {})
    assert (ops, taps) == (5 * 1419, 5 * 128)
    ops, taps = cs.shade_work("s1", _scene_args(tid, 2), EXACT, out, {})
    assert (ops, taps) == (5 * 115, 0)
    ops, taps = cs.shade_work("s1", _scene_args(tid, 9), EXACT, out, {})  # lit
    assert ops == 5 * 6642
    alpha = (torch.zeros(tid.shape), torch.zeros(tid.shape))
    ops, taps = cs.shade_work("s2", _scene_args(tid, 0), EXACT, alpha, {})
    assert (ops, taps) == (5 * 1002, 5 * 128)
    # each input once, each output under its own key
    args = _scene_args(tid, 0)
    n_in = sum(t.numel() * t.element_size() for a in args
               for t in (a.values() if isinstance(a, dict) else [a]))
    tensors = {}
    cs.shade_work("s1", args, EXACT, out, tensors)
    cs.shade_work("s1", args, EXACT, out, tensors)
    assert sum(tensors.values()) == n_in + 2 * 48 * 16


def test_s3_count():
    lt = torch.tensor([[[0, -1, 1, 1]]], dtype=torch.int32)
    ui = {"tex_slot": torch.tensor([0, 1], dtype=torch.int32),
          "tri_cmd": torch.tensor([0, 1], dtype=torch.int32)}
    mats = {"atlas_srgb": torch.tensor([1, 0], dtype=torch.int32)}
    ops, taps = cs.shade_work("s3", (lt, ui, mats), {"row0": torch.zeros((1, 1))},
                              (torch.zeros((1, 1, 4, 3)), torch.zeros((1, 1, 4))), {})
    # elements 0 and 1 (background reads command 0) sample slot 0, sRGB
    want_ops, want_taps = _four_channel_work(4, 2, True, 1, False)
    assert (ops, taps) == (want_ops - 4 * 4 + 4 * 70, want_taps)


def test_s3c_count():
    """The fused S3's count on a [2, 1, 4] stack over two samples: layer 0
    holds a font element inside its clip rect, a background element, an
    RGBA element clipped away and a kind-0 element; layer 1 an RGBA element
    inside its clip rect (on an sRGB texture) and three background ones."""
    lt = torch.tensor([[[0, -1, 1, 2]], [[3, -1, -1, -1]]], dtype=torch.int32)
    ui = {"tri_cmd": torch.tensor([0, 1, 2, 3], dtype=torch.int32),
          "clip": torch.tensor([[-1.0, -1.0, 9.0, 9.0], [5.0, 5.0, 6.0, 6.0],
                                [-1.0, -1.0, 9.0, 9.0], [-1.0, -1.0, 9.0, 9.0]]),
          "tex_kind": torch.tensor([1, 2, 0, 2], dtype=torch.int32),
          "tex_slot": torch.tensor([1, 0, 0, 0], dtype=torch.int32)}
    mats = {"atlas_srgb": torch.tensor([1, 0], dtype=torch.int32)}
    row0 = torch.zeros((1, 1))
    live, kind = cs.ui_live(lt, ui, row0)
    assert live.tolist() == [[[True, False, False, False]], [[True, False, False, False]]]
    ui.update(tris=torch.zeros((4, 3), dtype=torch.int32), pos=torch.zeros((5, 2)),
              uv=torch.zeros((5, 2)), col=torch.zeros((5, 4)))
    hdr = [torch.zeros((1, 4, 3)), torch.zeros((1, 4, 3))]
    out = [t.clone() for t in hdr]
    out[0][0, 0] = 0.5  # 3 values of sample 0 change; -0.0 differs from +0.0 in bits
    out[1][0, 3, 1] = -0.0
    tensors = {}
    ops, taps = cs.shade_work("s3c", (hdr, lt, ui, mats), {"row0": row0}, tuple(out), tensors)
    font_ops, font_taps = cs.sampler_work(1, 0, True, 1, False, 1, 1)
    rgba_ops, rgba_taps = cs.sampler_work(1, 1, True, 1, False, 4, 3)
    assert (ops, taps) == (2 * (70 + 10 * 2) + font_ops + rgba_ops, font_taps + rgba_taps)
    ui_bytes = 4 * (4 * 3 + 5 * 2 + 5 * 2 + 5 * 4 + 4 + 4 * 4 + 4 + 4)
    assert sum(tensors.values()) == lt.numel() * 4 + 4 + ui_bytes + 2 * 4 * 3 * 4 + 4 * 4
    # a second call on the same inputs adds its samples, not its inputs
    cs.shade_work("s3c", (hdr, lt, ui, mats), {"row0": row0}, tuple(hdr), tensors)
    assert sum(tensors.values()) == lt.numel() * 4 + 4 + ui_bytes + 4 * 4 * 3 * 4 + 4 * 4
