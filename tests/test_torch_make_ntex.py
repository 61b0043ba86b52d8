"""The port's texture compiler (renderer_tpu_torch/tools/make_ntex.py) and
its Pillow-free mip resize (tools/resample.py) on the CPU.

- resample.resize equals Pillow's LANCZOS and BILINEAR resize of RGBA
  images bit for bit: odd sizes, alpha 0, 255 and partial, down- and
  upscales, and every mip of a chain down to 4×4 against the JAX tool's
  build_mips.
- encode_ntex gives the JAX tool's bytes on the same PNG, and the port's
  PNG decode of it equals Pillow's.
- The CLI: output equal to the JAX CLI's, skip without --overwrite,
  --overwrite, --assume-linear, and the refusal of a file that is neither
  PNG nor JPEG, or a JPEG cut short (tests/test_torch_jpeg.py holds the
  JPEG path against the JAX tool).
"""

import numpy as np
import pytest
from PIL import Image

from tests import torch_parity  # noqa: F401 — one torch thread a worker

from renderer_tpu_torch.assets import ntex, png
from renderer_tpu_torch.tools import make_ntex, resample
from tools import make_ntex as jmake_ntex


def _rgba(h, w, seed):
    """Noise over a gradient, with alpha 0, 255 and partial in patches."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.linspace(0, 255, w), np.linspace(0, 255, h))
    img = np.stack([x, y, (x + y) / 2, 255 - x], -1) + rng.normal(0, 24, (h, w, 4))
    img = np.clip(img, 0, 255).astype(np.uint8)
    a = rng.random((h, w))
    img[..., 3] = np.where(a < 0.25, 0, np.where(a < 0.5, 255, img[..., 3]))
    return img


PIL_FILTERS = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR}


@pytest.mark.parametrize("filter_name", ["lanczos", "bilinear"])
@pytest.mark.parametrize("h,w", [(37, 23), (64, 64), (5, 131), (90, 7)])
def test_resize_equals_pillow(filter_name, h, w):
    img = _rgba(h, w, h * 1000 + w)
    for oh, ow in [(h // 2, w // 2), (max(h // 5, 1), max(w // 3, 1)), (h, max(w // 2, 1)),
                   (max(h // 2, 1), w), (h + 3, 2 * w)]:
        want = np.asarray(Image.fromarray(img).resize((ow, oh), PIL_FILTERS[filter_name]))
        np.testing.assert_array_equal(resample.resize(img, ow, oh, filter_name), want,
                                      err_msg=f"{filter_name} {h}x{w} -> {oh}x{ow}")


def test_premultiply_round_trip_equals_pillow():
    img = _rgba(16, 16, 3)
    img[0, :, 3] = np.arange(16) * 17  # every partial alpha step
    rgba_pm = np.asarray(Image.fromarray(img).convert("RGBa"))
    np.testing.assert_array_equal(resample.premultiply(img), rgba_pm)
    back = np.asarray(Image.fromarray(rgba_pm, "RGBa").convert("RGBA"))
    np.testing.assert_array_equal(resample.unpremultiply(rgba_pm), back)


def test_resize_refuses_bad_input():
    with pytest.raises(ValueError, match="u8"):
        resample.resize(np.zeros((4, 4, 3), np.uint8), 2, 2, "lanczos")
    with pytest.raises(ValueError, match="filter"):
        resample.resize(np.zeros((4, 4, 4), np.uint8), 2, 2, "bicubic")


@pytest.mark.parametrize("color", [True, False])
@pytest.mark.parametrize("h,w", [(64, 48), (71, 133)])
def test_mip_chain_equals_the_jax_tool(color, h, w):
    img = _rgba(h, w, 7)
    got = make_ntex.build_mips(img, color)
    want = jmake_ntex.build_mips(img, color)
    assert len(got) == len(want) and min(got[-1].shape[:2]) <= 4
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("srgb", [True, False])
def test_encode_ntex_bytes_equal_the_jax_tool(tmp_path, srgb):
    img = _rgba(29, 37, 11)
    path = tmp_path / "tex.png"
    png.write_png(path, img)
    decoded = make_ntex.read_image(path)
    np.testing.assert_array_equal(decoded, np.asarray(Image.open(path).convert("RGBA")))
    got = make_ntex.encode_ntex(decoded, srgb)
    assert got == jmake_ntex.encode_ntex(decoded, srgb)
    header, mips = ntex.decode(got, device="cpu")
    assert (header.width, header.height) == (37, 29)
    assert header.vk_format == (ntex.VK_FORMAT_BC7_SRGB if srgb else ntex.VK_FORMAT_BC7_UNORM)
    assert [m.shape[:2] for m in mips] == [(29, 37), (14, 18), (7, 9), (3, 4)]


def _write_pngs(root, names):
    root.mkdir()
    paths = []
    for i, name in enumerate(names):
        p = root / name
        png.write_png(p, _rgba(12 + 4 * i, 20, i))
        paths.append(p)
    return paths


def test_cli_equals_the_jax_cli_and_skips_and_overwrites(tmp_path):
    names = ["wall.png", "wall_rough.png"]  # colour and (by name) linear
    ours = _write_pngs(tmp_path / "port", names)
    theirs = _write_pngs(tmp_path / "jax", names)
    assert make_ntex.main(["--silent", *map(str, ours)]) == 0
    assert jmake_ntex.main(["--silent", *map(str, theirs)]) == 0
    for a, b in zip(ours, theirs):
        assert a.with_suffix(".ntex").read_bytes() == b.with_suffix(".ntex").read_bytes()
    formats = [ntex.decode_header(p.with_suffix(".ntex").read_bytes()).vk_format for p in ours]
    assert formats == [ntex.VK_FORMAT_BC7_SRGB, ntex.VK_FORMAT_BC7_UNORM]

    out = ours[0].with_suffix(".ntex")
    out.write_bytes(b"stale")
    assert make_ntex.main(["--silent", str(ours[0])]) == 0  # exists: skipped
    assert out.read_bytes() == b"stale"
    assert make_ntex.main(["--silent", "--overwrite", "--assume-linear", str(ours[0])]) == 0
    assert ntex.decode_header(out.read_bytes()).vk_format == ntex.VK_FORMAT_BC7_UNORM
    jout = theirs[0].with_suffix(".ntex")
    assert jmake_ntex.main(["--silent", "--overwrite", "--assume-linear", str(theirs[0])]) == 0
    assert out.read_bytes() == jout.read_bytes()


def test_cli_reports_a_skip(tmp_path, capsys):
    (path,) = _write_pngs(tmp_path / "d", ["a.png"])
    path.with_suffix(".ntex").write_bytes(b"x")
    assert make_ntex.main([str(path)]) == 0
    assert "skip" in capsys.readouterr().err


def test_cli_refuses_what_is_not_png(tmp_path):
    """Neither PNG nor JPEG (a GIF), and a JPEG cut short: both refused,
    naming what was found; no .ntex is written."""
    gif = tmp_path / "tex.gif"
    gif.write_bytes(b"GIF89a\x01\x00\x01\x00")
    with pytest.raises(ValueError, match="not a PNG or JPEG image"):
        make_ntex.main(["--silent", str(gif)])
    path = tmp_path / "tex.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ValueError, match="JPEG: corrupt or truncated"):
        make_ntex.main(["--silent", str(path)])
    assert not list(tmp_path.glob("*.ntex"))
