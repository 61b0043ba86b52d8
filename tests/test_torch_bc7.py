"""The port's BC7 decode, ntex container, device atlas and glTF proxy
against the JAX package (and Pillow) on the CPU.

tests/golden/torch-bc7-vectors.npz carries random blocks of every BC7 mode
and a mixed-mode 37×29 mip chain with Pillow's decode of each, so the card
(whose machine has neither Pillow nor jax) is held against the reference
decoder by chip_smoke.py. Regenerate it with

    python -m tests.test_torch_bc7 regen
"""

import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_parity  # noqa: F401 — one torch thread a worker

VECTORS = Path(__file__).parent / "golden" / "torch-bc7-vectors.npz"
CHAIN_W, CHAIN_H, CHAIN_MIPS = 37, 29, 5  # mip 5 of 37×29 would be 1×0


def random_blocks(rng, mode: int, n: int) -> np.ndarray:
    """n random valid blocks of one mode (any bits after the mode prefix)."""
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    blocks[:, 0] = ((1 << mode) | (blocks[:, 0] << (mode + 1))) & 0xFF
    return blocks


def mixed_blocks(rng, n: int) -> np.ndarray:
    """n random blocks of random modes 0-7."""
    modes = rng.integers(0, 8, n)
    out = np.empty((n, 16), np.uint8)
    for m in range(8):
        sel = np.nonzero(modes == m)[0]
        out[sel] = random_blocks(rng, m, len(sel))
    return out


def chain_shapes(w: int, h: int, n: int) -> list[tuple[int, int]]:
    """(h, w) of each mip as ntex sizes them (width >> mip)."""
    return [(h >> m, w >> m) for m in range(n)]


def chain_blocks(rng, w: int, h: int, n: int) -> list[np.ndarray]:
    return [mixed_blocks(rng, -(-mw // 4) * -(-mh // 4))
            for mh, mw in chain_shapes(w, h, n)]


def ntex_bytes(w: int, h: int, fmt: int, payloads, *, depth: int = 1,
               magic: bytes | None = None, block=(4, 4, 16)) -> bytes:
    """An ntex container (1024-byte header + packed mips)."""
    from renderer_tpu_torch.assets import ntex

    header = bytearray(1024)
    m = ntex.MAGIC if magic is None else magic
    header[:len(m)] = m
    struct.pack_into("<8I", header, 992, w, h, depth, len(payloads), fmt, *block)
    return bytes(header) + b"".join(
        p if isinstance(p, bytes) else np.ascontiguousarray(p).tobytes()
        for p in payloads)


def pillow_decode_blocks(blocks: np.ndarray) -> np.ndarray:
    """[N, 16] u32 texels of each block, decoded by Pillow's bcn decoder."""
    from tools.extract_bc7_tables import decode_block

    return np.stack([np.ascontiguousarray(decode_block(b.tobytes()).reshape(16, 4))
                     .view("<u4")[:, 0] for b in blocks])


def make_vectors() -> dict:
    """128 random blocks of each mode 0-7 and the mixed-mode 37×29 chain,
    with Pillow's decode of each (reserved blocks are left out: Pillow
    decodes them opaque black, the JAX package and the port transparent
    black)."""
    from renderer_tpu.assets import ntex as jntex

    rng = np.random.default_rng(2024)
    blocks = np.concatenate([random_blocks(rng, m, 128) for m in range(8)])
    out = {"blocks": blocks, "texels": pillow_decode_blocks(blocks)}
    for i, (b, (mh, mw)) in enumerate(zip(
            chain_blocks(rng, CHAIN_W, CHAIN_H, CHAIN_MIPS),
            chain_shapes(CHAIN_W, CHAIN_H, CHAIN_MIPS))):
        out[f"chain{i}_blocks"] = b
        out[f"chain{i}_rgba"] = jntex._decode_bc7(b.tobytes(), mw, mh)
    return out


# -- the BC7 decoder ---------------------------------------------------------


def test_tables_equal_the_jax_package_tables():
    from renderer_tpu.materials import bc7_tables as jt
    from renderer_tpu_torch.materials import bc7_tables as pt

    names = [n for n in dir(jt) if n.isupper()]
    assert names
    for n in names:
        np.testing.assert_array_equal(getattr(pt, n), getattr(jt, n), n)


@pytest.mark.parametrize("mode", [*range(8), "reserved"])
def test_decode_blocks_matches_jax(mode):
    """128 random blocks of one mode (or reserved: byte 0 zero) decode
    bit-equal to bc7_jax.decode_blocks_np."""
    from renderer_tpu.materials import bc7_jax
    from renderer_tpu_torch.materials import bc7

    rng = np.random.default_rng(11 if mode == "reserved" else 11 + mode)
    if mode == "reserved":
        blocks = rng.integers(0, 256, (128, 16), dtype=np.uint8)
        blocks[:, 0] = 0
    else:
        blocks = random_blocks(rng, mode, 128)
    got = bc7.decode_blocks(blocks, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (128, 16)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  bc7_jax.decode_blocks_np(blocks))


def test_committed_vectors_equal_a_fresh_pillow_decode():
    z = np.load(VECTORS)
    fresh = make_vectors()
    assert sorted(z.files) == sorted(fresh)
    for k in z.files:
        np.testing.assert_array_equal(z[k], fresh[k], k)


def test_port_decodes_the_vectors_like_pillow():
    from renderer_tpu_torch.materials import bc7

    z = np.load(VECTORS)
    got = bc7.decode_blocks(z["blocks"], device="cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got, z["texels"])
    for i, (mh, mw) in enumerate(chain_shapes(CHAIN_W, CHAIN_H, CHAIN_MIPS)):
        tex = bc7.decode_blocks(z[f"chain{i}_blocks"], device="cpu")
        np.testing.assert_array_equal(
            bc7.blocks_to_image(tex, mw, mh).numpy(), z[f"chain{i}_rgba"])


def test_decode_refuses_a_missing_card():
    from renderer_tpu_torch.materials import bc7

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bc7.decode_blocks(np.zeros((1, 16), np.uint8))


# -- ntex containers: the port parses what the JAX package parses ----------


def _ntex_cases():
    from renderer_tpu_torch.assets import ntex as n

    rng = np.random.default_rng(5)
    rgba = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            for h, w in ((8, 16), (4, 8), (2, 4), (1, 2), (1, 1))]
    r8 = [rng.integers(0, 256, (h, w), dtype=np.uint8)
          for h, w in ((6, 10), (3, 5), (1, 2), (1, 1))]
    bc = chain_blocks(rng, 16, 8, 3)
    odd = chain_blocks(rng, CHAIN_W, CHAIN_H, CHAIN_MIPS)
    return {
        "bc7-srgb": ntex_bytes(16, 8, n.VK_FORMAT_BC7_SRGB, bc),
        "bc7-unorm": ntex_bytes(16, 8, n.VK_FORMAT_BC7_UNORM, bc),
        "bc7-37x29": ntex_bytes(CHAIN_W, CHAIN_H, n.VK_FORMAT_BC7_SRGB, odd),
        "rgba8": ntex_bytes(16, 8, n.VK_FORMAT_R8G8B8A8_SRGB, rgba, block=(1, 1, 4)),
        "r8": ntex_bytes(10, 6, n.VK_FORMAT_R8_UNORM, r8, block=(1, 1, 1)),
        "bad-magic": ntex_bytes(16, 8, n.VK_FORMAT_BC7_SRGB, bc, magic=b"x" * 40),
        "short-header": ntex_bytes(16, 8, n.VK_FORMAT_BC7_SRGB, bc)[:1000],
        "depth-2": ntex_bytes(16, 8, n.VK_FORMAT_BC7_SRGB, bc, depth=2),
        "length-mismatch": ntex_bytes(16, 8, n.VK_FORMAT_BC7_SRGB, bc)[:-16],
        "unsupported-format": ntex_bytes(16, 8, 50, rgba, block=(1, 1, 4)),
        # 8×4 with 4 mips: the last mip is 1×0, an empty payload
        "zero-side-mip": ntex_bytes(8, 4, n.VK_FORMAT_BC7_SRGB,
                                    chain_blocks(rng, 8, 4, 3) + [b""]),
    }


_NTEX_CASES = ("bc7-srgb", "bc7-unorm", "bc7-37x29", "rgba8", "r8", "bad-magic",
               "short-header", "depth-2", "length-mismatch",
               "unsupported-format", "zero-side-mip")


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return "error", (type(e).__name__, str(e))


@pytest.mark.parametrize("case", _NTEX_CASES)
def test_ntex_container_parses_like_jax(case):
    from renderer_tpu.assets import ntex as jn
    from renderer_tpu_torch.assets import ntex as pn

    data = _ntex_cases()[case]
    for name in ("decode", "read_blocks"):
        jkind, jres = _outcome(lambda: getattr(jn, name)(data))
        pkw = {"device": "cpu"} if name == "decode" else {}
        pkind, pres = _outcome(lambda: getattr(pn, name)(data, **pkw))
        assert pkind == jkind, (name, jres, pres)
        if jkind == "error":
            assert pres == jres, name
            continue
        (jh, jm), (ph, pm) = jres, pres
        assert vars(jh) == vars(ph)
        assert jh.mip_ranges() == ph.mip_ranges()
        assert jn.is_srgb_format(jh.vk_format) == pn.is_srgb_format(ph.vk_format)
        assert (jm is None) == (pm is None)
        for a, b in zip(jm or [], pm or []):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ntex_reserved_blocks_decode_opaque_like_pillow():
    """A reserved block (byte 0 zero) decodes to opaque black in both
    packages' ntex decoders (Pillow's bcn decoder in the JAX package), on
    every texel; bc7.decode_blocks keeps bc7_jax's transparent black."""
    from renderer_tpu.assets import ntex as jn
    from renderer_tpu_torch.assets import ntex as pn
    from renderer_tpu_torch.materials import bc7

    rng = np.random.default_rng(6)
    blocks = mixed_blocks(rng, 4)  # 8×8: 2×2 blocks, two of them reserved
    blocks[[0, 3], 0] = 0
    data = ntex_bytes(8, 8, pn.VK_FORMAT_BC7_SRGB, [blocks])
    want, got = jn.decode(data)[1][0], pn.decode(data, device="cpu")[1][0]
    np.testing.assert_array_equal(got, want)
    assert (got[:4, :4] == [0, 0, 0, 255]).all()
    assert (got[4:, 4:] == [0, 0, 0, 255]).all()
    texels = bc7.decode_blocks(blocks, device="cpu").numpy()
    assert (texels[[0, 3]] == 0).all()


def test_ntex_decode_file_and_its_cache(tmp_path, monkeypatch):
    from renderer_tpu.assets import ntex as jn
    from renderer_tpu_torch.assets import ntex as pn

    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path / "cache"))
    f = tmp_path / "t.ntex"
    f.write_bytes(_ntex_cases()["bc7-37x29"])
    want = jn.decode_file(f, cache=False)[1]
    assert vars(pn.decode_header_file(f)) == vars(jn.decode_header_file(f))
    assert pn.file_fingerprint(f) == jn.file_fingerprint(f)
    for _ in range(2):  # cold (decodes, writes the cache), then warm
        header, mips = pn.decode_file(f, device="cpu")
        assert header.mip_levels == len(mips) == CHAIN_MIPS
        for a, b in zip(want, mips):
            np.testing.assert_array_equal(a, b)
    assert len(list((tmp_path / "cache" / "ntex").glob("*.npz"))) == 1


# -- the device atlas --------------------------------------------------------


def _checker(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[..., 3] = 255
    return img


def _registries():
    """test_bc7_decode.py's synthetic registry built in both packages: BC7
    textures 37×29 (sRGB), 16×64 with wrap (1, 2), a 4×4 normal map with
    wrap (2, 0), and a raw RGBA texture with wrap_s 1. The BC7 textures are
    lazy: decoded mips through each package's ntex decoder, raw blocks for
    the device plan."""
    import renderer_tpu as jt
    import renderer_tpu_torch as pt
    from renderer_tpu.assets import ntex as jn
    from renderer_tpu_torch.assets import ntex as pn

    rng = np.random.default_rng(3)
    specs = [("a", 37, 29, "SRGB_COLOR", 0, 0), ("b", 16, 64, "LINEAR_COLOR", 1, 2),
             ("c", 4, 4, "NORMAL_MAP", 2, 0)]
    chains = []
    for name, h, w, kind, ws, wt in specs:
        shapes, mh, mw = [], h, w
        while True:
            shapes.append((mh, mw))
            if mh == 1 and mw == 1:
                break
            mh, mw = max(mh // 2, 1), max(mw // 2, 1)
        chains.append([mixed_blocks(rng, -(-sw // 4) * -(-sh // 4))
                       for sh, sw in shapes])
    mips = [_checker(24, 24, 9)]
    while mips[-1].shape[0] > 1:
        mips.append(mips[-1][::2, ::2])

    regs = []
    for pkg, dec in ((jt, lambda b, w, h: jn._decode_bc7(b.tobytes(), w, h)),
                     (pt, lambda b, w, h: pn._decode_bc7(b.tobytes(), w, h, "cpu"))):
        reg = pkg.MaterialRegistry()
        for (name, h, w, kind, ws, wt), blocks in zip(specs, chains):
            def load(blocks=blocks, h=h, w=w, dec=dec):
                out, mh, mw = [], h, w
                for b in blocks:
                    out.append(dec(b, mw, mh))
                    mh, mw = max(mh // 2, 1), max(mw // 2, 1)
                return out

            reg.register_texture(pkg.Texture(
                None, getattr(pkg.TextureKind, kind), name=name, loader=load,
                shape=(h, w), fingerprint=f"test:{name}", wrap_s=ws, wrap_t=wt,
                blocks_loader=lambda blocks=blocks: blocks))
        reg.register_texture(pkg.Texture([m.copy() for m in mips],
                                          pkg.TextureKind.SRGB_COLOR, name="raw",
                                          wrap_s=1))
        regs.append(reg)
    return regs


def test_device_atlas_equals_the_host_atlases(tmp_path, monkeypatch):
    """realize_atlas(build_atlas_plan(...), "cpu") ≡ the port's host atlas ≡
    the JAX package's host atlas, texel for texel, with the same tables."""
    from renderer_tpu.materials.atlas import _build_atlas_uncached as jax_atlas
    from renderer_tpu_torch.materials import atlas, atlas_device

    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path))
    jreg, preg = _registries()
    want = jax_atlas(jreg)
    host = atlas.build_atlas(preg)
    np.testing.assert_array_equal(host.data, want.data)
    plan = atlas_device.build_atlas_plan(preg)
    dev = atlas_device.realize_atlas(plan, device="cpu")
    assert dev.dtype == torch.int32 and tuple(dev.shape) == want.data.shape
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), want.data)
    for k in ("table", "srgb", "wrap"):
        np.testing.assert_array_equal(getattr(plan, k), getattr(want, k), k)
        np.testing.assert_array_equal(getattr(host, k), getattr(want, k), k)
    np.testing.assert_allclose(plan.flat, want.flat, atol=1e-6)
    assert plan.upload_bytes < want.data.nbytes
    # warm: the bundle and the plan come back from their disk caches
    np.testing.assert_array_equal(atlas.build_atlas(preg).data, want.data)
    cached = atlas_device.build_atlas_plan_cached(preg)
    again = atlas_device.build_atlas_plan_cached(preg)
    np.testing.assert_array_equal(np.asarray(again.blocks), plan.blocks)
    assert again.mode_counts == cached.mode_counts == plan.mode_counts


def _reserved_registry():
    """A registry of one 16×8 BC7 texture "r" whose mips 0 and 2 hold
    reserved blocks (byte 0 zero); its loader decodes like Pillow."""
    import renderer_tpu_torch as pt
    from renderer_tpu_torch.assets import ntex as pn

    rng = np.random.default_rng(4)
    chain = [mixed_blocks(rng, n) for n in (8, 2, 1, 1)]  # 16×8 down to 1×1
    chain[0][::3, 0] = 0
    chain[2][:, 0] = 0
    shapes = [(8, 16), (4, 8), (2, 4), (1, 2)]
    reg = pt.MaterialRegistry()
    slot = reg.register_texture(pt.Texture(
        None, pt.TextureKind.SRGB_COLOR, name="r", shape=(8, 16), fingerprint="test:r",
        loader=lambda: [pn._decode_bc7(b.tobytes(), w, h, "cpu")
                        for b, (h, w) in zip(chain, shapes)],
        blocks_loader=lambda: chain))
    return reg, slot


def test_device_atlas_plan_refuses_reserved_blocks(tmp_path, monkeypatch):
    """Reserved blocks (byte 0 zero) in a texture's stream: the device plan
    raises, naming the texture, as the JAX plan asserts; the cached plan is
    None; the host atlas decodes them to Pillow's opaque black."""
    from renderer_tpu_torch.materials import atlas, atlas_device

    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path))
    reg, slot = _reserved_registry()
    assert atlas_device.reserved_block(reg) == "texture 'r' mip 0"
    with pytest.raises(ValueError, match="texture 'r' mip 0: reserved BC7 block"):
        atlas_device.build_atlas_plan(reg)
    assert atlas_device.build_atlas_plan_cached(reg) is None
    host = atlas.build_atlas(reg)
    x, y = host.table[slot, 0, :2]
    block0 = host.data[y:y + 4, x:x + 4].view(np.uint8).reshape(4, 4, 4)
    assert (block0 == [0, 0, 0, 255]).all()


def _render_textured_quad(reg, tex, mode, monkeypatch):
    """debug_mode 1 (base color) of a screen-filling quad textured with
    `tex`, atlas path forced to `mode`: (image, whether the renderer was
    on its device-atlas branch)."""
    import renderer_tpu_torch as pt
    from renderer_tpu_torch.core import math3d

    monkeypatch.setenv("RENDERER_TPU_ATLAS", mode)
    builder = pt.VertexLibraryBuilder()
    p = np.array([[-0.8, 0.8, 1.2], [0.8, 0.8, 1.2], [-0.8, -0.8, 1.2],
                  [0.8, -0.8, 1.2]], np.float32)
    uv = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
    nrm = np.tile([0, 0, -1.0], (4, 1)).astype(np.float32)
    t4 = np.tile([1, 0, 0, 1.0], (4, 1)).astype(np.float32)
    mesh = builder.add_mesh(p, uv, nrm, t4, np.array([0, 1, 2, 2, 1, 3], np.uint32))
    builder.build()
    mat = reg.create_material("m", pt.PbrMaterialParameters(base_color=tex))
    scene = pt.Scene()
    scene.queue_mesh(mesh, mat, None, math3d.IDENTITY)
    r = pt.Renderer(reg, pt.RenderConfig(width=128, height=64, tile_h=16),
                    device="cpu")
    img = r.render_frame(scene, debug_mode=1)
    return img, r._use_device_atlas()


def test_renderer_takes_the_host_atlas_for_reserved_blocks(tmp_path, monkeypatch, capsys):
    """RENDERER_TPU_ATLAS=device with a reserved block in a stream: the
    renderer chooses the host atlas (as the JAX renderer does after its
    plan's assert) and renders the same frame as the host path, the
    reserved blocks opaque black."""
    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path))
    reg, slot = _reserved_registry()
    host, used_host = _render_textured_quad(reg, reg.textures[slot], "host", monkeypatch)
    reg, slot = _reserved_registry()
    dev, used_dev = _render_textured_quad(reg, reg.textures[slot], "device", monkeypatch)
    assert (used_host, used_dev) == (False, True)
    assert "reserved BC7 block in a texture; using the host atlas path" in capsys.readouterr().out
    np.testing.assert_array_equal(host, dev)
    assert host.std() > 5 and (host == 0).all(axis=-1).any()


def test_renderer_device_atlas_renders_like_the_host_path(tmp_path, monkeypatch):
    """RENDERER_TPU_ATLAS=device renders the same frame as the host path
    (the sampler reading the device-realized atlas)."""
    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path))

    def render(mode):
        reg = _registries()[1]
        tex = next(t for t in reg.textures.values() if t.name == "a")
        return _render_textured_quad(reg, tex, mode, monkeypatch)

    host, used_host = render("host")
    dev, used_dev = render("device")
    assert (used_host, used_dev) == (False, True)
    assert host.std() > 5
    np.testing.assert_array_equal(host, dev)


def test_plan_cache_replaces_a_stale_format_dir(tmp_path, monkeypatch):
    """An old-format plan directory is replaced on rebuild (os.replace
    cannot overwrite a non-empty dir), and the next call loads the cache."""
    from renderer_tpu_torch.materials import atlas_device

    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path))
    reg = _registries()[1]
    cdir = atlas_device._plan_cache_dir(reg)
    cdir.mkdir(parents=True)
    (cdir / "meta.json").write_text('{"version": 1}')
    (cdir / "stale.npy").write_bytes(b"junk")
    plan = atlas_device.build_atlas_plan_cached(reg)
    assert json.loads((cdir / "meta.json").read_text())["version"] == 2
    assert not (cdir / "stale.npy").exists()
    monkeypatch.setattr(atlas_device, "build_atlas_plan", lambda r: pytest.fail("rebuilt"))
    np.testing.assert_array_equal(
        np.asarray(atlas_device.build_atlas_plan_cached(reg).blocks), plan.blocks)


# -- load_gltf_proxy -----------------------------------------------------------


def _proxy_files(root: Path):
    """A glTF JSON with no .bin (accessor metadata only) plus two ntex
    textures: a node tree (TRS, matrix, children), samplers, three
    materials in every alpha mode, two meshes of three primitives."""
    from renderer_tpu_torch.assets import ntex as n

    rng = np.random.default_rng(8)
    (root / "a.ntex").write_bytes(ntex_bytes(16, 8, n.VK_FORMAT_BC7_SRGB,
                                             chain_blocks(rng, 16, 8, 3)))
    (root / "b.ntex").write_bytes(ntex_bytes(8, 8, n.VK_FORMAT_BC7_UNORM,
                                             chain_blocks(rng, 8, 8, 4)))
    acc = [
        {"count": 120, "type": "VEC3", "componentType": 5126,
         "min": [-1, 0, -2], "max": [1, 3, 2]},
        {"count": 600, "type": "SCALAR", "componentType": 5125},
        {"count": 50, "type": "VEC3", "componentType": 5126,
         "min": [0, 0, 0], "max": [0.5, 2, 0.1]},
        {"count": 150, "type": "SCALAR", "componentType": 5123},
    ]
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [
            {"name": "root", "children": [1, 2], "translation": [0, 1, 0]},
            {"mesh": 0, "rotation": [0, 0.38268343, 0, 0.9238795], "scale": [2, 1, 1]},
            {"mesh": 1, "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 3, 0, -1, 1]},
        ],
        "images": [{"uri": "a.png"}, {"uri": "b.png"}],
        "samplers": [{"wrapS": 33071, "wrapT": 33648}],
        "textures": [{"source": 0, "sampler": 0}, {"source": 1}],
        "materials": [
            {"name": "stone", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
                "metallicRoughnessTexture": {"index": 1}}},
            {"name": "leaf", "alphaMode": "MASK", "alphaCutoff": 0.3,
             "normalTexture": {"index": 1, "scale": 0.5},
             "pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}},
            {"name": "glass", "alphaMode": "BLEND", "emissiveFactor": [1, 0.5, 0],
             "pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.9, 0.5]}},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "material": 0},
                            {"attributes": {"POSITION": 2}, "indices": 3, "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": 0}, "indices": 3, "material": 2}]},
        ],
        "accessors": acc,
    }
    path = root / "scene.gltf"
    path.write_text(json.dumps(gltf))
    return path


def test_load_gltf_proxy_matches_jax(tmp_path, monkeypatch):
    import renderer_tpu as jt
    import renderer_tpu_torch as pt
    from renderer_tpu.assets import proxy as jp
    from renderer_tpu_torch.assets import proxy as pp

    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path / "cache"))
    path = _proxy_files(tmp_path)
    jreg, jb = jt.MaterialRegistry(), jt.VertexLibraryBuilder()
    preg, pb = pt.MaterialRegistry(), pt.VertexLibraryBuilder()
    jg = jp.load_gltf_proxy(path, jb, jreg)
    pg = pp.load_gltf_proxy(path, pb, preg, device="cpu")
    jlib, plib = jb.build(), pb.build()
    assert pg.root_nodes == jg.root_nodes
    for a, b in zip(jg.nodes, pg.nodes, strict=True):
        assert (a.name, a.mesh, a.skin, a.children) == (b.name, b.mesh, b.skin, b.children)
        np.testing.assert_array_equal(a.transform, b.transform)
    for a, b in zip(jg.textures, pg.textures, strict=True):
        assert (a.name, a.kind, a.wrap_s, a.wrap_t, a.fingerprint) == \
            (b.name, b.kind, b.wrap_s, b.wrap_t, b.fingerprint)
        for x, y in zip(a.mips, b.mips, strict=True):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.bc7_mips, b.bc7_mips, strict=True):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(jg.materials, pg.materials, strict=True):
        assert (a.name, a.id) == (b.name, b.id)
    for k in ("base_color_factor", "emissive_occlusion", "alpha_rgh_mtl_normal",
              "tex_indices", "alpha_mode"):
        np.testing.assert_array_equal(getattr(jreg, k), getattr(preg, k), k)
    assert [[(m.vertex_count, m.index_count, mat.id) for m, mat in prims]
            for prims in pg.meshes] == \
        [[(m.vertex_count, m.index_count, mat.id) for m, mat in prims]
         for prims in jg.meshes]
    for k in ("positions", "uvs", "normals", "tangents", "indices"):
        np.testing.assert_array_equal(getattr(plib, k), getattr(jlib, k), k)


def regenerate():
    VECTORS.parent.mkdir(exist_ok=True)
    np.savez_compressed(VECTORS, **make_vectors())
    print(f"wrote {VECTORS}")


if __name__ == "__main__":
    import sys

    from tests import conftest  # noqa: F401 — the JAX package on the CPU

    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        regenerate()
