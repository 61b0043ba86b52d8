"""make_ntex: the offline texture compiler, PNG and JPEG images → BC7 .ntex
files.

The reference's make-ntex CLI (make-ntex/src/main.rs:47-95): a full mip
chain (Lanczos for colour, bilinear for non-colour data,
main.rs:150-156,201-209), BC7 compression (the host library's
all-mode encoder, csrc/bc7enc.cpp through tools/native.py; the reference
uses intel_tex at slow settings) and the 1024-byte ntex header.

Without Pillow: images are decoded by assets/image.py (PNG through
assets/png.py, JPEG through assets/jpeg.py, each equal to Pillow's decode;
anything else raises), and the mips come from tools/resample.py, which
equals Pillow's LANCZOS / BILINEAR resize bit for bit, so the output equals
the JAX package's tool (tools/make_ntex.py) byte for byte.

    python -m renderer_tpu_torch.tools.make_ntex [--overwrite] [--silent]
        [--assume-color | --assume-linear] FILE [FILE ...]

Each FILE (.png, .jpg, ...) is written beside itself as FILE.ntex; an
existing .ntex is skipped unless --overwrite.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from renderer_tpu_torch.assets import ntex as ntex_mod
from renderer_tpu_torch.assets.image import decode_image
from renderer_tpu_torch.tools import native, resample


def build_mips(rgba: np.ndarray, color: bool) -> list[np.ndarray]:
    """The full mip chain, each level resized from the base image: Lanczos
    for colour data, bilinear for non-colour data (make-ntex/src/main.rs:
    150-156), halving until a side reaches 4 (a BC7 block)."""
    filter_name = "lanczos" if color else "bilinear"
    mips = [rgba]
    h, w = rgba.shape[:2]
    while w > 4 and h > 4:
        w //= 2
        h //= 2
        mips.append(resample.resize(rgba, w, h, filter_name))
    return mips


def _assemble_ntex(rgba: np.ndarray, mips_blocks: list[bytes], srgb: bool) -> bytes:
    fmt = ntex_mod.VK_FORMAT_BC7_SRGB if srgb else ntex_mod.VK_FORMAT_BC7_UNORM
    header = bytearray(1024)
    header[: len(ntex_mod.MAGIC)] = ntex_mod.MAGIC
    struct.pack_into(
        "<8I", header, 992,
        rgba.shape[1], rgba.shape[0], 1, len(mips_blocks), fmt, 4, 4, 16,
    )
    return bytes(header) + b"".join(mips_blocks)


def encode_ntex(rgba: np.ndarray, srgb: bool, pool=None) -> bytes:
    """One image as .ntex bytes. With an executor the per-mip BC7 encodes
    fan out on it (the reference runs rayon over files × mips,
    make-ntex/src/main.rs:76-88,198-210; the encoder is a ctypes call,
    which releases the interpreter lock, so threads scale)."""
    mips = build_mips(np.ascontiguousarray(rgba, np.uint8), color=srgb)
    if pool is None:
        blocks = [native.bc7_encode(m).tobytes() for m in mips]
    else:
        blocks = [f.result().tobytes()
                  for f in [pool.submit(native.bc7_encode, m) for m in mips]]
    return _assemble_ntex(rgba, blocks, srgb)


def is_color_image(path: Path, assume_color: bool, assume_linear: bool) -> bool:
    if assume_color:
        return True
    if assume_linear:
        return False
    # make-ntex's name-based guess, colour by default
    name = path.stem.lower()
    return not any(k in name for k in ("normal", "rough", "metal", "occl", "_n", "_rm"))


def read_image(path: Path) -> np.ndarray:
    """RGBA u8 [h, w, 4] of a PNG or JPEG file; other formats raise
    ValueError."""
    try:
        return decode_image(path.read_bytes())
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="+", type=Path)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--silent", action="store_true")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--assume-color", action="store_true")
    group.add_argument("--assume-linear", action="store_true")
    args = ap.parse_args(argv)

    todo = []
    for path in args.files:
        out = path.with_suffix(".ntex")
        if out.exists() and not args.overwrite:
            if not args.silent:
                print(f"skip {out} (exists; use --overwrite)", file=sys.stderr)
            continue
        todo.append((path, out))

    # parallel over files and mips (make-ntex/src/main.rs:76-88,198-210):
    # per-file tasks decode and build the mips, the per-mip BC7 encodes fan
    # out on a second pool, so a lone large file still uses every core
    nproc = os.cpu_count() or 4
    with ThreadPoolExecutor(nproc) as files_pool, ThreadPoolExecutor(nproc) as mips_pool:

        def process(path: Path, out: Path) -> str:
            rgba = read_image(path)
            srgb = is_color_image(path, args.assume_color, args.assume_linear)
            out.write_bytes(encode_ntex(rgba, srgb, pool=mips_pool))
            kind = "sRGB" if srgb else "linear"
            return f"wrote {out} ({rgba.shape[1]}x{rgba.shape[0]}, BC7 {kind})"

        for f in [files_pool.submit(process, p, o) for p, o in todo]:
            msg = f.result()
            if not args.silent:
                print(msg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
