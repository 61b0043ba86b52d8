"""The port imports torch and numpy only: every module of renderer_tpu_torch
(ui/, overlay/, the asset loaders and apps/ included) imports with jax, the
JAX package and Pillow unavailable — the card's machine has none of them —
and no source file names jax or the JAX package."""

import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1] / "renderer_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    mods = list(_modules())
    assert len(mods) > 20
    assert {"renderer_tpu_torch.ui.widgets", "renderer_tpu_torch.overlay.hud",
            "renderer_tpu_torch.raster.ui_stage", "renderer_tpu_torch.apps.sandbox",
            "renderer_tpu_torch.assets.ntex", "renderer_tpu_torch.assets.png",
            "renderer_tpu_torch.materials.bc7",
            "renderer_tpu_torch.materials.atlas_device",
            "renderer_tpu_torch.engine.stats",
            "renderer_tpu_torch.tools.timings_report",
            "renderer_tpu_torch.apps.configs", "renderer_tpu_torch.tools.stress_run",
            "renderer_tpu_torch.tools.flythrough_run",
            "renderer_tpu_torch.tools.frame_capture",
            "renderer_tpu_torch.tools.binning_scaling",
            "renderer_tpu_torch.tools.prologue_probe",
            "renderer_tpu_torch.tools.startup_probe",
            "renderer_tpu_torch.tools.native", "renderer_tpu_torch.tools.make_ntex",
            "renderer_tpu_torch.tools.resample",
            "renderer_tpu_torch.tools.shard_workcount", "renderer_tpu_torch.tools.bench",
            "renderer_tpu_torch.parallel", "renderer_tpu_torch.parallel.mesh"} <= set(mods)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['renderer_tpu'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k in ('jax', 'PIL')\n"
        "               or k.startswith(('jax.', 'renderer_tpu.', 'PIL.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "from renderer_tpu_torch.ui.font import get_font\n"
        "assert len(get_font().glyphs) == 95\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


def test_no_source_names_jax_or_the_jax_package():
    offenders = []
    for path in sorted(PKG.rglob("*")):
        if path.suffix not in (".py", ".cu", ".cuh"):
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "import jax" in line or "from jax" in line or "renderer_tpu." in line:
                offenders.append(f"{path.relative_to(PKG.parent)}:{i}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_only_the_font_atlas_script_imports_pillow():
    """The font atlas is committed (ui/font_atlas.npz); only the script that
    regenerates it imports Pillow, inside its main()."""
    script = PKG / "tools" / "make_font_atlas.py"
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "import PIL" in line or "from PIL" in line:
                if path != script or not line.startswith("    "):
                    offenders.append(f"{path.relative_to(PKG.parent)}:{i}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
    assert (PKG / "ui" / "font_atlas.npz").is_file()
