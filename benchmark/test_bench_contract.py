"""BENCHMARK.json against the contract it is written to, and the harness's
refusals: every entry resolves to its files by name, names and units use
the allowed characters, a run without a card fails, and nothing the harness
or the reference imports is JAX or the JAX package."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "renderer_tpu"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(c) for c in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_entry_resolves_by_name():
    paths = [ROOT / p for p in BENCH["paths"]]
    configs = {}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = ROOT / c["file"]
        assert f.is_file() and any(p in f.parents for p in paths)
        cfg = json.loads(f.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "benchmark" / "scenes" / f"{cfg['scene']}.py").is_file()
        configs[c["name"]] = cfg
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        reader = ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
        assert reader.is_file(), reader
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        tree = ast.parse(reader.read_text())
        work = [n.value.value for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "WORK"]
        for name in work:
            assert (ROOT / "benchmark" / "work" / f"{name}.py").is_file()
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_names_units_and_texts():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert TEXT.match(m["layer"])
        if m["unit"] == "%" and m["name"].endswith("_roofline_pct"):
            assert m["better"] == "higher"


@pytest.mark.parametrize("where", ["checkout", "benchmark alone"])
def test_a_run_without_a_card_fails_and_prints_no_result(where, tmp_path):
    """In the checkout, and in a directory that holds only BENCHMARK.json
    and the files under `paths` (no program to run)."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    cwd = ROOT
    if where == "benchmark alone":
        cwd = tmp_path
        shutil.copy(ROOT / "BENCHMARK.json", cwd)
        for p in BENCH["paths"]:
            shutil.copytree(ROOT / p, cwd / p, ignore=shutil.ignore_patterns("__pycache__"))
    w = BENCH["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", w, "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


IMPORT_ALL = """
import importlib, pkgutil, sys
import benchmark, benchmark.reference, benchmark.work, benchmark.scenes
{extra}
for pkg in {packages}:
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if ".test_" not in m.name:
            importlib.import_module(m.name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_levels(packages: str, extra: str = "") -> set:
    code = IMPORT_ALL.format(packages=packages, extra=extra)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    """The harness with the program (what a run loads: the port's package
    included), compared by whole top-level names: renderer_tpu_torch begins
    with renderer_tpu and is not it."""
    tops = _top_levels("[benchmark]", "import renderer_tpu_torch, benchmark.harness")
    assert not tops & FORBIDDEN
    assert "renderer_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    tops = _top_levels("[benchmark.reference, benchmark.work, benchmark.scenes]")
    assert not tops & (FORBIDDEN | {"renderer_tpu_torch"})
    for f in (ROOT / "benchmark" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"renderer_tpu_torch"}, (f, n)
