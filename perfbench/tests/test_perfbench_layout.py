"""The benchmark's files: that they parse, keep to the contract's names and
shapes, are found by name (a new cell and metric need no code edit), and
import neither JAX nor the JAX package."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests import tiny

ROOT = harness.BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_files_parse_and_match_the_benchmark():
    assert set(BENCH) == KEYS["top"]
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert config["reduced"] == c["reduced"]
        harness.reference_module(c["name"])
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (cell.spec["config"], cell.spec["traffic"], cell.chips) == (
            w["config"], w["traffic"], w["chips"])
        assert cell.spec["why"] == w["why"]
        assert (harness.BENCH_DIR / "drivers" / f"{cell.spec['driver']}.py").is_file()
    for m in BENCH["per_layer"]:
        reader = harness.load_module(harness.BENCH_DIR / "metrics" / f"{m['name']}.py", "m")
        assert callable(reader.read)


def test_names_units_and_keys_keep_to_the_contract():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == KEYS[section], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32


def test_every_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["layer"])
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        reported, per_layer = harness.cell_metrics(BENCH, cell)
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        assert cell.spec["rate_metric"] in names
        for m in per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_the_check_budget_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """Added as files only: a cell with a traffic mix of its own, on the
    existing driver, and a per-layer metric; the harness runs both."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    base = json.loads((harness.BENCH_DIR / "traffic" / "score-lists-3s.json").read_text())
    (root / "perfbench" / "traffic" / "score-lists-1s.json").write_text(
        json.dumps({**base, "seconds": 1.0}))
    spec = json.loads((harness.BENCH_DIR / "workloads" / "etdnn-score-3s.json").read_text())
    (root / "perfbench" / "workloads" / "etdnn-score-1s.json").write_text(
        json.dumps({**spec, "traffic": "score-lists-1s"}))
    (root / "perfbench" / "metrics" / "lists.score.py").write_text(
        "def read(window):\n    return float(window.units)\n")
    bench["workloads"].append({"name": "etdnn-score-1s", "config": "etdnn-vox12",
                               "traffic": "score-lists-1s", "chips": 1, "why": "shorter"})
    bench["end_to_end"][0]["workloads"].append("etdnn-score-1s")
    bench["per_layer"].append({"name": "lists.score", "unit": "lists", "better": "higher",
                               "source": "program_counter", "layer": "Entry",
                               "moves": "trials_per_s"})
    bench_dir = root / "perfbench"
    cell = harness.load_cell("etdnn-score-1s", bench_dir)
    assert cell.traffic["seconds"] == 1.0
    e2e, per_layer = harness.cell_metrics(bench, cell)
    assert "lists.score" in {m["name"] for m in per_layer}
    small = tiny.tiny_cell("etdnn-score-3s")
    small = harness.Cell("etdnn-score-1s", cell.spec, small.config, small.traffic)
    import time

    import torch

    result = harness.execute(small, e2e, per_layer, 5, 0.3, True, torch.device("cpu"),
                             time.perf_counter(), bench_dir)
    assert result["metrics"]["lists.score"]["value"] == result["attempted"] > 0


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _sources():
    return [p for p in harness.BENCH_DIR.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_the_jax_package_or_the_old_benchmarks():
    banned = set(harness.FORBIDDEN) | {"benchmarks", "bench", "chip_smoke"}
    for path in _sources():
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & banned, (path, tops & banned)


def test_the_references_import_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "deeplip_tpu_torch" not in tops and not tops & set(harness.FORBIDDEN), path


def test_loading_every_file_leaves_no_jax_in_the_process():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from perfbench import harness, calibrate\n"
        "d = harness.BENCH_DIR\n"
        "for p in sorted(d.glob('drivers/*.py')) + sorted(d.glob('metrics/*.py')):\n"
        "    harness.load_module(p, 'x_' + p.stem.replace('.', '_'))\n"
        "for p in sorted(d.glob('reference/*.py')):\n"
        "    harness.load_module(p, 'r_' + p.stem)\n"
        "import deeplip_tpu_torch.train.audio, deeplip_tpu_torch.train.video\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["deeplip_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["jax.numpy", "deeplip_tpu.ops", "optax"]) == [
        "deeplip_tpu", "jax", "optax"]


@pytest.mark.parametrize("hide", [True, False])
def test_a_run_without_a_card_prints_no_result(tmp_path, hide):
    """No card: exit 3 and nothing on standard output; with ``hide`` the
    checkout holds only ``BENCHMARK.json`` and the benchmark's files."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cwd = ROOT
    if hide:
        cwd = tmp_path / "bare"
        shutil.copytree(harness.BENCH_DIR, cwd / "perfbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", cwd)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "etdnn-score-3s",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
