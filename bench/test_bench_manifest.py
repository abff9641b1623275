"""BENCHMARK.json against the benchmark's contract, and every name in it
leading to its file."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    None: {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
           "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_keys_are_the_contracts():
    assert set(MANIFEST) == KEYS[None]
    for section in ("configs", "workloads"):
        for entry in MANIFEST[section]:
            assert set(entry) == KEYS[section], entry["name"]
    for section in ("end_to_end", "per_layer"):
        for entry in MANIFEST[section]:
            assert set(entry) - {"workloads"} == KEYS[section], entry["name"]


def test_names_units_and_text_fields():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
            for key in entry.get("reduced", []):
                assert NAME.match(key)
    assert len(set(names)) == len(names)
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and cmd[1] == "bench/run.py"
    for word in cmd:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
    assert MANIFEST["paths"] == ["bench"]
    for path in MANIFEST["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
    assert (ROOT / cmd[1]).is_file()


def test_counts_bounds_and_budget():
    m = MANIFEST
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each with run_seconds
    # + 60 s, 2 x 90 s a cell to compile, 1,200 s spare, within 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert all(w["chips"] in (1, 4) for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    from bench.lib import cells
    from bench.lib.harness import Manifest

    man = Manifest(ROOT)
    w = man.workload(cell)
    conf = man.configs[w["config"]]
    assert conf["file"].startswith("bench/configs/") and (ROOT / conf["file"]).is_file()
    config = man.config(w)
    assert config["name"] == w["config"] and config["reduced"] == conf["reduced"]
    traffic = man.traffic(w)
    assert traffic["kind"] in cells.KINDS and traffic["limits"]
    e2e = [x["name"] for x in man.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = man.per_layer(cell)
    assert layer
    for metric in layer:
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
        assert metric["moves"] in e2e


def test_every_entry_is_used_and_every_file_named():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for m in MANIFEST["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in CELLS
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "kernels" in layers and "device" in layers
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
            assert (BENCH / "cost" / f"{m['name'][:-len('_roofline')]}.py").is_file()
