"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and the chip time a full check takes."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(names()), ids=lambda x: str(x)[:40])
def test_names_units_and_keys(group, entry):
    assert NAME.match(entry["name"])
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[group]
    assert set(entry) - {"workloads"} == keys
    for text in ("why", "layer", "source"):
        if text in entry and group != "end_to_end" and group != "per_layer":
            assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text] and "\t" not in entry[text]
    if group in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    if group == "per_layer":
        assert 1 <= len(entry["layer"]) <= 200 and "\n" not in entry["layer"]
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "workloads":
        assert entry["chips"] in (1, 4) and NAME.match(entry["config"])
        assert NAME.match(entry["traffic"])
    if group == "configs":
        assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16


def test_every_file_is_found_by_name():
    bench = os.path.join(ROOT, "benchmark")
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in MAN["workloads"]:
        mix = json.load(open(os.path.join(bench, "traffic", w["traffic"] + ".json")))
        assert os.path.isfile(os.path.join(bench, "traffic", mix["kind"] + ".py"))
    for m in MAN["per_layer"]:
        assert os.path.isfile(os.path.join(bench, "metrics", m["name"] + ".py"))
    assert len({c["file"] for c in MAN["configs"]}) == len(MAN["configs"])


def test_cells_metrics_and_layers_fit_together():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert {w["config"] for w in MAN["workloads"]} == {c["name"] for c in MAN["configs"]}
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(cells)
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in MAN["per_layer"])
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_full_check_fits_its_time():
    """2 + 14 runs a cell of run_seconds + 60 s, 2 x 90 s a cell to
    compile, 1200 s spare: within 43,200 s with the full 24 cells."""
    r = MAN["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
