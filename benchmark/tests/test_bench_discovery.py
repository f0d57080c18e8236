"""A new configuration, traffic mix, cell or per-layer metric is added as
new files only: the harness finds each by its name in BENCHMARK.json."""

import json
import os
import shutil

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    # a configuration, a mix of a kind that exists, a cell and a metric
    cfg = json.load(open(bench / "configs" / "geo.json"))
    cfg["model"]["inputShape"] = [64, 720]
    (bench / "configs" / "geo-narrow.json").write_text(json.dumps(cfg))
    mix = json.load(open(bench / "traffic" / "lcd-dense.json"))
    mix["map_frames"] = 2000
    (bench / "traffic" / "lcd-dense-2k.json").write_text(json.dumps(mix))
    (bench / "metrics" / "frames_seen.dense2k.py").write_text(
        "def read(run, trace):\n    return trace.counts.get('frames')\n")
    man["configs"].append({"name": "geo-narrow", "source": "x",
                           "file": "benchmark/configs/geo-narrow.json", "reduced": [],
                           "why": "x"})
    man["workloads"].append({"name": "geo-narrow.lcd-dense-2k", "config": "geo-narrow",
                             "traffic": "lcd-dense-2k", "chips": 1, "why": "x"})
    man["end_to_end"][0]["workloads"].append("geo-narrow.lcd-dense-2k")
    man["per_layer"].append({"name": "frames_seen.dense2k", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "Device",
                             "moves": "lcd_frames_per_s",
                             "workloads": ["geo-narrow.lcd-dense-2k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    monkeypatch.setattr(harness, "HERE", str(bench))

    spec = harness.find_cell("geo-narrow.lcd-dense-2k", root=str(tmp_path))
    assert spec.config["model"]["inputShape"] == [64, 720]
    assert spec.mix["map_frames"] == 2000 and spec.mix["kind"] == "lcd_replay"
    assert hasattr(spec.driver, "window") and hasattr(spec.driver, "check")
    assert set(spec.readers) == {"frames_seen.dense2k"}
    assert [m["name"] for m in spec.end_to_end] == ["lcd_frames_per_s", "setup_s"]
    # the existing cells are untouched by the additions
    old = harness.find_cell("geo.lcd-dense", root=str(tmp_path))
    assert "frames_seen.dense2k" not in old.readers and old.mix["map_frames"] == 3000


def test_a_metric_without_workloads_is_reported_everywhere():
    assert harness.reports({"moves": "lcd_frames_per_s"}, "any.cell")
    assert harness.reports({"moves": "x", "workloads": ["a"]}, "a")
    assert not harness.reports({"moves": "x", "workloads": ["a"]}, "b")
