"""The readers of the program's own spans and counters: each gives the
expected number on a hand-built trace and record, None where the program
keeps no such span or record (as a program before them), and the device
metrics None off a card; the tiny traced runs of both cells on the CPU
report the two GT metrics and none of the device ones."""

import os
import types

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.tests.test_bench_cells import run
from benchmark.tracing import Trace
from overlapnet_torch.core import profiling

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")
DEVICE = ("frame_idle_ms.replay", "legs_ms_per_scan.replay", "heads_us_per_pair.replay")
GT = ("gt_prepare_ms_per_call.gt", "gt_useful_share.gt")
RECORD = {"counts": {"model.scans": 4, "model.pairs": 1000, "gt.live_pairs": 80,
                     "gt.nonzero_pairs": 20},
          "device_ms": {"model.heads": 35.0}}


def reader(name):
    return harness.load_module(os.path.join(METRICS, name + ".py"))


def hand_built() -> Trace:
    """Two frames of 100 and 50 us: the first holds device rows over 10-30
    and 20-50 (union 40 us), the second one row that reaches 20 us into it;
    one row lies outside both. Two GT calls whose prepare spans last 300 and
    500 us. Two leg calls: the first launches rows over 615-640 and 640-660
    (45 us) while a row launched before it runs over 600-612, and a copy
    launched after it runs over 705-708; the second launches rows over
    812-832 and 850-860 (30 us). Each row has its launch, the first one's
    stamped after its row starts, as the profiler's clocks may have it."""
    device = [("k", 10.0, 30.0), ("k", 20.0, 50.0), ("k", 190.0, 220.0), ("k", 400.0, 500.0),
              ("k", 600.0, 612.0), ("k", 615.0, 640.0), ("Memset (Device)", 640.0, 660.0),
              ("Memcpy DtoH (Device -> Pageable)", 705.0, 708.0), ("k", 812.0, 832.0),
              ("k", 850.0, 860.0)]
    launches = [("cudaLaunchKernel", 12.0), ("cuLaunchKernel", 15.0),
                ("cudaLaunchKernelExC", 185.0), ("cudaLaunchKernel", 395.0),
                ("cudaLaunchKernel", 560.0), ("cudaLaunchKernel", 610.0),
                ("cudaMemsetAsync", 620.0), ("cudaMemcpyAsync", 702.0),
                ("cudaLaunchKernel", 810.0), ("cuLaunchKernel", 815.0)]
    return Trace(
        device=device,
        host_ops=[("lcd.frame", 0.0, 100.0), ("lcd.frame", 200.0, 250.0),
                  ("aten::cat", 0.0, 300.0), ("gt.prepare", 1000.0, 1300.0),
                  ("gt.prepare", 2000.0, 2500.0), ("model.legs", 600.0, 700.0),
                  ("cudaEventRecord", 615.0, 616.0), ("cudaStreamSynchronize", 703.0, 720.0),
                  ("model.legs", 800.0, 900.0)] + [(n, s, s + 1.0) for n, s in launches],
        start_us=0.0, end_us=3000.0)


def on(device):
    return types.SimpleNamespace(device=torch.device(device))


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "record", lambda: RECORD)


@pytest.mark.parametrize("name,want", [
    ("frame_idle_ms.replay", ((100 - 40) + (50 - 20)) / 2 / 1e3),
    ("legs_ms_per_scan.replay", (45.0 + 30.0) / 4 / 1e3),
    ("heads_us_per_pair.replay", 35.0),
    ("gt_prepare_ms_per_call.gt", 0.4),
    ("gt_useful_share.gt", 25.0),
])
def test_each_reader_on_a_hand_built_trace(name, want, recorded):
    assert reader(name).read(on("cuda"), hand_built()) == pytest.approx(want)


def test_launches_pair_with_their_rows_in_order():
    tr = hand_built()
    legs = program_trace.spans(tr, "model.legs")
    assert program_trace.launched_rows(tr, legs) == [[(615.0, 640.0), (640.0, 660.0)],
                                                      [(812.0, 832.0), (850.0, 860.0)]]
    tr.device.append(("k", 950.0, 960.0))  # a row with no launch of its own
    assert program_trace.launched_rows(tr, legs) == [None, None]
    assert reader("legs_ms_per_scan.replay").read(on("cuda"), tr) is None


@pytest.mark.parametrize("name", DEVICE)
def test_device_readers_give_none_off_a_card_or_without_device_rows(name, recorded):
    assert reader(name).read(on("cpu"), hand_built()) is None
    empty = hand_built()
    empty.device = []
    assert reader(name).read(on("cuda"), empty) is None


@pytest.mark.parametrize("name", DEVICE + GT)
def test_a_program_without_spans_or_record_gives_none(name, monkeypatch):
    monkeypatch.delattr(profiling, "record")
    bare = hand_built()
    bare.host_ops = [r for r in bare.host_ops if r[0].startswith("aten::")]
    assert reader(name).read(on("cuda"), bare) is None


@pytest.mark.parametrize("cell,have,lack", [("geo.lcd-dense", (), DEVICE + GT),
                                            ("geo.gt-prep", GT, DEVICE)])
def test_tiny_traced_runs_report_the_host_metrics_only(cell, have, lack, bench_root):
    out = run(cell, bench_root, trace=True)
    assert out["correct"], out["checks"]
    assert set(have) <= set(out["metrics"]) and not set(lack) & set(out["metrics"])
    if cell == "geo.gt-prep":
        assert 0.0 < out["metrics"]["gt_useful_share.gt"]["value"] <= 100.0
        assert out["metrics"]["gt_prepare_ms_per_call.gt"]["value"] > 0.0
