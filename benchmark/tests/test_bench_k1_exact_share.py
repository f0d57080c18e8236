"""``k1_exact_share.replay``: the share of the window's K1 calls that took
K1's exact path, from the program's record; None off a card, without
device rows, and where the program counts no exact calls (as a program
before the counter)."""

import os
import types

import pytest
import torch

from benchmark import harness
from benchmark.tracing import Trace
from overlapnet_torch.core import profiling

METRIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "metrics", "k1_exact_share.replay.py")
TRACE = Trace(device=[("delta_conv1_kernel", 0.0, 10.0)], host_ops=[], start_us=0.0,
              end_us=100.0)


def read(device, counts, monkeypatch):
    monkeypatch.setattr(profiling, "record", lambda: {"counts": counts, "device_ms": {}})
    run = types.SimpleNamespace(device=torch.device(device))
    return harness.load_module(METRIC).read(run, TRACE)


@pytest.mark.parametrize("counts,want", [
    ({"k1.launches": 40, "k1.exact_calls": 40}, 100.0),
    ({"k1.launches": 40, "k1.exact_calls": 10}, 25.0),
    ({"k1.launches": 40, "k1.exact_calls": 0}, 0.0),
    ({"k1.launches": 40}, None),  # a program without the counter
    ({"k1.exact_calls": 0}, None),  # no K1 call in the window
])
def test_exact_share_from_the_record(counts, want, monkeypatch):
    got = read("cuda", counts, monkeypatch)
    assert got == (None if want is None else pytest.approx(want))


def test_exact_share_is_none_off_a_card_or_without_a_record(monkeypatch):
    assert read("cpu", {"k1.launches": 4, "k1.exact_calls": 4}, monkeypatch) is None
    monkeypatch.delattr(profiling, "record")
    run = types.SimpleNamespace(device=torch.device("cuda"))
    assert harness.load_module(METRIC).read(run, TRACE) is None
