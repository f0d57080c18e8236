"""The harness's own tests. Tests that need an NVIDIA card carry the
``card`` marker and skip without one; the decision is made inside the test,
never while a module is imported."""

import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The training cell that no committed cell uses yet: its configuration, mix,
# driver and readers are files of the benchmark, run here through a manifest
# of the tests' own (PERF.md, Open questions: the host-bound step at the
# published batch spreads beyond any bound a check can hold).
TRAINING = {
    "configs": [{"name": "semantic", "source": "x", "reduced": [], "why": "x",
                 "file": os.path.join(ROOT, "benchmark", "configs", "semantic.json")}],
    "workloads": [{"name": "semantic.train", "config": "semantic", "traffic": "train",
                   "chips": 1, "why": "x"}],
    "end_to_end": [{"name": "train_pairs_per_s", "unit": "pairs/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": ["semantic.train"]}],
    "per_layer": [{"name": name, "unit": "%", "better": better, "source": "device_trace",
                   "layer": layer, "moves": "train_pairs_per_s", "workloads": ["semantic.train"]}
                  for name, better, layer in (
                      ("train_mfu", "higher", "Trainer step, train/trainer.py"),
                      ("k2_roofline.train", "higher", "Kernel K2, csrc/delta_conv1_bwd.cu"),
                      ("device_idle_share.train", "lower", "Device"))],
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; none is visible")
    return torch.device("cuda")


@pytest.fixture
def bench_root(tmp_path):
    """A root whose BENCHMARK.json is the committed one with the training
    cell added; configurations are named by absolute path."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for c in man["configs"]:
        c["file"] = os.path.join(ROOT, c["file"])
    for key, entries in TRAINING.items():
        man[key] = man[key] + entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    return str(tmp_path)
