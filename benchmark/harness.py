"""The harness: finds a cell's files by name and runs it.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name in
``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the configuration as it is run (the
  network.yml keys the program reads), with its source, ``reduced`` and
  ``assumed``;
- ``benchmark/traffic/<traffic>.json``: a traffic mix, its ``kind`` and
  parameters, and the limits of the numbers that decide ``correct``;
- ``benchmark/traffic/<kind>.py``: the driver of a kind of traffic, with
  ``setup(run)``, ``window(run, state, seconds, tracer)`` and
  ``check(run, state)``;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(run, trace)``, which returns a number or None.

Adding a cell, a configuration, a mix or a metric adds files; no file here
names one.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from types import ModuleType

import torch

from benchmark.tracing import Tracer

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "overlapnet_tpu")


def load_module(path: str) -> ModuleType:
    """Import a file by path (names may hold dots and hyphens)."""
    name = "benchmark._found." + os.path.relpath(path, HERE).replace(os.sep, "/")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ".") -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class CellSpec:
    """A cell and everything the harness found for it by name."""

    name: str
    chips: int
    config_name: str
    config: dict
    mix_name: str
    mix: dict
    driver: ModuleType
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict[str, ModuleType]


def reports(metric: dict, cell: str) -> bool:
    """Whether a cell reports a metric: its ``workloads`` list the cell, or
    it has none (reported everywhere)."""
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, root: str = ".", overrides: dict | None = None,
              config_overrides: dict | None = None) -> CellSpec:
    """The cell ``name`` of the manifest under ``root``, its configuration,
    its mix, its driver and its readers. ``overrides`` replaces mix keys and
    ``config_overrides`` keys of the configuration, its ``model`` key by key
    (tiny sizes, for the harness's own tests)."""
    man = manifest(root)
    cells = {c["name"]: c for c in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = read_json(os.path.join(root, conf["file"]))
    for key, value in (config_overrides or {}).items():
        if key == "model":
            config["model"].update(value)
        else:
            config[key] = value
    mix = read_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    mix.update(overrides or {})
    driver = load_module(os.path.join(HERE, "traffic", mix["kind"] + ".py"))
    e2e = [m for m in man["end_to_end"] if reports(m, name)]
    per_layer = [m for m in man["per_layer"] if reports(m, name)]
    readers = {m["name"]: load_module(os.path.join(HERE, "metrics", m["name"] + ".py"))
               for m in per_layer}
    return CellSpec(name, int(cell["chips"]), cell["config"], config, cell["traffic"], mix,
                    driver, e2e, per_layer, readers)


@dataclass
class Run:
    """One run of a cell: what the drivers and readers share."""

    spec: CellSpec
    seed: int
    device: torch.device
    workdir: str
    counts: dict = field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.spec.config

    @property
    def mix(self) -> dict:
        return self.spec.mix

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def forbidden_loaded() -> list[str]:
    """Top-level names of the JAX stack or the JAX package in sys.modules,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    """Set up, measure for ``seconds``, read the per-layer metrics when
    ``trace``, free the program, check its outputs against the reference.
    Returns the result line's fields, the compared numbers under
    ``checks`` last."""
    device = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="overlapnet-bench-")
    try:
        run = Run(spec, int(seed), device, workdir)
        t0 = time.perf_counter()
        state = spec.driver.setup(run)
        run.sync()
        # what set-up made stays: the collector need not walk it in the window
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t0
        tracer = Tracer(trace, device)
        if trace:  # the profiler's rows must stay few enough to read in time
            seconds = min(seconds, spec.mix.get("trace_seconds", seconds))
        with tracer.window():
            e2e = spec.driver.window(run, state, seconds, tracer)
        info = device_info(device, spec.chips)
        metrics = {}
        if trace:
            tr = tracer.trace
            tr.counts = run.counts
            for m in spec.per_layer:
                value = spec.readers[m["name"]].read(run, tr)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            info["busy_s"] = tr.busy_s()
            info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps_by_host()}
            del tracer
        else:
            e2e["setup_s"] = setup_s
            for m in spec.end_to_end:
                if m["name"] in e2e:
                    metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
        gc.unfreeze()
        gc.collect()
        checks = spec.driver.check(run, state)
        del state
        gc.collect()
        correct = run.counts.get("failed", 0) == 0 and all(
            v <= lim for v, lim in checks.values())
        out = {"correct": bool(correct), "attempted": int(run.counts.get("attempted", 0)),
               "failed": int(run.counts.get("failed", 0)), "metrics": metrics,
               "device": info}
        if trace:
            out["breakdown"] = breakdown
        out["checks"] = {k: {"value": float(v), "limit": float(lim)}
                         for k, (v, lim) in checks.items()}
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
