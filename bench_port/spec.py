"""Finding a cell's files by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; they are
``configs/<config>.json`` and ``traffic/<traffic>.json``, its correctness
limits ``checks/<cell>.json``, and each metric's reader
``metrics/<metric>.py``, all under this directory.
"""

from __future__ import annotations

import importlib.util
import json
import os

__all__ = ["HERE", "ROOT", "benchmark", "load", "cell", "metrics_for",
           "reader"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under this directory."""
    return _json(HERE, kind, name + ".json")


def cell(name: str, bench: dict | None = None) -> dict:
    """{"workload", "config", "traffic", "limits", "chips"} of cell `name`."""
    bench = bench or benchmark()
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return {"workload": w, "config": load("configs", w["config"]),
            "traffic": load("traffic", w["traffic"]),
            "limits": load("checks", name), "chips": int(w["chips"])}


def metrics_for(name: str, trace: bool, bench: dict | None = None) -> list:
    """The metric entries cell `name` reports: its end-to-end metrics
    untraced, its per-layer ones traced."""
    bench = bench or benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


_READERS: dict = {}


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    fn = _READERS.get(metric)
    if fn is None:
        path = os.path.join(HERE, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_port_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fn = _READERS[metric] = mod.read
    return fn
