"""The control on the card, at each cell's own size and load: the port with
its fp8 cache (e5m2), the next precision below the configuration's bf16
cache, serves the cell's traffic for a short window; the comparison has to
find it not correct on every seed. Its widest gaps are the upper readings
the limits in ``checks/`` were set below (PERF.md).

    python -m pytest bench_port/tests/test_bench_port_control.py -m cuda -s

``BENCH_CONTROL_SECONDS`` sets the window (default 20 s: the chat mix's
longest requests finish in it) and ``BENCH_CONTROL_SEEDS`` the seeds.
"""

import json
import os

import pytest

from bench_port import serve, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    seconds = float(os.environ.get("BENCH_CONTROL_SECONDS", "20"))
    seeds = [int(s) for s in os.environ.get(
        "BENCH_CONTROL_SEEDS", "2654435761,40503,2246822519").split(",")]
    results = []
    for seed in seeds:
        res = serve.run_cell(cell, seed, seconds, False, device=card,
                             overrides={"serving": {"cache_kind": "fp8"}})
        results.append(res)
        print(json.dumps({"cell": cell, "seed": seed, "control": "fp8 cache",
                          "readings": res["readings"],
                          "check": res["check"]}), flush=True)
    for res in results:
        assert not res["correct"], res["check"]
