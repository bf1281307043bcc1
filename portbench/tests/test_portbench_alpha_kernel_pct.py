"""The reader of alpha_kernel_pct.pt (portbench/metrics/alpha_kernel_pct.pt.py)
on synthetic records and on tiny runs of the cells: None without the
program's alpha-test counters or where the frames make no alpha test, else
100 x the kernel's tests over all tests of the window's unprofiled rows."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench import program_record, run
from portbench.tests.helpers import run_tiny, tiny_environment
from steeljax_torch.core import profiling

NAME = "alpha_kernel_pct.pt"


def _read(ctx):
    spec = importlib.util.spec_from_file_location(
        "portbench_test_metric_alpha_kernel_pct_pt",
        Path(__file__).resolve().parents[1] / "metrics" / f"{NAME}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def _row(tests=None, kernel_tests=None, profiled=False):
    counters = {"integrator.bounces": 4, "integrator.stage_bounces": 4}
    if tests is not None:
        counters["integrator.alpha_tests"] = tests
    if kernel_tests is not None:
        counters["integrator.alpha_kernel_tests"] = kernel_tests
    return {"frame": program_record.PT_FRAME, "ms": 40.0, "wait_ms": 0.0,
            "spans": {}, "self_ms": {}, "profiled": profiled,
            "counters": counters}


@pytest.mark.parametrize("rows, expected", [
    ([_row(), _row()], None),
    ([_row(0, 0), _row(0, 0)], None),
    ([_row(40, 40), _row(40, 40), _row(40, 0, profiled=True)], 100.0),
    ([_row(40, 40), _row(40, 0)], 50.0),
], ids=["no_counters", "no_tests", "all_on_the_kernel", "half"])
def test_share_of_the_window_rows(rows, expected):
    ctx = {"mode": "pt", "window": {"frames": 2},
           "program_record": {"rows": rows, "totals": {}}}
    assert _read(ctx) == expected
    ctx["mode"] = "hybrid"
    assert _read(ctx) is None


@pytest.mark.parametrize("workload", ["foliage_alpha.pt_720p",
                                      "sunlit_stress.pt_720p",
                                      "sunlit_stress.hybrid_1080p"])
def test_reads_exactly_its_cells(workload, monkeypatch):
    """A tiny run of each cell on the CPU: a number (0 there, no kernel on
    the CPU) where BENCHMARK.json lists the cell under the metric, nothing
    elsewhere."""
    tiny_environment(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        profiling.reset()
        run_tiny(workload)
    finally:
        torch.set_num_threads(threads)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    (metric,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    value = _read({"mode": workload.split(".")[1].split("_")[0]})
    if workload in metric["workloads"]:
        assert value == 0.0
    else:
        assert value is None
