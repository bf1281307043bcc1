"""The readers of the program's own record (portbench/program_record.py and
the metrics that use it) on synthetic records: each gives the median of the
frames no profiler collected in, and None where it has nothing to read."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench import program_record, run
from portbench.tests.helpers import run_tiny, tiny_environment
from steeljax_torch.core import profiling

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "portbench_test_metric_" + name.replace(".", "_"),
        METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _row(frame, ms, wait_ms=0.0, profiled=False, retrace=None):
    row = {"frame": frame, "ms": ms, "wait_ms": wait_ms, "spans": {},
           "self_ms": {}, "profiled": profiled}
    if retrace is not None:
        row["retrace"] = retrace
    return row


PT, HYBRID = program_record.PT_FRAME, program_record.HYBRID_FRAME
RECORD = {
    "rows": [
        _row(PT, 40.0, 2.0), _row(PT, 44.0, 3.0),
        _row(PT, 46.0, 30.0, retrace={"pending": 25, "slots": 1000}),
        _row(PT, 400.0, 300.0, profiled=True,
             retrace={"pending": 900, "slots": 1000}),
        _row(HYBRID, 7.0), _row(HYBRID, 9.0), _row(HYBRID, 8.0),
        _row(HYBRID, 90.0, profiled=True),
    ],
    "totals": {"dispatch.prepare_tables": {"calls": 1, "ms": 4500.0,
                                           "self_ms": 100.0},
               "environment.load": {"calls": 1, "ms": 2500.0,
                                    "self_ms": 10.0}},
}


@pytest.mark.parametrize("name, mode, expected", [
    ("host_frame_ms.pt", "pt", 44.0),
    ("host_wait_ms.pt", "pt", 3.0),
    ("retrace_live_pct.pt", "pt", 2.5),
    ("host_frame_ms.hybrid", "hybrid", 8.0),
    ("prepare_tables_s", "pt", 4.5),
    ("prepare_tables_s", "hybrid", 4.5),
    ("environment_s", "hybrid", 2.5),
])
def test_reader_takes_the_unprofiled_median(name, mode, expected):
    ctx = {"mode": mode, "program_record": RECORD}
    assert _reader(name)(ctx) == pytest.approx(expected)


@pytest.mark.parametrize("name, mode", [
    ("host_frame_ms.pt", "hybrid"), ("host_wait_ms.pt", "hybrid"),
    ("retrace_live_pct.pt", "hybrid"), ("host_frame_ms.hybrid", "pt"),
])
def test_reader_of_another_mode_reads_nothing(name, mode):
    assert _reader(name)({"mode": mode, "program_record": RECORD}) is None


@pytest.mark.parametrize("name", [
    "host_frame_ms.pt", "host_wait_ms.pt", "retrace_live_pct.pt",
    "host_frame_ms.hybrid", "prepare_tables_s", "environment_s"])
@pytest.mark.parametrize("record", [
    None,
    {"rows": [], "totals": {}},
    {"rows": [_row(PT, 400.0, profiled=True),
              _row(HYBRID, 90.0, profiled=True)], "totals": {}},
], ids=["no_record", "empty", "profiled_only"])
def test_reader_without_its_record_reads_nothing(name, record):
    mode = "hybrid" if name.endswith(".hybrid") else "pt"
    assert _reader(name)({"mode": mode, "program_record": record}) is None


def test_unprofiled_rows_without_counts_give_no_live_share():
    record = {"rows": [_row(PT, 40.0),
                       _row(PT, 41.0, retrace={"pending": 0, "slots": 0})],
              "totals": {}}
    assert _reader("retrace_live_pct.pt")(
        {"mode": "pt", "program_record": record}) is None


def test_record_is_read_from_the_program_once(monkeypatch):
    calls = []

    def fake():
        calls.append(1)
        return RECORD

    monkeypatch.setattr(profiling, "record", fake)
    ctx = {"mode": "pt"}
    assert _reader("host_frame_ms.pt")(ctx) == 44.0
    assert _reader("prepare_tables_s")(ctx) == 4.5
    assert calls == [1]


def test_program_without_a_record_reads_nothing(monkeypatch):
    """A port whose profiling module keeps no record (as before it had
    one): every reader reports nothing and none raises."""
    monkeypatch.delattr(profiling, "record")
    for name in ("host_frame_ms.pt", "prepare_tables_s", "environment_s"):
        assert _reader(name)({"mode": "pt"}) is None


NEW = ("host_frame_ms.pt", "host_wait_ms.pt", "retrace_live_pct.pt",
       "host_frame_ms.hybrid", "prepare_tables_s", "environment_s")


@pytest.mark.parametrize("workload", ["foliage_alpha.pt_720p",
                                      "sunlit_stress.pt_720p",
                                      "sunlit_stress.hybrid_1080p"])
def test_readers_read_exactly_their_cells(workload, monkeypatch):
    """A tiny run of each cell on the CPU: the program's record gives a
    number to each reader whose metric lists the cell in BENCHMARK.json,
    and nothing to the others."""
    tiny_environment(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        profiling.reset()
        run_tiny(workload)
    finally:
        torch.set_num_threads(threads)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]
              if workload in m.get("workloads", [workload])}
    ctx = {"mode": workload.split(".")[1].split("_")[0]}
    for name in NEW:
        value = _reader(name)(ctx)
        if name in listed:
            assert value is not None and value >= 0.0, name
        else:
            assert value is None, name
