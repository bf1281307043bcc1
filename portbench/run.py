"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Reads BENCHMARK.json at the root of the checkout, finds the cell, its
configuration (portbench/configs/<config>.json), its traffic mix
(portbench/traffic/<mix>.json, whose "mode" names portbench/modes/<mode>.py)
and its metrics (portbench/metrics/<metric>.py), does the set-up, measures
for --seconds, checks the frames against the plain reference and prints
one JSON line.  With --trace 0 the line holds the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read from a profiled
stretch of frames after the window.  Without a card, or with fewer cards
than the cell asks for, it exits 2 and prints no result; if JAX, flax or
the JAX package (steeljax) is loaded once the window has closed, it exits
3 and prints no result.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Run as a script, the interpreter puts portbench/ first on the path, where
# its modules would shadow the standard library's: put the root there.
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "steeljax")


def forbidden_modules(modules=None) -> list:
    """Loaded modules (or the names in `modules`) whose top-level name is
    JAX's, flax's or the JAX package's, compared whole: steeljax_torch is
    not steeljax."""
    names = list(sys.modules) if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_cell(workload: str, root: Path = ROOT) -> tuple:
    """(bench, cell, config, traffic) of the cell named `workload`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(entries: list, workload: str) -> list:
    return [m for m in entries
            if workload in m.get("workloads", [workload])]


def read_metric(name: str, ctx: dict):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, torch, started: float, window_fn=None,
             loaded=None, cell_limits=None) -> tuple:
    """Set up, measure and judge one run of a cell on `device`.  Returns
    (result, numbers, cell_limits, session) with result the line's dict
    without its check entry.  The CPU tests hand in `loaded` (load_cell's tuple),
    `cell_limits`, and `window_fn(step, seconds, in_flight, min_frames)`
    in place of the timed window."""
    from portbench import checks, traced, window

    bench, cell, config, traffic = loaded or load_cell(workload)
    mode = importlib.import_module(f"portbench.modes.{traffic['mode']}")
    opened = time.perf_counter()
    session = mode.Session(config, traffic, seed, device, torch)
    setup_s = time.perf_counter() - started
    steps = {"before the scene": opened - started,
             **session.setup_steps, "prepare": session.prepare_s}
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()),
          file=sys.stderr)
    in_flight = traffic["frames_in_flight"]
    if window_fn is None:
        win = window.run(session.step, seconds, in_flight, torch,
                         session.min_frames)
    else:
        win = window_fn(session.step, seconds, in_flight,
                        session.min_frames)
    times = sorted(win["frame_ms"])
    print(f"window: {win['frames']} frames in {win['wall_s']:.3f} s; frame "
          f"ms p10 {times[len(times) // 10]:.3f}, p50 "
          f"{times[len(times) // 2]:.3f}, p90 "
          f"{times[len(times) * 9 // 10]:.3f}", file=sys.stderr)
    ctx = {"mode": traffic["mode"], "setup_s": setup_s,
           "prepare_s": session.prepare_s, "window": win,
           "e2e": session.end_to_end(win)}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1}
    breakdown = None
    if trace:
        frames = traffic["profile_frames"]
        events, wall = traced.stretch(session.step, win["frames"], frames,
                                       in_flight, torch)
        prof = traced.reduce(events, wall, frames, mode.SPANS)
        ctx["profile"] = prof
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        breakdown = {"device_ops": [list(x) for x in prof["device_ops"]],
                     "idle_gaps": [list(x) for x in prof["idle_gaps"]]}
    if device.type == "cuda":
        torch.cuda.synchronize()
        device_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
        device_info["power_limit"] = power_limit()
    session.release()
    numbers = session.judge()
    if trace:
        ctx["shapes"] = session.shapes(win["frames"] + 1,
                                       traffic["profile_frames"])
    if cell_limits is None:
        cell_limits = checks.limits(workload)
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in cell_metrics(entries, workload):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": checks.verdict(numbers, cell_limits),
              "attempted": win["frames"], "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, numbers, cell_limits, session


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    # One intra-op thread: the frame loop is the host launching kernels,
    # and idle pool threads spinning on a shared host slow it unevenly.
    torch.set_num_threads(1)
    _, cell, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    result, numbers, cell_limits, _ = run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), device,
        torch, PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["checks"] = {name: {"value": value,
                               "limit": cell_limits.get(name)}
                        for name, value in numbers.items()}
    for name, value in numbers.items():
        print(f"check {name} {value!r} limit {cell_limits.get(name)!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
