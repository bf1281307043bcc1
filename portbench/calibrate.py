"""The readings the limits of `correct` are set from, for one cell, in one
process on the card:

    python3 portbench/calibrate.py --workload <name> --seeds N \
        --controls M --seconds S [--first SEED] [--out FILE]

For each of N seeds it runs the cell as run.py does (set-up, a window of S
seconds, the check) and prints the program's compared numbers; for the
first M of them it also prints the control's: the plain reference put in
the program's place in the next precision below the configuration's
(bfloat16 under float32), judged against the float32 reference.  The
benchmark's own runs never run the control.  Seeds are FIRST + k * 104729.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(HERE.parent)

from portbench import run  # noqa: E402

LOWER = {"float32": "bfloat16"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--first", type=int, default=2_147_483_659)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench: calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    _, _, config, _ = run.load_cell(args.workload)
    lower = getattr(torch, LOWER[config["precision"]])
    rows = []
    for k in range(args.seeds):
        seed = args.first + k * 104_729
        started = time.perf_counter()
        result, numbers, _, session = run.run_cell(
            args.workload, seed, args.seconds, False, device, torch, started)
        row = {"seed": seed, "program": numbers,
               "frames": result["attempted"]}
        if k < args.controls:
            row["control"] = session.control(lower)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del session
        torch.cuda.empty_cache()
    summary = {name: {"lower": max(r["program"][name] for r in rows)}
               for name in rows[0]["program"]}
    for name in summary:
        controls = [r["control"][name] for r in rows if "control" in r]
        if controls:
            summary[name]["upper"] = min(controls)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
