"""What the readers of the program's own record share.

The port keeps its spans in memory (`steeljax_torch.core.profiling`: a row
a frame with its host ms, its host ms inside calls that wait on the card
and whether a profiler collected during it, and the totals of every span,
set-up steps included).  The readers read it once the run is over, and
take the median over the frames no profiler collected in: in a traced run
those are the untraced window's, whose host times the profiler did not
slow.  A program without the record gives None, and its readers then
report nothing."""

from __future__ import annotations

import statistics

PT_FRAME = "integrator.render_pixels"
HYBRID_FRAME = "hybrid.render_frame_device"


def of(ctx: dict):
    """The program's record (profiling.record()), read once a run and kept
    in `ctx`; None where the program keeps none."""
    if "program_record" not in ctx:
        try:
            from steeljax_torch.core import profiling
        except ImportError:
            profiling = None
        read = getattr(profiling, "record", None)
        ctx["program_record"] = read() if read is not None else None
    return ctx["program_record"]


def frame_median(ctx: dict, mode: str, frame: str, value):
    """The median of value(row) over the unprofiled rows of frames named
    `frame` in a run of `mode` (rows where value gives None left out), or
    None."""
    record = of(ctx) if ctx.get("mode") == mode else None
    if record is None:
        return None
    values = [value(row) for row in record["rows"]
              if row["frame"] == frame and not row["profiled"]]
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def total_s(ctx: dict, name: str):
    """Host seconds inside every span named `name`, or None."""
    record = of(ctx)
    if record is None or name not in record["totals"]:
        return None
    return record["totals"][name]["ms"] / 1000.0
