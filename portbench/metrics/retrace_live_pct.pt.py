"""retrace_live_pct.pt: the share of the alpha re-trace passes' rows that
carry a pending ray, in %: the pending rays entering passes 1..P summed over
a frame's material and shadow traces, over P times the rays each pass is
launched over, summed the same way (the program's counts of the last frame
no profiler collected in)."""

from portbench import program_record


def _live_pct(row):
    retrace = row.get("retrace")
    if not retrace or retrace["slots"] <= 0:
        return None
    return 100.0 * retrace["pending"] / retrace["slots"]


def read(ctx):
    return program_record.frame_median(ctx, "pt", program_record.PT_FRAME,
                                       _live_pct)
