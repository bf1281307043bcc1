"""alpha_kernel_pct.pt: the share of the path-traced frames' exact alpha
tests that ran as the program's alpha kernel, in %: 100 x the counter
`integrator.alpha_kernel_tests` over the counter `integrator.alpha_tests`,
summed over the unprofiled rows of the program's frame
`integrator.render_pixels`, the last as many as the window had frames (the
set-up's warm frames fall outside).  A program whose rows carry no such
counters, or whose frames make no alpha test, gives nothing."""

from portbench import program_record


def read(ctx):
    record = (program_record.of(ctx)
              if ctx.get("mode") == "pt" else None)
    if record is None:
        return None
    rows = [row for row in record["rows"]
            if row["frame"] == program_record.PT_FRAME
            and not row["profiled"]]
    frames = ctx.get("window", {}).get("frames") or len(rows)
    counts = [row.get("counters") or {} for row in rows[-frames:]]
    if not counts or any("integrator.alpha_tests" not in c for c in counts):
        return None
    tests = sum(c["integrator.alpha_tests"] for c in counts)
    if tests <= 0:
        return None
    return 100.0 * sum(c.get("integrator.alpha_kernel_tests", 0)
                       for c in counts) / tests
