"""stage_kernel_pct.pt: the share of the path-traced frames' bounces whose
next-event estimation and BRDF sampling ran as the program's two stage
kernels, in %: 100 x the counter `integrator.stage_bounces` over the
counter `integrator.bounces`, summed over the unprofiled rows of the
program's frame `integrator.render_pixels`, the last as many as the window
had frames (the set-up's warm frames fall outside).  A program whose rows
carry no such counters gives nothing."""

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
    if not counts or any("integrator.bounces" not in c for c in counts):
        return None
    bounces = sum(c["integrator.bounces"] for c in counts)
    if bounces <= 0:
        return None
    return 100.0 * sum(c.get("integrator.stage_bounces", 0)
                       for c in counts) / bounces
