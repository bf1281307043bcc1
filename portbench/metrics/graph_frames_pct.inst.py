"""graph_frames_pct.inst: the share of the frames of mode pt_instanced that
replayed a CUDA graph, in %: of the unprofiled rows of the program's frame
`integrator.render_pixels`, the last as many as the window had frames (the
set-up's warm frames fall outside).  Rows that say nothing of how they ran
give nothing."""

from portbench import program_record


def read(ctx):
    record = (program_record.of(ctx)
              if ctx.get("mode") == "pt_instanced" else None)
    if record is None:
        return None
    rows = [row for row in record["rows"]
            if row["frame"] == program_record.PT_FRAME
            and not row["profiled"]]
    frames = ctx.get("window", {}).get("frames") or len(rows)
    rows = rows[-frames:]
    if not rows or any("ran" not in row for row in rows):
        return None
    return 100.0 * sum(row["ran"] == "replay" for row in rows) / len(rows)
