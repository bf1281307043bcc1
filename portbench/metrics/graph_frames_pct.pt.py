"""graph_frames_pct.pt: the share of path-traced frames that replayed a CUDA
graph, in %: of the unprofiled rows of the program's frame
`integrator.render_pixels` (program_record.frame_median's rows), the last
as many as the window had frames, so that the set-up's warm frames (a
key's first frame runs eagerly, its second captures) fall outside.  Rows
that say nothing of how they ran (a program without graphs) give
nothing."""

from portbench import program_record


def read(ctx):
    record = program_record.of(ctx) if ctx.get("mode") == "pt" else None
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
