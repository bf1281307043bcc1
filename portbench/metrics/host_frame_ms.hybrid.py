"""host_frame_ms.hybrid: host ms a hybrid frame inside the program's
`hybrid.render_frame_device` frame span (median over the frames no
profiler collected in)."""

from portbench import program_record


def read(ctx):
    return program_record.frame_median(ctx, "hybrid",
                                       program_record.HYBRID_FRAME,
                                       lambda row: row["ms"])
