"""host_wait_ms.pt: host ms a path-traced frame inside the program's
`wait=True` spans, the calls that wait on the card (median over the frames
no profiler collected in)."""

from portbench import program_record


def read(ctx):
    return program_record.frame_median(ctx, "pt", program_record.PT_FRAME,
                                       lambda row: row["wait_ms"])
