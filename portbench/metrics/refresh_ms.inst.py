"""refresh_ms.inst: host ms of the program's per-frame refresh of the
instanced tables, its record's `instances.refresh` rows (median over the
rows no profiler collected in).  A program without that row gives
nothing."""

from portbench import program_record

REFRESH = "instances.refresh"


def read(ctx):
    return program_record.frame_median(ctx, "pt_instanced", REFRESH,
                                       lambda row: row["ms"])
