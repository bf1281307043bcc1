"""prepare_tables_s: host seconds inside the program's
`dispatch.prepare_tables` span (the BVH build, collapse, packing, records
and masks of the scene's tables, ending in a synchronize)."""

from portbench import program_record


def read(ctx):
    return program_record.total_s(ctx, "dispatch.prepare_tables")
