"""environment_s: host seconds inside the program's `environment.load`
span (the environment cube and its bakes: reflection mips, irradiance,
the specular BRDF LUT; each step ending in a synchronize)."""

from portbench import program_record


def read(ctx):
    return program_record.total_s(ctx, "environment.load")
