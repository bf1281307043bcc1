"""setup_s: process start to the first timed frame (host clock)."""


def read(ctx):
    return ctx["setup_s"]
