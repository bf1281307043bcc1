"""prepare_s: host seconds of the scene preparation (prepare_scene, or the
HybridRenderer construction), ending in a synchronize."""


def read(ctx):
    return ctx.get("prepare_s")
