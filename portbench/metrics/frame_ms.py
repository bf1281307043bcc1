"""frame_ms: the window's wall milliseconds over the frames it completed
(host clock, ending in torch.cuda.synchronize())."""


def read(ctx):
    if ctx["mode"] != "hybrid":
        return None
    window = ctx["window"]
    return window["wall_s"] * 1000.0 / window["frames"]
