"""rays_per_s: every rays_traced of the window over the window's wall
seconds (host clock, ending in torch.cuda.synchronize())."""


def read(ctx):
    return ctx["e2e"].get("rays_per_s")
