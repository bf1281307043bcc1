"""What the metric readers under metrics/ share.  A reader's `read(ctx)`
returns the metric's value, or None where the run has nothing to read for
it (the harness then leaves the metric out of the line).  `ctx` holds:
"mode" (the traffic mode), "setup_s", "prepare_s", "window" (frames, wall_s,
frame_ms), "e2e" (the mode's own end-to-end numbers), and in a traced run
"profile" (traced.reduce's per-frame numbers) and "shapes" (the roofline
count's inputs)."""

from __future__ import annotations

from portbench import roofline


def profiled(ctx, mode: str):
    """The traced stretch's numbers in a run of `mode`, else None."""
    if ctx.get("mode") != mode:
        return None
    return ctx.get("profile")


def trace_ms(ctx, mode: str):
    prof = profiled(ctx, mode)
    if prof is None or prof["trace_ms"] <= 0.0:
        return None
    return prof["trace_ms"]


def trace_roofline(ctx, mode: str):
    ms = trace_ms(ctx, mode)
    if ms is None or ctx.get("shapes") is None:
        return None
    return 100.0 * roofline.least_ms(ctx["shapes"]) / ms


def device_idle_pct(ctx, mode: str):
    """1 - device busy a frame (the traced stretch) / wall a frame (the
    untraced window of the same run), in %: the profiler slows the host,
    so the traced stretch's own wall would overstate the idle share."""
    prof = profiled(ctx, mode)
    window = ctx["window"]
    if prof is None or window["frames"] == 0:
        return None
    wall_ms = window["wall_s"] * 1000.0 / window["frames"]
    return 100.0 * (1.0 - prof["busy_ms"] / wall_ms)


def span_ms(ctx, mode: str, name: str):
    prof = profiled(ctx, mode)
    if prof is None:
        return None
    return prof["span_ms"].get(name)
