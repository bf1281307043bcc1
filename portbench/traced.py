"""The traced stretch: torch.profiler over a fixed number of steady frames
inside the window, reduced to the numbers the per-layer readers take.

The arithmetic follows `chip_smoke._profile_frames` (device busy, device
kernels, the time inside the program's `trace_kernel.*` ranges and the
device span of named `record_function` ranges), read here from the
profiler's event list so that the busy time is the union of the device
operations' intervals and the idle gaps can be named by what the host was
doing.  No trace file is written.
"""

from __future__ import annotations

import time

import numpy as np

TRACE_RANGE = "trace_kernel."


def stretch(step, first: int, frames: int, in_flight: int, torch) -> tuple:
    """Profile frames first .. first + frames - 1 (after one more frame
    under the profiler to absorb its start), with at most `in_flight` frames
    queued.  Returns (events, wall_s): the profiler's events of the active
    frames and the host seconds they took, from a synchronized start to a
    synchronized end."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=frames,
                                   repeat=1)) as prof:
        ends = []
        t0 = None
        for i in range(frames + 1):
            if i == 1:
                cuda.synchronize()
                t0 = time.perf_counter()
            if i > in_flight:
                ends[i - 1 - in_flight].synchronize()
            step(first + i)
            end = cuda.Event()
            end.record()
            ends.append(end)
            if i == frames:
                cuda.synchronize()
            prof.step()
        wall = time.perf_counter() - t0
    return list(prof.events()), wall


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType
    return evt.device_type == DeviceType.CUDA


def reduce(events, wall_s: float, frames: int, spans=()) -> dict:
    """Per-frame numbers of a traced stretch: busy_ms (the union of device
    operations), kernels (device kernels, copies and fills not counted),
    trace_ms (device time inside `trace_kernel.*` ranges), span_ms (each
    named range's device span, first operation to last), the breakdown's
    device operations and idle gaps, and the totals in seconds."""
    ops, ranges, host = [], {}, []
    for evt in events:
        start, end = evt.time_range.start, evt.time_range.end
        if _is_device(evt):
            if evt.is_user_annotation:
                ranges.setdefault(evt.name, []).append((start, end))
            else:
                ops.append((start, end, evt.name))
        elif not evt.is_user_annotation or evt.name.startswith(TRACE_RANGE):
            host.append((start, end, evt.name))
    ops.sort()
    merged = []
    for start, end, _ in ops:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy_us = sum(end - start for start, end in merged)
    by_name: dict = {}
    kernels = 0
    for start, end, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    trace_us = sum(end - start for name, spans_ in ranges.items()
                   if name.startswith(TRACE_RANGE) for start, end in spans_)
    span_ms = {name: sum(end - start for start, end in ranges[name])
               / 1000.0 / frames for name in spans if name in ranges}
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    return {
        "frames": frames,
        "wall_ms": wall_s * 1000.0 / frames,
        "busy_ms": busy_us / 1000.0 / frames,
        "kernels": kernels / frames,
        "trace_ms": trace_us / 1000.0 / frames,
        "span_ms": span_ms,
        "busy_s": busy_us / 1e6,
        "window_s": wall_s,
        "device_ops": sorted(((n, t / 1e6) for n, t in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": _name_gaps(gaps, host),
    }


def _name_gaps(gaps, host, longest: int = 200) -> list:
    """The longest idle gaps summed by what the host was doing at each
    gap's middle: the innermost host operation or range that spans it."""
    starts = np.asarray([h[0] for h in host], np.float64)
    ends = np.asarray([h[1] for h in host], np.float64)
    totals: dict = {}
    for length, start, end in sorted(gaps, reverse=True)[:longest]:
        mid = 0.5 * (start + end)
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = "host idle"
        if inside.size:
            name = host[inside[np.argmin(ends[inside] - starts[inside])]][2]
        totals[name] = totals.get(name, 0.0) + length / 1e6
    return sorted(totals.items(), key=lambda x: -x[1])[:10]
