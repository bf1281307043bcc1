"""Device and host timing of kernel launches on one card.

time_ms brackets repeated calls with two CUDA events; device_ms queues a
whole sequence of launch closures behind a device sleep and brackets it
with two CUDA events, so that no host gap between the launches counts;
queued_ms applies it to repeated launches of one kernel, trace_device_ms
to one treelet trace (the scheduler's first pick and its K rounds of the
treelet kernel K7).  chip_smoke.py times with these.
"""

from __future__ import annotations

import time

import torch

REPS = 10
# Device cycles the card sleeps before a timed sequence, so that the host
# has queued all of its launches before the first one starts (about 2 ms).
SLEEP_CYCLES = 4_000_000


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device ms of `fn()` over `reps` calls between two CUDA events,
    after one warm call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = REPS) -> float:
    """Mean host ms of `fn()` over `reps` calls ending in a synchronize,
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(reset, launches, reps: int = REPS) -> float:
    """Mean device ms of the launch closures `launches`, run in order after
    `reset()` (queued before the events, so not timed): the card sleeps
    first, so that the host queues them all before the first starts and no
    host gap lies between the two events.  The first of reps + 1 runs warms
    up and is not counted."""
    pairs = []
    for _ in range(reps + 1):
        reset()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for launch in launches:
            launch()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs[1:]) / reps


def queued_ms(launch, count: int, reps: int = 3) -> float:
    """Mean device ms of one `launch()`, from device_ms of `count` launches
    queued behind the device sleep, so that the host's time between two
    launches does not count even for a kernel that runs for microseconds."""
    return device_ms(lambda: None, [launch] * count, reps) / count


def trace_device_ms(tt, rays, cull: bool, any_hit: bool,
                    pick: bool = True) -> float:
    """Device ms of one treelet trace of `rays` on the tables `tt`, in
    packets of treelets.PACKET_RAYS rays: the first pick and the K rounds,
    or with pick=False the K rounds alone (the pick then runs untimed,
    before the events)."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel import treelets

    state = treelets.treelet_state(tt, *rays, any_hit)
    t_far = state.t_far.clone()
    rec = {key: value.clone() for key, value in state.rec.items()}
    first = ct.treelet_pick_launcher(tt, state)
    rounds = [ct.treelet_launcher(tt, state, r, cull, any_hit)[0]
              for r in range(min(3, tt.count))]

    def reset():
        # Back to the first pick's input.
        state.t_far.copy_(t_far)
        state.visited.zero_()
        state.keys.fill_(ct.EMPTY_KEY)
        for key, value in rec.items():
            state.rec[key].copy_(value)
        if not pick:
            first()

    launches = [rounds[r % 3] for r in range(tt.count)]
    return device_ms(reset, [first] + launches if pick else launches)
