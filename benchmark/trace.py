"""``torch.profiler`` over a few of the window's units, read from its raw
events: the device's busy time (the union of kernel, copy and memset
intervals), the device operations by name, the idle gaps by what the
host was doing, and the device time of the kernels launched from
autograd's backward (its ``autograd::engine::evaluate_function:``
ranges, any thread)."""

from __future__ import annotations

import bisect
import collections

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "benchmark.window"
BACKWARD = "autograd::engine::evaluate_function:"
# host-side bookkeeping of the profiler and the driver, not program work
_NOT_HOST_WORK = ("Activity Buffer Request", "Runtime Triggered Module "
                  "Loading", "Lazy Function Loading", WINDOW)


def run_traced(run_unit, units: int):
    """Run ``units`` units under the profiler; returns (raw events, units'
    total count returned by ``run_unit``)."""
    done = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(units):
                done += run_unit()
    return prof.profiler.kineto_results.events(), done


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict:
    """busy_s, window_s, device_events, backward_s, device_ops and
    idle_gaps (each [name, seconds], the ten largest)."""
    window = [e for e in events if e.name() == WINDOW
              and e.device_type() == DeviceType.CPU]
    if not window:
        raise RuntimeError("the traced window's range is missing")
    w0 = window[0].start_ns()
    w1 = w0 + window[0].duration_ns()
    dev, host, launches, backward = [], [], {}, collections.defaultdict(list)
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(e)
        elif e.device_type() == DeviceType.CPU:
            name = e.name()
            if name.startswith(BACKWARD):
                backward[e.start_thread_id()].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith(("cuda", "cu")) and e.correlation_id():
                launches[e.correlation_id()] = e
            if name not in _NOT_HOST_WORK:
                host.append(e)
    spans = [(max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1))
             for e in dev]
    busy = _union([(s, t) for s, t in spans if t > s])
    busy_ns = sum(t - s for s, t in busy)

    by_name = collections.Counter()
    for e in dev:
        by_name[e.name()] += e.duration_ns()

    # backward: device time of what was launched inside an
    # evaluate_function range of the launching thread
    ranges = {tid: _union(r) for tid, r in backward.items()}
    starts = {tid: [s for s, _ in r] for tid, r in ranges.items()}
    backward_ns = 0
    for e in dev:
        launch = launches.get(e.correlation_id())
        if launch is None:
            continue
        tid = launch.start_thread_id()
        if tid not in ranges:
            continue
        i = bisect.bisect_right(starts[tid], launch.start_ns()) - 1
        if i >= 0 and launch.start_ns() < ranges[tid][i][1]:
            backward_ns += e.duration_ns()

    # idle gaps inside the window, named by the innermost host operation
    # running when each began (on the main thread or a backward thread:
    # the one that started last); Python between operations is not an
    # operation
    gaps, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    threads = collections.defaultdict(list)
    for e in host:
        threads[e.start_thread_id()].append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.duration_ns()))
    stacks = {tid: [] for tid in threads}
    nexts = dict.fromkeys(threads, 0)
    idle = collections.Counter()
    for g0, g1 in gaps:
        best = None
        for tid, evs in threads.items():
            stack, j = stacks[tid], nexts[tid]
            while j < len(evs) and evs[j].start_ns() <= g0:
                e = evs[j]
                while stack and stack[-1][1] <= e.start_ns():
                    stack.pop()
                stack.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.name()))
                j += 1
            nexts[tid] = j
            while stack and stack[-1][1] <= g0:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        idle[best[2] if best else "(Python between operations)"] += g1 - g0

    top = lambda c: [[k, v * 1e-9] for k, v in c.most_common(10)]
    return {"busy_s": busy_ns * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "device_events": len(dev), "backward_s": backward_ns * 1e-9,
            "device_ops": top(by_name), "idle_gaps": top(idle)}
