"""The device trace of a ``--trace 1`` run and what is read from it.

The measured window runs under ``torch.profiler`` with CUDA activity
alone (no host operator events, so the trace adds little host work).
Its device events carry epoch nanoseconds, the clock of the
benchmark's spans (:class:`driving.Spans`) and, shifted by one offset,
of the engine's telemetry spans, so each idle gap on the device is
labelled with the innermost host span around its start.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager

OUTSIDE = "outside_bench_spans"


@contextmanager
def untraced():
    yield {}


class Traced:
    """``window()`` profiles the measured loop; ``summary`` is filled
    when the loop ends."""

    def __init__(self, on_card: bool = True):
        self.on_card = on_card
        self.events = []
        self.start_ns = self.end_ns = 0

    @contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # off the card (the tests) there is no device to trace
        act = ProfilerActivity.CUDA if self.on_card else ProfilerActivity.CPU
        marks = {}
        with profile(activities=[act]) as prof:
            self.start_ns = time.time_ns()
            yield marks
            if self.on_card:
                torch.cuda.synchronize()
            self.end_ns = time.time_ns()
        self.events = device_events(prof)


def device_events(prof) -> "list[tuple[str, int, int]]":
    """(name, start_ns, end_ns) of every device event of the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


def summarize(events, start_ns: int, end_ns: int,
              spans: "list[tuple[str, int, int]]") -> dict:
    """Busy seconds (the union of device events inside the window), the
    window, seconds by kernel name, and idle gaps by host span."""
    ev = sorted((max(s, start_ns), min(e, end_ns), n) for n, s, e in events
                if e > start_ns and s < end_ns)
    by_name = defaultdict(float)
    busy = 0
    gaps = []
    cursor = start_ns
    for s, e, n in ev:
        by_name[n] += (e - s) / 1e9
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if end_ns > cursor:
        gaps.append((cursor, end_ns))
    label = _labeller(spans)
    idle = defaultdict(lambda: [0, 0.0])
    for a, b in gaps:
        slot = idle[label(a)]
        slot[0] += 1
        slot[1] += (b - a) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (end_ns - start_ns) / 1e9,
            "by_name": dict(by_name), "idle": {k: tuple(v) for k, v in
                                               idle.items()}}


def _labeller(spans):
    """t -> name of the innermost span holding t (spans nest)."""
    points = []
    for name, s, e in spans:
        points.append((s, 1, -(e - s), name))
        points.append((e, 0, 0, name))
    points.sort()
    cuts, names, stack = [], [], []
    for t, opening, _, name in points:
        if opening:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        cuts.append(t)
        names.append(stack[-1] if stack else OUTSIDE)

    def label(t):
        i = bisect.bisect_right(cuts, t) - 1
        return names[i] if i >= 0 else OUTSIDE
    return label


def kernel_seconds(summary: dict, patterns) -> float:
    return sum(s for n, s in summary["by_name"].items()
               if any(p in n for p in patterns))


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[f"{n}: {c} gaps", s] for n, (c, s) in gaps]}
