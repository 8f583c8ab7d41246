"""Blocking host copies per fused decode dispatch in the measured
window: the program's ``sync.*`` spans (its telemetry plane's
``blocking``) that start inside an engine ``megastep`` span, over the
number of ``megastep`` spans.  Only the megasteps that start in the
window count: the record's spans run from the engine's construction on,
set-up included, and the window is the last ``window_s`` seconds before
the end of the last span (the window closes right after its last step).
None where the program records no ``sync.*`` span."""

import bisect


def read(ctx):
    run = ctx["run"]
    spans = run.get("spans") or ()
    if not spans or not any(n.startswith("sync.") for n, _, _ in spans):
        return None
    opened = max(e for _, _, e in spans) - run["window_s"] * 1e9
    megasteps = sorted((s, e) for name, s, e in spans
                       if name == "megastep" and s >= opened)
    if not megasteps:
        return None
    syncs = [s for name, s, _ in spans if name.startswith("sync.")]
    starts = [s for s, _ in megasteps]
    inside = 0
    for t in syncs:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and t <= megasteps[i][1]
    return inside / len(megasteps)
