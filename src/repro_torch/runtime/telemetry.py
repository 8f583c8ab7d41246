"""Runtime telemetry plane: typed metrics, structured spans, trace export.

The paper's claims — latency reduction, bounded memory overhead,
adaptive scheduling under budgets — are *time-series* claims, but until
this module the repro could only report end-of-run aggregates scattered
across ad-hoc engine attributes.  This module provides the three layers
that make a serving run diagnosable:

* **Metrics registry** (:class:`MetricsRegistry`) — typed counters,
  gauges (with high-water tracking) and histograms with fixed
  log-spaced buckets.  The engines, the block KV cache, the stepper and
  the hetero executor all register their counters here instead of
  growing bespoke attributes; the old attribute names survive as
  read-only property façades.  ``snapshot()`` is deterministic: metric
  values depend only on the workload (never on wall time), so two
  identical seeded runs snapshot identically.

* **Span recorder** (:class:`SpanRecorder`) — structured events with
  monotonic timestamps, per-request and per-iteration.  The taxonomy is
  fixed (:data:`SPAN_KINDS`): ``submit`` / ``admit`` / ``first_token``
  / ``prefill_chunk`` / ``decode`` / ``megastep`` / ``reconcile`` /
  ``preempt`` / ``spill`` / ``restore`` / ``stalled`` / ``fault`` /
  ``complete`` / ``iteration`` (engine) and ``segment`` (hetero
  executor).  Recording is **disabled by default**: every hook site is
  a single ``enabled`` check, ``now()`` returns ``0.0`` without touching
  the clock, and nothing allocates — the disabled hot path is
  micro-benchmarked by ``benchmarks/serving.py`` and gated under 2 % of
  per-token wall time by ``benchmarks/gate.py``.

* **Exporters** — ``MetricsRegistry.snapshot()`` (JSON),
  :func:`request_timelines` (per-request lifecycle), and
  :func:`chrome_trace` (Chrome trace-event format, loadable in Perfetto
  or ``chrome://tracing``): engine iterations and dispatch spans as
  duration events on one track, request lifecycles as async events plus
  per-slot residency tracks, KV-pool occupancy as counter samples, and
  fault activations as instant events.  ``python -m repro_torch.launch.serve
  --trace out.json`` writes one for a live serving run.

**The hard invariant: tracing changes nothing.**  Recording reads the
clock and appends to a host-side list — it never feeds back into
scheduling, sampling or dispatch.  Greedy streams and dispatch counts
are bit-identical with tracing on vs off, asserted by the identity
child's ``--tele`` sweep (tests/serving_identity_child.py) and by the
``tracing_invisible`` flag the serving benchmark reports and the bench
gate enforces.
"""

from __future__ import annotations

import json
import time
from bisect import bisect_left

#: Every structured-event kind any component can emit.  The engine emits
#: all but "segment" (the hetero executor's per-segment span); the
#: schema check in tests/test_telemetry.py validates every recorded
#: event against this taxonomy.  ``spill`` / ``restore`` time the host-
#: tier block transfers (with block/byte args); ``stalled`` marks an
#: iteration the engine deliberately idled through a shrunk budget
#: waiting on a scheduled restore (cause + pending-restore ETA args);
#: ``first_token`` marks the instant a request's first generated token
#: reached the host (submit -> first_token is the open-loop harness's
#: TTFT-under-load signal); ``cache_evict`` marks a prefix-cache block
#: leaving the device pool (block/byte args, ``to_host`` when the host
#: tier gave it a second chance).
SPAN_KINDS = ("submit", "admit", "first_token", "prefill_chunk",
              "decode", "megastep", "reconcile", "preempt", "spill",
              "restore", "stalled", "fault", "complete", "iteration",
              "segment", "cache_evict")

#: Kinds recorded with a duration (``ts`` + ``dur``); the rest are
#: instantaneous points (``ts`` only).
DURATION_KINDS = frozenset({"iteration", "prefill_chunk", "decode",
                            "megastep", "reconcile", "spill", "restore",
                            "segment"})
POINT_KINDS = frozenset(k for k in SPAN_KINDS if k not in DURATION_KINDS)

#: Kinds that always carry a ``request_id``.
REQUEST_KINDS = frozenset({"submit", "admit", "first_token", "preempt",
                           "spill", "restore", "complete"})


def log_buckets(lo: int = 1, hi: int = 1 << 16,
                base: int = 2) -> "tuple[float, ...]":
    """Fixed log-spaced histogram bucket upper bounds: lo, lo*base, ...
    up to and including the first bound >= hi."""
    if lo <= 0 or base <= 1:
        raise ValueError(f"need lo > 0 and base > 1, got {lo}, {base}")
    bounds = [float(lo)]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * base)
    return tuple(bounds)


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self.value += n


class Gauge:
    """Point-in-time value with high-water tracking."""

    __slots__ = ("name", "value", "high_water")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.high_water = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.high_water:
            self.high_water = v


class Histogram:
    """Fixed-bucket histogram; bucket i counts observations
    ``v <= bounds[i]`` (the last bucket is the overflow).  Bounds are
    log-spaced by default (:func:`log_buckets`) and immutable after
    construction, so snapshots of identical runs are identical."""

    __slots__ = ("name", "bounds", "counts", "total", "count")

    def __init__(self, name: str, bounds: "tuple | None" = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None \
            else log_buckets()
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError(f"histogram {name}: bounds must be "
                             f"non-empty ascending, got {self.bounds}")
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.count = 0

    def observe(self, v) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1


class MetricsRegistry:
    """Typed, name-keyed metric store.  ``counter``/``gauge``/
    ``histogram`` create on first use and return the existing instance
    afterwards; re-registering a name as a different type raises (the
    registry is *typed* — a silent type change would corrupt every
    consumer of the snapshot)."""

    def __init__(self):
        self._metrics: "dict[str, object]" = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif type(m) is not cls:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: "tuple | None" = None) -> Histogram:
        return self._get(name, Histogram, bounds)

    def names(self) -> "list[str]":
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-ready, deterministically ordered dump of every metric.
        Values depend only on what was recorded — identical seeded runs
        produce identical snapshots (timings live in spans, not here)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = {"value": m.value,
                                       "high_water": m.high_water}
            else:
                out["histograms"][name] = {
                    "buckets": list(m.bounds),
                    "counts": list(m.counts),
                    "sum": m.total,
                    "count": m.count,
                }
        return out


class SpanRecorder:
    """Structured span/point event recorder with a no-op fast path.

    Disabled (the default), every hook is one attribute check:
    ``now()`` returns 0.0 without reading the clock and ``point`` /
    ``span`` return before building anything.  Enabled, events append
    to a host-side list as plain dicts::

        {"kind": ..., "ts": <monotonic s>, ["dur": <s>,]
         ["iteration": i,] ["request_id": r,] ["slot": s,]
         ["args": {...}]}

    Recording never feeds back into engine state — see the module
    docstring's invariance contract.
    """

    __slots__ = ("enabled", "events")

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.events: "list[dict]" = []

    def now(self) -> float:
        """Monotonic timestamp, or 0.0 (clock untouched) when disabled."""
        return time.perf_counter() if self.enabled else 0.0

    def _event(self, kind, ts, iteration, request_id, slot, args):
        e = {"kind": kind, "ts": ts}
        if iteration is not None:
            e["iteration"] = iteration
        if request_id is not None:
            e["request_id"] = request_id
        if slot is not None:
            e["slot"] = slot
        if args:
            e["args"] = args
        self.events.append(e)
        return e

    def point(self, kind: str, *, iteration=None, request_id=None,
              slot=None, **args) -> None:
        """Record an instantaneous event (stamped now)."""
        if not self.enabled:
            return
        self._event(kind, time.perf_counter(), iteration, request_id,
                    slot, args)

    def span(self, kind: str, t0: float, *, iteration=None,
             request_id=None, slot=None, **args) -> None:
        """Record a duration event started at ``t0`` (a prior ``now()``)
        and ending now."""
        if not self.enabled:
            return
        now = time.perf_counter()
        e = self._event(kind, t0, iteration, request_id, slot, args)
        e["dur"] = now - t0


class Telemetry:
    """One process-wide telemetry plane: a metrics registry (always on —
    counters replace what used to be ad-hoc attributes) plus a span
    recorder (off unless ``trace=True``).  Engines, caches and
    executors take a ``telemetry=`` argument and default to a private
    disabled instance, so sharing one plane across components is opt-in
    and costless when unused."""

    def __init__(self, trace: bool = False,
                 metrics: "MetricsRegistry | None" = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.rec = SpanRecorder(trace)

    @property
    def tracing(self) -> bool:
        return self.rec.enabled

    @property
    def events(self) -> "list[dict]":
        return self.rec.events

    def timelines(self) -> "dict[int, list[dict]]":
        return request_timelines(self.rec.events)

    def chrome_trace(self) -> dict:
        return chrome_trace(self.rec.events)

    def save_chrome_trace(self, path: str) -> dict:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------

def request_timelines(events: "list[dict]") -> "dict[int, list[dict]]":
    """Per-request lifecycle timeline: request id -> its events in
    recording order (submit → admit → [preempt → admit ...] →
    complete)."""
    out: "dict[int, list[dict]]" = {}
    for e in events:
        rid = e.get("request_id")
        if rid is not None:
            out.setdefault(rid, []).append(e)
    return out


#: Chrome trace-event "pid" lanes: engine iterations + dispatch spans,
#: request async lifecycles, and per-slot residency tracks.
PID_ENGINE, PID_REQUESTS, PID_SLOTS = 1, 2, 3


def chrome_trace(events: "list[dict]") -> dict:
    """Convert recorded events to Chrome trace-event format (the JSON
    Perfetto and ``chrome://tracing`` load).

    Mapping:

    * duration kinds (``iteration``, ``prefill_chunk``, ``decode``,
      ``megastep``, ``reconcile``, ``segment``) → complete events
      (``ph: "X"``) on the engine track; dispatch spans nest inside
      their iteration's slice,
    * ``submit``/``complete`` → nestable async begin/end (``"b"``/
      ``"e"``, ``id`` = request id) with ``admit``/``preempt`` as async
      instants (``"n"``) — one async lifecycle per request,
    * ``admit``→``preempt``/``complete`` additionally synthesize a
      per-slot residency slice (``"X"``, one tid per slot) so slot
      occupancy reads directly off the per-slot tracks,
    * iteration KV-pool samples → counter events (``ph: "C"``,
      name ``kv_pool``) — the pool-occupancy time series — plus a
      ``kv_host`` counter series (host-tier residency) when the
      iteration spans carry ``host_blocks`` (host pool armed),
    * ``fault`` → instant events (``ph: "i"``) on the engine track.

    Timestamps are exported in microseconds relative to the earliest
    event.
    """
    te: "list[dict]" = [
        {"ph": "M", "name": "process_name", "pid": PID_ENGINE, "tid": 0,
         "args": {"name": "engine"}},
        {"ph": "M", "name": "process_name", "pid": PID_REQUESTS,
         "tid": 0, "args": {"name": "requests"}},
        {"ph": "M", "name": "process_name", "pid": PID_SLOTS, "tid": 0,
         "args": {"name": "slots"}},
        {"ph": "M", "name": "thread_name", "pid": PID_ENGINE, "tid": 0,
         "args": {"name": "iterations"}},
    ]
    t0 = min((e["ts"] for e in events), default=0.0)

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    residency: "dict[int, tuple[int, float]]" = {}  # rid -> (slot, ts)
    slot_tids: "set[int]" = set()

    def close_residency(rid, ts):
        opened = residency.pop(rid, None)
        if opened is None:
            return
        slot, since = opened
        te.append({"ph": "X", "name": f"req {rid}", "pid": PID_SLOTS,
                   "tid": slot, "ts": us(since),
                   "dur": max(us(ts) - us(since), 0.0),
                   "args": {"request_id": rid}})

    for e in events:
        kind = e["kind"]
        args = dict(e.get("args") or {})
        if "iteration" in e:
            args["iteration"] = e["iteration"]
        rid = e.get("request_id")
        if kind in DURATION_KINDS:
            te.append({"ph": "X", "name": kind, "pid": PID_ENGINE,
                       "tid": 0, "ts": us(e["ts"]),
                       "dur": round(e.get("dur", 0.0) * 1e6, 3),
                       "args": args})
            if kind == "iteration" and "kv_blocks" in args:
                te.append({"ph": "C", "name": "kv_pool",
                           "pid": PID_ENGINE, "tid": 0,
                           "ts": us(e["ts"] + e.get("dur", 0.0)),
                           "args": {"blocks": args["kv_blocks"]}})
            if kind == "iteration" and "host_blocks" in args:
                # host-tier residency time series (present only when
                # the engine runs with a host pool armed)
                te.append({"ph": "C", "name": "kv_host",
                           "pid": PID_ENGINE, "tid": 0,
                           "ts": us(e["ts"] + e.get("dur", 0.0)),
                           "args": {"blocks": args["host_blocks"]}})
        elif kind == "submit":
            te.append({"ph": "b", "cat": "request", "id": str(rid),
                       "name": f"req {rid}", "pid": PID_REQUESTS,
                       "tid": 0, "ts": us(e["ts"]), "args": args})
        elif kind == "admit":
            slot = e.get("slot", 0)
            slot_tids.add(slot)
            residency[rid] = (slot, e["ts"])
            te.append({"ph": "n", "cat": "request", "id": str(rid),
                       "name": f"req {rid}", "pid": PID_REQUESTS,
                       "tid": 0, "ts": us(e["ts"]),
                       "args": dict(args, phase="admit",
                                    slot=slot)})
        elif kind == "first_token":
            te.append({"ph": "n", "cat": "request", "id": str(rid),
                       "name": f"req {rid}", "pid": PID_REQUESTS,
                       "tid": 0, "ts": us(e["ts"]),
                       "args": dict(args, phase="first_token")})
        elif kind == "preempt":
            close_residency(rid, e["ts"])
            te.append({"ph": "n", "cat": "request", "id": str(rid),
                       "name": f"req {rid}", "pid": PID_REQUESTS,
                       "tid": 0, "ts": us(e["ts"]),
                       "args": dict(args, phase="preempt")})
        elif kind == "complete":
            close_residency(rid, e["ts"])
            te.append({"ph": "e", "cat": "request", "id": str(rid),
                       "name": f"req {rid}", "pid": PID_REQUESTS,
                       "tid": 0, "ts": us(e["ts"]), "args": args})
        elif kind == "fault":
            te.append({"ph": "i", "s": "p", "name": "fault",
                       "pid": PID_ENGINE, "tid": 0, "ts": us(e["ts"]),
                       "args": args})
    for slot in sorted(slot_tids):
        te.append({"ph": "M", "name": "thread_name", "pid": PID_SLOTS,
                   "tid": slot, "args": {"name": f"slot {slot}"}})
    return {"traceEvents": te, "displayTimeUnit": "ms"}


_VALID_PHASES = frozenset({"X", "i", "I", "b", "e", "n", "C", "M"})


def validate_chrome_trace(trace, require_names: "tuple | list" = ()) \
        -> dict:
    """Validate a Chrome trace-event JSON object (or a path to one):
    ``traceEvents`` present and non-empty, every event a dict with a
    known ``ph``, a non-empty ``name``, integer ``pid``/``tid`` >= 0,
    numeric ``ts`` >= 0 (metadata exempt), ``X`` events carrying a
    numeric ``dur`` >= 0, async events carrying ``cat`` + ``id`` with
    begins/ends balanced per id, and counter events carrying numeric
    ``args``.  ``require_names`` additionally demands each substring
    appear in at least one event name (e.g. ``("megastep", "kv_pool")``
    for a serving trace).  Returns a summary dict; raises ``ValueError``
    on any violation — CI runs this against the ``--trace`` artifact.
    """
    if isinstance(trace, (str, bytes)):
        with open(trace) as f:
            trace = json.load(f)
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        raise ValueError("not a Chrome trace: no traceEvents list")
    events = trace["traceEvents"]
    if not events:
        raise ValueError("empty traceEvents")
    names: "set[str]" = set()
    async_depth: "dict[tuple, int]" = {}
    phases: "dict[str, int]" = {}
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: not an object")
        ph = ev.get("ph")
        if ph not in _VALID_PHASES:
            raise ValueError(f"{where}: unknown phase {ph!r}")
        phases[ph] = phases.get(ph, 0) + 1
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError(f"{where}: missing name")
        names.add(name)
        for key in ("pid", "tid"):
            v = ev.get(key)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"{where}: bad {key} {v!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: bad dur {dur!r}")
        if ph in ("b", "e", "n"):
            if not isinstance(ev.get("cat"), str) or "id" not in ev:
                raise ValueError(f"{where}: async event without cat/id")
            key = (ev["cat"], ev["id"])
            if ph == "b":
                async_depth[key] = async_depth.get(key, 0) + 1
            elif ph == "e":
                async_depth[key] = async_depth.get(key, 0) - 1
                if async_depth[key] < 0:
                    raise ValueError(
                        f"{where}: async end without begin for {key}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"{where}: counter without numeric args")
    unbalanced = {k: d for k, d in async_depth.items() if d != 0}
    if unbalanced:
        raise ValueError(f"unbalanced async events: {unbalanced}")
    for want in require_names:
        if not any(want in n for n in names):
            raise ValueError(f"required event name {want!r} absent "
                             f"(have {sorted(names)[:20]})")
    return {"events": len(events), "phases": phases,
            "names": sorted(names)}
