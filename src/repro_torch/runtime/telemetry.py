"""Runtime telemetry plane: typed metrics, structured spans, trace export.

The paper's claims — latency reduction, bounded memory overhead,
adaptive scheduling under budgets — are *time-series* claims, but until
this module the repro could only report end-of-run aggregates scattered
across ad-hoc engine attributes.  This module provides the layers that
make a serving run diagnosable:

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
  ``complete`` / ``iteration`` (engine), ``segment`` (hetero
  executor), the model step's sublayers (:data:`MODEL_KINDS`) and the
  copies that block the host (:data:`SYNC_KINDS`).  Recording is
  **disabled by default**: every hook site is a single ``enabled``
  check, ``now()`` returns ``0.0`` without touching the clock, and the
  model step's hooks (``mark`` / ``sublayer``) build nothing.

* **The installed plane** (:class:`install`, :func:`recorder`) — the
  model code takes no telemetry argument; it records into the plane a
  caller installed around its call (the engines install their own
  around every ``step``), else into a disabled default.  Every copy of
  the serving path that blocks the host (its device-to-host reads,
  :func:`to_host`, the host tier's copies of KV blocks both ways and the
  stepper's pageable host-to-device copies) goes through
  :func:`blocking`, which counts it in the installed plane's registry
  (``sync.<site>``) and, while tracing, records it as a ``sync.<site>``
  span.

* **Exporters** — ``MetricsRegistry.snapshot()`` (JSON) and
  :func:`chrome_trace` (Chrome trace-event format, loadable in Perfetto
  or ``chrome://tracing``): engine iterations, dispatch spans and the
  model step's spans as duration events on one track, request
  lifecycles as async events plus per-slot residency tracks, KV-pool
  occupancy as counter samples, and fault activations as instant
  events.  ``python -m repro_torch.launch.serve --trace out.json``
  writes one for a live serving run.  ``ts`` is ``perf_counter``
  seconds; :meth:`Telemetry.to_epoch_ns` maps it to the epoch
  nanoseconds of ``torch.profiler``'s device events, and
  ``chrome_trace(epoch=True)`` exports on that clock.  Spans add no
  event to a device trace (no ``record_function``, no NVTX range).

**The hard invariant: tracing changes nothing.**  Recording reads the
clock and appends to a host-side list — it never feeds back into
scheduling, sampling or dispatch.  Greedy streams, dispatch counts and
every counter are bit-identical with tracing on vs off
(tests/test_torch_telemetry.py, tests/test_torch_model_spans.py).  The
disabled path's cost on the card is measured by interleaved runs of the
benchmark's batch-decode cell, and the recording path's cost by the same
job traced without the profiler (PERF.md).
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
#: The model step's sublayer spans (``models/transformer.py``,
#: ``blocks.py``, ``moe.py``), one naming for prefill and decode:
#: ``embed``; per block the mixer half (``attn`` or ``mamba``: norm1, the
#: mixer, the residual) and the channel half (``mlp`` for a dense
#: channel; for an MoE channel ``moe.route``: norm2, router, softmax,
#: top-k, aux; ``moe.dispatch``: the buckets and the gather, and the
#: token exchange under expert parallelism; ``moe.experts``: the three
#: grouped GEMMs and SiLU·up; ``moe.combine``: the combine, a shared
#: expert and the residual); ``head``: the final norm and the logits.
#: Block spans carry ``args={"layer": index}``.
MODEL_KINDS = ("embed", "attn", "mamba", "mlp", "moe.route",
               "moe.dispatch", "moe.experts", "moe.combine", "head")

#: Copies of the serving path that block the host until the stream has
#: drained, each through :func:`blocking`: the device-to-host reads of
#: the MoE bucket capacity (``models/moe.py``) and of the engine's results
#: (``runtime/engine.py`` ``_host``), the host-tier copies of KV blocks
#: (``sync.kv_spill``: the block ids up and the blocks down;
#: ``sync.kv_restore``: the block ids and the blocks up, both from
#: pageable memory), and the stepper's host-to-device copies of a
#: dispatch's inputs from pageable memory (``runtime/stepper.py``
#: ``_device``).
SYNC_KINDS = ("sync.moe_capacity", "sync.engine_copy", "sync.kv_spill",
              "sync.kv_restore", "sync.step_inputs")

SPAN_KINDS = ("submit", "admit", "first_token", "prefill_chunk",
              "decode", "megastep", "reconcile", "preempt", "spill",
              "restore", "stalled", "fault", "complete", "iteration",
              "segment", "cache_evict") + MODEL_KINDS + SYNC_KINDS

#: Kinds recorded with a duration (``ts`` + ``dur``); the rest are
#: instantaneous points (``ts`` only).
DURATION_KINDS = frozenset({"iteration", "prefill_chunk", "decode",
                            "megastep", "reconcile", "spill", "restore",
                            "segment", *MODEL_KINDS, *SYNC_KINDS})

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

    __slots__ = ("enabled", "events", "layer", "_mark")

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.events: "list[dict]" = []
        # the model step's chain of sublayer spans: its layer and where
        # its next span starts (``mark`` / ``sublayer``)
        self.layer: "int | None" = None
        self._mark = 0.0

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

    def mark(self, layer: "int | None" = None) -> None:
        """Start a chain of the model step's sublayer spans now, in block
        ``layer`` (None outside the blocks: ``embed``, ``head``)."""
        if self.enabled:
            self.layer = layer
            self._mark = time.perf_counter()

    def sublayer(self, kind: str) -> None:
        """Record a duration event from the chain's mark (its previous
        sublayer's end) to now, with ``args={"layer": ...}`` inside a
        block, and move the mark to now.  Disabled, one check and no
        allocation."""
        if not self.enabled:
            return
        now = time.perf_counter()
        e = {"kind": kind, "ts": self._mark, "dur": now - self._mark}
        if self.layer is not None:
            e["args"] = {"layer": self.layer}
        self.events.append(e)
        self._mark = now


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
        # epoch ns minus perf_counter ns, read once when tracing starts:
        # maps ``ts`` onto torch.profiler's device clock
        self.epoch_offset_ns = (time.time_ns() - time.perf_counter_ns()
                                if trace else 0)

    @property
    def events(self) -> "list[dict]":
        return self.rec.events

    def to_epoch_ns(self, ts: float) -> int:
        """A recorded ``ts`` (perf_counter seconds) in epoch nanoseconds,
        the clock of ``torch.profiler``'s device events."""
        return round(ts * 1e9) + self.epoch_offset_ns

    def chrome_trace(self, epoch: bool = False) -> dict:
        """:func:`chrome_trace` of the recorded events; ``epoch`` puts
        them on the epoch clock of a ``torch.profiler`` trace."""
        return chrome_trace(self.rec.events,
                            self.epoch_offset_ns if epoch else None)

    def save_chrome_trace(self, path: str) -> dict:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


# --------------------------------------------------------------------------
# the installed plane
# --------------------------------------------------------------------------

#: the plane in use when no caller installed one: tracing off, and
#: :func:`blocking` counts nothing in it
_DISABLED = Telemetry()
_installed = _DISABLED


def recorder() -> SpanRecorder:
    """The span recorder the model step records into: the innermost
    :class:`install`-ed plane's, else the disabled default's."""
    return _installed.rec


class install:
    """``with install(tele):`` makes ``tele`` the installed plane and
    restores the previous one on exit, however the block ends."""

    __slots__ = ("tele", "prev")

    def __init__(self, tele: Telemetry):
        self.tele = tele
        self.prev = None

    def __enter__(self) -> Telemetry:
        global _installed
        self.prev = _installed
        _installed = self.tele
        return self.tele

    def __exit__(self, *exc) -> None:
        global _installed
        _installed = self.prev


def blocking(kind: str, copy, *args, **kwargs):
    """``copy(*args, **kwargs)``, a copy that blocks the host: counted as
    ``kind`` (one of :data:`SYNC_KINDS`) in the installed plane's
    registry and, while it traces, recorded as a ``kind`` duration span
    around the copy.  The disabled default counts nothing."""
    tele = _installed
    if tele is _DISABLED:
        return copy(*args, **kwargs)
    if kind not in SYNC_KINDS:
        raise ValueError(f"unknown host-sync site {kind!r}")
    tele.metrics.counter(kind).inc()
    rec = tele.rec
    if not rec.enabled:
        return copy(*args, **kwargs)
    t0 = time.perf_counter()
    out = copy(*args, **kwargs)
    rec.span(kind, t0)
    return out


def to_host(kind: str, t):
    """``t.cpu()``, a blocking device-to-host read (:func:`blocking`)."""
    return blocking(kind, t.cpu)


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------

#: Chrome trace-event "pid" lanes: engine iterations + dispatch spans,
#: request async lifecycles, and per-slot residency tracks.
PID_ENGINE, PID_REQUESTS, PID_SLOTS = 1, 2, 3


def chrome_trace(events: "list[dict]",
                 epoch_offset_ns: "int | None" = None) -> dict:
    """Convert recorded events to Chrome trace-event format (the JSON
    Perfetto and ``chrome://tracing`` load).

    Mapping:

    * duration kinds (``iteration``, ``prefill_chunk``, ``decode``,
      ``megastep``, ``reconcile``, ``segment``, the model step's and the
      host reads') → complete events (``ph: "X"``) on the engine track;
      dispatch spans nest inside their iteration's slice, the model
      step's spans and host reads inside their dispatch's,
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
    event, or, given ``epoch_offset_ns`` (:attr:`Telemetry.epoch_offset_ns`),
    in epoch microseconds, the clock of a ``torch.profiler`` trace.
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
    if epoch_offset_ns is None:
        t0 = min((e["ts"] for e in events), default=0.0)

        def us(t: float) -> float:
            return round((t - t0) * 1e6, 3)
    else:
        def us(t: float) -> float:
            return round(t * 1e6 + epoch_offset_ns / 1e3, 3)

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
