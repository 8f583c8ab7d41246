"""Deterministic fault-injection plane for the serving engine.

The paper's premise is an adaptive scheduler that keeps inference alive
*under device memory constraints* — but real edge deployments fail in
more ways than a static budget models: co-tenant apps shrink the
available memory mid-run, a flaky accelerator dispatch returns NaN
logits, clients hang up or outlive their deadlines, and traffic bursts
overflow any unbounded queue.  This module turns each of those into a
**deterministic, seed-driven, replayable** fault schedule the
:class:`~repro_torch.runtime.engine.ContinuousEngine` consumes, so "degrade,
don't die" is a tested invariant instead of a hope:

* ``budget`` — set the block-pool budget to an absolute byte value at a
  chosen engine iteration (simulated co-tenant pressure).  Shrinks may
  drop the budget below the bytes currently in use; the engine reacts
  by refusing growth and demote-preempting, and stalls (instead of
  raising) while a scheduled restore can make the pool feasible again.
* ``poison`` — overwrite chosen slot rows' logits with NaN inside the
  dispatch (injected *in-trace*, so the engine's in-dispatch NaN
  watchdog detects genuinely corrupted device results, not a host-side
  flag).  ``repeats`` poisons that iteration's first ``repeats``
  dispatch attempts, exercising the retry ladder: megastep → N=1 sync
  retries with bounded backoff → fail only the affected rows.
* ``cancel`` — cancel a request by id at a chosen iteration, either at
  iteration start (mid-prefill / mid-decode) or ``post_reserve``
  (immediately after a megastep bulk-reserved its KV blocks, forcing
  the engine to return the whole reservation and take the sync path).

A :class:`FaultPlane` is **stateless**: it is a pure schedule keyed by
the engine's iteration counter, so one plane can drive many runs (e.g.
the chaos harness replays the same schedule at megastep N=1 and N=8 and
asserts unaffected streams stay bit-identical).  ``FaultPlane.random``
derives an arbitrary schedule from a seed; every generated shrink is
paired with a restore so a finite schedule never wedges the engine.

Knobs: ``PARALLAX_FAULT_SEED`` (read by ``launch/serve.py``) arms a
random plane over the serving run; the engine itself takes an explicit
``faults=`` argument and never reads the environment.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

FAULT_SEED_ENV = "PARALLAX_FAULT_SEED"

KINDS = ("budget", "poison", "cancel")
WHENS = ("start", "post_reserve")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault, keyed by the engine iteration it fires at.

    ``iteration`` matches ``ContinuousEngine.iterations`` *after* its
    per-step increment, i.e. the first ``step()`` call is iteration 1.
    Fields beyond ``kind`` apply to one kind each: ``budget_bytes``
    (budget), ``rows``/``repeats`` (poison; slot indices, and how many
    consecutive dispatch attempts of that iteration stay poisoned),
    ``request_id``/``when`` (cancel).
    """

    iteration: int
    kind: str
    budget_bytes: "int | None" = None
    rows: "tuple[int, ...]" = ()
    repeats: int = 1
    request_id: "int | None" = None
    when: str = "start"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.iteration < 1:
            raise ValueError(f"fault iteration must be >= 1, "
                             f"got {self.iteration}")
        if self.when not in WHENS:
            raise ValueError(f"unknown fault phase {self.when!r} "
                             f"(expected one of {WHENS})")
        if self.kind == "budget" and (self.budget_bytes is None
                                      or self.budget_bytes < 0):
            raise ValueError("budget fault needs budget_bytes >= 0")
        if self.kind == "poison" and (not self.rows or self.repeats < 1):
            raise ValueError("poison fault needs rows and repeats >= 1")
        if self.kind == "cancel" and self.request_id is None:
            raise ValueError("cancel fault needs request_id")
        if self.kind != "cancel" and self.when != "start":
            raise ValueError(f"{self.kind} faults only fire at "
                             f"iteration start")

    def span_args(self) -> dict:
        """Flat JSON-safe args for the telemetry plane's ``fault``
        instant event: ``what``/``when`` plus the kind-specific fields
        that are actually set."""
        args = {"what": self.kind, "when": self.when}
        if self.kind == "budget":
            args["budget_bytes"] = self.budget_bytes
        elif self.kind == "poison":
            args["rows"] = list(self.rows)
            args["repeats"] = self.repeats
        elif self.kind == "cancel":
            args["request_id"] = self.request_id
        return args


@dataclass(frozen=True)
class FaultPlane:
    """An immutable, replayable schedule of :class:`FaultEvent`.

    The engine queries it at fixed hook points; the plane never mutates,
    so the same instance can drive any number of runs deterministically.
    """

    events: "tuple[FaultEvent, ...]" = ()
    _by_iter: dict = field(default_factory=dict, repr=False,
                           compare=False)

    def __init__(self, events=()):
        evs = tuple(sorted(events, key=lambda e: (e.iteration,
                                                  KINDS.index(e.kind))))
        object.__setattr__(self, "events", evs)
        by_iter: "dict[int, list[FaultEvent]]" = {}
        for e in evs:
            by_iter.setdefault(e.iteration, []).append(e)
        object.__setattr__(self, "_by_iter", by_iter)

    # -- engine hook points --------------------------------------------------

    def events_at(self, iteration: int,
                  when: str = "start") -> "list[FaultEvent]":
        """Budget and cancel events firing at ``iteration`` in phase
        ``when`` (poison events are queried per dispatch attempt via
        :meth:`poison_rows` instead)."""
        return [e for e in self._by_iter.get(iteration, ())
                if e.kind != "poison" and e.when == when]

    def poison_rows(self, iteration: int, attempt: int,
                    n_rows: int) -> "np.ndarray | None":
        """(n_rows,) bool mask of slot rows to poison on dispatch
        ``attempt`` (0 = the iteration's first dispatch) of
        ``iteration``, or None when the dispatch runs clean."""
        mask = None
        for e in self._by_iter.get(iteration, ()):
            if e.kind != "poison" or attempt >= e.repeats:
                continue
            if mask is None:
                mask = np.zeros(n_rows, bool)
            for r in e.rows:
                if 0 <= r < n_rows:
                    mask[r] = True
        if mask is not None and not mask.any():
            return None
        return mask

    def max_future_budget(self, iteration: int) -> "int | None":
        """Largest budget any event scheduled *after* ``iteration``
        will set — the engine stalls instead of raising MemoryError
        while this could make an infeasible pool feasible again."""
        fut = [e.budget_bytes for e in self.events
               if e.kind == "budget" and e.iteration > iteration]
        return max(fut) if fut else None

    def next_budget_recovery(self, iteration: int,
                             need: int) -> "int | None":
        """Earliest iteration after ``iteration`` whose budget event
        sets at least ``need`` bytes — the pending-restore ETA the
        engine's ``stalled`` telemetry span reports (None when no
        scheduled event can cover ``need``)."""
        fut = [e.iteration for e in self.events
               if e.kind == "budget" and e.iteration > iteration
               and e.budget_bytes >= need]
        return min(fut) if fut else None

    @property
    def poison_armed(self) -> bool:
        return any(e.kind == "poison" for e in self.events)

    # -- schedule generation -------------------------------------------------

    @classmethod
    def random(cls, seed: int, *, horizon: int = 12,
               budget_bytes: "int | None" = None,
               request_ids: "tuple | list" = (),
               max_batch: int = 4,
               kinds: "tuple[str, ...]" = KINDS,
               max_events: int = 3) -> "FaultPlane":
        """Deterministic schedule from a seed: up to ``max_events``
        faults per requested kind within ``horizon`` iterations.  Every
        budget shrink (an absolute value of 5–60 % of ``budget_bytes``)
        is paired with a restore to the full budget a few iterations
        later, and one final full restore closes the schedule, so a
        finite workload always regains feasibility.  Poison ``repeats``
        draws from {1, 2, 6}: 1–2 recover through the retry ladder, 6
        exhausts it and fails the affected rows."""
        rng = np.random.default_rng(seed)
        events: "list[FaultEvent]" = []
        if "budget" in kinds and budget_bytes:
            last = 1
            for _ in range(int(rng.integers(1, max_events + 1))):
                at = int(rng.integers(1, max(2, horizon)))
                dur = int(rng.integers(1, 8))
                frac = float(rng.uniform(0.05, 0.6))
                events.append(FaultEvent(
                    at, "budget",
                    budget_bytes=max(1, int(budget_bytes * frac))))
                events.append(FaultEvent(at + dur, "budget",
                                         budget_bytes=budget_bytes))
                last = max(last, at + dur)
            events.append(FaultEvent(last + 1, "budget",
                                     budget_bytes=budget_bytes))
        if "poison" in kinds:
            for _ in range(int(rng.integers(1, max_events + 1))):
                n = int(rng.integers(1, max_batch + 1))
                rows = tuple(sorted(set(
                    int(r) for r in rng.integers(0, max_batch, size=n))))
                events.append(FaultEvent(
                    int(rng.integers(1, max(2, horizon))), "poison",
                    rows=rows,
                    repeats=int(rng.choice([1, 1, 2, 6]))))
        if "cancel" in kinds and len(request_ids):
            for _ in range(int(rng.integers(1, max_events + 1))):
                events.append(FaultEvent(
                    int(rng.integers(1, max(2, horizon))), "cancel",
                    request_id=int(rng.choice(list(request_ids))),
                    when=str(rng.choice(["start", "start",
                                         "post_reserve"]))))
        return cls(events)


def fault_seed_from_env() -> "int | None":
    """``PARALLAX_FAULT_SEED`` as an int, or None when unset.  Read by
    launch entry points only — the engine never consults the env."""
    raw = os.environ.get(FAULT_SEED_ENV)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{FAULT_SEED_ENV}={raw!r}: expected an "
                         f"integer seed") from None
