"""Open-loop traffic: Poisson / trace-driven arrivals + the clock loop.

Closed-loop benchmarks (submit everything, then ``run()``) can never
see queueing: the engine is always saturated exactly as much as the
submitted batch, so TTFT-under-load, queue growth, and the saturation
knee are invisible.  An **open-loop** workload injects each request at
its own arrival time regardless of how the engine is keeping up — the
load is what it is, and the engine's backlog is the measurement.

Two generators build an :class:`OpenLoopWorkload`:

* :meth:`OpenLoopWorkload.poisson` — exponential inter-arrival gaps at
  a target rate, with a mixed prompt/output length distribution
  (weighted classes, mirroring the serving benchmark's short-prompt/
  long-gen + long-prompt/short-gen mix).  Seeded and deterministic:
  one seed fixes the arrival *order*, the arrival times, and every
  prompt token.
* :meth:`OpenLoopWorkload.from_trace` — replay a JSONL trace (one
  ``{"t_s", "id", "prompt"| "prompt_len", "max_new", ...}`` object per
  line), the round-trip twin of :meth:`OpenLoopWorkload.save_trace`.

:func:`run_open_loop` is the shared clock loop (serve.py's
``--arrival-rate`` path and ``benchmarks/openloop.py`` both drive it):
``submit()`` each request when the wall clock passes its arrival time,
``engine.step()`` while there is work, ``drain_completions()`` every
iteration, and sample the queue depth — returning an
:class:`OpenLoopResult` with per-request observation times the caller
turns into goodput/TTFT/TBT statistics.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np

from .engine import Completion, Request

#: (weight, (prompt_lo, prompt_hi), (new_lo, new_hi)) — inclusive
#: bounds.  Two classes: short-prompt/long-generation (chat-like) and
#: long-prompt/short-generation (summarization-like), the same mix the
#: closed-loop serving benchmark uses.
DEFAULT_LENGTH_MIX = ((1, (3, 7), (10, 16)),
                      (2, (12, 20), (2, 6)))


@dataclass(frozen=True)
class Arrival:
    """One request and the instant it enters the system (seconds from
    workload start)."""

    t_s: float
    request: Request


class OpenLoopWorkload:
    """An immutable, time-ordered sequence of :class:`Arrival`\\ s."""

    def __init__(self, arrivals: "list[Arrival]"):
        for a, b in zip(arrivals, arrivals[1:]):
            if b.t_s < a.t_s:
                raise ValueError("arrivals must be time-ordered")
        ids = [a.request.id for a in arrivals]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate request ids in workload")
        self.arrivals = tuple(arrivals)

    def __len__(self) -> int:
        return len(self.arrivals)

    def __iter__(self):
        return iter(self.arrivals)

    @property
    def duration_s(self) -> float:
        """Last arrival time (the injection window)."""
        return self.arrivals[-1].t_s if self.arrivals else 0.0

    @property
    def offered_rate_rps(self) -> float:
        """Mean offered arrival rate over the injection window."""
        if len(self.arrivals) < 2 or self.duration_s <= 0:
            return 0.0
        return (len(self.arrivals) - 1) / self.duration_s

    @property
    def total_tokens(self) -> int:
        """Prompt + max-new tokens offered (upper bound on work)."""
        return sum(len(a.request.prompt) + a.request.max_new_tokens
                   for a in self.arrivals)

    # -- generators ---------------------------------------------------------

    @classmethod
    def poisson(cls, rate_rps: float, n_requests: int, vocab_size: int,
                seed: int = 0, deadline_s: "float | None" = None,
                id_base: int = 0,
                length_mix=DEFAULT_LENGTH_MIX) -> "OpenLoopWorkload":
        """Poisson arrivals at ``rate_rps`` with the mixed length
        distribution.  Deterministic in ``seed``: arrival order, gaps,
        class draws, and prompt tokens all come from one
        ``default_rng(seed)`` stream."""
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        if n_requests < 1:
            raise ValueError(f"need >= 1 request, got {n_requests}")
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / rate_rps, n_requests)
        gaps[0] = 0.0                       # first request opens the run
        times = np.cumsum(gaps)
        weights = np.asarray([m[0] for m in length_mix], float)
        weights /= weights.sum()
        arrivals = []
        for i in range(n_requests):
            k = int(rng.choice(len(length_mix), p=weights))
            _, (plo, phi), (nlo, nhi) = length_mix[k]
            plen = int(rng.integers(plo, phi + 1))
            max_new = int(rng.integers(nlo, nhi + 1))
            prompt = rng.integers(
                0, vocab_size, plen).astype(np.int32)
            arrivals.append(Arrival(float(times[i]), Request(
                id_base + i, prompt, max_new_tokens=max_new,
                deadline_s=deadline_s)))
        return cls(arrivals)

    # -- trace round-trip ---------------------------------------------------

    def save_trace(self, path: str) -> None:
        """Write the workload as JSONL, one arrival per line with
        explicit prompt tokens — self-contained, replayable on any
        model whose vocab covers the ids."""
        with open(path, "w") as f:
            for a in self.arrivals:
                rec = {"t_s": round(a.t_s, 9), "id": a.request.id,
                       "prompt": np.asarray(a.request.prompt).tolist(),
                       "max_new": a.request.max_new_tokens}
                if a.request.deadline_s is not None:
                    rec["deadline_s"] = a.request.deadline_s
                if a.request.eos_id is not None:
                    rec["eos_id"] = a.request.eos_id
                f.write(json.dumps(rec) + "\n")

    @classmethod
    def from_trace(cls, path: str, vocab_size: "int | None" = None,
                   seed: int = 0,
                   deadline_s: "float | None" = None) -> "OpenLoopWorkload":
        """Replay a JSONL trace.  Lines carry either explicit
        ``prompt`` token ids or just ``prompt_len`` — the latter needs
        ``vocab_size`` and derives tokens deterministically from
        ``(seed, id)``, so two replays of the same trace are identical.
        ``deadline_s`` applies to lines that do not set their own."""
        arrivals = []
        with open(path) as f:
            for ln, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{path}:{ln + 1}: not JSON ({e})") from None
                if "prompt" in rec:
                    prompt = np.asarray(rec["prompt"], np.int32)
                elif "prompt_len" in rec:
                    if vocab_size is None:
                        raise ValueError(
                            f"{path}:{ln + 1}: prompt_len trace needs "
                            f"vocab_size to derive tokens")
                    prompt = np.random.default_rng(
                        [seed, int(rec["id"])]).integers(
                        0, vocab_size, int(rec["prompt_len"])) \
                        .astype(np.int32)
                else:
                    raise ValueError(f"{path}:{ln + 1}: needs 'prompt' "
                                     f"or 'prompt_len'")
                arrivals.append(Arrival(float(rec["t_s"]), Request(
                    int(rec["id"]), prompt,
                    max_new_tokens=int(rec.get("max_new", 16)),
                    eos_id=rec.get("eos_id"),
                    deadline_s=rec.get("deadline_s", deadline_s))))
        arrivals.sort(key=lambda a: a.t_s)
        return cls(arrivals)


@dataclass
class OpenLoopResult:
    """What one open-loop drive observed.  Times are wall seconds from
    the drive's t=0 (the first arrival)."""

    completions: "dict[int, Completion]" = field(default_factory=dict)
    submit_t: "dict[int, float]" = field(default_factory=dict)
    finish_t: "dict[int, float]" = field(default_factory=dict)
    #: (t_s, queue_depth, active_slots) sampled once per engine step
    queue_samples: "list[tuple]" = field(default_factory=list)
    wall_s: float = 0.0
    iterations: int = 0

    def by_status(self) -> "dict[str, int]":
        out: "dict[str, int]" = {}
        for c in self.completions.values():
            out[c.status] = out.get(c.status, 0) + 1
        return out


def run_open_loop(engine, workload: OpenLoopWorkload,
                  max_iters: int = 1_000_000,
                  idle_sleep_s: float = 0.0002) -> OpenLoopResult:
    """Drive ``engine`` through ``workload`` on the wall clock.

    The loop: submit every arrival whose time has come, ``step()`` when
    the engine has work, drain completions, repeat until every request
    has been injected AND resolved.  Between a quiet engine and a
    not-yet-due arrival it sleeps (bounded), so an idle tail costs no
    busy-spin.  ``max_iters`` is a liveness backstop mirroring
    ``run()``'s: on overrun the engine's own cap path fails whatever is
    still live, keeping every-id accounting intact.
    """
    res = OpenLoopResult()
    pending = list(workload.arrivals)
    next_i = 0
    t0 = time.perf_counter()
    while next_i < len(pending) or engine.has_work():
        now = time.perf_counter() - t0
        while next_i < len(pending) and pending[next_i].t_s <= now:
            arr = pending[next_i]
            engine.submit(arr.request)
            res.submit_t[arr.request.id] = now
            next_i += 1
        if engine.has_work():
            if res.iterations >= max_iters:
                engine.run(0)                 # cap: fail-resolve leftovers
            else:
                engine.step()
                res.iterations += 1
            now = time.perf_counter() - t0
            res.queue_samples.append(
                (now, len(engine.waiting)
                 if hasattr(engine, "waiting") else len(engine.queue),
                 getattr(engine, "num_active", 0)))
        elif next_i < len(pending):
            # quiet engine, future arrival: sleep toward it (bounded so
            # a long gap still reacts to the clock promptly)
            gap = pending[next_i].t_s - (time.perf_counter() - t0)
            if gap > 0:
                time.sleep(min(gap, idle_sleep_s * 25))
        for comp in engine.drain_completions():
            res.finish_t[comp.request_id] = time.perf_counter() - t0
            res.completions[comp.request_id] = comp
    res.wall_s = time.perf_counter() - t0
    return res


def percentile(values, q: float) -> float:
    """float(np.percentile) with an empty-input guard (0.0)."""
    vals = [v for v in values if v is not None]
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals, float), q))
