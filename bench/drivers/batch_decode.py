"""An offline batch job on ``ContinuousEngine``: ``job`` requests
submitted at once, greedy, no EOS.  Set-up steps the engine until every
slot has consumed its prompt; the window measures what follows.  A
request that finishes hands its slot to the job's next.

Traffic keys: ``job``, ``prompt`` = {lo, hi} (prompt lengths evenly
spread over [lo, hi], shuffled by the seed), ``max_new_tokens``,
``engine`` (``EngineConfig`` fields), ``check_rows``.

Compared answers: ``check_rows`` requests drawn from the seed, the one
with the most served tokens among them; every served greedy token is
held against the reference by its gap below the reference's best at
that position (:func:`reference.compare.gaps`), and the compared number
is the mean gap over all of them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from driving import sample
from reference import compare


def prompt_lengths(traffic: dict, seed: int, count: int) -> "list[int]":
    lo, hi = traffic["prompt"]["lo"], traffic["prompt"]["hi"]
    job = traffic["job"]
    base = np.linspace(lo, hi, job).round().astype(int).tolist()
    rng = np.random.default_rng([seed, 5])
    out = []
    while len(out) < count:
        out += [base[j] for j in rng.permutation(job)]
    return out[:count]


def positions(at_start: dict, at_end: dict) -> np.ndarray:
    """The cache position of every token a row processed in the window
    (each attends to its position + 1 keys), from each request's cached
    length when the window opened (0 if it had no slot) and when it
    closed."""
    spans = [np.arange(at_start.get(rid, 0), end)
             for rid, end in at_end.items()]
    return np.concatenate(spans) if spans else np.zeros(0, np.int64)


def run(api, params, dm, traffic, seed, seconds, spans, window):
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import (PREFILL, ContinuousEngine,
                                            Request)
    from repro_torch.runtime.telemetry import Telemetry

    telemetry = Telemetry(trace=spans.on)
    eng = ContinuousEngine(api, params, EngineConfig(**traffic["engine"]),
                           telemetry=telemetry, device=api.device)
    lengths = prompt_lengths(traffic, seed, 100_000)
    new_tokens = traffic["max_new_tokens"]
    prompts: "dict[int, np.ndarray]" = {}
    done: "dict[int, list[int]]" = {}
    failed = []

    def submit(n):
        for _ in range(n):
            rid = len(prompts)
            prompts[rid] = np.random.default_rng([seed, 6, rid]).integers(
                0, dm.V, lengths[rid]).astype(np.int32)
            eng.submit(Request(rid, prompts[rid],
                               max_new_tokens=new_tokens))

    def step():
        with spans("engine.step"):
            eng.step()
        finished = eng.drain_completions()
        for c in finished:
            if c.status != "completed":
                failed.append(c.request_id)
            done[c.request_id] = list(c.tokens)
        submit(len(finished))

    def generated():
        live = sum(len(s.gen) for s in eng.slots if s is not None)
        return live + sum(len(t) for t in done.values())

    def cached():
        return {s.req.id: int(eng.slot_len[i])
                for i, s in enumerate(eng.slots) if s is not None}

    submit(traffic["job"])
    while eng.waiting or (eng.slot_phase == PREFILL).any():
        step()
    counters0 = eng.stats()["counters"]
    gen0, done0, at_start = generated(), set(done), cached()
    offset_ns = time.time_ns() - time.perf_counter_ns()
    with window() as t_window:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            step()
        t_window["end"] = time.perf_counter()
    stats = eng.stats()
    at_end = cached()
    for rid in set(done) - done0:      # finished inside the window: its
        at_end[rid] = len(prompts[rid]) + len(done[rid]) - 1  # last token
    streams = {s.req.id: list(s.gen) for s in eng.slots if s is not None}
    streams.update(done)
    ids = sorted(streams)
    longest = int(np.argmax([len(streams[r]) for r in ids]))
    picked = sample(seed, len(ids), traffic["check_rows"], longest)
    delta = {k: stats["counters"][k] - counters0[k]
             for k in ("engine.dispatches", "engine.fused_iterations")}
    pos = positions(at_start, at_end)
    return {
        "kind": "batch_decode",
        "window_s": t_window["end"] - t0,
        "attempted": len(prompts), "failed": len(failed),
        "tokens": generated() - gen0,
        "dispatches": delta["engine.dispatches"],
        "decode_steps": delta["engine.fused_iterations"],
        "positions": pos,
        "about": (f", cache positions {int(pos.min())}-{int(pos.max())}, "
                  f"{len(pos)} processed" if len(pos) else ""),
        "experts_rows": eng.max_batch,
        "kv_blocks_peak": stats["gauges"]["kv.blocks_live"]["high_water"],
        "kv_blocks": eng.num_blocks,
        "spans": [(e["kind"], int(e["ts"] * 1e9) + offset_ns,
                   int((e["ts"] + e["dur"]) * 1e9) + offset_ns)
                  for e in telemetry.events if "dur" in e],
        "check": [{"prompt": prompts[ids[j]],
                   "served": np.asarray(streams[ids[j]], np.int64)}
                  for j in picked],
    }


def reference_inputs(record):
    seqs, pos = zip(*(compare.served_positions(c["prompt"], c["served"])
                      for c in record["check"]))
    return list(seqs), list(pos)


def items(record, ref):
    """Each compared row's gaps, one a served token."""
    return [compare.gaps(r, torch.as_tensor(c["served"]))
            for c, r in zip(record["check"], ref)]


def control_items(record, ref, other):
    """The gaps of the tokens the other precision ranks first."""
    return [compare.gaps(r, o.argmax(-1)) for o, r in zip(other, ref)]


def summary(record, per_item) -> dict:
    return {"mean_served_gap": float(torch.cat(per_item).mean())}
