"""Serving entry point: batched requests through the §3.3-admitting engine.

Port of ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
        --requests 8 --max-new 16 --engine continuous [--device cuda] \\
        [--arrival-rate R | --trace-file PATH] [--deadline-s D] \\
        [--megastep N] [--host-pool 512M] [--fault-seed S] ...

Every engine knob flag (``--hbm-budget``, ``--max-batch``,
``--megastep``, ``--host-pool``, ``--fault-seed``, ``--max-queue``, ...)
is generated from :class:`repro_torch.runtime.config.EngineConfig` — run
``--help`` for the table.  An omitted flag falls back to its
``PARALLAX_*`` env var, then the field default.

``--engine continuous`` (this entry point's default) serves through the
iteration-level slot-table engine on the paged block KV cache with
cross-request prefix sharing; ``--no-paged`` gives it dense per-slot
caches instead.  ``--engine round`` (the JAX entry point's default)
runs the round-based baseline ``ServingEngine`` on a fresh dense cache
per round, sized to the round's longest request unless
``--max-context`` is given.  Fault injection, backpressure, deadlines,
the host KV tier and open-loop arrivals harden the continuous engine
only.  ``--device`` defaults to ``cuda`` and the run fails without a card
unless ``--device cpu`` is given.

Like the JAX entry point, :func:`serve` runs the arch's ``reduced()``
config with random weights from ``--seed``.  **Closed loop** (the
default) submits every request up front and ``run()`` drains them;
**open loop** (``--arrival-rate`` / ``--trace-file``) injects arrivals
on the wall clock through ``submit()``/``step()``/
``drain_completions()``.  ``--fault-seed`` arms the fault-injection
plane and prints the degraded-mode counters.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (ContinuousEngine, Request,
                                       ServingEngine)
from repro_torch.runtime.faults import FaultPlane
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.workload import (OpenLoopWorkload, percentile,
                                          run_open_loop)


def serve(arch: str, n_requests: int = 8, max_new: int = 16,
          budget_mb: int = 256, prompt_len: int = 12, seed: int = 0,
          max_batch: int = 4, engine_mode: str = "continuous",
          paged: bool = True, megastep: "int | None" = None,
          fault_seed: "int | None" = None,
          max_queue: "int | None" = None,
          deadline_s: "float | None" = None,
          trace_path: "str | None" = None,
          host_pool: "int | None" = None,
          config: "EngineConfig | None" = None,
          arrival_rate: "float | None" = None,
          trace_file: "str | None" = None,
          device=None):
    if engine_mode not in ("round", "continuous"):
        raise ValueError(f"unknown engine {engine_mode!r}")
    cfg = get_config(arch).reduced()
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=api.device).manual_seed(seed))
    tele = Telemetry(trace=trace_path is not None)
    if config is None:
        # a kwarg left at None is unset and falls through EngineConfig's
        # env-then-default resolution
        config = EngineConfig(
            hbm_budget=budget_mb << 20, max_batch=max_batch, paged=paged,
            max_context=(prompt_len + max_new
                         if engine_mode == "continuous" else None),
            **{k: v for k, v in dict(
                megastep=megastep, fault_seed=fault_seed,
                max_queue=max_queue, host_pool=host_pool).items()
               if v is not None})
    open_loop = arrival_rate is not None or trace_file is not None
    if engine_mode != "continuous" and (
            config.fault_seed is not None or max_queue is not None
            or deadline_s is not None or host_pool is not None
            or open_loop):
        raise ValueError("fault plane / backpressure / deadlines / host "
                         "KV tier / open-loop arrivals harden the "
                         "continuous engine only (--engine continuous)")

    workload = None
    if open_loop:
        if trace_file is not None:
            workload = OpenLoopWorkload.from_trace(
                trace_file, vocab_size=cfg.vocab_size, seed=seed,
                deadline_s=deadline_s)
        else:
            workload = OpenLoopWorkload.poisson(
                arrival_rate, n_requests, cfg.vocab_size, seed=seed,
                deadline_s=deadline_s)
        need = max(len(a.request.prompt) + a.request.max_new_tokens
                   for a in workload)
        if config.max_context is None or config.max_context < need:
            print(f"max_context {config.max_context} -> {need} "
                  f"(longest workload request)")
            config = replace(config, max_context=need)
        request_ids = [a.request.id for a in workload]
    else:
        request_ids = list(range(n_requests))

    faults = None
    if engine_mode == "continuous":
        engine = ContinuousEngine(api, params, config=config,
                                  telemetry=tele, device=api.device)
        if config.fault_seed is not None:
            # the schedule's budget events are absolute post-margin
            # byte values, so derive them from the pool's real budget
            faults = FaultPlane.random(
                config.fault_seed, budget_bytes=engine.kv.budget,
                request_ids=request_ids, max_batch=config.max_batch)
            engine.faults = faults
            print(f"fault plane armed: seed {config.fault_seed}, "
                  f"{len(faults.events)} events")
    else:
        engine = ServingEngine(api, params, config=config, telemetry=tele,
                               device=api.device)

    if open_loop:
        res = run_open_loop(engine, workload)
        done, wall = res.completions, res.wall_s
        n_requests = len(workload)
    else:
        rng = np.random.default_rng(seed)
        for i in range(n_requests):
            plen = int(rng.integers(4, prompt_len + 1))
            engine.submit(Request(
                id=i, prompt=rng.integers(
                    0, cfg.vocab_size, plen).astype(np.int32),
                max_new_tokens=max_new, deadline_s=deadline_s))
        t0 = time.time()
        done = engine.run()
        wall = time.time() - t0
    for rid in sorted(done):
        c = done[rid]
        tag = "" if c.ok else f" [{c.status}: {c.reason}]"
        print(f"req {rid}: {len(c.tokens)} tokens "
              f"(ttft {c.ttft_s*1e3:.1f} ms) -> {c.tokens[:8]}...{tag}")
    print(f"{len(done)}/{n_requests} requests in {wall:.2f}s on "
          f"{api.device}; peak cache {engine.kv.peak_bytes/2**20:.1f} MiB "
          f"(budget {engine.kv.budget/2**20:.1f} MiB), "
          f"slab reuse hits {engine.kv.reuse_count}")
    if open_loop:
        ok = [c for c in done.values() if c.ok]
        good = sum(len(c.tokens) for c in ok)
        ttfts = [c.ttft_submit_s for c in ok if c.ttft_submit_s > 0]
        depth = max((q for _, q, _ in res.queue_samples), default=0)
        print(f"open loop: offered {workload.offered_rate_rps:.2f} "
              f"req/s over {workload.duration_s:.2f}s, attainment "
              f"{len(ok)}/{n_requests}, goodput "
              f"{good / max(wall, 1e-9):.1f} tok/s, ttft p50 "
              f"{percentile(ttfts, 50)*1e3:.1f} ms / p95 "
              f"{percentile(ttfts, 95)*1e3:.1f} ms, peak queue "
              f"{depth}")
    total = sum(len(c.tokens) for c in done.values())
    if engine_mode == "round":
        print(f"round engine (dense cache): dispatches "
              f"{engine.dispatches} "
              f"({engine.dispatches/max(total, 1):.2f}/tok)")
    else:
        print(f"iterations {engine.iterations}, dispatches "
              f"{engine.dispatches} ({engine.dispatches/max(total, 1):.2f}"
              f"/tok), megasteps {engine.megasteps} "
              f"({engine.megastep_steps} fused iters, "
              f"N={engine.megastep_n}), "
              f"preemptions {engine.preemptions}")
        if engine.spill_enabled:
            print(f"host tier: {engine.spills} spills / "
                  f"{engine.restores} restores, "
                  f"{engine.prefill_tokens_saved} prefill tokens saved, "
                  f"{engine.reprefill_tokens} re-prefilled, host peak "
                  f"{engine.kv.host_peak_bytes/2**20:.2f} MiB "
                  f"(pool {engine.kv.host_budget/2**20:.2f} MiB), "
                  f"stalls {engine.stalls}")
        if faults is not None or config.max_queue is not None \
                or deadline_s is not None:
            by_status: "dict[str, int]" = {}
            for c in done.values():
                by_status[c.status] = by_status.get(c.status, 0) + 1
            print(f"resolution {by_status}; degraded activations "
                  f"{engine.degraded_activations} (watchdog trips "
                  f"{engine.watchdog_trips}, megastep fallbacks "
                  f"{engine.megastep_fallbacks}, retries "
                  f"{engine.retry_dispatches}, rows failed "
                  f"{engine.rows_failed}), cancellations "
                  f"{engine.cancellations}, rejected {engine.rejected}, "
                  f"budget events {engine.budget_events}")
        engine.assert_quiescent()
    if trace_path is not None:
        trace = tele.save_chrome_trace(trace_path)
        print(f"trace: {len(trace['traceEvents'])} events -> "
              f"{trace_path} (load in Perfetto / chrome://tracing)")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    default="stablelm-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=("round", "continuous"),
                    default="continuous")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the run fails without a card "
                         "unless 'cpu' is given")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    metavar="RPS",
                    help="open loop: Poisson arrivals at this req/s "
                         "through submit()/step()/drain_completions() "
                         "on the wall clock")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="open loop: replay a JSONL arrival trace "
                         "(see runtime/workload.py)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline in seconds")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record structured spans and write a Chrome "
                         "trace-event JSON here (open in Perfetto)")
    EngineConfig.add_cli_args(ap)
    args = ap.parse_args(argv)
    overrides = {}
    if args.max_context is None:
        # closed-loop default: prompt + generation exactly fit; the
        # round engine keeps its dynamic per-round bucketing
        overrides["max_context"] = (
            args.prompt_len + args.max_new
            if args.engine == "continuous" else None)
    config = EngineConfig.from_cli_args(args, **overrides)
    serve(args.arch, args.requests, args.max_new,
          prompt_len=args.prompt_len, seed=args.seed,
          engine_mode=args.engine, deadline_s=args.deadline_s,
          trace_path=args.trace, config=config,
          arrival_rate=args.arrival_rate, trace_file=args.trace_file,
          device=args.device)


if __name__ == "__main__":
    main()
