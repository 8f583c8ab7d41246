"""Serving engines with resource-constrained admission — paper §3.3 as a
first-class serving feature, at two scheduling granularities.

Port of ``repro.runtime.engine``.  :class:`ServingEngine` (round-based,
the measured baseline) admits the largest-cardinality subset of waiting
requests whose whole-lifetime peak cache memory fits the budget,
prefills them as one batch on a fresh dense cache, and decodes the round
to completion before admitting again.

:class:`ContinuousEngine` (iteration-level scheduling) keeps a
fixed-capacity **slot table** of
``max_batch`` rows runs one masked decode dispatch per iteration, so
requests join and leave between iterations.  Chunked prefill of newly
admitted requests interleaves with decode iterations.  KV memory is a
:class:`~repro_torch.runtime.kv_cache.BlockKVCache` — per-slot block
tables over a pool of fixed-size slab blocks, grown lazily and released
the iteration a request finishes — and admission re-runs the §3.3
greedy selection *every iteration* against the pool's actual headroom
(:func:`repro_torch.core.scheduler.incremental_select`).  When growth
would exceed the budget the engine preempts the youngest request: with
a host KV tier armed (``host_pool`` / env ``PARALLAX_HOST_POOL``) its
written blocks SPILL to host memory and re-admission RESTORES them;
without it the blocks are freed and re-admission re-prefills.

The scheduling logic is the JAX package's, line for line; what differs
is the device side.  The model's KV pools are torch tensors that the
kernels update **in place**, where the JAX engine rebinds immutable
arrays; Mamba layers' per-row state, by contrast, is rebuilt out of
place every step.  So a dispatch the engine discards (a poisoned
megastep, a retried decode) is undone by putting back the list of
caches from before it, as the JAX engine does: that restores every
Mamba layer's state exactly, and for the KV pools
:meth:`ContinuousEngine._discard_dispatch` relies on the masking
argument it states, on the paged pool and on the dense per-slot cache
alike.  Models with per-row state also get a reset dispatch
(``Stepper.reset_rows``) for every admission wave.

Both engines drive the same :class:`~repro_torch.runtime.stepper.Stepper`
with per-row cache positions, so for decoder-only models they emit the
same greedy streams on a mixed-length request set: the continuous engine
is a pure scheduling optimisation.  On the card the decode kernels walk
each row's positions in fixed tiles and stop at its length, so a row's
result does not depend on the cache's width; on the CPU the plain
versions reduce over the whole width, so exact comparisons there give
both engines one ``max_context`` (as the JAX package's identity test
does).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.scheduler import greedy_select, incremental_select
from repro_torch.device import resolve_device
from .config import EngineConfig
from .kv_cache import BlockKVCache, KVCacheManager, request_peak_bytes
from .stepper import Stepper
from .telemetry import Telemetry, blocking, install, to_host


@dataclass
class Request:
    id: int
    prompt: "np.ndarray"           # (S,) int32
    max_new_tokens: int = 16
    eos_id: "int | None" = None    # stop after sampling this token
    deadline_s: "float | None" = None   # wall seconds from submit();
    # past it the engine cancels the request wherever it lives (waiting,
    # mid-prefill or mid-decode), returning the partial stream

    def context_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens


#: Every submitted request resolves to exactly one of these — nothing is
#: ever silently dropped.  "completed" is the only status whose stream
#: is final; "cancelled" (explicit cancel / deadline) and "failed"
#: (poisoned dispatch after retries, or the run's iteration cap) carry
#: the partial stream generated so far, "rejected" (queue backpressure)
#: carries none.  ``reason`` is machine-readable for non-completed
#: statuses (e.g. "queue_full", "deadline", "poisoned_logits",
#: "max_iters").
COMPLETION_STATUSES = ("completed", "cancelled", "rejected", "failed")


@dataclass
class Completion:
    request_id: int
    tokens: "list[int]" = field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    ttft_s: float = 0.0            # run-start -> first generated token
    ttft_admit_s: float = 0.0      # admission -> first generated token
    ttft_submit_s: float = 0.0     # submit -> first generated token
    # (queueing included — the open-loop harness's TTFT-under-load)
    status: str = "completed"      # one of COMPLETION_STATUSES
    reason: "str | None" = None    # machine-readable, non-completed only

    @property
    def ok(self) -> bool:
        return self.status == "completed"


def _validate_request(req: Request, max_context: "int | None") -> None:
    """Reject malformed requests AT SUBMIT with a clear error — not ten
    dispatches later with a pool assert deep inside prefill."""
    prompt = np.asarray(req.prompt)
    if prompt.ndim != 1:
        raise ValueError(f"request {req.id}: prompt must be 1-D token "
                         f"ids, got shape {prompt.shape}")
    if len(prompt) == 0:
        raise ValueError(f"request {req.id}: empty prompt")
    if not np.issubdtype(prompt.dtype, np.integer):
        raise ValueError(f"request {req.id}: prompt must hold integer "
                         f"token ids, got dtype {prompt.dtype}")
    if req.max_new_tokens < 0:
        raise ValueError(f"request {req.id}: max_new_tokens must be "
                         f">= 0, got {req.max_new_tokens}")
    if req.deadline_s is not None and req.deadline_s <= 0:
        raise ValueError(f"request {req.id}: deadline_s must be > 0, "
                         f"got {req.deadline_s}")
    if max_context is not None and req.context_len() > max_context:
        raise ValueError(
            f"request {req.id}: context {req.context_len()} exceeds "
            f"max_context {max_context}")


def _pad_to_multiple(arr: "np.ndarray", multiple: int) -> "np.ndarray":
    cols = -(-arr.shape[1] // multiple) * multiple if arr.shape[1] else \
        multiple
    out = np.zeros((arr.shape[0], cols), np.int32)
    out[:, :arr.shape[1]] = arr
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """Device -> host copy of a dispatch's result, a blocking read
    (``sync.engine_copy``).  A megastep makes three (tokens, masks,
    watchdog), a decode step two; the model's own reads
    (``sync.moe_capacity``) come on top inside the dispatch."""
    return to_host("sync.engine_copy", t).numpy()


def _engine_device(api, device) -> None:
    """An engine runs on the card unless the caller asks for the CPU,
    like build_model; the model must live where the engine runs."""
    device = resolve_device(device)
    if device.type != api.device.type:
        raise ValueError(f"engine on {device}, model built for "
                         f"{api.device}")


class ServingEngine:
    """Round-based batched prefill + decode with §3.3 greedy admission.

    The measured baseline for :class:`ContinuousEngine`: whole-lifetime
    peak-memory admission (`KVCacheManager`), one dense cache per round
    (``api.init_caches``, freed when the round ends), and
    round-at-a-time scheduling.  Prefill and decode run through the
    shared :class:`Stepper`, so every row advances from its own prompt
    length (length-correct streams) and the fixed-width masked prefill
    chunk serves every prompt-length remainder with one batch shape.

    ``config.max_context=None`` — the default when no config is given —
    sizes each round's cache to its longest request, rounded up to a
    multiple of 32 slots.  The dense cache reduces in tiles of
    ``config.block_size`` tokens, the continuous engine's block size.
    """

    def __init__(self, api, params, config: "EngineConfig | None" = None,
                 stepper: "Stepper | None" = None,
                 telemetry: "Telemetry | None" = None, device=None):
        _engine_device(api, device)
        # the round engine's default is dynamic per-round bucketing
        config = (config if config is not None
                  else EngineConfig(max_context=None)).on_device(api.device)
        self.config = config
        self.api = api
        self.cfg = api.cfg
        self.params = params
        # the paper's working-memory budget: free capacity minus margin
        self.kv = KVCacheManager(
            self.cfg, int(config.hbm_budget * (1.0 - config.margin)))
        self.max_batch = config.max_batch
        self.prefill_chunk = config.prefill_chunk
        self.max_context = config.max_context
        self.queue: list[Request] = []
        self.completed: dict[int, Completion] = {}
        self._drainable: "deque[Completion]" = deque()
        self._submit_t: dict[int, float] = {}
        self._t0: "float | None" = None
        if stepper is not None and stepper.api is not api:
            raise ValueError("shared stepper built for a different model")
        self.stepper = stepper if stepper is not None else Stepper(api)
        # telemetry plane: metrics live in the registry, spans record
        # only when the caller armed tracing — recording never feeds back
        # into scheduling
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._rec = self.telemetry.rec
        m = self.telemetry.metrics
        self._m_dispatches = m.counter("engine.dispatches")
        self._m_submitted = m.counter("engine.requests_submitted")
        self._m_resolved = m.counter("engine.requests_resolved")
        self._h_prompt = m.histogram("engine.prompt_len")
        self._g_queue = m.gauge("engine.queue_depth")

    def submit(self, req: Request) -> bool:
        _validate_request(req, self.max_context)
        if any(r.id == req.id for r in self.queue) \
                or req.id in self.completed:
            raise ValueError(f"duplicate request id {req.id}")
        self._m_submitted.inc()
        self._h_prompt.observe(len(req.prompt))
        self._rec.point("submit", request_id=req.id,
                        prompt_len=len(req.prompt),
                        max_new=req.max_new_tokens)
        self._submit_t[req.id] = time.perf_counter()
        self.queue.append(req)
        self._g_queue.set(len(self.queue))
        return True

    @property
    def dispatch_count(self) -> int:
        return self._m_dispatches.value

    @property
    def dispatches(self) -> int:
        return self._m_dispatches.value

    def stats(self) -> dict:
        """Deterministic JSON-ready snapshot of every metric plus the
        stepper's counters."""
        snap = self.telemetry.metrics.snapshot()
        snap["stepper"] = self.stepper.trace_stats()
        return snap

    # -- scheduling round ---------------------------------------------------

    def _admit(self) -> "list[Request]":
        """Greedy §3.3 selection over the waiting queue (whole-lifetime
        peak-memory upper bounds — contrast incremental_select)."""
        if not self.queue:
            return []
        peak = {r.id: request_peak_bytes(self.cfg, r.context_len())
                for r in self.queue}
        headroom = self.kv.budget - self.kv.in_use
        chosen_ids, _ = greedy_select(peak, [r.id for r in self.queue],
                                      headroom, self.max_batch)
        chosen = [r for r in self.queue if r.id in chosen_ids]
        self.queue = [r for r in self.queue if r.id not in chosen_ids]
        return chosen

    def _run_round(self, batch_reqs, t_run0: float,
                   t_admit: "float | None" = None) -> None:
        """One round over a fixed ``max_batch``-wide batch: rounds with
        fewer admitted requests pad with inactive rows (n_valid = 0,
        never active), so every dispatch has one shape and a row's
        result does not depend on how many requests the round admitted."""
        C = self.prefill_chunk
        B = self.max_batch
        n = len(batch_reqs)
        plens = np.zeros(B, np.int32)
        max_new = np.zeros(B, np.int32)
        plens[:n] = [len(r.prompt) for r in batch_reqs]
        max_new[:n] = [r.max_new_tokens for r in batch_reqs]
        if self.max_context is not None:
            max_ctx = self.max_context
        else:
            # bucket the per-round cache width so rounds with similar
            # context lengths share one shape (32-slot steps)
            need = max(r.context_len() for r in batch_reqs)
            max_ctx = -(-need // 32) * 32
        toks = np.zeros((B, int(plens.max())), np.int32)
        for i, r in enumerate(batch_reqs):
            toks[i, :len(r.prompt)] = r.prompt          # right padding
        toks = _pad_to_multiple(toks, C)

        caches = self.api.init_caches(B, max_ctx, self.api.dtype,
                                      tile=self.config.block_size)
        lens = np.zeros(B, np.int32)
        first_tok = np.zeros(B, np.int32)

        rec = self._rec
        t0 = time.perf_counter()
        for t in range(0, int(plens.max()), C):
            n_valid = np.clip(plens - t, 0, C)
            self._m_dispatches.inc()
            t_d = rec.now()
            caches, _, first, _ = self.stepper.prefill_chunk(
                self.params, caches, toks[:, t:t + C], lens, n_valid)
            done_here = (t < plens) & (plens <= t + C)
            if done_here.any():
                first_host = _host(first)
                first_tok[done_here] = first_host[done_here]
            lens += n_valid
            rec.span("prefill_chunk", t_d, rows=int((n_valid > 0).sum()),
                     tokens=int(n_valid.sum()))
        prefill_s = time.perf_counter() - t0
        t_first = time.perf_counter()
        ttft_s = t_first - t_run0
        ttft_admit_s = t_first - (t_admit if t_admit is not None
                                  else t_run0)

        comps = {r.id: Completion(
            r.id, prefill_s=prefill_s, ttft_s=ttft_s,
            ttft_admit_s=ttft_admit_s,
            ttft_submit_s=t_first - self._submit_t.get(r.id, t_run0))
            for r in batch_reqs}
        for r in batch_reqs:
            rec.point("first_token", request_id=r.id,
                      ttft_s=round(ttft_s, 6))
        eos = np.full(B, -1, np.int64)
        for i, r in enumerate(batch_reqs):
            if r.eos_id is not None:
                eos[i] = r.eos_id
        count = np.zeros(B, np.int32)       # pad rows stay at 0
        for i, r in enumerate(batch_reqs):
            if r.max_new_tokens > 0:        # 0 = prefill-only request
                comps[r.id].tokens.append(int(first_tok[i]))
                count[i] = 1
                if first_tok[i] == eos[i]:  # stop after the EOS token
                    count[i] = max_new[i]
        last = first_tok.copy()

        t0 = time.perf_counter()
        while (count < max_new).any():
            active = count < max_new
            self._m_dispatches.inc()
            t_d = rec.now()
            # the round baseline ignores the watchdog flag: it exists to
            # measure the continuous engine against, and its semantics
            # must not drift with the hardening work
            last_dev, _, caches = self.stepper.decode(
                self.params, caches, last, lens, active)
            last = _host(last_dev)
            rec.span("decode", t_d, rows=int(active.sum()))
            lens += active
            count += active
            for i, r in enumerate(batch_reqs):
                if active[i]:
                    comps[r.id].tokens.append(int(last[i]))
                    if last[i] == eos[i]:
                        count[i] = max_new[i]
        decode_s = time.perf_counter() - t0

        for r in batch_reqs:
            comps[r.id].decode_s = decode_s
            self.kv.release(r.id)
            self._m_resolved.inc()
            rec.point("complete", request_id=r.id, status="completed",
                      tokens=len(comps[r.id].tokens))
            self.completed[r.id] = comps[r.id]
            self._drainable.append(comps[r.id])

    # -- step/drain surface -------------------------------------------------

    def has_work(self) -> bool:
        """True while any submitted request is still unresolved."""
        return bool(self.queue)

    def step(self) -> None:
        """ONE scheduling round: admit the largest-fitting subset of the
        queue, prefill it as a batch, decode it to completion.  A no-op
        when the queue is empty — callers drive ``submit()`` / ``step()``
        / :meth:`drain_completions` from their own loop (the open-loop
        harness), and :meth:`run` is a thin wrapper doing exactly that."""
        if not self.queue:
            return
        if self._t0 is None:
            self._t0 = time.perf_counter()
        batch_reqs = self._admit()
        if not batch_reqs:
            # between rounds the pool is empty, so an empty round means
            # no queued request can EVER fit — raise like the continuous
            # engine instead of silently dropping them
            smallest = min(
                request_peak_bytes(self.cfg, r.context_len())
                for r in self.queue)
            raise MemoryError(
                f"no queued request fits: smallest peak {smallest} "
                f"bytes, headroom {self.kv.budget - self.kv.in_use}")
        self._g_queue.set(len(self.queue))
        t_admit = time.perf_counter()
        for i, r in enumerate(batch_reqs):
            self.kv.admit(r.id, r.context_len())
            self._rec.point("admit", request_id=r.id, slot=i)
        with install(self.telemetry):    # the model records into it
            self._run_round(batch_reqs, self._t0, t_admit)

    def drain_completions(self) -> "list[Completion]":
        """Completions resolved since the last drain, in resolution
        order — the incremental twin of :meth:`run`'s end-of-world
        dict (which keeps accumulating regardless of draining)."""
        out = list(self._drainable)
        self._drainable.clear()
        return out

    def run(self, max_rounds: int = 64) -> "dict[int, Completion]":
        """Drain the queue through the step surface: at most
        ``max_rounds`` scheduling rounds, then every still-queued
        request resolves as failed (the cap is a liveness backstop,
        not a silent drop)."""
        self._t0 = time.perf_counter()
        rounds = 0
        while self.queue and rounds < max_rounds:
            rounds += 1
            self.step()
        for r in self.queue:
            self._m_resolved.inc()
            self._rec.point("complete", request_id=r.id, status="failed",
                            reason="max_rounds")
            comp = Completion(r.id, status="failed", reason="max_rounds")
            self.completed[r.id] = comp
            self._drainable.append(comp)
        self.queue.clear()
        self._g_queue.set(0)
        return self.completed


# --------------------------------------------------------------------------
# continuous batching
# --------------------------------------------------------------------------

@dataclass
class _Seq:
    """A request's serving state (survives preemption)."""

    req: Request
    gen: "list[int]" = field(default_factory=list)
    ttft_s: "float | None" = None
    ttft_admit_s: "float | None" = None
    ttft_submit_s: "float | None" = None
    admit_t: "float | None" = None     # first admission (pre-preemption)
    preempted: bool = False
    submit_t: "float | None" = None    # deadline_s counts from here
    written_at_preempt: int = 0        # cache watermark when last demoted

    def pending_len(self) -> int:
        """len(pending_prompt()) without materializing it — the per-
        iteration admission cost query must stay O(1)."""
        return len(self.req.prompt) + max(len(self.gen) - 1, 0)

    def pending_prompt(self) -> "np.ndarray":
        """Tokens that must be in the cache before decode resumes: the
        original prompt plus every *consumed* generated token (the last
        sampled token has not entered the cache yet)."""
        if not self.gen:
            return np.asarray(self.req.prompt, np.int32)
        return np.concatenate([np.asarray(self.req.prompt, np.int32),
                               np.asarray(self.gen[:-1], np.int32)])


FREE, PREFILL, DECODE = 0, 1, 2


class ContinuousEngine:
    """Iteration-level scheduling over a fixed slot table (decoder-only).

    Every iteration: (1) §3.3 admission against live block-pool headroom
    fills free slots, (2) one masked prefill chunk advances every
    prefilling slot by up to ``prefill_chunk`` prompt tokens, (3) block
    growth (with demote-only preemption of the youngest request when the
    pool is exhausted), (4) ONE decode dispatch advances every decoding
    slot.  Caches are allocated once.

    **Decode megastep** (``megastep`` / env ``PARALLAX_MEGASTEP``,
    default 8): instead of one decode dispatch per
    iteration, up to N consecutive decode iterations run as ONE
    dispatch whose loop carry holds (token ids, per-row
    cache_len, active mask, sampling state) entirely on device — greedy
    sampling, EOS checks and max-token countdown run in-carry, so
    finished rows self-deactivate mid-megastep without a host sync, and
    prefilling rows ride by force-feeding their remaining prompt
    tokens.  The engine **bulk-reserves** every KV block the scan could
    write before launching (the scan never allocates), **flushes** with
    a short megastep whenever requests wait (N clips to the next slot
    completion, bounding TTFT inflation), fences off a demoted
    request's re-admission headroom from the reservation, and
    **reconciles** after the result's host copies (three; an MoE layer
    over ``CAPACITY_STEP`` rows adds a capacity read per fused step,
    ``sync.*`` in the telemetry plane): streams truncate at
    EOS, reserved-but-unused blocks return to the pool, admission and
    preemption re-run.  ``megastep=1`` is the per-iteration engine,
    bit-identical streams by construction; N >= 2 preserves them
    because each scan step runs the very same per-row computation.

    ``paged=True`` (default) stores KV in ONE physical block pool per
    layer — ``BlockKVCache`` slab ids index the pool rows, and the
    engine ships a ``(max_batch, blocks_per_seq)`` block table with
    every dispatch, so block reuse reaches the memory the kernels read
    (not just the byte accounting).  ``prefix_sharing=True`` maps
    identical prompt prefixes of concurrently live requests onto the
    same physical blocks (content-hashed full blocks, refcounted,
    immutable): the shared tokens are neither re-prefilled nor
    re-allocated.  ``paged=False`` keeps dense per-slot caches
    (``api.init_caches``, ``max_context`` slots a row, reduced in tiles
    of ``block_size``) — the bit-identical baseline the paged path is
    validated against; it has no host tier and no prefix sharing.

    **Robustness** (see ``runtime/faults.py``): every dispatch carries
    an in-dispatch NaN watchdog; a poisoned result degrades down a
    ladder — megastep discarded (see :meth:`_discard_dispatch` for why
    the in-place pools need no checkpoint and what the free checkpoint
    of per-row SSM state is), N=1 sync retries with
    bounded exponential backoff
    (``dispatch_retries`` / ``retry_backoff_s``), then only the affected
    rows fail with ``reason="poisoned_logits"``.  The block-pool budget
    can shrink/restore mid-run (``faults``); the engine preempts and
    refuses growth instead of tripping pool asserts, and stalls rather
    than raising while a scheduled restore can regain feasibility —
    each stalled iteration is counted (``engine.stalls``) and traced
    with its cause and the pending restore's ETA.  **Host KV tier**
    (``host_pool`` / env ``PARALLAX_HOST_POOL``, paged attention-only
    models): preempted and admission-evicted blocks spill to a host
    byte pool instead of being discarded, and re-admission restores
    them bit-identically — zero re-prefill under memory pressure while
    the tier has capacity, with permanent infeasibility raised only
    when BOTH tiers are exhausted.
    Requests can be cancelled (:meth:`cancel`) or carry deadlines
    (``Request.deadline_s``); admission is bounded (``max_queue``) with
    machine-readable rejections.  All of it is free on the happy path:
    the watchdog rides existing dispatches and syncs, and the fault /
    deadline hooks are single attribute checks when disarmed.
    """

    def __init__(self, api, params, config: "EngineConfig | None" = None,
                 stepper: "Stepper | None" = None, faults=None,
                 telemetry: "Telemetry | None" = None, device=None):
        _engine_device(api, device)
        config = (config if config is not None
                  else EngineConfig()).on_device(api.device)
        if config.max_context is None:
            raise ValueError("ContinuousEngine needs an integer "
                             "max_context (the paged pool shape depends "
                             "on it); max_context=None is the round "
                             "engine's dynamic bucketing")
        self.config = config
        paged = config.paged
        prefix_sharing = config.prefix_sharing
        max_batch = config.max_batch
        max_context = config.max_context
        block_size = config.block_size
        if api.cfg.is_encoder_decoder:
            raise ValueError("ContinuousEngine serves decoder-only "
                             "models (encoder-decoder needs an encoder "
                             "pass the slot table does not schedule)")
        self.api = api
        self.cfg = api.cfg
        self.params = params
        # telemetry plane (runtime/telemetry.py): every counter below
        # lives in the registry — the old attribute names survive as
        # read-only property façades — and the span recorder is a no-op
        # unless the caller armed tracing.  Recording never feeds back
        # into scheduling, so streams and dispatch counts stay
        # bit-identical with tracing on vs off (the identity child's
        # --tele sweep asserts it).
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._rec = self.telemetry.rec
        m = self.telemetry.metrics
        # host KV tier: only the paged path can spill (the dense cache
        # has no physical block rows to capture), and BlockKVCache
        # additionally gates on pure-attention archs (host_enabled)
        self.host_pool_bytes = config.host_pool if paged else 0
        self.kv = BlockKVCache(self.cfg,
                               int(config.hbm_budget
                                   * (1.0 - config.margin)),
                               block_size, metrics=m,
                               host_budget_bytes=self.host_pool_bytes,
                               prefix_cache=(bool(config.prefix_cache)
                                             and paged and prefix_sharing))
        self.max_batch = max_batch
        self.prefill_chunk = config.prefill_chunk
        self.max_context = max_context
        if stepper is not None and stepper.api is not api:
            raise ValueError("shared stepper built for a different model")
        self.stepper = stepper if stepper is not None else Stepper(api)
        self._m_dispatches = m.counter("engine.dispatches")
        self.paged = paged
        # sharing skips recompute of the shared tokens, which is only
        # sound when the WHOLE per-token state lives in the shared KV
        # blocks — any SSM/conv layer carries per-row state the skipped
        # tokens would never reach, so hybrid archs keep sharing off
        self.prefix_sharing = (paged and prefix_sharing
                               and self.kv.block_bytes > 0
                               and self.kv.state_bytes == 0)
        # the persistent prefix cache extends the same walk across
        # request LIFETIMES (finished requests' published blocks are
        # retained, LRU-evicted under pressure) and is gated on the
        # exact same soundness conditions — the kv resolved them
        self.prefix_cache = self.kv.prefix_cache
        # spill/restore moves whole written-token state through the
        # host tier, sound under the same conditions as sharing: the
        # entire per-token state must live in the KV blocks
        self.spill_enabled = paged and self.kv.host_enabled
        if paged:
            # physical pool rows: every table entry holding a distinct
            # block bounds the ids BlockKVCache can ever issue, so the
            # pool shape depends only on (max_batch, max_context,
            # block_size) — engines differing just in budget share one
            # pool shape
            self.blocks_per_seq = max(1, self.kv.blocks_for(max_context))
            cap = max_batch * self.blocks_per_seq
            self.num_blocks = cap
            self.scratch_block = cap        # pool row cap = scratch
            self.tables = np.full((max_batch, self.blocks_per_seq),
                                  self.scratch_block, np.int32)
            self.caches = api.init_paged_caches(
                max_batch, self.num_blocks, block_size, api.dtype)
            # cache-tier retention may exhaust the pool's free list; cap
            # the slab ids the kv can mint so it recycles cached rows
            # instead of indexing past the paged pools' physical rows
            self.kv.row_cap = self.num_blocks
            if self.prefix_cache:
                self.kv.rec = self._rec
                if self.kv.host_enabled:
                    # evicted cached rows take a second chance host-side
                    self.kv.capture_hook = self._capture_blocks
                    self.kv.scatter_hook = self._scatter_blocks
        else:
            self.tables = None
            self.caches = api.init_caches(max_batch, max_context, api.dtype,
                                          tile=block_size)

        self.slots: "list[_Seq | None]" = [None] * max_batch
        self.slot_len = np.zeros(max_batch, np.int32)
        self.slot_phase = np.full(max_batch, FREE, np.int32)
        self.slot_off = np.zeros(max_batch, np.int32)
        self.slot_seq = np.zeros(max_batch, np.int64)
        self.slot_last = np.zeros(max_batch, np.int32)
        self._slot_prompt: "list[np.ndarray | None]" = [None] * max_batch

        self.waiting: "deque[_Seq]" = deque()
        self.completed: dict[int, Completion] = {}
        self._drainable: "deque[Completion]" = deque()
        # scheduling iterations = step() calls.  Under a megastep one
        # step() fuses up to N decode iterations into one dispatch, so
        # engine.iterations advances by 1 while engine.fused_iterations
        # advances by the scan's executed length — fault schedules and
        # anything else keyed by ``iterations`` target step() calls,
        # NOT tokens (see runtime/faults.py and tests/test_chaos.py).
        self._m_iterations = m.counter("engine.iterations")
        self._m_fused_iterations = m.counter("engine.fused_iterations")
        self._m_preemptions = m.counter("engine.preemptions")
        self._admit_counter = 0
        self._t0: "float | None" = None
        # fault plane + degradation bookkeeping (runtime/faults.py).
        # Every counter below stays 0 on a fault-free run — the serving
        # benchmark asserts it and gate.py regresses on it (the
        # watchdog and deadline hooks must cost nothing when healthy).
        self.faults = faults
        self.max_queue = config.max_queue
        self.dispatch_retries = config.dispatch_retries
        self.retry_backoff_s = config.retry_backoff_s
        self._m_watchdog_trips = m.counter("engine.watchdog_trips")
        self._m_megastep_fallbacks = m.counter("engine.megastep_fallbacks")
        self._m_retry_dispatches = m.counter("engine.retry_dispatches")
        self._m_rows_failed = m.counter("engine.rows_failed")
        self._m_rejected = m.counter("engine.rejected")
        self._m_cancellations = m.counter("engine.cancellations")
        self._m_budget_events = m.counter("engine.budget_events")
        # host-tier + stall visibility: spills/restores count slot
        # movements (kv.* counters carry blocks/bytes); reprefill_tokens
        # counts tokens replayed after demote-DISCARD re-admissions (0
        # when every preemption spilled); prefill_tokens_saved counts
        # tokens a restore brought back without recompute; stalls counts
        # iterations deliberately idled through a shrunk budget while a
        # scheduled restore pends (PR 6 stall path, now visible)
        self._m_spills = m.counter("engine.spills")
        self._m_restores = m.counter("engine.restores")
        self._m_reprefill_tokens = m.counter("engine.reprefill_tokens")
        self._m_saved_tokens = m.counter("engine.prefill_tokens_saved")
        self._m_saved_cache = m.counter(
            "engine.prefill_tokens_saved_cache")
        self._m_stalls = m.counter("engine.stalls")
        self._m_submitted = m.counter("engine.requests_submitted")
        self._m_resolved = m.counter("engine.requests_resolved")
        self._h_prompt = m.histogram("engine.prompt_len")
        self._h_generated = m.histogram("engine.generated_tokens")
        self._h_megastep_len = m.histogram("engine.megastep_len")
        self._g_queue = m.gauge("engine.queue_depth")
        self._deadlines_armed = False
        # decode megastep: N fused iterations per dispatch (1 = the
        # per-iteration path; env PARALLAX_MEGASTEP via EngineConfig)
        self.megastep_n = config.megastep
        self._m_megasteps = m.counter("engine.megasteps")
        self._m_megastep_steps = m.counter("engine.megastep_steps")
        # slot-reset dispatches only exist to clear per-row state that
        # attention masking cannot neutralize (SSM state, conv windows).
        # Attention-only models read nothing but positions t <= cache_len
        # — all freshly written by the new tenant — so the reset dispatch
        # is skipped entirely (one dispatch saved per admission wave).
        self._needs_reset = self.kv.state_bytes > 0

    def submit(self, req: Request) -> bool:
        """Queue a request.  Malformed submissions raise; a full queue
        (``max_queue``) REJECTS instead: False is returned and the id
        resolves immediately as ``Completion(status="rejected",
        reason="queue_full")`` — bounded admission with a machine-
        readable result, never an unbounded queue or a silent drop."""
        _validate_request(req, self.max_context)
        live = {s.req.id for s in self.slots if s is not None}
        if any(s.req.id == req.id for s in self.waiting) \
                or req.id in live or req.id in self.completed:
            # admission/bookkeeping key on request id — a duplicate
            # would admit twice against one charged cost
            raise ValueError(f"duplicate request id {req.id}")
        self._m_submitted.inc()
        self._h_prompt.observe(len(req.prompt))
        self._rec.point("submit", request_id=req.id,
                        prompt_len=len(req.prompt),
                        max_new=req.max_new_tokens)
        if self.max_queue is not None \
                and len(self.waiting) >= self.max_queue:
            self._m_rejected.inc()
            self._m_resolved.inc()
            self._rec.point("complete", request_id=req.id,
                            status="rejected", reason="queue_full")
            comp = Completion(req.id, status="rejected",
                              reason="queue_full")
            self.completed[req.id] = comp
            self._drainable.append(comp)
            return False
        if req.deadline_s is not None:
            self._deadlines_armed = True
        self.waiting.append(_Seq(req, submit_t=time.perf_counter()))
        self._g_queue.set(len(self.waiting))
        return True

    def cancel(self, req_id: int, reason: str = "cancelled") -> bool:
        """Cancel a request wherever it lives — waiting (including
        demoted), mid-prefill or mid-decode — reclaiming its cache
        blocks immediately.  The partial stream generated so far is
        returned as ``Completion(status="cancelled")``; it is a strict
        prefix of the stream a fault-free run would produce.  Returns
        False when the id is unknown or already resolved."""
        for seq in self.waiting:
            if seq.req.id == req_id:
                self.waiting.remove(seq)
                self._g_queue.set(len(self.waiting))
                self._m_cancellations.inc()
                if self.spill_enabled:       # reclaim host-tier bytes
                    self.kv.drop_spill(req_id)
                self._resolve(seq, "cancelled", reason)
                return True
        for s in range(self.max_batch):
            seq = self.slots[s]
            if seq is not None and seq.req.id == req_id:
                self._m_cancellations.inc()
                self._release_slot(s)
                self._resolve(seq, "cancelled", reason)
                return True
        return False

    def _expire_deadlines(self) -> None:
        """Cancel every request whose ``deadline_s`` has passed (wall
        time since submit).  Only called when a deadline exists
        (``_deadlines_armed``), so the happy path pays one bool check."""
        now = time.perf_counter()
        for seq in [s for s in self.waiting
                    if s.req.deadline_s is not None]:
            if now - seq.submit_t >= seq.req.deadline_s:
                self.cancel(seq.req.id, reason="deadline")
        for s in range(self.max_batch):
            seq = self.slots[s]
            if seq is not None and seq.req.deadline_s is not None \
                    and now - seq.submit_t >= seq.req.deadline_s:
                self.cancel(seq.req.id, reason="deadline")

    # -- metric façade ------------------------------------------------------
    # The counters moved into the telemetry registry; these read-only
    # properties keep every pre-telemetry attribute name working.

    @property
    def dispatch_count(self) -> int:
        return self._m_dispatches.value

    @property
    def dispatches(self) -> int:
        return self._m_dispatches.value

    @property
    def iterations(self) -> int:
        """Scheduling iterations (= step() calls).  NOT decode
        iterations: a megastep fuses up to N of those into one step() —
        see :attr:`fused_iterations`."""
        return self._m_iterations.value

    @property
    def fused_iterations(self) -> int:
        """Decode iterations actually executed, counting every step
        fused inside a megastep scan: advances by the scan's executed
        length per megastep and by 1 per sync-path decode dispatch.
        ``>= iterations``-ish in decode-heavy runs; anything keyed to
        token-granular timing (e.g. fault schedules) must target
        :attr:`iterations` at megastep=1 or reason in fused steps."""
        return self._m_fused_iterations.value

    @property
    def preemptions(self) -> int:
        return self._m_preemptions.value

    @property
    def watchdog_trips(self) -> int:
        return self._m_watchdog_trips.value

    @property
    def megastep_fallbacks(self) -> int:
        return self._m_megastep_fallbacks.value

    @property
    def retry_dispatches(self) -> int:
        return self._m_retry_dispatches.value

    @property
    def rows_failed(self) -> int:
        return self._m_rows_failed.value

    @property
    def rejected(self) -> int:
        return self._m_rejected.value

    @property
    def cancellations(self) -> int:
        return self._m_cancellations.value

    @property
    def budget_events(self) -> int:
        return self._m_budget_events.value

    @property
    def spills(self) -> int:
        return self._m_spills.value

    @property
    def restores(self) -> int:
        return self._m_restores.value

    @property
    def reprefill_tokens(self) -> int:
        """Tokens replayed through prefill after demote-discard
        re-admissions — 0 whenever the host tier absorbed every
        preemption (the chaos suite asserts it)."""
        return self._m_reprefill_tokens.value

    @property
    def prefill_tokens_saved(self) -> int:
        """Tokens restored from the host tier instead of re-prefilled."""
        return self._m_saved_tokens.value

    @property
    def prefill_tokens_saved_cache(self) -> int:
        """Tokens whose prefill the persistent prefix cache skipped —
        admissions that revived cached blocks with NO live holder (live
        sharing saves tokens too, but never these: they'd have
        re-prefilled under sharing alone)."""
        return self._m_saved_cache.value

    @property
    def stalls(self) -> int:
        """Iterations deliberately idled through an infeasible (shrunk)
        budget while a scheduled restore pends."""
        return self._m_stalls.value

    @property
    def megasteps(self) -> int:
        return self._m_megasteps.value

    @property
    def megastep_steps(self) -> int:
        return self._m_megastep_steps.value

    @property
    def num_active(self) -> int:
        return int((self.slot_phase != FREE).sum())

    @property
    def degraded_activations(self) -> int:
        """Total degraded-mode events — 0 on any fault-free run (the
        benchmark asserts it; gate.py regresses on it)."""
        return (self.watchdog_trips + self.megastep_fallbacks
                + self.retry_dispatches + self.rows_failed)

    def stats(self) -> dict:
        """Deterministic JSON-ready snapshot: every registry metric
        (engine.* and kv.* — see :meth:`MetricsRegistry.snapshot`), the
        derived degraded_activations, and the stepper's counters.  Values
        depend only on the workload, never on wall time."""
        snap = self.telemetry.metrics.snapshot()
        snap["derived"] = {
            "degraded_activations": self.degraded_activations,
            "megastep_n": self.megastep_n,
            "paged": self.paged,
            "spill_enabled": self.spill_enabled,
            "host_pool_bytes": self.kv.host_budget,
            "prefix_cache": self.prefix_cache,
        }
        snap["stepper"] = self.stepper.trace_stats()
        return snap

    # -- iteration phases ---------------------------------------------------

    def _admit(self) -> int:
        """§3.3 greedy selection against *actual* block-pool headroom —
        re-run every iteration, charging each candidate only its next
        allocation (prompt blocks + state), not a lifetime bound.

        Preempted (demoted) requests re-admit FIRST, in queue order,
        whenever their pending cache fits: cost-sorted greedy_select
        alone would starve them behind any sustained stream of cheaper
        fresh requests, forcing unbounded re-prefills."""
        free = [s for s in range(self.max_batch)
                if self.slot_phase[s] == FREE]
        if not free or not self.waiting:
            return 0
        fresh = np.zeros(self.max_batch, bool)
        for seq in [s for s in self.waiting if s.preempted]:
            if not free:
                break
            need = self._resume_need(seq)
            if need > self.kv.budget:
                if self._budget_may_recover(need):
                    break    # shrunk pool; a scheduled restore covers it
                # grown past what the whole DEVICE pool can ever hold:
                # waiting would block fresh admission forever — fail it
                # now (a spilled request's need is already discounted to
                # its restore transfer, so this is genuine infeasibility
                # of both tiers, not a full host tier)
                raise MemoryError(
                    f"request {seq.req.id}: resumed cache needs {need} "
                    f"bytes, more than the whole block-pool budget "
                    f"{self.kv.budget}")
            if need > self.kv.headroom:
                # cold cache yields before a demoted request waits: the
                # same evictions (and the same spill-key pins) restore
                # itself would apply, so the re-check below is exact
                self.kv.reclaim_cached(need, protect_spill=seq.req.id)
            if need > self.kv.headroom:
                break
            self.waiting.remove(seq)
            self._place(free.pop(0), seq, fresh)
        # while any demoted request still waits, fresh work must not
        # leapfrog it and consume the headroom it is waiting for
        blocked = any(s.preempted for s in self.waiting)
        if free and self.waiting and not blocked:
            by_id = {seq.req.id: seq for seq in self.waiting}
            costs = {rid: self.kv.bytes_for(seq.pending_len())
                     for rid, seq in by_id.items()}
            # cold blocks the host tier could absorb count as headroom
            # (admission no longer defers everything when the device
            # pool is full but the host tier has room); anything chosen
            # against that credit is placed only after _spill_for
            # actually reclaims the bytes
            chosen, _ = incremental_select(
                costs, list(by_id), self.kv.budget, self.kv.in_use,
                max_parallel=len(free),
                reclaimable=self._reclaimable_bytes())
            chosen_set = set(chosen)
            placed = set()
            for seq in [s for s in self.waiting
                        if s.req.id in chosen_set]:
                if not free:
                    break
                need = costs[seq.req.id]
                if need > self.kv.headroom \
                        and not self._spill_for(need):
                    break     # reclamation fell short: defer the rest
                self._place(free.pop(0), seq, fresh)
                placed.add(seq.req.id)
            self.waiting = deque(s for s in self.waiting
                                 if s.req.id not in placed)
        if not fresh.any():
            return 0
        self._g_queue.set(len(self.waiting))
        if self._needs_reset:
            self._m_dispatches.inc()
            self.caches = self.stepper.reset_rows(self.caches, fresh)
        return int(fresh.sum())

    def _place(self, slot: int, seq: "_Seq", fresh: "np.ndarray") -> None:
        prompt = seq.pending_prompt()
        restored = self.spill_enabled and self.kv.has_spill(seq.req.id)
        if restored:
            # spilled request: restore its blocks instead of
            # re-prefilling — matched is the full written watermark
            matched = self._restore_slot(slot, seq)
            if matched < len(prompt):
                # spilled mid-prefill: pre-allocate the rest of the
                # prompt's blocks exactly like admit (the prefill paths
                # expect the table to cover the whole prompt); the
                # bytes were charged by _resume_need, so this holds
                grew = self.kv.grow(slot, len(prompt))
                assert grew, "restore admission underestimated need"
        else:
            cache_before = self.kv.prefix_cache_hit_blocks
            matched = self.kv.admit(
                slot, len(prompt),
                tokens=prompt if self.prefix_sharing else None)
            if self.prefix_cache:
                # revived blocks had NO live holder — without the
                # cache every one of their tokens would re-prefill
                self._m_saved_cache.inc(
                    (self.kv.prefix_cache_hit_blocks - cache_before)
                    * self.kv.block_size)
        if seq.preempted:
            # tokens REPLAYED through prefill: written before the
            # demotion but recomputed now (prompt tokens past the
            # watermark are first-time work, not replay).  A spill
            # round-trip restores exactly the watermark, so it counts 0.
            self._m_reprefill_tokens.inc(
                max(0, seq.written_at_preempt - matched))
        self.slots[slot] = seq
        self._slot_prompt[slot] = prompt
        if seq.admit_t is None:           # re-admissions keep the first
            seq.admit_t = time.perf_counter()
        self.slot_phase[slot] = PREFILL
        # a shared prefix is already IN the cache (written by the
        # request that published it, bit-identically — same tokens, same
        # positions, same executable): prefill resumes after it
        self.slot_len[slot] = matched
        self.slot_off[slot] = matched
        self.slot_seq[slot] = self._admit_counter
        self._admit_counter += 1
        self._refresh_table(slot)
        fresh[slot] = True
        self._rec.point("admit", request_id=seq.req.id, slot=slot,
                        iteration=self.iterations, matched=matched,
                        resumed=seq.preempted, restored=restored)
        if matched >= len(prompt):
            # a fully restored decode row: every pending token is back
            # in the cache and the next input is the already-sampled
            # seq.gen[-1] — flip straight to DECODE before any dispatch
            # (only restores reach here: admit's sharing cap keeps
            # matched strictly below the prompt length)
            self._complete_prefill(slot, None)

    def _refresh_table(self, slot: int) -> None:
        """Mirror the slot's BlockKVCache table into the np block table
        shipped with every dispatch (unallocated entries -> scratch)."""
        if not self.paged:
            return
        row = self.tables[slot]
        row[:] = self.scratch_block
        ids = self.kv.table_ids(slot)
        row[:len(ids)] = ids

    def _prefill(self) -> None:
        """Chunked prefill — dispatched only when the pending prompt
        tokens amortize a chunk's fixed scan cost (a chunk always runs
        ``prefill_chunk`` masked steps); short prompt tails instead ride
        the per-iteration decode dispatch for free (_decode)."""
        pre = [s for s in range(self.max_batch)
               if self.slot_phase[s] == PREFILL]
        if not pre:
            return
        remaining = sum(len(self._slot_prompt[s]) - int(self.slot_off[s])
                        for s in pre)
        if remaining < self.prefill_chunk:
            return
        C = self.prefill_chunk
        toks = np.zeros((self.max_batch, C), np.int32)
        n_valid = np.zeros(self.max_batch, np.int32)
        for s in pre:
            prompt = self._slot_prompt[s]
            take = min(C, len(prompt) - int(self.slot_off[s]))
            toks[s, :take] = prompt[self.slot_off[s]:
                                    self.slot_off[s] + take]
            n_valid[s] = take
            self.kv.check_write(s, int(self.slot_len[s]),
                                int(self.slot_len[s]) + take)
        self._m_dispatches.inc()
        t_d = self._rec.now()
        self.caches, _, first, bad_dev = self.stepper.prefill_chunk(
            self.params, self.caches, toks, self.slot_len, n_valid,
            block_tables=self.tables)
        self.slot_len += n_valid
        self.slot_off += n_valid
        first_host: "list[np.ndarray]" = []   # read lazily: syncs
        bad_host: "list[np.ndarray]" = []
        for s in pre:
            if self.prefix_sharing:
                # newly completed full prompt blocks become shareable
                # (the write dispatch is already issued, and same-device
                # dispatches execute in issue order)
                self.kv.publish(s, self._slot_prompt[s],
                                int(self.slot_len[s]))
            if self.slot_off[s] < len(self._slot_prompt[s]):
                continue                      # more prompt next iteration
            if not first_host:
                first_host.append(_host(first))
                bad_host.append(_host(bad_dev))
            if bad_host[0][s]:
                # the chunk watchdog is checked at the same lazy sync
                # that reads the first token — a NaN argmax must never
                # enter a stream.  Mid-prompt corruption needs no extra
                # sync: a NaN hidden state propagates through the cache
                # and the decode watchdog backstops it within one
                # iteration.
                self._m_watchdog_trips.inc()
                self._rec.point("fault", iteration=self.iterations,
                                what="watchdog", where="prefill_chunk",
                                slot=s)
                self._fail(s, "poisoned_logits")
                continue
            self._complete_prefill(s, lambda s=s: int(first_host[0][s]))
        self._rec.span("prefill_chunk", t_d, iteration=self.iterations,
                       rows=len(pre), tokens=int(n_valid.sum()))

    def _complete_prefill(self, slot: int, get_first_tok) -> None:
        """Prompt fully consumed: flip the slot to DECODE.  Resumed
        requests already hold their next token; fresh ones take their
        first generated token from ``get_first_tok()`` (the argmax at
        the prompt's last position, whichever dispatch produced it)."""
        seq = self.slots[slot]
        self.slot_phase[slot] = DECODE
        if seq.gen:                           # resumed after preemption
            self.slot_last[slot] = seq.gen[-1]
            return
        if seq.req.max_new_tokens == 0:       # prefill-only request
            self._finish(slot)
            return
        tok = get_first_tok()
        seq.gen.append(tok)
        self.slot_last[slot] = tok
        now = time.perf_counter()
        seq.ttft_s = now - self._t0
        seq.ttft_admit_s = now - seq.admit_t
        seq.ttft_submit_s = now - seq.submit_t
        self._rec.point("first_token", request_id=seq.req.id,
                        iteration=self.iterations,
                        ttft_submit_s=round(seq.ttft_submit_s, 6))
        if len(seq.gen) >= seq.req.max_new_tokens \
                or tok == seq.req.eos_id:
            self._finish(slot)

    def _grow_or_preempt(self) -> None:
        """Lazy block growth, oldest request first; on exhaustion the
        youngest request is preempted — spilled to the host tier when
        one is armed and has room, demote-discarded otherwise."""
        order = sorted(
            (s for s in range(self.max_batch)
             if self.slot_phase[s] == DECODE),
            key=lambda s: self.slot_seq[s])
        for s in order:
            if self.slot_phase[s] != DECODE:
                continue                      # preempted as a victim
            while not self.kv.grow(s, int(self.slot_len[s]) + 1):
                active = [v for v in range(self.max_batch)
                          if self.slot_phase[v] != FREE]
                victim = max(active, key=lambda v: self.slot_seq[v])
                if victim == s and len(active) == 1:
                    if self._budget_may_recover(
                            self.kv.bytes_for(int(self.slot_len[s]) + 1)):
                        # shrunk below a single row: demote it and stall
                        # until the scheduled budget restore re-admits
                        self._preempt(s)
                        break
                    raise MemoryError(
                        f"block pool budget {self.kv.budget} cannot hold "
                        f"a single growing request (slot {s}, "
                        f"{self.slot_len[s] + 1} tokens)")
                self._preempt(victim)
                if victim == s:               # the grower IS the youngest
                    break                     # — demote it, not an elder
            if self.slot_phase[s] == DECODE:  # grew (not demoted)
                self._refresh_table(s)

    def _preempt(self, slot: int) -> None:
        seq = self.slots[slot]
        seq.written_at_preempt = int(self.slot_len[slot])
        spilled = self.spill_enabled and self._spill_slot(slot, seq)
        self._rec.point("preempt", request_id=seq.req.id, slot=slot,
                        iteration=self.iterations,
                        tokens=len(seq.gen), spilled=spilled)
        if not spilled:
            # host tier disabled or out of room: demote-discard exactly
            # as before the tier existed (re-admission re-prefills)
            self._release_slot(slot)
        seq.preempted = True                  # priority re-admission
        self.waiting.appendleft(seq)
        self._g_queue.set(len(self.waiting))
        self._m_preemptions.inc()

    # -- host KV tier: spill / restore --------------------------------------

    def _resume_need(self, seq: "_Seq") -> int:
        """Device bytes re-admitting ``seq`` costs right now: a spilled
        request pays its restore transfer target (blocks a live slot
        still registers are shared back for free) plus — when it was
        spilled MID-prefill — the blocks for the rest of its pending
        prompt, which placement pre-allocates exactly like admit; a
        demote-discarded request pays its full pending blocks again."""
        if self.spill_enabled and self.kv.has_spill(seq.req.id):
            need = self.kv.restore_bytes(seq.req.id)
            spilled = self.kv.spilled_tokens(seq.req.id)
            pend = seq.pending_len()
            if pend > spilled:
                need += (self.kv.blocks_for(pend)
                         - self.kv.blocks_for(spilled)) \
                    * self.kv.block_bytes
            return need
        return self.kv.bytes_for(seq.pending_len())

    def _spill_slot(self, slot: int, seq: "_Seq") -> bool:
        """Move the slot's written blocks to the host tier: plan, copy
        device->host, charge the host pool, then free the device blocks
        (capture strictly precedes the free, so a block is never spilled
        mid-write or after its row was handed to another tenant).  False
        when the host tier lacks room — the caller demote-discards."""
        plan = self.kv.spill_plan(slot, seq.req.id,
                                  int(self.slot_len[slot]))
        if plan is None:
            return False
        t_d = self._rec.now()
        data = self._capture_blocks(plan.capture_ids)
        nbytes = self.kv.commit_spill(plan, data)
        self._m_spills.inc()
        self._release_slot(slot)
        self._rec.span("spill", t_d, request_id=seq.req.id, slot=slot,
                       iteration=self.iterations,
                       blocks=len(plan.entries),
                       transferred=len(plan.capture_ids), bytes=nbytes)
        return True

    def _restore_slot(self, slot: int, seq: "_Seq") -> int:
        """Rebuild a spilled request's blocks on device — scheduled at
        placement, strictly before the row's next dispatch.  Returns the
        restored token watermark (the resume's ``matched``): zero tokens
        re-prefilled, and the restored bytes are bit-identical to what
        was captured, so the resumed stream matches the fault-free one
        exactly."""
        t_d = self._rec.now()
        n_tokens, scatter = self.kv.restore(slot, seq.req.id)
        if scatter:
            self._scatter_blocks(scatter)
        self._m_restores.inc()
        self._m_saved_tokens.inc(n_tokens)
        self._rec.span("restore", t_d, request_id=seq.req.id, slot=slot,
                       iteration=self.iterations,
                       blocks=len(self.kv.block_tables[slot]),
                       transferred=len(scatter),
                       bytes=len(scatter) * self.kv.block_bytes)
        return n_tokens

    def _capture_blocks(self, ids: "list[int]") -> dict:
        """Device -> host copy of physical pool rows ``ids``: one
        ``index_select`` per layer pool, each read and the ids' copy up a
        blocking copy (``sync.kv_spill``).  Returns ``{slab_id: [per-pool
        host tensors in layer order, k then v]}`` — the payload layout
        :meth:`_scatter_blocks` writes back (bit-exact: same dtype)."""
        out: "dict[int, list]" = {b: [] for b in ids}
        if not ids:
            return out
        idx = blocking("sync.kv_spill", torch.tensor, ids, dtype=torch.long,
                       device=self.api.device)
        for c in self.caches:
            for name in ("k_pool", "v_pool"):
                rows = to_host("sync.kv_spill",
                               c[name].index_select(0, idx))
                for j, b in enumerate(ids):
                    out[b].append(rows[j])
        return out

    def _scatter_blocks(self, scatter: "list[tuple]") -> None:
        """Host -> device: write restored payloads into their (new)
        physical pool rows with ``index_copy_``, traversing pools in
        :meth:`_capture_blocks` order.  The pools update in place; the
        ids and each pool's payload go up from pageable memory, a
        blocking copy each (``sync.kv_restore``)."""
        ids = blocking("sync.kv_restore", torch.tensor,
                       [b for b, _ in scatter], dtype=torch.long,
                       device=self.api.device)
        payloads = [p for _, p in scatter]
        li = 0
        for c in self.caches:
            for name in ("k_pool", "v_pool"):
                vals = torch.stack([p[li] for p in payloads])
                li += 1
                c[name].index_copy_(0, ids, blocking(
                    "sync.kv_restore", vals.to, c[name].device))

    def _reclaimable_bytes(self) -> int:
        """Device bytes fresh admission could reclaim on demand: the
        prefix cache's evictable blocks (cheapest — nothing live
        demotes) plus cold decode slots it could spill (youngest-first
        victims, same order as preemption) while the host pool can
        absorb the capture.  Conservative on the spill half: shared
        blocks may free less than counted, so placement re-verifies
        real headroom."""
        if not self.spill_enabled:
            return self.kv.evictable_bytes
        total = self.kv.evictable_bytes
        host_room = self.kv.host_headroom
        for s in range(self.max_batch):
            if self.slot_phase[s] != DECODE:
                continue
            need_host = self.kv.blocks_for(int(self.slot_len[s])) \
                * self.kv.block_bytes
            if need_host <= host_room:
                host_room -= need_host
                total += len(self.kv.block_tables[s]) \
                    * self.kv.block_bytes
        return total

    def _spill_for(self, need: int) -> bool:
        """Reclaim device headroom for ``need`` bytes: prefix-cache
        blocks are evicted first (cheapest — nothing live demotes),
        then youngest decode slots spill to the host tier; False when
        reclamation falls short (the admission that asked simply
        defers)."""
        while need > self.kv.headroom:
            if self.kv.evict_cached():
                continue
            if not self.spill_enabled:
                return False
            victims = [s for s in range(self.max_batch)
                       if self.slot_phase[s] == DECODE]
            if not victims:
                return False
            v = max(victims, key=lambda s: self.slot_seq[s])
            if self.kv.blocks_for(int(self.slot_len[v])) \
                    * self.kv.block_bytes > self.kv.host_headroom:
                return False      # host tier cannot absorb the victim
            self._preempt(v)
        return True

    def _decode(self, attempts_used: int = 0) -> None:
        """ONE dispatch advances every active slot by one token: decode
        rows feed their last sampled token; rows still holding prompt
        tokens (short tails the chunk path skipped) feed the next prompt
        token instead — iteration-level batching à la Orca, so trailing
        prefill costs zero extra dispatches.  A row consuming its final
        prompt token gets its first generated token from this very
        dispatch's argmax.

        This is also the bottom of the degradation ladder: when the
        in-dispatch watchdog flags a row, the dispatch is discarded
        (:meth:`_discard_dispatch`) and retried up to ``dispatch_retries``
        times with exponential backoff; exhausting the ladder commits
        the clean rows from the final dispatch (rows are computationally
        independent) and fails only the affected rows.
        ``attempts_used`` counts dispatch attempts this iteration
        already burned (1 after a discarded megastep)."""
        decoding = self.slot_phase == DECODE
        prefilling = self.slot_phase == PREFILL
        active = decoding | prefilling
        if not active.any():
            return
        self._m_fused_iterations.inc()        # sync path: 1 iter = 1 tok
        toks = self.slot_last.copy()
        for s in np.flatnonzero(prefilling):
            toks[s] = self._slot_prompt[s][self.slot_off[s]]
        for s in np.flatnonzero(active):
            self.kv.check_write(int(s), int(self.slot_len[s]),
                                int(self.slot_len[s]) + 1)
        t_d = self._rec.now()
        attempt = attempts_used
        while True:
            snapshot = self.caches
            self._m_dispatches.inc()
            if attempt > attempts_used:
                self._m_retry_dispatches.inc()
            nxt, bad_dev, self.caches = self.stepper.decode(
                self.params, self.caches, toks, self.slot_len, active,
                block_tables=self.tables, poison=self._poison(attempt))
            nxt_host = _host(nxt)             # 2 engine copies a step
            bad = _host(bad_dev)
            if not bad.any():
                break
            self._m_watchdog_trips.inc()
            self._rec.point("fault", iteration=self.iterations,
                            what="watchdog", where="decode",
                            attempt=attempt - attempts_used)
            if attempt - attempts_used >= self.dispatch_retries:
                break        # ladder exhausted: fail the bad rows below
            self._discard_dispatch(snapshot)  # the retry starts afresh
            time.sleep(self.retry_backoff_s
                       * (1 << (attempt - attempts_used)))
            attempt += 1
        self._rec.span("decode", t_d, iteration=self.iterations,
                       rows=int(active.sum()),
                       attempts=attempt - attempts_used + 1)
        self.slot_len += active
        for s in np.flatnonzero(bad):
            self._fail(int(s), "poisoned_logits")
        for s in np.flatnonzero(prefilling & ~bad):
            self.slot_off[s] += 1
            if self.prefix_sharing:
                self.kv.publish(int(s), self._slot_prompt[s],
                                int(self.slot_len[s]))
            if self.slot_off[s] < len(self._slot_prompt[s]):
                continue
            self._complete_prefill(int(s), lambda s=s: int(nxt_host[s]))
        for s in np.flatnonzero(decoding & ~bad):
            seq = self.slots[s]
            tok = int(nxt_host[s])
            seq.gen.append(tok)
            self.slot_last[s] = tok
            if len(seq.gen) >= seq.req.max_new_tokens \
                    or tok == seq.req.eos_id:
                self._finish(int(s))

    def _discard_dispatch(self, snapshot: list) -> None:
        """Forget a dispatch whose results the engine throws away.

        ``snapshot`` is ``self.caches`` from before the dispatch; it is put
        back, as the JAX engine restores its pre-dispatch cache pytree.
        For Mamba layers that is an exact, free checkpoint: a decode step
        builds new state and conv tensors (``torch.where(active, new,
        old)``) and never writes the old ones, so the old list still holds
        them — no copy of the per-row state (51 MB a row at mamba2-370m's
        widths, by ``kv_cache.state_bytes``).  The KV
        pools were written in place and need no checkpoint: a dispatch
        writes only positions ``>= slot_len[b]`` of its rows' own reserved
        blocks (``check_write`` refuses shared and registered blocks) or
        the scratch row — or, on the dense cache, of its rows' own slots.
        Every such position lies past the row's committed length, so it
        stays masked (``t <= cache_len``) until the retry — or the
        block's next owner — writes it again before anything reads it."""
        self.caches = snapshot

    def _poison(self, attempt: int) -> "np.ndarray | None":
        """Fault-plane injection mask for this iteration's dispatch
        ``attempt`` (None on clean runs: the stepper injects nothing)."""
        if self.faults is None:
            return None
        return self.faults.poison_rows(self.iterations, attempt,
                                       self.max_batch)

    # -- decode megastep: reserve -> scan -> reconcile ----------------------

    def _row_plan(self, slot: int) -> "tuple[int, int]":
        """(steps_budget, n_forced) of an occupied slot.

        ``steps_budget`` is the number of decode iterations the row can
        execute before it terminates on its own (max-token; EOS can only
        shorten it in-scan), ``n_forced`` the tokens it must force-feed
        before its input comes from the sampled carry (remaining pending
        prompt, plus the already-sampled last token of a resumed
        request)."""
        seq = self.slots[slot]
        m_rem = seq.req.max_new_tokens - len(seq.gen)
        if self.slot_phase[slot] == PREFILL:
            prem = len(self._slot_prompt[slot]) - int(self.slot_off[slot])
            n_forced = prem + (1 if seq.gen else 0)
            budget = n_forced + m_rem - 1 if m_rem > 0 else n_forced
        else:
            n_forced = 0
            budget = m_rem
        return budget, n_forced

    def _plan_megastep(self) -> "tuple[int, dict]":
        """Choose the megastep length N and bulk-reserve every KV block
        the scan could write; returns ``(N, row plans)`` — the per-slot
        ``_row_plan`` tuples the launch must use, so reservation sizing
        and the scan's forced/budget arrays can never desynchronize —
        or ``(0, {})`` when the per-iteration path should run instead
        (N < 2, or the pool cannot back even a 2-step scan without
        preempting).

        Two caps keep the fusion honest:

        * **flush** — while requests wait, N is clipped to the smallest
          active row's remaining budget, so the megastep ends exactly
          when the first slot frees and admission runs: waiting
          requests never sit behind a full-length megastep (TTFT).
        * **re-admission headroom** — a demote-only-preempted request
          re-admits with priority the moment its pending cache fits;
          megastep reservations must not consume that headroom, so the
          head demoted request's need is fenced off before sizing N.
        """
        occupied = [s for s in range(self.max_batch)
                    if self.slot_phase[s] != FREE]
        if not occupied or self.megastep_n < 2:
            return 0, {}
        plans = {s: self._row_plan(s) for s in occupied}
        budgets = {s: plans[s][0] for s in occupied}
        n = min(self.megastep_n, max(budgets.values()))
        if self.waiting:
            n = min(n, min(budgets.values()))
        if n < 2:
            return 0, {}
        if self.kv.block_bytes:
            reserve = 0
            head = next((q for q in self.waiting if q.preempted), None)
            if head is not None:
                reserve = self._resume_need(head)

            def extra_bytes(n_try: int) -> int:
                need = 0
                for s in occupied:
                    cover = int(self.slot_len[s]) + min(n_try, budgets[s])
                    extra = self.kv.blocks_for(cover) \
                        - len(self.kv.block_tables[s])
                    need += max(extra, 0) * self.kv.block_bytes
                return need

            while n >= 2:
                need = extra_bytes(n)
                # evictable cached blocks count: grow() reclaims them
                # internally, so the reservation below cannot fall short
                if need == 0 or need <= self.kv.headroom \
                        + self.kv.evictable_bytes - reserve:
                    break
                n -= 1
            if n < 2:
                return 0, {}
            for s in occupied:
                cover = int(self.slot_len[s]) + min(n, budgets[s])
                grew = self.kv.grow(s, cover)
                assert grew, "megastep reservation exceeded headroom"
                self._refresh_table(s)
        return n, plans

    def _megastep(self, n: int, plans: dict) -> None:
        """ONE dispatch advances every occupied slot by up to ``n``
        iterations: a fused-loop twin of :meth:`_decode` carries
        (caches, sampled token, per-row cache_len, active mask, step
        budget) on device — greedy sampling, EOS and max-token
        termination all happen in-carry, so finished rows deactivate
        and stop writing mid-scan without a host sync.  Prefilling rows
        ride the scan by force-feeding their remaining prompt tokens
        (and a resumed request's already-sampled last token) from a
        host-built (B, n) column set.  After the result's host copies
        (``sync.engine_copy``; an MoE layer over ``CAPACITY_STEP`` rows
        also reads its capacity back in every fused step), reconciliation
        replays the bookkeeping: streams are extended
        (truncated past EOS), TTFTs stamped post-reconciliation,
        reserved-but-unused blocks returned to the pool, and finished
        slots freed so admission sees the true headroom."""
        B = self.max_batch
        active = self.slot_phase != FREE
        prefilling = self.slot_phase == PREFILL
        budget = np.zeros(B, np.int32)
        n_forced = np.zeros(B, np.int32)
        forced = np.zeros((B, n), np.int32)
        eos_ids = np.full(B, -1, np.int32)
        for s in np.flatnonzero(active):
            seq = self.slots[s]
            budget[s], n_forced[s] = plans[int(s)]
            if prefilling[s]:
                pending = self._slot_prompt[s]
                off = int(self.slot_off[s])
                take = min(n, len(pending) - off)
                forced[s, :take] = pending[off:off + take]
                if seq.gen and take < n:      # resumed: re-feed last tok
                    forced[s, take] = seq.gen[-1]
            if seq.req.eos_id is not None:
                eos_ids[s] = seq.req.eos_id
            self.kv.check_write(
                int(s), int(self.slot_len[s]),
                int(self.slot_len[s]) + min(n, int(budget[s])))
        self._m_dispatches.inc()
        self._m_megasteps.inc()
        self._h_megastep_len.observe(n)
        t_d = self._rec.now()
        snapshot = self.caches                # free O(1) checkpoint
        toks_dev, act_dev, bad_dev, self.caches = self.stepper.megastep(
            self.params, self.caches, self.slot_last, self.slot_len,
            active, budget, forced, n_forced, eos_ids,
            block_tables=self.tables, poison=self._poison(0))
        toks_out = _host(toks_dev)            # (n, B): 3 engine copies
        act_out = _host(act_dev)
        bad = _host(bad_dev)
        if bad.any():
            # watchdog tripped inside the fused scan: one poisoned step
            # contaminates every later step of that row, so the whole
            # dispatch is discarded (_discard_dispatch), the bulk
            # reservation returned, and the iteration degrades to the
            # N=1 sync path (which retries with backoff and can fail
            # rows individually).  No bookkeeping above this point
            # mutated engine state, so the fallback replays the
            # iteration exactly.
            self._discard_dispatch(snapshot)
            self._m_watchdog_trips.inc()
            self._m_megastep_fallbacks.inc()
            self._rec.point("fault", iteration=self.iterations,
                            what="watchdog", where="megastep", n=n)
            for s in np.flatnonzero(active):
                self._release_reservation(int(s))
            self._grow_or_preempt()
            self._decode(attempts_used=1)
            return
        now = time.perf_counter()             # post-reconciliation stamp
        steps = act_out.sum(axis=0).astype(np.int32)
        executed = int(steps.max())
        self._m_megastep_steps.inc(executed)
        self._m_fused_iterations.inc(executed)
        self._rec.span("megastep", t_d, iteration=self.iterations,
                       n=n, executed=executed, rows=int(active.sum()))
        t_r = self._rec.now()
        self.slot_len += steps
        for s in np.flatnonzero(active):
            s = int(s)
            seq = self.slots[s]
            st = int(steps[s])
            gen_start = 0
            if prefilling[s]:
                pending = self._slot_prompt[s]
                prem = len(pending) - int(self.slot_off[s])
                self.slot_off[s] += min(st, prem)
                if self.prefix_sharing:
                    self.kv.publish(s, pending, int(self.slot_len[s]))
                gen_start = int(n_forced[s]) - 1
            new_toks = [int(t) for t in toks_out[gen_start:st, s]] \
                if seq.req.max_new_tokens > 0 else []
            fresh_first = prefilling[s] and not seq.gen and new_toks
            seq.gen.extend(new_toks)
            if prefilling[s] \
                    and self.slot_off[s] >= len(self._slot_prompt[s]):
                self.slot_phase[s] = DECODE
                if seq.req.max_new_tokens == 0:
                    self._finish(s)           # prefill-only request
                    continue
            if fresh_first:
                seq.ttft_s = now - self._t0
                seq.ttft_admit_s = now - seq.admit_t
                seq.ttft_submit_s = now - seq.submit_t
                self._rec.point("first_token", request_id=seq.req.id,
                                iteration=self.iterations,
                                ttft_submit_s=round(seq.ttft_submit_s,
                                                    6))
            if seq.gen:
                self.slot_last[s] = seq.gen[-1]
            # termination applies only once the prompt is consumed — a
            # still-prefilling row (prompt longer than the megastep)
            # must keep its slot even when max_new_tokens == 0
            if self.slot_phase[s] == DECODE and \
                    (len(seq.gen) >= seq.req.max_new_tokens or
                     (new_toks and new_toks[-1] == seq.req.eos_id)):
                self._finish(s)
                continue
            # return reserved-but-unused blocks (EOS fired early, or the
            # row's budget emptied before N); a still-prefilling row
            # keeps its admitted prompt blocks
            keep = max(int(self.slot_len[s]),
                       len(self._slot_prompt[s])
                       if self.slot_phase[s] == PREFILL else 0)
            if self.kv.release_to(s, keep):
                self._refresh_table(s)
        self._rec.span("reconcile", t_r, iteration=self.iterations,
                       rows=int(active.sum()))

    def _release_reservation(self, slot: int) -> None:
        """Return an occupied slot's reserved-but-unwritten blocks —
        everything past its written watermark (plus a prefilling row's
        admitted prompt blocks) — undoing a megastep bulk reserve whose
        scan was discarded or never launched."""
        keep = max(int(self.slot_len[slot]),
                   len(self._slot_prompt[slot])
                   if self.slot_phase[slot] == PREFILL else 0)
        if self.kv.release_to(slot, keep):
            self._refresh_table(slot)

    def _release_slot(self, slot: int) -> None:
        """Free the slot's cache blocks and park it (shared by finish /
        fail / cancel — any way a request leaves its slot)."""
        self.kv.free(slot)
        self.slots[slot] = None
        self._slot_prompt[slot] = None
        self.slot_phase[slot] = FREE
        if self.paged:
            self.tables[slot, :] = self.scratch_block

    def _resolve(self, seq: "_Seq", status: str,
                 reason: "str | None" = None) -> None:
        comp = Completion(
            seq.req.id, tokens=list(seq.gen),
            ttft_s=seq.ttft_s if seq.ttft_s is not None else 0.0,
            ttft_admit_s=seq.ttft_admit_s
            if seq.ttft_admit_s is not None else 0.0,
            ttft_submit_s=seq.ttft_submit_s
            if seq.ttft_submit_s is not None else 0.0,
            status=status, reason=reason)
        self.completed[seq.req.id] = comp
        self._drainable.append(comp)
        self._m_resolved.inc()
        self._h_generated.observe(len(seq.gen))
        self._rec.point("complete", request_id=seq.req.id,
                        iteration=self.iterations,
                        status=status, reason=reason,
                        tokens=len(seq.gen))

    def _finish(self, slot: int) -> None:
        """Release the slot's cache blocks the iteration it finishes."""
        seq = self.slots[slot]
        self._release_slot(slot)
        self._resolve(seq, "completed")

    def _fail(self, slot: int, reason: str) -> None:
        """Fail ONE row (bottom of the degradation ladder), reclaiming
        its blocks; the partial stream rides the Completion."""
        seq = self.slots[slot]
        self._m_rows_failed.inc()
        self._release_slot(slot)
        self._resolve(seq, "failed", reason)

    # -- driver -------------------------------------------------------------

    def step(self) -> None:
        """One scheduling iteration: admit, prefill a chunk, then either
        ONE fused decode megastep (reserve -> scan -> reconcile,
        advancing every slot by up to ``megastep_n`` tokens) or the
        per-iteration path (grow/preempt, decode one token per slot).
        The megastep plan falls back to the per-iteration path whenever
        fusing is pointless (N < 2) or unsafe (the pool cannot back a
        2-step scan without preempting — preemption stays a
        per-iteration-path decision).  The engine's telemetry plane is
        installed around the iteration, so the model step records into
        it."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._m_iterations.inc()
        rec = self._rec
        if not rec.enabled:          # no-op fast path: zero clock reads
            with install(self.telemetry):
                self._step()
            return
        t_it = rec.now()
        try:
            with install(self.telemetry):   # the model records into it
                self._step()
        finally:
            extra = {}
            if self.kv.host_budget:
                extra = {"host_blocks": self.kv.host_blocks_live,
                         "host_bytes": self.kv.host_in_use}
            rec.span("iteration", t_it, iteration=self.iterations,
                     kv_blocks=self.kv.live_blocks,
                     kv_bytes=self.kv.in_use,
                     active=self.num_active,
                     waiting=len(self.waiting), **extra)

    def _step(self) -> None:
        if self.faults is not None:
            self._apply_faults(self.faults.events_at(self.iterations))
        if self._deadlines_armed:
            self._expire_deadlines()
        admitted = self._admit()
        if self.num_active == 0:
            if admitted == 0 and self.waiting:
                need = min(self._resume_need(s) for s in self.waiting)
                if self._budget_may_recover(need):
                    # stall: a scheduled budget restore pends.  PR 6
                    # left these iterations invisible — now each one
                    # counts and (under tracing) reports its cause and
                    # the restore's ETA, so a wedged-looking run can be
                    # told apart from a deliberately idling one.
                    self._m_stalls.inc()
                    if self._rec.enabled:
                        self._rec.point(
                            "stalled", iteration=self.iterations,
                            cause="budget_shrunk", need_bytes=need,
                            waiting=len(self.waiting),
                            restore_eta_iteration=self.faults
                            .next_budget_recovery(self.iterations, need))
                    return
                raise MemoryError(
                    f"no request fits: smallest pending need is "
                    f"{need} bytes, budget is {self.kv.budget}")
            if admitted == 0:
                return
        self._prefill()
        n, plans = self._plan_megastep()
        if n >= 2 and self.faults is not None:
            posted = self.faults.events_at(self.iterations,
                                           when="post_reserve")
            if posted:
                # a cancel landing right after the megastep bulk
                # reserve: return every slot's reservation, apply the
                # cancel, and take the sync path this iteration —
                # exercises mid-scan-reservation block reclamation
                for s in range(self.max_batch):
                    if self.slot_phase[s] != FREE:
                        self._release_reservation(s)
                self._apply_faults(posted)
                n = 0
        if n >= 2:
            self._megastep(n, plans)
        else:
            self._grow_or_preempt()
            self._decode()

    def _apply_faults(self, events) -> None:
        for e in events:
            self._rec.point("fault", iteration=self.iterations,
                            **e.span_args())
            if e.kind == "budget":
                self.kv.set_budget(e.budget_bytes)
                self._m_budget_events.inc()
            elif e.kind == "cancel":
                self.cancel(e.request_id, reason="injected_cancel")

    def _budget_may_recover(self, need: int) -> bool:
        """True while the fault plane schedules a future budget event
        of at least ``need`` bytes — the engine stalls on infeasibility
        instead of raising MemoryError, because the scheduled restore
        can make the pool feasible again.  Without a plane (or without
        such an event) infeasibility is permanent and raising stays
        correct."""
        if self.faults is None:
            return False
        fut = self.faults.max_future_budget(self.iterations)
        return fut is not None and fut >= need

    def has_work(self) -> bool:
        """True while any submitted request is still unresolved —
        waiting in the queue (including demoted/spilled) or live in a
        slot.  The open-loop driver's loop condition."""
        return bool(self.waiting) or self.num_active > 0

    def drain_completions(self) -> "list[Completion]":
        """Completions resolved since the last drain, in resolution
        order — the incremental twin of :meth:`run`'s end-of-world
        dict (which keeps accumulating regardless of draining).  Covers
        every terminal status, including submit-time rejections."""
        out = list(self._drainable)
        self._drainable.clear()
        return out

    def run(self, max_iters: int = 100_000) -> "dict[int, Completion]":
        """Thin wrapper over the step surface: step until quiescent or
        the iteration cap, then fail whatever is still live."""
        self._t0 = time.perf_counter()
        it = 0
        while (self.waiting or self.num_active) and it < max_iters:
            self.step()
            it += 1
        if self.waiting or self.num_active:
            # the iteration cap is a liveness backstop, not a silent
            # drop: every still-live request resolves as failed (blocks
            # reclaimed, partial streams returned) so callers can
            # account for every submitted id and the pool still drains
            # to quiescence
            for s in range(self.max_batch):
                if self.slots[s] is not None:
                    self._fail(s, "max_iters")
            while self.waiting:
                seq = self.waiting.popleft()
                if self.spill_enabled:
                    self.kv.drop_spill(seq.req.id)
                self._resolve(seq, "failed", "max_iters")
            self._g_queue.set(0)
        return self.completed

    def assert_quiescent(self) -> None:
        """Zero-leak audit once every request resolved: no occupied
        slots, all phases FREE, nothing waiting, every block-table row
        parked on the scratch block, and the block pool fully drained
        (:meth:`BlockKVCache.assert_quiescent`)."""
        live = [s for s in range(self.max_batch)
                if self.slots[s] is not None]
        assert not live, f"slots still occupied: {live}"
        assert not (self.slot_phase != FREE).any(), \
            f"non-FREE slot phases: {self.slot_phase.tolist()}"
        assert not self.waiting, \
            f"requests still waiting: {[s.req.id for s in self.waiting]}"
        if self.paged:
            assert (self.tables == self.scratch_block).all(), \
                "block-table rows not parked on the scratch block"
        self.kv.assert_quiescent()
