"""Batched step functions shared by both serving engines.

Port of ``repro.runtime.stepper``.  One :class:`Stepper` drives the
model's ``decode_fn`` over a whole slot table:

* ``decode`` — ONE decode iteration: every row advances from its own
  ``cache_len`` under an ``active`` mask, greedy sampling included, so
  requests join and leave between iterations;
* ``prefill_chunk`` — ``C`` decode steps that consume a fixed-width
  chunk of prompt tokens per row; per-row ``n_valid`` masks ragged tails
  and idle rows; the argmax at each row's last valid step is its first
  generated token;
* ``megastep`` — N fused decode iterations: greedy sampling, EOS checks
  and the max-token countdown stay on the device
  (:func:`~repro_torch.runtime.sampling.megastep_advance`), so finished
  rows stop writing mid-loop; rows still holding prompt tokens
  force-feed them from a host-built ``forced`` column.

The JAX package compiles each into one ``jit``/``lax.scan`` dispatch;
here each is a Python loop whose carry stays on the device.  Nothing in
a loop reads a value back to the host: the engine's one sync per
dispatch is where it copies the result out.  Every step function also
returns the NaN watchdog flag per row, and ``poison`` (B,) bool — the
fault plane's injection mask — is an argument of the same function.
``dispatches`` counts calls exactly as the JAX package counts jitted
calls.

Each step function has a *dense* flavour (``block_tables=None``: the
per-row caches of ``api.init_caches``) and a *paged* one (a ``(B,
blocks_per_seq)`` block table routing every layer's pool of
``api.init_paged_caches``); ``megastep_sizes`` records ``(paged, N)``
per megastep length run.  ``reset_rows`` clears the per-row state of
newly admitted rows (SSM state and conv windows, which attention masking
cannot neutralise) as one counted dispatch; the engines call it only for
models that carry such state.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampling import (greedy_serving, logits_watchdog, megastep_advance,
                       poison_logits, select_tokens)
from .telemetry import MetricsRegistry

# cache entries without a batch axis: a dense cache's slot positions and
# tile, the physical block pools of a paged one
_ROWLESS = ("pos", "tile", "k_pool", "v_pool")


class Stepper:
    """Validity-masked decode / prefill dispatches for one model."""

    def __init__(self, api):
        self.api = api
        self.cfg = api.cfg
        self.device = api.device
        m = MetricsRegistry()
        self.metrics = m
        self._m_dispatches = m.counter("stepper.dispatches")
        # distinct megastep lengths run, as (paged, N)
        self.megastep_sizes: "set[tuple[bool, int]]" = set()

    @property
    def dispatches(self) -> int:
        return self._m_dispatches.value

    def trace_stats(self) -> dict:
        """Counter snapshot + megastep lengths, merged into
        ``engine.stats()``."""
        stats = dict(self.metrics.snapshot()["counters"])
        stats["megastep_sizes"] = sorted(
            [list(k) for k in self.megastep_sizes])
        return stats

    def _device(self, x, dtype):
        """Host array -> device tensor, always a copy: the engine mutates
        its slot-table arrays in place after the call."""
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _step(self, params, caches, toks, lens, active, tables):
        batch = {"tokens": toks[:, None], "cache_len": lens,
                 "active": active, "block_tables": tables}
        return self.api.decode_fn(params, caches, batch)

    def _tables(self, block_tables):
        return (None if block_tables is None
                else self._device(block_tables, torch.int32))

    # -- decode -------------------------------------------------------------

    @torch.no_grad()
    def decode(self, params, caches, toks, lens, active,
               block_tables=None, poison=None):
        """toks/lens/active (B,) -> (next_tok (B,), bad (B,), caches).
        ``bad`` flags active rows whose logits came back non-finite;
        ``poison`` (B,) bool NaNs those rows' logits (fault injection)."""
        self._m_dispatches.inc()
        toks = self._device(toks, torch.int32)
        active = self._device(active, torch.bool)
        logits, caches = self._step(
            params, caches, toks, self._device(lens, torch.int32), active,
            self._tables(block_tables))
        if poison is not None:
            logits = poison_logits(logits, self._device(poison, torch.bool))
        bad = logits_watchdog(logits, active)
        return select_tokens(logits, active, toks), bad, caches

    # -- chunked prefill ----------------------------------------------------

    @torch.no_grad()
    def prefill_chunk(self, params, caches, toks, lens, n_valid,
                      block_tables=None):
        """toks (B, C); lens/n_valid (B,).  Consumes ``n_valid[b]`` prompt
        tokens for row b starting at its ``lens[b]`` cache position.
        Returns (caches, new lens, first token per row — meaningful only
        for rows whose prompt completed in this chunk, watchdog flag per
        row OR-ed over the chunk's steps)."""
        self._m_dispatches.inc()
        toks = self._device(toks, torch.int32)
        lens = self._device(lens, torch.int32)
        n_valid = self._device(n_valid, torch.int32)
        tables = self._tables(block_tables)
        B, C = toks.shape
        first = torch.zeros(B, dtype=torch.int32, device=self.device)
        bad = torch.zeros(B, dtype=torch.bool, device=self.device)
        for i in range(C):
            active = i < n_valid
            logits, caches = self._step(params, caches, toks[:, i], lens,
                                        active, tables)
            first = torch.where(n_valid - 1 == i, greedy_serving(logits),
                                first)
            bad = bad | logits_watchdog(logits, active)
            lens = lens + active.to(torch.int32)
        return caches, lens, first, bad

    # -- decode megastep ----------------------------------------------------

    @torch.no_grad()
    def megastep(self, params, caches, toks, lens, active, budget,
                 forced, n_forced, eos_ids, block_tables=None,
                 poison=None):
        """N fused decode iterations, ONE dispatch, ONE host sync.

        toks/lens/active/budget/n_forced/eos_ids (B,); forced (B, N)
        prompt tokens to force-feed (row b uses column s while
        ``s < n_forced[b]``).  Returns ``(toks_out (N, B), act_out (N,
        B), bad (B,), caches)`` — ``act_out[s]`` is the mask of rows that
        executed step ``s``; ``bad`` is the NaN watchdog OR-ed over every
        executed step.  The caller must have reserved cache blocks for
        every position the loop can write: it never allocates.
        ``poison`` (B,) bool injects at step 0 (fault injection).
        """
        self._m_dispatches.inc()
        forced = self._device(forced, torch.int32)
        N = forced.shape[1]
        self.megastep_sizes.add((block_tables is not None, N))
        last = self._device(toks, torch.int32)
        lens = self._device(lens, torch.int32)
        active = self._device(active, torch.bool)
        budget = self._device(budget, torch.int32)
        n_forced = self._device(n_forced, torch.int32)
        eos_ids = self._device(eos_ids, torch.int32)
        tables = self._tables(block_tables)
        rows = None if poison is None else self._device(poison, torch.bool)
        bad = torch.zeros_like(active)
        toks_out, act_out = [], []
        for s in range(N):
            # rows still consuming prompt (or a resumed request's re-fed
            # last token) take the forced column; everyone else feeds
            # back the sampled carry
            tok_in = torch.where(s < n_forced, forced[:, s], last)
            logits, caches = self._step(params, caches, tok_in, lens,
                                        active, tables)
            if rows is not None and s == 0:
                # the fault fires at the megastep's FIRST fused
                # iteration — the engine iteration it was keyed to
                logits = poison_logits(logits, rows)
            bad = bad | logits_watchdog(logits, active)
            nxt, nactive, budget = megastep_advance(
                logits, last, active, budget, n_forced, eos_ids, s)
            lens = lens + active.to(torch.int32)
            # emit the pre-update mask: which rows EXECUTED this step
            toks_out.append(nxt)
            act_out.append(active)
            last, active = nxt, nactive
        return torch.stack(toks_out), torch.stack(act_out), bad, caches

    # -- slot reset ---------------------------------------------------------

    @torch.no_grad()
    def reset_rows(self, caches, fresh):
        """Zero every per-row cache entry of rows with ``fresh[b]`` True — a
        new tenant must see exactly the state ``init_caches`` would give
        it (SSM state / conv windows are carried outside the masked KV
        region, so stale tenants would otherwise leak through).  Block
        pools and slot positions have no rows and need no reset: every
        position a new tenant can attend to (t <= cache_len) is freshly
        written before it is read.  Returns new per-layer dicts; the
        tensors passed in are not written."""
        self._m_dispatches.inc()
        fresh = self._device(fresh, torch.bool)
        out = []
        for cache in caches:
            new = dict(cache)
            for name, a in cache.items():
                if name not in _ROWLESS:
                    rows = fresh.reshape((-1,) + (1,) * (a.ndim - 1))
                    new[name] = torch.where(rows, torch.zeros_like(a), a)
            out.append(new)
        return out
