"""Heterogeneous plan execution — the ``parallax-hetero`` runtime.

Drives a placed plan's :class:`~repro_torch.core.compile.
CompiledHeteroSchedule` across the resolved physical devices:

* every segment's inputs are copied to its device with ``.to(device)``
  before dispatch, once per (tensor, device) per run — planned boundary
  crossings (``TransferPlan.crossing_keys``) increment the transfer
  counters, while a tensor already on the device passes through (as do
  the aliases of the CPU-only simulation);
* host → card copies are stream-ordered and non-blocking; card → host
  copies block until the data has landed, so a host segment never reads
  a buffer the card is still writing;
* static segments call their fused closure; dynamic segments run
  host-side through :class:`~repro_torch.hetero.dynamic.DynamicRegionCache`
  (per-subgraph captures, shape-bucketed);
* like the homogeneous executor, card work streams asynchronously with
  exactly one explicit barrier (``torch.cuda.synchronize``) at the graph
  outputs (``profile=True`` reinstates a barrier after every segment).
  Card segments of a layer are enqueued before its host segments, so the
  CPU computes its fallbacks while the card runs.

Graph inputs are caller-owned host memory (numpy arrays or CPU tensors;
``TransferPlan``'s ``EXTERNAL`` source), so the counted bytes are the
PCIe traffic of a run.  Params are moved like any input but never
counted: ``TransferPlan`` excludes them, as weights are resident on their
consumer's device.

Counters: ``last_dispatch_count`` / ``last_sync_count`` mirror
``PlanExecutor``; ``last_device_dispatches`` splits dispatches by logical
device and ``last_transfer_bytes`` / ``last_transfer_count`` account the
boundary traffic actually moved — one copy per (tensor, device), equal to
the static ``TransferPlan.physical_bytes()`` (tests assert this), while
``total_bytes`` is the larger per-consumer staging charge the scheduler
uses.
"""

from __future__ import annotations

import time

import torch

from ..core.compile import compile_hetero_schedule
from ..core.executor import LayerTiming, RunResult
from ..core.plan import ExecutionPlan
from ..runtime.telemetry import Telemetry
from .dynamic import DynamicRegionCache
from .placement import resolve_devices
from .transfer import TransferPlan, plan_transfers


def _move(v, dev: torch.device) -> torch.Tensor:
    """``v`` on ``dev``: a numpy array becomes a CPU tensor sharing its
    memory; a card → host copy blocks until it has landed, a host → card
    copy is enqueued on the current stream."""
    v = torch.as_tensor(v)
    if v.device == dev:
        return v
    return v.to(dev, non_blocking=dev.type == "cuda")


class HeteroExecutor:
    """Executes a heterogenized plan (``plan.placement`` must be set) on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, plan: ExecutionPlan, *,
                 use_branch_kernel: bool = True, profile: bool = False,
                 device=None, telemetry: "Telemetry | None" = None):
        if plan.placement is None:
            raise ValueError("plan has no placement — call "
                             "repro_torch.hetero.heterogenize(plan) first")
        self.plan = plan
        self.profile = profile
        self.device_map = resolve_devices(plan.placement, device)
        self._cards = sorted({d for d in self.device_map.values()
                              if d.type == "cuda"}, key=str)
        self.compiled = compile_hetero_schedule(
            plan, use_branch_kernel=use_branch_kernel)
        transfers = plan.attrs.get("transfers")
        if not isinstance(transfers, TransferPlan):
            transfers = plan_transfers(plan, plan.placement)
        self.transfers = transfers
        self._crossing = transfers.crossing_keys()
        self.dynamic_cache = DynamicRegionCache(plan.graph)
        # cumulative counters live in the telemetry registry (legacy
        # names below are a read-only façade); the last_* per-run
        # scratch stays plain — it is reset every __call__
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._rec = self.telemetry.rec
        m = self.telemetry.metrics
        self._m_dispatches = m.counter("hetero.dispatches")
        self._m_syncs = m.counter("hetero.syncs")
        self._m_transfer_bytes = m.counter("hetero.transfer_bytes")
        self._m_transfers = m.counter("hetero.transfers")
        self._m_per_device: dict = {}      # logical device -> Counter
        self.last_dispatch_count = 0
        self.last_sync_count = 0
        self.last_transfer_bytes = 0
        self.last_transfer_count = 0
        self.last_device_dispatches: dict[tuple, int] = {}

    @property
    def dispatch_count(self) -> int:
        return self._m_dispatches.value

    @property
    def sync_count(self) -> int:
        return self._m_syncs.value

    @property
    def transfer_bytes(self) -> int:
        return self._m_transfer_bytes.value

    @property
    def transfer_count(self) -> int:
        return self._m_transfers.value

    def _device_counter(self, device):
        c = self._m_per_device.get(device)
        if c is None:
            tag = "_".join(str(p) for p in device) \
                if isinstance(device, tuple) else str(device)
            c = self.telemetry.metrics.counter(f"hetero.dispatches.{tag}")
            self._m_per_device[device] = c
        return c

    def stats(self) -> dict:
        """JSON-safe snapshot of the executor's cumulative counters."""
        return self.telemetry.metrics.snapshot()

    def _block(self) -> None:
        """One barrier: every card in use has finished its work."""
        for card in self._cards:
            torch.cuda.synchronize(card)
        self.last_sync_count += 1

    def __call__(self, env: "dict[int, object]") -> RunResult:
        graph = self.plan.graph
        tensors = graph.tensors
        self.last_dispatch_count = 0
        self.last_sync_count = 0
        self.last_transfer_bytes = 0
        self.last_transfer_count = 0
        self.last_device_dispatches = {}
        env = dict(env)
        placed: dict[tuple, object] = {}   # (tensor, logical dev) -> tensor
        timings: list[LayerTiming] = []
        rec = self._rec
        for seg in self.compiled.segments:
            t0 = time.perf_counter()
            dev = self.device_map[seg.device]
            args = []
            for t in seg.in_ids:
                key = (t, seg.device)
                v = placed.get(key)
                if v is None:
                    # One physical move per (tensor, device) per run —
                    # shared by co-located consumers, so the counter
                    # equals TransferPlan.physical_bytes().
                    v = _move(env[t], dev)
                    placed[key] = v
                    if key in self._crossing:
                        self.last_transfer_bytes += tensors[t].nbytes()
                        self.last_transfer_count += 1
                args.append(v)
            if seg.dynamic:
                outs = self.dynamic_cache.run(seg.node_ids, tuple(args))
            else:
                outs = seg.fn(*args)
            self.last_dispatch_count += 1
            self.last_device_dispatches[seg.device] = (
                self.last_device_dispatches.get(seg.device, 0) + 1)
            self._device_counter(seg.device).inc()
            for t, v in zip(seg.out_ids, outs):
                env[t] = v
                # outputs are already resident on the segment device:
                # same-device consumers read them without a copy
                placed[(t, seg.device)] = v
            if self.profile:
                self._block()
            timings.append(LayerTiming(seg.layer_index,
                                       time.perf_counter() - t0, seg.width))
            if rec.enabled:
                rec.span("segment", t0,
                         device=str(seg.device),
                         layer=seg.layer_index,
                         dynamic=bool(seg.dynamic))
        outs = {t: env[t] for t in graph.outputs}
        self._block()
        self._m_dispatches.inc(self.last_dispatch_count)
        self._m_syncs.inc(self.last_sync_count)
        self._m_transfer_bytes.inc(self.last_transfer_bytes)
        self._m_transfers.inc(self.last_transfer_count)
        return RunResult(outs, timings)
