"""Plan execution — the Parallax runtime.

Three executors over one :class:`~repro_torch.core.plan.ExecutionPlan`:

* ``reference`` — op-by-op interpretation of the graph in topological
  order (the correctness oracle; models stock framework execution).
* ``sequential`` — layer/branch-ordered op-by-op execution (same work as
  reference, Parallax structure but no parallelism; the paper's "1 thread"
  point in Fig. 3).
* ``parallax`` — the schedule is *compiled* (core/compile.py): by default
  every scheduled layer lowers to one fused callable, and homogeneous
  balanced groups batch their matmuls into the grouped ``branch_matmul``
  CUDA kernel.

Execution modes & dispatch model
--------------------------------

========================  =============================  ==================
mode                      unit of dispatch               dispatches / run
========================  =============================  ==================
``reference``             one eager op                   O(nodes)
``sequential``            one eager op, schedule order   O(nodes)
``parallax`` (fused)      one scheduled layer            O(layers)
``parallax`` whole-plan   the entire schedule            1
``parallax`` interpreted  one group / one branch         O(groups x layers)
``parallax-hetero``       one (layer, device) segment    O(layers x devices)
========================  =============================  ==================

``parallax-hetero`` executes a *placed* plan across heterogeneous devices
(repro_torch.hetero): card segments and host fallback segments dispatch
per device, boundary tensors move by ``.to(device)`` (host → card
enqueued, card → host blocking), and control-flow branches run as
host-side dynamic regions.  Unplaced plans are heterogenized on the fly
(``hetero_profile`` / ``n_accel`` kwargs).

Devices: the executor runs on ``device`` (``cuda`` unless the caller asks
for ``cpu``; without a card asking for ``cuda`` raises).  A run moves the
numpy arrays of its environment onto that device; tensors already there
pass through.  On the card every kernel is enqueued on the current stream.

Synchronization: with ``profile=False`` (default) the parallax executor
never blocks mid-run — dispatches stream asynchronously and exactly one
``torch.cuda.synchronize`` happens at the graph outputs
(``last_sync_count == 1``).  ``profile=True`` reinstates a barrier after
every scheduled layer so ``RunResult.layer_timings`` measure completed
compute; without it they measure (cheap) enqueue latency.
``sequential`` keeps its per-layer barriers — it exists to model
barrier-synchronized baselines.  On the CPU a barrier is counted but has
nothing to wait for.

Homogeneous-group batching kicks in when a §3.1-balanced group's branches
share chain length and a chain position is a pure 2-D matmul with
identical shapes across branches; that position runs as ONE grouped
``branch_matmul`` ``(G, M, K) x (G, K, N)`` launch inside the fused
layer.  Disable with ``use_branch_kernel=False``.

Compiled callables are cached per graph object, keyed on
:func:`~repro_torch.core.plan.plan_signature` — fresh executors over an
identical plan signature (same graph) share compiled artifacts.

``ArenaExecutor`` additionally materializes every branch arena as one
device byte buffer and runs the graph *through the planned offsets*, so
any liveness/overlap bug in §3.2 produces wrong numerics against the
oracle — this is how tests validate Eq. 1 end-to-end, on the card itself.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..device import resolve_device
from .compile import compile_schedule
from .graph import Graph, region_boundary_tensors
from .plan import ExecutionPlan


def make_subgraph_fn(graph: Graph, node_ids: "list[int]"):
    """Closure executing ``node_ids`` of ``graph``.

    Returns ``(fn, in_tensor_ids, out_tensor_ids)`` where ``fn(*tensors)``
    maps boundary inputs to boundary outputs.
    """
    region = set(node_ids)
    order = [n for n in graph.topo_order() if n in region]
    in_ids, out_ids = region_boundary_tensors(graph, region)

    def fn(*args):
        env = dict(zip(in_ids, args))
        for nid in order:
            node = graph.nodes[nid]
            outs = node.fn(*[env[t] for t in node.inputs])
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for t, v in zip(node.outputs, outs):
                env[t] = v
        return tuple(env[t] for t in out_ids)

    return fn, list(in_ids), list(out_ids)


def to_device(env: "dict[int, object]", device: torch.device) -> dict:
    """Tensor id -> tensor on ``device`` (numpy arrays are copied there)."""
    return {t: torch.as_tensor(v, device=device) for t, v in env.items()}


@dataclass
class LayerTiming:
    layer_index: int
    seconds: float
    width: int            # branch count executed concurrently (BR column)


@dataclass
class RunResult:
    outputs: "dict[int, object]"
    layer_timings: "list[LayerTiming]" = field(default_factory=list)

    def total_seconds(self) -> float:
        return sum(t.seconds for t in self.layer_timings)


class PlanExecutor:
    """Executes an ExecutionPlan in one of the four modes.

    Parallax-mode knobs (see module docstring for semantics):

    * ``fused`` — lower the schedule with core/compile.py (default).
      ``fused=False`` keeps the interpreted one-dispatch-per-group path.
    * ``whole_plan`` — fuse the entire schedule into a single callable.
    * ``profile`` — re-enable per-layer barriers for honest layer timings.
    * ``use_branch_kernel`` — grouped-GEMM batching of homogeneous groups.
    * ``donate`` — drop dead intermediates from the working environment
      after their layer (None = auto: on for ``cuda``, off for ``cpu``).
    * ``device`` — where the run happens (None = ``cuda``); in
      ``parallax-hetero`` mode the accelerator segments run there and the
      host segments on the CPU.
    * ``hetero_profile`` / ``n_accel`` — the placement's cost model and
      accelerator count when an unplaced plan is heterogenized.

    Counters: ``last_dispatch_count`` / ``last_sync_count`` describe the
    most recent run; ``dispatch_count`` / ``sync_count`` accumulate.  In
    ``parallax-hetero`` mode ``last_transfer_bytes`` and
    ``last_device_dispatches`` add the run's boundary traffic and its
    dispatches per logical device.
    """

    def __init__(self, plan: ExecutionPlan, mode: str = "parallax", *,
                 fused: bool = True, whole_plan: bool = False,
                 profile: bool = False, use_branch_kernel: bool = True,
                 donate: "bool | None" = None, device=None,
                 hetero_profile=None, n_accel: "int | None" = None):
        if mode not in ("reference", "sequential", "parallax",
                        "parallax-hetero"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.profile = profile
        self.device = resolve_device(device)
        self._hetero = None
        if mode == "parallax-hetero":
            if whole_plan or not fused or donate is not None:
                raise ValueError(
                    "whole_plan/fused/donate are parallax-only knobs; "
                    "parallax-hetero always dispatches one fused callable "
                    "per (layer, device) segment")
            # Deferred import: repro_torch.hetero builds on core.
            from ..hetero import HeteroExecutor, heterogenize
            if plan.placement is None:
                plan = heterogenize(plan, profile=hetero_profile,
                                    n_accel=n_accel)
            self._hetero = HeteroExecutor(
                plan, use_branch_kernel=use_branch_kernel, profile=profile,
                device=self.device)
        self.plan = plan
        if donate is None:
            donate = self.device.type == "cuda"
        self._group_cache: dict = {}
        self.compiled = None
        if mode == "parallax" and fused:
            self.compiled = compile_schedule(
                plan, whole_plan=whole_plan,
                use_branch_kernel=use_branch_kernel, donate=donate)
        self.dispatch_count = 0
        self.sync_count = 0
        self.last_dispatch_count = 0
        self.last_sync_count = 0
        self.last_transfer_bytes = 0
        self.last_device_dispatches: dict = {}

    @property
    def hetero_stats(self):
        """``HeteroCompileStats`` of the placed schedule (segments, dynamic
        regions, devices) — None outside ``parallax-hetero`` mode."""
        return (self._hetero.compiled.stats
                if self._hetero is not None else None)

    # -- group callables (interpreted path) ---------------------------------

    def _group_callable(self, branch_ids: "tuple[int, ...]"):
        key = tuple(branch_ids)
        if key not in self._group_cache:
            nodes = [n for b in branch_ids
                     for n in self.plan.branches[b].nodes]
            self._group_cache[key] = make_subgraph_fn(self.plan.graph, nodes)
        return self._group_cache[key]

    # -- execution -------------------------------------------------------

    def __call__(self, env: "dict[int, object]") -> RunResult:
        self.last_dispatch_count = 0
        self.last_sync_count = 0
        if self._hetero is not None:
            # the hetero executor moves each input to its segments' devices
            result = self._hetero(env)
            self.last_dispatch_count = self._hetero.last_dispatch_count
            self.last_sync_count = self._hetero.last_sync_count
            self.last_transfer_bytes = self._hetero.last_transfer_bytes
            self.last_device_dispatches = dict(
                self._hetero.last_device_dispatches)
        elif self.mode == "reference":
            result = self._run_reference(to_device(env, self.device))
        elif self.compiled is not None:
            result = self._run_fused(to_device(env, self.device))
        else:
            result = self._run_interpreted(to_device(env, self.device))
        self.dispatch_count += self.last_dispatch_count
        self.sync_count += self.last_sync_count
        return result

    def _block(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_sync_count += 1

    def _run_reference(self, env) -> RunResult:
        graph = self.plan.graph
        t0 = time.perf_counter()
        full = graph.execute(env)
        outs = {t: full[t] for t in graph.outputs}
        self._block()
        dt = time.perf_counter() - t0
        self.last_dispatch_count = len(graph.nodes)
        return RunResult(outs, [LayerTiming(0, dt, 1)])

    def _run_fused(self, env) -> RunResult:
        graph = self.plan.graph
        c = self.compiled
        timings: list[LayerTiming] = []
        if c.whole is not None:
            t0 = time.perf_counter()
            outs = c.whole.fn(*[env[t] for t in c.whole.in_ids])
            self.last_dispatch_count += 1
            env.update(zip(c.whole.out_ids, outs))
            if self.profile:
                self._block()
            timings.append(
                LayerTiming(0, time.perf_counter() - t0, c.whole.width))
        else:
            for cl in c.layers:
                t0 = time.perf_counter()
                outs = cl.fn(*[env[t] for t in cl.in_ids])
                self.last_dispatch_count += 1
                if c.donate:
                    for i in cl.donate_argnums:
                        del env[cl.in_ids[i]]
                env.update(zip(cl.out_ids, outs))
                if self.profile:
                    self._block()
                timings.append(LayerTiming(cl.layer_index,
                                           time.perf_counter() - t0,
                                           cl.width))
        outs = {t: env[t] for t in graph.outputs}
        self._block()
        return RunResult(outs, timings)

    def _run_interpreted(self, env) -> RunResult:
        graph = self.plan.graph
        timings: list[LayerTiming] = []
        for sl in self.plan.schedule.layers:
            t0 = time.perf_counter()
            width = 1
            if self.mode == "parallax":
                for group in sl.parallel_groups:
                    self._run_unit(env, tuple(group))
                    width = max(width, len(group))
                for bid in sl.sequential:      # single branches
                    self._run_unit(env, (bid,))
            else:  # sequential mode: everything op-by-op, schedule order
                for bid in sl.all_branches():
                    self._run_branch_eager(env, bid)
            # sequential is the barrier-synchronized baseline; parallax only
            # barriers here under profile=True (honest layer timings)
            if self.profile or self.mode == "sequential":
                self._block()
            timings.append(
                LayerTiming(sl.layer_index, time.perf_counter() - t0, width))
        outs = {t: env[t] for t in graph.outputs}
        self._block()
        return RunResult(outs, timings)

    def _run_unit(self, env, branch_ids: "tuple[int, ...]") -> None:
        fn, in_ids, out_ids = self._group_callable(branch_ids)
        outs = fn(*[env[t] for t in in_ids])
        self.last_dispatch_count += 1
        env.update(zip(out_ids, outs))

    def _run_branch_eager(self, env, branch_id: int) -> None:
        graph = self.plan.graph
        for nid in self.plan.branches[branch_id].nodes:
            node = graph.nodes[nid]
            self.last_dispatch_count += 1
            outs = node.fn(*[env[t] for t in node.inputs])
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            env.update(zip(node.outputs, outs))


class ArenaExecutor:
    """Runs the plan through the *planned byte offsets* (§3.2 validation).

    Every branch arena is one ``uint8`` tensor on the device; node outputs
    are copied into their planned slots and inputs read back from the
    slots, as views, at use time.  Offsets are 64-byte aligned
    (core/arena.py), so every typed view is legal.  If the liveness
    analysis or offset assignment ever allowed two live tensors to overlap
    (violating Eq. 1), a later read returns clobbered data and the result
    diverges from the oracle.
    """

    def __init__(self, plan: ExecutionPlan, device=None):
        self.plan = plan
        self.device = resolve_device(device)
        self.arenas: dict[int, torch.Tensor] = {
            bid: torch.empty(p.size, dtype=torch.uint8, device=self.device)
            for bid, p in plan.arena_plans.items()}
        # tensor id -> (branch id, offset, nbytes) for arena-resident tensors
        self.slots: dict[int, tuple] = {}
        for bid, p in plan.arena_plans.items():
            for t, (off, _sz) in p.offsets.items():
                self.slots[t] = (bid, off, plan.graph.tensors[t].nbytes())

    def _view(self, t: int) -> torch.Tensor:
        bid, off, nb = self.slots[t]
        spec = self.plan.graph.tensors[t].spec
        return (self.arenas[bid][off:off + nb]
                .view(getattr(torch, spec.dtype)).view(spec.static_shape))

    def _store(self, t: int, value) -> None:
        slot = self._view(t)
        nb = value.numel() * value.element_size()
        assert value.dtype == slot.dtype and nb == self.slots[t][2], (
            f"tensor {t}: {value.dtype} {nb} B != planned {slot.dtype} "
            f"{self.slots[t][2]} B")
        slot.copy_(value.reshape(slot.shape))

    def __call__(self, env: "dict[int, object]") -> "dict[int, object]":
        graph = self.plan.graph
        ext = to_device(env, self.device)  # graph inputs / params
        for sl in self.plan.schedule.layers:
            for bid in sl.all_branches():
                for nid in self.plan.branches[bid].nodes:
                    node = graph.nodes[nid]
                    args = [self._view(t) if t in self.slots else ext[t]
                            for t in node.inputs]
                    outs = node.fn(*args)
                    if not isinstance(outs, (tuple, list)):
                        outs = (outs,)
                    for t, v in zip(node.outputs, outs):
                        if t in self.slots:
                            self._store(t, v)
                        else:
                            ext[t] = v
        return {t: (self._view(t).clone() if t in self.slots else ext[t])
                for t in graph.outputs}
