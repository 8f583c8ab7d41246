"""Heterogeneous device placement — branch/region → device assignment.

The paper's runtime targets an accelerator plus a host CPU that absorbs
operator fallbacks (§1).  This module turns an
:class:`~repro_torch.core.plan.ExecutionPlan` into a :class:`PlacementPlan`
assigning every branch a *logical* device:

* branches containing a fused ``delegate`` region (accepted by the §3.1 /
  Appendix B cost model, recorded in ``PartitionReport``) run on an
  accelerator;
* branches with unsupported or control-flow nodes fall back to the host —
  control-flow branches additionally become *dynamic* regions executed by
  ``hetero/dynamic.py`` outside any fused callable;
* remaining supported branches go to the accelerator when their FLOPs clear
  the profile's compute floor ``F > L·R_cpu`` (Appendix B.2 — below it the
  dispatch costs more than the speedup), else they stay on the host, which
  is exactly the paper's "default backend" for undelegated work.

Parallel-group members round-robin across the available accelerator
devices (per-stream placement, cf. Opara in PAPERS.md): position ``p`` of
a §3.3 parallel group lands on logical ``accel:(p mod n_accel)``, so
branch-level parallelism becomes device-level parallelism when more than
one accelerator exists.

Logical devices are resolved to physical ``torch.device``s by
:func:`resolve_devices`: the host is the CPU and the accelerators are the
CUDA cards ``cuda:0 … cuda:n-1``.  A run asked for on the CPU
(``device="cpu"``, the tests) has the pool ``[cpu]``: every logical
device aliases it, so placement (and its byte accounting) still runs
without a card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..core.partition import HardwareProfile
from ..core.plan import ExecutionPlan
from ..core.scheduler import Schedule
from ..device import resolve_device

HOST = "host"
ACCEL = "accel"


@dataclass(frozen=True)
class DeviceAssignment:
    """Logical device of one branch (+ whether it is a dynamic region)."""

    kind: str                 # "accel" | "host"
    index: int                # logical index within the kind
    dynamic: bool = False     # host-side dynamic subgraph (control flow)

    @property
    def key(self) -> tuple:
        return (self.kind, self.index)


@dataclass
class PlacementPlan:
    """Branch id → :class:`DeviceAssignment`, plus the logical topology."""

    assignments: "dict[int, DeviceAssignment]" = field(default_factory=dict)
    n_accel: int = 1
    n_host: int = 1
    profile_name: str = ""

    def device_of(self, branch_id: int) -> tuple:
        return self.assignments[branch_id].key

    def is_dynamic(self, branch_id: int) -> bool:
        return self.assignments[branch_id].dynamic

    def devices_used(self) -> "list[tuple]":
        return sorted({a.key for a in self.assignments.values()})

    def branches_on(self, key: tuple) -> "list[int]":
        return sorted(b for b, a in self.assignments.items() if a.key == key)

    def signature(self) -> tuple:
        """Hashable token folded into
        :func:`~repro_torch.core.plan.plan_signature` so placed plans never
        share compiled artifacts with unplaced ones."""
        return (self.n_accel, self.n_host, self.profile_name,
                tuple((b, a.kind, a.index, a.dynamic)
                      for b, a in sorted(self.assignments.items())))


def logical_accel_count() -> int:
    """Accelerators the runtime can target: the CUDA cards of this
    machine.  Without a card one accelerator is simulated (it aliases the
    CPU when the run is asked for there)."""
    return max(1, torch.cuda.device_count())


def resolve_devices(placement: PlacementPlan,
                    device=None) -> "dict[tuple, torch.device]":
    """Logical (kind, index) → physical ``torch.device``.

    The host is the CPU.  The accelerator pool is every CUDA card, or
    ``[cpu]`` when ``device`` is the CPU; logical accelerators beyond the
    pool wrap around.  ``device=None`` means ``cuda`` and raises without a
    card (:func:`~repro_torch.device.resolve_device`): nothing falls back
    to the CPU silently.
    """
    dev = resolve_device(device)
    host = torch.device("cpu")
    pool = ([host] if dev.type == "cpu" else
            [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())])
    mapping: dict[tuple, torch.device] = {(HOST, i): host
                                          for i in range(placement.n_host)}
    for i in range(placement.n_accel):
        mapping[(ACCEL, i)] = pool[i % len(pool)]
    return mapping


def _assign_branch(plan: ExecutionPlan, bid: int, group_pos: int,
                   n_accel: int, profile: HardwareProfile) -> DeviceAssignment:
    br = plan.branches[bid]
    nodes = [plan.graph.nodes[n] for n in br.nodes]
    dynamic = any(n.is_control_flow() for n in nodes)
    if dynamic or any(not n.supported for n in nodes):
        return DeviceAssignment(HOST, 0, dynamic)
    if br.delegate or br.flops >= profile.derived_flops_floor():
        return DeviceAssignment(ACCEL, group_pos % n_accel)
    return DeviceAssignment(HOST, 0)


def plan_placement(plan: ExecutionPlan,
                   profile: "HardwareProfile | None" = None,
                   n_accel: "int | None" = None,
                   schedule: "Schedule | None" = None) -> PlacementPlan:
    """Deterministic placement of every scheduled branch.

    Walks the §3.3 schedule (sorted layers, groups in order, members in
    order), so two plans with equal signatures always produce identical
    assignments.  ``profile`` defaults to the cost model the plan was
    compiled with; ``n_accel`` to :func:`logical_accel_count`.
    """
    if profile is None:
        cfg = plan.attrs.get("config")
        profile = (cfg.cost_model.profile if cfg is not None
                   else HardwareProfile("permissive", 0.0, 1.0, 1.0, 1.0))
    if n_accel is None:
        n_accel = logical_accel_count()
    sched = schedule if schedule is not None else plan.schedule
    out = PlacementPlan(n_accel=n_accel, profile_name=profile.name)
    for sl in sched.layers:
        for group in sl.parallel_groups:
            for pos, bid in enumerate(group):
                out.assignments[bid] = _assign_branch(
                    plan, bid, pos, n_accel, profile)
        for bid in sl.sequential:
            out.assignments[bid] = _assign_branch(
                plan, bid, 0, n_accel, profile)
    return out
