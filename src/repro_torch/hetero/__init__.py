"""Heterogeneous placement & fallback dispatch runtime.

Executes an :class:`~repro_torch.core.plan.ExecutionPlan` across
heterogeneous devices — the accelerator/CPU co-execution the paper
evaluates, here the host CPU beside the CUDA card:

* :mod:`~repro_torch.hetero.placement` — branch → logical device assignment
  (delegates and floor-clearing compute on accelerators, fallbacks on the
  host; parallel-group members round-robin across accelerator devices),
* :mod:`~repro_torch.hetero.transfer` — boundary-tensor movement planning with
  per-edge byte accounting, fed back into the §3.3 greedy scheduler,
* :mod:`~repro_torch.hetero.dynamic` — host-side execution of control-flow
  subgraphs with a shape-bucketed per-region capture cache,
* :mod:`~repro_torch.hetero.executor` — the ``parallax-hetero`` runtime over
  per-(layer, device) fused segments (lowered by core/compile.py).

Typical use::

    from repro_torch.core import compile_plan, PlanExecutor
    from repro_torch.hetero import heterogenize

    plan = heterogenize(compile_plan(g, cfg))
    out = PlanExecutor(plan, mode="parallax-hetero")(inputs)   # on cuda

``PlanExecutor(mode="parallax-hetero")`` heterogenizes on the fly when
handed an unplaced plan.
"""

from __future__ import annotations

import dataclasses

from ..core.partition import HardwareProfile
from ..core.plan import ExecutionPlan
from ..core.scheduler import Schedule, greedy_select, schedule_layers
from .dynamic import DynamicRegionCache, shape_bucket
from .executor import HeteroExecutor
from .placement import (ACCEL, HOST, DeviceAssignment, PlacementPlan,
                        logical_accel_count, plan_placement, resolve_devices)
from .transfer import (TransferEdge, TransferPlan, branch_boundary_tensors,
                       plan_transfers)

__all__ = [
    "ACCEL", "HOST", "DeviceAssignment", "DynamicRegionCache",
    "HeteroExecutor", "PlacementPlan", "TransferEdge", "TransferPlan",
    "branch_boundary_tensors", "heterogenize", "logical_accel_count",
    "plan_placement", "plan_transfers", "resolve_devices", "shape_bucket",
]


def _demote_over_budget(schedule: Schedule, peak_mems: "dict[int, int]",
                        extra_mems: "dict[int, int]") -> bool:
    """Re-select any parallel group whose members' *current* staging
    charges no longer fit the budget; over-charge members defer to
    sequential.  Mutates ``schedule`` in place; returns True on change.
    Demote-only, so repeated application terminates."""
    changed = False
    for sl in schedule.layers:
        kept: list[list[int]] = []
        for group in sl.parallel_groups:
            total = sum(peak_mems[b] + extra_mems.get(b, 0) for b in group)
            if total <= schedule.budget:
                kept.append(group)
                continue
            chosen, deferred = greedy_select(
                peak_mems, group, schedule.budget, schedule.max_parallel,
                extra_mems=extra_mems)
            changed = True
            if len(chosen) >= 2:
                kept.append(chosen)
                sl.sequential.extend(deferred)
            else:
                sl.sequential.extend(group)
        if changed:
            sl.parallel_groups = kept
            sl.sequential = sorted(set(sl.sequential))
    return changed


def heterogenize(plan: ExecutionPlan,
                 profile: "HardwareProfile | None" = None,
                 n_accel: "int | None" = None,
                 charge_transfers: bool = True) -> ExecutionPlan:
    """Attach a placement (+ transfer-charged schedule) to a plan.

    First place against the plan's §3.3 schedule and enumerate boundary
    transfers, then re-run the greedy scheduler charging each branch its
    incoming transfer bytes on top of peak memory (``extra_mems``) — a
    branch whose staged cross-device inputs no longer fit is deferred to
    sequential execution.  Because deferral shifts round-robin positions
    (and therefore the transfers themselves), placement and charges are
    recomputed against each intermediate schedule and any group whose
    *recomputed* charges exceed the budget is demoted again — a
    demote-only repair loop, so it terminates and never re-admits on
    stale (smaller) first-pass charges.  The final placement/transfer
    pair always describes the schedule that actually runs.

    Returns a new plan (the input is not mutated) whose signature covers
    the placement, so compiled hetero artifacts never collide with the
    homogeneous ones.  The transfer plan rides along in
    ``plan.attrs["transfers"]``.
    """
    placement = plan_placement(plan, profile, n_accel)
    transfers = plan_transfers(plan, placement)
    schedule = plan.schedule
    if charge_transfers and transfers.bytes_in:
        peak_mems = {bid: b.peak_memory for bid, b in plan.branches.items()}
        schedule = schedule_layers(
            plan.layer_groups, peak_mems, budget=plan.schedule.budget,
            max_parallel=plan.schedule.max_parallel,
            extra_mems=transfers.bytes_in)
        for _ in range(max(1, len(plan.branches))):
            placement = plan_placement(plan, profile, n_accel,
                                       schedule=schedule)
            transfers = plan_transfers(
                dataclasses.replace(plan, schedule=schedule), placement)
            if not _demote_over_budget(schedule, peak_mems,
                                       transfers.bytes_in):
                break
    new_plan = dataclasses.replace(
        plan, schedule=schedule, placement=placement,
        attrs={**plan.attrs, "transfers": transfers})
    return new_plan
