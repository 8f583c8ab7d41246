"""The port's §3 planner, schedule compiler and executors against JAX's.

For each of the six zoo graphs (``torch_graph_zoo.py`` and its JAX twin
``graph_zoo.py``, the same topology and the same numpy inputs):

* ``compile_plan`` gives the JAX planner's plan: branches, layers, the
  §3.3 schedule, arena sizes and ``CompileStats``;
* every executor mode matches the JAX oracle's outputs to rtol = atol =
  2e-5 (fp32 sums in other orders), and with the grouped kernel off the
  port's modes are bit-identical to its own ``reference`` (the same ops
  on the same inputs);
* dispatch and sync counts equal the JAX executor's.

JAX is imported only inside fixtures, so the ``cuda`` cases collect on
the card's machine, which has no JAX.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_graph_zoo as tz  # noqa: E402
from repro_torch.core import (ArenaExecutor, ParallaxConfig,  # noqa: E402
                              PlanExecutor, clear_compile_cache,
                              compile_plan, compile_schedule, gemm_positions,
                              plan_signature)
from repro_torch.core.compile import _is_pure_matmul  # noqa: E402

CFG = ParallaxConfig(budget=1 << 30)
NAMES = sorted(tz.ALL_ZOO)
CPU = "cpu"
MODES = {
    "reference": dict(mode="reference"),
    "sequential": dict(mode="sequential"),
    "fused": dict(),
    "whole-plan": dict(whole_plan=True),
    "interpreted": dict(fused=False),
    "fused-no-kernel": dict(use_branch_kernel=False),
    "whole-plan-no-kernel": dict(whole_plan=True, use_branch_kernel=False),
}
KERNEL_OFF = ["sequential", "interpreted", "fused-no-kernel",
              "whole-plan-no-kernel"]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import graph_zoo
    from repro import core

    return SimpleNamespace(zoo=graph_zoo.ALL_ZOO, core=core,
                           cfg=core.ParallaxConfig(budget=1 << 30))


def _out(result, graph):
    return result.outputs[graph.outputs[0]]


def _jax_ref(jx, name, seed):
    g, make = jx.zoo[name]()
    env = make(np.random.default_rng(seed))
    return np.asarray(g.execute(dict(env))[g.outputs[0]])


def _schedule(plan):
    return [(sl.layer_index, sl.parallel_groups, sl.sequential)
            for sl in plan.schedule.layers]


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_plan_matches_jax(jx, name):
    gj, _ = jx.zoo[name]()
    gt, _ = tz.ALL_ZOO[name]()
    pj = jx.core.compile_plan(gj, jx.cfg)
    pt = compile_plan(gt, CFG)
    assert ({b: br.nodes for b, br in pt.branches.items()}
            == {b: br.nodes for b, br in pj.branches.items()})
    assert pt.layers == pj.layers
    assert _schedule(pt) == _schedule(pj)
    assert pt.sum_arena_sizes() == pj.sum_arena_sizes()
    assert pt.pooled_arena_peak() == pj.pooled_arena_peak()
    assert pt.stats_parallax.as_row() == pj.stats_parallax.as_row()
    assert (dataclasses.astuple(compile_schedule(pt).stats)
            == dataclasses.astuple(jx.core.compile_schedule(pj).stats))


@pytest.mark.parametrize("name", NAMES)
def test_plan_signature_is_equal_across_builds(name):
    p1 = compile_plan(tz.ALL_ZOO[name]()[0], CFG)
    p2 = compile_plan(tz.ALL_ZOO[name]()[0], CFG)
    assert plan_signature(p1) == plan_signature(p2)


# -- numerics ----------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_mode_matches_jax_oracle(jx, name, mode):
    g, make = tz.ALL_ZOO[name]()
    plan = compile_plan(g, CFG)
    ex = PlanExecutor(plan, device=CPU, **MODES[mode])
    got = _out(ex(make(np.random.default_rng(42))), plan.graph)
    np.testing.assert_allclose(got.numpy(), _jax_ref(jx, name, 42),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", KERNEL_OFF)
@pytest.mark.parametrize("name", NAMES)
def test_kernel_off_is_bit_identical_to_reference(name, mode):
    g, make = tz.ALL_ZOO[name]()
    env = make(np.random.default_rng(1))
    plan = compile_plan(g, CFG)
    ref = _out(PlanExecutor(plan, "reference", device=CPU)(env), g)
    got = _out(PlanExecutor(plan, device=CPU, **MODES[mode])(env), g)
    assert torch.equal(ref, got)


@pytest.mark.parametrize("name", NAMES)
def test_arena_executor_matches_the_oracle(jx, name):
    g, make = tz.ALL_ZOO[name]()
    env = make(np.random.default_rng(3))
    plan = compile_plan(g, CFG)
    got = ArenaExecutor(plan, device=CPU)(env)[g.outputs[0]]
    ref = _out(PlanExecutor(plan, "reference", device=CPU)(env), g)
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got.numpy(), _jax_ref(jx, name, 3),
                               rtol=2e-5, atol=2e-5)


def test_arena_executor_sees_an_overlap():
    """Live tensors of different branches planned onto one slot give
    wrong numerics: the check has teeth."""
    g, make = tz.multihead_graph()
    env = make(np.random.default_rng(0))
    plan = compile_plan(g, CFG)
    ref = _out(PlanExecutor(plan, "reference", device=CPU)(env), g)
    ex = ArenaExecutor(plan, device=CPU)
    big = max(ex.arenas, key=lambda b: ex.arenas[b].numel())
    for t, (_, _, nb) in ex.slots.items():    # every head output on one slot
        ex.slots[t] = (big, 0, nb)
    assert not torch.equal(ex(env)[g.outputs[0]], ref)


# -- homogeneous-group batching ---------------------------------------------

def test_multihead_routes_through_branch_matmul():
    g, make = tz.multihead_graph()
    plan = compile_plan(g, CFG)
    compiled = compile_schedule(plan)
    assert compiled.use_branch_kernel
    assert compiled.stats.batched_groups >= 1
    assert compiled.stats.gemm_sites >= 2
    env = make(np.random.default_rng(5))
    got = _out(PlanExecutor(plan, device=CPU)(env), g)
    ref = _out(PlanExecutor(plan, "reference", device=CPU)(env), g)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6)


def test_epilogue_matmuls_are_not_batched():
    """diamond branches compute tanh(a @ w): op_class 'matmul' but not a
    pure product, so the aten-graph test must reject them."""
    g, _ = tz.diamond_graph()
    plan = compile_plan(g, CFG)
    assert compile_schedule(plan).stats.batched_groups == 0
    for sl in plan.schedule.layers:
        for group in sl.parallel_groups:
            assert gemm_positions(plan, group) == ()


@pytest.mark.parametrize("fn, pure", [
    (lambda a, w: a @ w, True),
    (lambda a, w: torch.matmul(a, w), True),
    (lambda a, w: torch.mm(a, w), True),
    (lambda a, w: torch.tanh(a @ w), False),
    (lambda a, w: (a @ w) * 0.1, False),
    (lambda a, w: a @ w + a.sum(), False),
], ids=["at", "matmul", "mm", "tanh", "scaled", "extra-op"])
def test_pure_matmul_detection(fn, pure):
    from repro_torch.core import GraphBuilder, TensorSpec

    b = GraphBuilder()
    x, w = b.input((4, 8), name="x"), b.param((8, 4), name="w")
    y = b.op("mm", "matmul", [x, w], [TensorSpec((4, 4))], fn=fn)
    b.mark_output(y)
    g = b.build()
    assert _is_pure_matmul(g, g.nodes[0]) is pure


# -- compile cache -----------------------------------------------------------

def test_compile_cache_shares_callables_across_executors():
    g, _ = tz.diamond_graph()
    plan = compile_plan(g, CFG)
    ex1 = PlanExecutor(plan, device=CPU)
    ex2 = PlanExecutor(plan, device=CPU)
    assert ex1.compiled is ex2.compiled
    plan2 = compile_plan(g, CFG)
    assert plan_signature(plan2) == plan_signature(plan)
    assert compile_schedule(plan2, donate=False) is ex1.compiled
    assert compile_schedule(plan, whole_plan=True) is not ex1.compiled


def test_cache_never_shared_across_graph_objects():
    from repro_torch.core import GraphBuilder, TensorSpec

    def build(weight):
        w = torch.full((4, 4), weight)
        b = GraphBuilder()
        x = b.input((4, 4), name="x")
        y = b.op("mm", "matmul", [x], [TensorSpec((4, 4))],
                 fn=lambda a, _w=w: a @ _w)
        b.mark_output(y)
        return b.build()

    g1, g2 = build(1.0), build(2.0)
    p1, p2 = compile_plan(g1, CFG), compile_plan(g2, CFG)
    assert plan_signature(p1) == plan_signature(p2)
    assert compile_schedule(p1) is not compile_schedule(p2)
    env = {g1.inputs[0]: np.ones((4, 4), np.float32)}
    out1 = _out(PlanExecutor(p1, device=CPU)(env), g1)
    out2 = _out(PlanExecutor(p2, device=CPU)(env), g2)
    assert torch.equal(out1, torch.full((4, 4), 4.0))
    assert torch.equal(out2, torch.full((4, 4), 8.0))


def test_clear_compile_cache_forces_recompile():
    g, _ = tz.chain_graph()
    plan = compile_plan(g, CFG)
    first = compile_schedule(plan)
    clear_compile_cache()
    assert compile_schedule(plan) is not first


# -- dispatch & synchronization accounting -----------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_single_host_sync_per_run(name):
    g, make = tz.ALL_ZOO[name]()
    env = make(np.random.default_rng(0))
    plan = compile_plan(g, CFG)
    for kw in [dict(), dict(whole_plan=True), dict(fused=False)]:
        ex = PlanExecutor(plan, device=CPU, **kw)
        ex(env)
        assert ex.last_sync_count == 1, kw


@pytest.mark.parametrize("name", NAMES)
def test_counts_equal_jax(jx, name):
    """Dispatches and syncs of every mode, against the JAX executor's."""
    gt, make = tz.ALL_ZOO[name]()
    gj, make_j = jx.zoo[name]()
    pt, pj = compile_plan(gt, CFG), jx.core.compile_plan(gj, jx.cfg)
    env = make(np.random.default_rng(0))
    env_j = make_j(np.random.default_rng(0))
    for kw in [dict(mode="reference"), dict(mode="sequential"), dict(),
               dict(whole_plan=True), dict(fused=False),
               dict(profile=True)]:
        ext = PlanExecutor(pt, device=CPU, **kw)
        exj = jx.core.PlanExecutor(pj, **kw)
        ext(env)
        exj(env_j)
        assert ((ext.last_dispatch_count, ext.last_sync_count)
                == (exj.last_dispatch_count, exj.last_sync_count)), kw


def test_profile_mode_reinstates_layer_barriers():
    g, make = tz.diamond_graph()
    env = make(np.random.default_rng(0))
    plan = compile_plan(g, CFG)
    ex = PlanExecutor(plan, device=CPU, profile=True)
    ex(env)
    assert ex.last_sync_count == len(plan.schedule.layers) + 1


def test_dispatch_counts_per_strategy():
    g, make = tz.diamond_graph(width=8)    # wider than max_parallel=6
    env = make(np.random.default_rng(0))
    plan = compile_plan(g, CFG)
    n_layers = len(plan.schedule.layers)
    n_units = sum(len(sl.parallel_groups) + len(sl.sequential)
                  for sl in plan.schedule.layers)
    assert n_units > n_layers

    fused = PlanExecutor(plan, device=CPU)
    fused(env)
    assert fused.last_dispatch_count == n_layers
    whole = PlanExecutor(plan, device=CPU, whole_plan=True)
    whole(env)
    assert whole.last_dispatch_count == 1
    interp = PlanExecutor(plan, device=CPU, fused=False)
    interp(env)
    assert interp.last_dispatch_count == n_units
    assert whole.last_dispatch_count < fused.last_dispatch_count \
        < interp.last_dispatch_count


def test_donation_drops_dead_intermediates():
    """Chain graph: each layer's activation input dies at that layer; it is
    recorded as donatable, and a donating run still gives the oracle's
    result.  Params and graph inputs never are."""
    g, make = tz.chain_graph()
    plan = compile_plan(g, CFG)
    env = make(np.random.default_rng(0))
    ref = _out(PlanExecutor(plan, "reference", device=CPU)(env), g)
    ex = PlanExecutor(plan, device=CPU, donate=True)
    assert ex.compiled.donate
    caller_owned = set(g.inputs) | set(g.params)
    for cl in ex.compiled.layers:
        for i in cl.donate_argnums:
            assert cl.in_ids[i] not in caller_owned
            assert cl.in_ids[i] not in g.outputs
    assert torch.equal(_out(ex(env), g), ref)
    assert not PlanExecutor(plan, device=CPU).compiled.donate


def test_runresult_timings_cover_every_layer():
    g, make = tz.multihead_graph()
    env = make(np.random.default_rng(0))
    plan = compile_plan(g, CFG)
    res = PlanExecutor(plan, device=CPU)(env)
    assert len(res.layer_timings) == len(plan.schedule.layers)
    assert max(t.width for t in res.layer_timings) >= 2


def test_unknown_and_hetero_modes_raise():
    """An unknown mode raises, and so do the parallax-only knobs in
    ``parallax-hetero`` mode (the twin of JAX's
    ``test_hetero_rejects_parallax_only_knobs``)."""
    from repro_torch.core import HardwareProfile

    plan = compile_plan(tz.chain_graph()[0], CFG)
    with pytest.raises(ValueError, match="unknown mode"):
        PlanExecutor(plan, "threads", device=CPU)
    for kw in (dict(whole_plan=True), dict(fused=False), dict(donate=True)):
        with pytest.raises(ValueError, match="parallax-only"):
            PlanExecutor(plan, "parallax-hetero", device=CPU, **kw)
    perm = HardwareProfile("permissive", 0.0, 1.0, 1.0, 1.0)
    ex = PlanExecutor(plan, "parallax-hetero", device=CPU,
                      hetero_profile=perm)
    assert ex.hetero_stats is not None
    assert ex.hetero_stats.segments >= 1
    assert PlanExecutor(plan, device=CPU).hetero_stats is None


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_modes_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels.branch_matmul import launches

    g, make = tz.ALL_ZOO[name]()
    env = make(np.random.default_rng(7))
    plan = compile_plan(g, CFG)
    ref = _out(PlanExecutor(plan, "reference")(env), g)
    cpu = _out(PlanExecutor(plan, "reference", device=CPU)(env), g)
    # cuBLAS and the CPU sum in other orders; the chain's outputs reach
    # ~1e2 and some entries cancel to ~1e-1, so atol scales with the output
    torch.testing.assert_close(ref.cpu(), cpu, rtol=2e-5,
                               atol=2e-5 * float(cpu.abs().max()))
    for mode in sorted(MODES):
        ex = PlanExecutor(plan, **MODES[mode])
        before = launches["branch_matmul"]
        got = _out(ex(env), g)
        sites = (ex.compiled.stats.gemm_sites
                 if ex.compiled is not None and ex.compiled.use_branch_kernel
                 else 0)
        assert launches["branch_matmul"] - before == sites, mode
        if mode in KERNEL_OFF:
            assert torch.equal(got, ref), mode
        else:
            torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    arena = ArenaExecutor(plan)(env)[g.outputs[0]]
    assert torch.equal(arena, ref)
