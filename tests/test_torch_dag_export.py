"""The port's model -> DAG exporter against the JAX exporter.

``stablelm-3b`` reduced (2 layers, d_model 256): the JAX model's params
are bridged into the port's ``LM`` (``models/bridge.py``, fp32), both
packages export the graph at batch 1, seq 16, and the graphs must agree
node by node (names, op classes, flops, supported flags) and in their
logits.  Tolerance rtol = atol = 2e-5: the same fp32 arithmetic in other
summation orders (measured max abs difference 1.4e-6 on logits of
magnitude 1.2, on the CPU).  The port's graph then runs through the
§3 planner and every executor mode, bit-identical to its own oracle:
this DAG has no pure-matmul group, so no mode reaches the grouped kernel.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ArenaExecutor, ParallaxConfig,  # noqa: E402
                              PlanExecutor, compile_plan, compile_schedule)
from repro_torch.models.dag_export import (export_decoder_graph,  # noqa: E402
                                           export_encoder_graph,
                                           export_graph)

CFG = ParallaxConfig(budget=1 << 30)
ARCH, BATCH, SEQ = "stablelm-3b", 1, 16


@pytest.fixture(scope="module")
def pair():
    """(JAX graph, JAX inputs, port graph, port inputs) on one set of
    weights."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_config
    from repro.models import build_model
    from repro.models.dag_export import export_graph as jax_export
    from repro_torch.models.bridge import params_from_numpy

    jcfg = jax_config(ARCH).reduced()
    params = build_model(jcfg).init(jax.random.key(0))
    gj, make_j = jax_export(jcfg, params, BATCH, SEQ)
    cfg = get_config(ARCH).reduced()
    lm = params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                           device="cpu", dtype="float32")
    gt, make_t = export_decoder_graph(cfg, lm, BATCH, SEQ)
    return SimpleNamespace(gj=gj, make_j=make_j, gt=gt, make_t=make_t,
                           cfg=cfg, lm=lm)


def _nodes(g):
    return [(n.name, n.op_class, n.flops, n.supported, len(n.inputs),
             len(n.outputs)) for n in g.nodes.values()]


def test_graph_matches_jax_node_by_node(pair):
    assert _nodes(pair.gt) == _nodes(pair.gj)
    assert len(pair.gt.inputs) == len(pair.gj.inputs)
    assert len(pair.gt.params) == len(pair.gj.params)
    for tj, tt in zip(pair.gj.tensors.values(), pair.gt.tensors.values()):
        assert (tt.name, tt.spec.shape, tt.spec.dtype) \
            == (tj.name, tj.spec.shape, tj.spec.dtype)


def test_logits_match_jax(pair):
    env_j = pair.make_j(np.random.default_rng(0))
    ref = np.asarray(pair.gj.execute(env_j)[pair.gj.outputs[0]])
    env_t = pair.make_t(np.random.default_rng(0))
    assert np.array_equal(env_t[pair.gt.inputs[0]], env_j[pair.gj.inputs[0]])
    got = PlanExecutor(compile_plan(pair.gt, CFG), "reference",
                       device="cpu")(env_t).outputs[pair.gt.outputs[0]]
    assert got.shape == (BATCH, SEQ, pair.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_plan_matches_jax(pair):
    from repro.core import ParallaxConfig as JaxConfig
    from repro.core import compile_plan as jax_compile_plan

    pj = jax_compile_plan(pair.gj, JaxConfig(budget=1 << 30))
    pt = compile_plan(pair.gt, CFG)
    assert ({b: br.nodes for b, br in pt.branches.items()}
            == {b: br.nodes for b, br in pj.branches.items()})
    assert [(sl.parallel_groups, sl.sequential) for sl in pt.schedule.layers] \
        == [(sl.parallel_groups, sl.sequential) for sl in pj.schedule.layers]
    assert pt.sum_arena_sizes() == pj.sum_arena_sizes()
    assert pt.schedule.max_width() >= 2          # the heads are grouped


@pytest.mark.parametrize("kw", [dict(mode="sequential"), dict(),
                                dict(whole_plan=True), dict(fused=False)],
                         ids=["sequential", "fused", "whole-plan",
                              "interpreted"])
def test_modes_are_bit_identical_to_the_oracle(pair, kw):
    plan = compile_plan(pair.gt, CFG)
    assert compile_schedule(plan).stats.gemm_sites == 0
    env = pair.make_t(np.random.default_rng(1))
    out = pair.gt.outputs[0]
    ref = PlanExecutor(plan, "reference", device="cpu")(env).outputs[out]
    ex = PlanExecutor(plan, device="cpu", **kw)
    assert torch.equal(ex(env).outputs[out], ref)
    assert ex.last_sync_count == (len(plan.schedule.layers) + 1
                                  if kw.get("mode") == "sequential" else 1)


def test_arena_executor_matches_the_oracle(pair):
    plan = compile_plan(pair.gt, CFG)
    env = pair.make_t(np.random.default_rng(2))
    out = pair.gt.outputs[0]
    ref = PlanExecutor(plan, "reference", device="cpu")(env).outputs[out]
    assert torch.equal(ArenaExecutor(plan, device="cpu")(env)[out], ref)


def test_flops_cfg_scales_metadata_not_topology():
    from repro_torch.models import build_model

    full = get_config(ARCH)
    small = full.structural()
    lm = build_model(small, device="cpu").init(torch.Generator()
                                               .manual_seed(0))
    g1, _ = export_graph(small, lm, 1, 16)
    g2, _ = export_graph(small, lm, 1, 16, flops_cfg=full)
    assert g1.num_nodes() == g2.num_nodes()
    assert g2.total_flops() > 100 * g1.total_flops()


def test_later_slices_raise():
    cfg = get_config("whisper-tiny")
    with pytest.raises(NotImplementedError, match="Whisper slice"):
        export_graph(cfg, None, 1, 16)
    with pytest.raises(NotImplementedError, match="Whisper slice"):
        export_encoder_graph(cfg, None, 1, 16)
    from repro_torch.models import dag_export

    with pytest.raises(NotImplementedError, match="MoE slice"):
        dag_export._export_moe(None, cfg, None, None, 0, 1, 16)
    # Mamba2 mixers have landed (tests/test_torch_mamba.py holds them to
    # the JAX exporter): four nodes a layer, the scan a fallback node
    from repro_torch.models import build_model

    mamba = get_config("mamba2-370m").reduced()
    lm = build_model(mamba, device="cpu").init(
        torch.Generator().manual_seed(0))
    g, _ = export_graph(mamba, lm, 1, 16)
    names = [n.name for n in g.nodes.values()]
    for i in range(mamba.num_layers):
        for part in ("in_proj", "conv", "ssd_scan", "out_proj"):
            assert f"L{i}.{part}" in names
    assert [n.name for n in g.nodes.values() if not n.supported] == \
        [f"L{i}.ssd_scan" for i in range(mamba.num_layers)]
