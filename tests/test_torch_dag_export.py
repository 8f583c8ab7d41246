"""The port's model -> DAG exporter against the JAX exporter.

``stablelm-3b`` reduced (2 layers, d_model 256; the decoder graph),
``whisper-tiny`` reduced (2 encoder layers, d_model 256; the encoder
graph) and ``qwen2-vl-2b`` reduced (GQA 4/2, QKV biases, tied
embeddings, M-RoPE sections; the decoder graph): the JAX model's params
are bridged into the port's ``LM`` / ``EncDec`` (``models/bridge.py``,
fp32), both packages export the graph at batch 1, seq 16, and the
graphs must agree node by node (names, op classes, flops, supported
flags) and in their outputs (logits; the encoder's final hidden
states).  Tolerance rtol = atol = 2e-5: the same fp32 arithmetic in
other summation orders (measured max abs difference 1.4e-6 on stablelm
logits of magnitude 1.2, on the CPU).  Whisper's graph is held to JAX's
graph, not to ``encode``: JAX's encoder graph reuses the decoder's
attention chains (RoPE node, causal mask), which the model's
bidirectional encoder does not have.  Qwen2-VL's graph is held to JAX's
graph too, not to ``forward_lm``: JAX's exporter builds it from tokens
only, with plain RoPE by position, no QKV bias and no frontend.  The
port's graph then runs through the §3 planner and every executor mode,
bit-identical to its own oracle: these DAGs have no pure-matmul group,
so no mode reaches the grouped kernel.
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


@pytest.fixture(scope="module",
                params=[ARCH, "whisper-tiny", "qwen2-vl-2b"])
def pair(request):
    """(JAX graph, JAX inputs, port graph, port inputs) on one set of
    weights; ``width`` is the output's last dimension."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_config
    from repro.models import build_model
    from repro.models.dag_export import export_graph as jax_export
    from repro_torch.models.bridge import params_from_numpy

    jcfg = jax_config(request.param).reduced()
    params = build_model(jcfg).init(jax.random.key(0))
    gj, make_j = jax_export(jcfg, params, BATCH, SEQ)
    cfg = get_config(request.param).reduced()
    lm = params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                           device="cpu", dtype="float32")
    if cfg.is_encoder_decoder:
        gt, make_t = export_encoder_graph(cfg, lm, BATCH, SEQ)
        width = cfg.d_model
    else:
        gt, make_t = export_decoder_graph(cfg, lm, BATCH, SEQ)
        width = cfg.vocab_size
    return SimpleNamespace(gj=gj, make_j=make_j, gt=gt, make_t=make_t,
                           cfg=cfg, lm=lm, width=width)


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
    assert got.shape == (BATCH, SEQ, pair.width)
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
    # the Whisper encoder graph has landed (the parametrised cases above
    # hold it to JAX's), and so has its training half (tests/
    # test_torch_training.py holds the loss and its gradient to JAX's):
    # api.loss_fn is encdec_loss over decode_train's hidden states
    from repro_torch.models import build_model, encdec

    cfg = get_config("whisper-tiny").reduced()
    api = build_model(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0))
    g, _ = export_graph(cfg, model, 1, 16)
    assert g.outputs and "enc_final" in [n.name for n in g.nodes.values()]
    frames = torch.zeros(1, cfg.encoder_seq, cfg.d_model)
    toks = torch.zeros(1, 4, dtype=torch.int32)
    with torch.no_grad():
        loss, metrics = api.loss_fn(
            model, {"frames": frames, "tokens": toks, "labels": toks})
        hidden = encdec.decode_train(model, cfg, toks,
                                     encdec.encode(model, cfg, frames))
        assert torch.equal(loss, encdec.encdec_loss(model, cfg, frames, toks,
                                                    toks)[0])
    assert torch.isfinite(loss) and metrics == {"ce": loss}
    assert hidden.shape == (1, 4, cfg.d_model)
    # MoE blocks have landed (tests/test_torch_moe.py holds them to JAX):
    # node by node equal to the JAX exporter's on a reduced MoE config
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build_model
    from repro.models.dag_export import export_graph as jax_export
    from repro_torch.models.bridge import params_from_numpy

    japi = jax_build_model(jax_config("dbrx-132b").reduced())
    jparams = japi.init(jax.random.key(0))
    moe = get_config("dbrx-132b").reduced()
    lm = params_from_numpy(moe, jax.tree.map(np.asarray, jparams),
                           device="cpu")
    gj, _ = jax_export(japi.cfg, jparams, 1, 16)
    gt, _ = export_graph(moe, lm, 1, 16)
    assert [(n.name, n.op_class, n.flops, n.supported)
            for n in gt.nodes.values()] == [
        (n.name, n.op_class, n.flops, n.supported)
        for n in gj.nodes.values()]
    routers = [n for n in gt.nodes.values() if n.name.endswith(".router")]
    assert len(routers) == moe.num_layers
    assert not any(n.supported for n in routers)
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
