"""The MoE channel mix in the port against the JAX package.

Modules, on parameters initialised by the JAX package and carried across
as numpy (``bridge._load_module`` / ``params_from_numpy``):

* ``route`` (routing indices equal, weights, aux loss), ``moe_dense``
  and ``moe_ragged`` at E=8, k=2, where JAX takes ``jax.lax.ragged_dot``
  and the port buckets the pairs for ``branch_matmul`` (T up to one
  kernel tile, capacity T; and past it, capacity read from the routing)
  in fp32 and bf16;
* ``moe_branch_matmul`` against JAX's Pallas version in interpret mode
  at JAX's own cases (``tests/test_kernels_integration.py``): capacity
  factor E (nothing drops) and 0.25 (pairs drop) — the same pairs kept;
* the models: ``dbrx-132b.reduced()`` (4 experts: ``moe_dense``) and a
  kimi-like config (``kimi-k2-1t-a32b.reduced()`` with 8 experts and
  ``layer_offset=1``: a dense first layer, then ``moe_ragged`` with a
  shared expert) — ``prefill_fn`` logits, the forward's aux loss, and
  ``decode_fn`` logits on the dense and the paged caches;
* the DAG: ``export_decoder_graph`` (``_export_moe``) node by node
  against JAX's exporter, executed against the JAX oracle;
* the engines: the kimi-like model's streams and ``engine.dispatches``
  against the JAX engines, run in a child process (this file with
  ``--child``: bit-identical JAX streams need
  ``jax_cpu_enable_async_dispatch`` off, a process-wide switch).

``cuda`` cases hold ``moe_ragged``'s kernel path to its plain path and
a row's bits to its capacity, on the card.

Tolerances: fp32 2e-5 and bf16 2e-2, the repository's kernel
tolerances (``tests/test_kernels.py``).  Both sides sum the expert
products and the k contributions in other orders.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCHS = ("dbrx-132b", "kimi-like")
MAX_BATCH, BLOCK, MAX_CONTEXT = 3, 4, 32


def _config(configs, arch):
    """A reduced config from ``configs`` (the JAX or the port package)."""
    if arch == "kimi-like":
        cfg = configs.get_config("kimi-k2-1t-a32b").reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=8, layer_offset=1))
    return configs.get_config(arch).reduced()


def _moe_config(configs, E=8, k=2, d=64, f=32, shared=0):
    """One MoE layer's config, as ``tests/test_kernels_integration.py``."""
    return configs.ModelConfig(
        name="t", arch_type="moe", num_layers=1, d_model=d, num_heads=4,
        num_kv_heads=2, d_ff=0, vocab_size=7,
        moe=configs.MoEConfig(num_experts=E, num_experts_per_tok=k,
                              d_ff_expert=f, num_shared_experts=shared),
        dtype="float32")


def workload(vocab: int):
    """(id, prompt, max_new) triples of mixed lengths."""
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, vocab, int(rng.integers(3, 20)))
             .astype(np.int32), int(rng.integers(2, 10))) for i in range(7)]


# (key, engine, knobs)
RUNS = [
    ("paged-8", "continuous", dict(megastep=8)),
    ("paged-1-unshared", "continuous", dict(megastep=1,
                                            prefix_sharing=False)),
    ("dense-8", "continuous", dict(megastep=8, paged=False)),
    ("round-32", "round", dict()),
]


def _engine_config(EngineConfig, knobs):
    return EngineConfig(**{"hbm_budget": 1 << 30, "max_batch": MAX_BATCH,
                           "block_size": BLOCK, "max_context": MAX_CONTEXT,
                           **knobs})


def child() -> None:
    """JAX reference: streams and dispatches of every run in RUNS."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax

    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro import configs
    from repro.models import build_model
    from repro.runtime.config import EngineConfig
    from repro.runtime.engine import (ContinuousEngine, Request,
                                      ServingEngine)
    from repro.runtime.stepper import Stepper

    api = build_model(_config(configs, "kimi-like"))
    params = api.init(jax.random.key(0))
    stepper = Stepper(api)
    out = {}
    for key, engine, knobs in RUNS:
        cls = ServingEngine if engine == "round" else ContinuousEngine
        eng = cls(api, params, stepper=stepper,
                  config=_engine_config(EngineConfig, knobs))
        for i, prompt, max_new in workload(api.cfg.vocab_size):
            eng.submit(Request(i, prompt, max_new))
        done = eng.run()
        out[key] = {"streams": {str(k): v.tokens for k, v in done.items()},
                    "dispatches": eng.dispatches}
    print(json.dumps(out))


@pytest.fixture(scope="module")
def jax_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, "--child"],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def bridged():
    """arch -> (JAX api, JAX params, port api, port params)."""
    import jax

    from repro import configs as jax_configs
    from repro.models import build_model as jax_build_model
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models.bridge import params_from_numpy

    out = {}
    for arch in ARCHS:
        japi = jax_build_model(_config(jax_configs, arch))
        jparams = japi.init(jax.random.key(0))
        cfg = _config(configs, arch)
        tapi = build_model(cfg, device="cpu")
        tparams = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        out[arch] = (japi, jparams, tapi, tparams)
    return out


def _layer(E=8, k=2, d=64, f=32, shared=0, dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port MoE) for one layer."""
    import jax

    from repro import configs as jax_configs
    from repro.models.moe import init_moe
    from repro_torch import configs
    from repro_torch.models.bridge import _load_module
    from repro_torch.models.moe import MoE

    jcfg = _moe_config(jax_configs, E, k, d, f, shared)
    jparams = init_moe(jax.random.key(0), jcfg)
    cfg = _moe_config(configs, E, k, d, f, shared)
    moe = MoE(cfg, None, "cpu", getattr(torch, dtype))
    _load_module(moe, jax.tree.map(np.asarray, jparams), "moe")
    return jcfg, jparams, cfg, moe


def _tokens(T, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (T, d)).astype(np.float32)


# --------------------------------------------------------------------------
# the modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(8, 2), (16, 4), (4, 2)])
def test_route_matches_jax(E, k):
    from repro.models.moe import route as jax_route
    from repro_torch.models.moe import route

    jcfg, jparams, cfg, moe = _layer(E=E, k=k)
    x = _tokens(40, 64)
    jw, jidx, jaux = jax_route(jparams, jcfg, x)
    w, idx, aux = route(moe, cfg, torch.tensor(x))
    assert moe.router.dtype == torch.float32
    assert idx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **FP32)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)


def test_router_stays_fp32_in_a_bf16_model():
    import jax.numpy as jnp

    from repro.models.moe import route as jax_route
    from repro_torch.models.moe import route

    jcfg, jparams, cfg, moe = _layer(dtype="bfloat16")
    assert moe.router.dtype == torch.float32
    assert moe.w_gate.dtype == torch.bfloat16
    x = torch.tensor(_tokens(24, 64)).bfloat16()
    jw, jidx, _ = jax_route(jparams, jcfg, jnp.asarray(
        x.float().numpy(), dtype=jnp.bfloat16))
    w, idx, _ = route(moe, cfg, x)
    assert w.dtype == torch.bfloat16
    assert idx.tolist() == np.asarray(jidx).tolist()


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_dense_matches_jax(shared):
    from repro.models.moe import moe_dense as jax_dense
    from repro_torch.models.moe import moe_dense

    jcfg, jparams, cfg, moe = _layer(E=4, shared=shared)
    x = _tokens(24, 64)
    jy, jaux = jax_dense(jparams, jcfg, x)
    y, aux = moe_dense(moe, cfg, torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [5, 32, 80])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ragged_matches_jax(T, dtype, shared):
    """T=5 and 32: capacity T (one kernel tile); T=80: the largest group,
    rounded up to the tile.  Never an expert past its capacity."""
    import jax.numpy as jnp

    from repro.models.moe import moe_ragged as jax_ragged
    from repro_torch.kernels.branch_matmul import launches
    from repro_torch.models.moe import (CAPACITY_STEP, Buckets, moe_ragged,
                                        route)

    jcfg, jparams, cfg, moe = _layer(shared=shared, dtype=dtype)
    x = torch.tensor(_tokens(T, 64)).to(getattr(torch, dtype))
    jy, jaux = jax_ragged(jparams, jcfg, jnp.asarray(
        x.float().numpy(), dtype=dtype))
    before = dict(launches)
    y, aux = moe_ragged(moe, cfg, x)
    assert launches == before                      # CPU: plain version
    assert y.dtype == x.dtype
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy).astype(np.float32), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)
    b = Buckets(route(moe, cfg, x)[1], cfg.moe.num_experts)
    assert bool(b.keep.all())
    assert b.cap == (T if T <= CAPACITY_STEP
                     else -(-int(b.counts.max()) // CAPACITY_STEP)
                     * CAPACITY_STEP)
    assert int(b.counts.sum()) == T * cfg.moe.num_experts_per_tok


@pytest.mark.parametrize("T", [5, 32, 80])
def test_expert_ffn_with_counts_matches_jax_ragged(T):
    """The port's expert GEMMs on a routing's buckets with its counts
    against JAX's ``_expert_ffn_ragged`` (``jax.lax.ragged_dot`` with the
    same counts as ``group_sizes``) on the same routed rows, packed
    expert after expert; the bucket rows past the counts are zeros."""
    import jax.numpy as jnp

    from repro.models.moe import _expert_ffn_ragged
    from repro_torch.models.moe import Buckets, expert_ffn, route

    jcfg, jparams, cfg, moe = _layer(E=8, k=2)
    x = torch.tensor(_tokens(T, 64))
    b = Buckets(route(moe, cfg, x)[1], cfg.moe.num_experts)
    counts = b.counts.clamp(max=b.cap).int()
    yb = expert_ffn(moe, b.gather(x), counts)
    rows = b.src[b.valid].numpy()          # expert by expert, slot order
    want = _expert_ffn_ragged(jparams, jnp.asarray(x.numpy()[rows]),
                              jnp.asarray(counts.numpy()), jnp.float32)
    np.testing.assert_allclose(yb[b.valid].numpy(), np.asarray(want),
                               **FP32)
    assert not yb[~b.valid].any()


def test_moe_ragged_passes_counts_to_its_three_launches(monkeypatch):
    """``moe_ragged`` hands each of its three GEMMs the experts' row
    counts clamped to the capacity; ``moe_branch_matmul`` (JAX's Pallas
    path has no counts) hands none."""
    from repro_torch.kernels.branch_matmul import branch_matmul_plain
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.moe_pallas import moe_branch_matmul

    seen = []

    def recording(x, w, counts=None):
        seen.append(counts)
        return branch_matmul_plain(x, w, counts)

    monkeypatch.setattr(moe_mod, "branch_matmul", recording)
    _, _, cfg, moe = _layer(E=8, k=2)
    x = torch.tensor(_tokens(40, 64))
    moe_mod.moe_ragged(moe, cfg, x)
    b = moe_mod.Buckets(moe_mod.route(moe, cfg, x)[1], cfg.moe.num_experts)
    assert len(seen) == 3
    for counts in seen:
        assert counts.dtype == torch.int32
        assert torch.equal(counts, b.counts.clamp(max=b.cap).int())
    seen.clear()
    moe_branch_matmul(moe, cfg, x, capacity_factor=0.25)
    assert seen == [None, None, None]


def test_buckets_follow_jax_positions():
    """Each pair's slot is its rank among its expert's pairs in token
    order (JAX's cumsum of one-hots); every slot holds the token that
    routed there."""
    from repro_torch.models.moe import Buckets

    rng = np.random.default_rng(0)
    T, k, E = 37, 3, 6
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    flat = idx.reshape(-1)
    onehot = np.eye(E, dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, 0) * onehot).sum(-1) - 1).reshape(T, k)
    b = Buckets(torch.tensor(idx), E, 9)
    assert b.pos.tolist() == pos.tolist()
    assert b.keep.tolist() == (pos < 9).tolist()
    for e in range(E):
        toks = [p // k for p in range(T * k) if flat[p] == e][:9]
        assert b.src[e, :len(toks)].tolist() == toks
        assert b.valid[e].tolist() == [i < len(toks) for i in range(9)]


@pytest.mark.parametrize("E,k,T,d,f", [
    (4, 2, 24, 64, 32),
    (8, 2, 16, 32, 64),
    (2, 1, 12, 32, 32),
])
def test_moe_branch_matmul_matches_jax_without_drops(E, k, T, d, f):
    """Capacity factor E: nothing drops; equal to JAX's Pallas version
    (interpret mode) and to the port's moe_ragged."""
    from repro.models.moe_pallas import moe_branch_matmul as jax_bm
    from repro_torch.models.moe import moe_ragged
    from repro_torch.models.moe_pallas import moe_branch_matmul

    jcfg, jparams, cfg, moe = _layer(E=E, k=k, d=d, f=f)
    x = _tokens(T, d)
    jy, jaux = jax_bm(jparams, jcfg, x, capacity_factor=float(E),
                      interpret=True, block_m=8, block_n=32, block_k=32)
    y, aux = moe_branch_matmul(moe, cfg, torch.tensor(x),
                               capacity_factor=float(E))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)
    ragged, _ = moe_ragged(moe, cfg, torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), ragged.numpy(), **FP32)


@pytest.mark.parametrize("E,k,T", [(2, 2, 64), (8, 2, 48)])
def test_moe_branch_matmul_drops_as_jax(E, k, T):
    """Capacity factor 0.25: the pairs past each expert's capacity drop —
    the same pairs as JAX's (its cumsum positions), so the outputs agree;
    dropping never invents a contribution."""
    import jax.numpy as jnp

    from repro.models.moe import route as jax_route
    from repro.models.moe_pallas import moe_branch_matmul as jax_bm
    from repro_torch.models.moe import Buckets, route
    from repro_torch.models.moe_pallas import moe_branch_matmul

    jcfg, jparams, cfg, moe = _layer(E=E, k=k)
    x = _tokens(T, 64)
    jy, _ = jax_bm(jparams, jcfg, x, capacity_factor=0.25, interpret=True,
                   block_m=8, block_n=32, block_k=32)
    y, _ = moe_branch_matmul(moe, cfg, torch.tensor(x),
                             capacity_factor=0.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
    full, _ = moe_branch_matmul(moe, cfg, torch.tensor(x),
                                capacity_factor=4.0)
    assert torch.isfinite(y).all()
    assert float(y.abs().sum()) <= float(full.abs().sum()) + 1e-3
    # JAX's keep mask, from its own routing and cumsum rule
    cap = max(int(T * k * 0.25 / E), 1)
    cap += (-cap) % 8
    _, jidx, _ = jax_route(jparams, jcfg, x)
    flat = np.asarray(jidx).reshape(-1)
    onehot = np.asarray(jnp.eye(E, dtype=jnp.int32))[flat]
    jpos = (np.cumsum(onehot, 0) * onehot).sum(-1) - 1
    b = Buckets(route(moe, cfg, torch.tensor(x))[1], E, cap)
    assert b.keep.reshape(-1).tolist() == (jpos < cap).tolist()
    assert 0 < int(b.keep.sum()) < T * k


def test_moe_impl_follows_jax():
    from repro.models.model import _moe_impl_for as jax_impl
    from repro_torch import configs
    from repro_torch.models.model import _moe_impl_for

    for arch in ("dbrx-132b", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
                 "stablelm-3b"):
        for cfg in (configs.get_config(arch),
                    configs.get_config(arch).reduced()):
            for distributed in (False, True):
                assert _moe_impl_for(cfg, distributed) \
                    == jax_impl(cfg, distributed)
    # a one-rank moe_ep (in a child process: a process group is
    # process-global) equals moe_ragged on a dropless input
    proc = subprocess.run(
        [sys.executable, "-c", _ONE_RANK_EP % os.path.dirname(__file__)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "equal"


_ONE_RANK_EP = """
import sys
sys.path.insert(0, %r)
import torch
from test_torch_moe import _layer, _tokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as m
_, _, cfg, layer = _layer()
x = torch.tensor(_tokens(5, cfg.d_model))
y, aux = m.moe_ep(layer, cfg, x, make_host_mesh(backend="gloo"))
y2, aux2 = m.moe_ragged(layer, cfg, x)
assert torch.equal(y, y2) and torch.equal(aux, aux2)
print("equal")
"""


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

def test_blocks_and_params(bridged):
    _, _, dbrx_api, dbrx = bridged["dbrx-132b"]
    assert [layer.kind for layer in dbrx.layers] == [("attn", "moe")] * 2
    assert dbrx.layers[0].moe.shared is None
    _, _, kimi_api, kimi = bridged["kimi-like"]
    assert [layer.kind for layer in kimi.layers] == [("attn", "dense"),
                                                     ("attn", "moe")]
    moe = kimi.layers[1].moe
    assert moe.shared.w_gate.shape == (256, 128)
    assert moe.w_gate.shape == (8, 256, 128)
    assert moe.w_down.shape == (8, 128, 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(bridged, arch):
    from repro.models.transformer import forward_lm as jax_forward
    from repro_torch.kernels.branch_matmul import launches
    from repro_torch.models.model import _moe_impl_for
    from repro_torch.models.transformer import forward_lm

    japi, jparams, tapi, tparams = bridged[arch]
    tokens = np.random.default_rng(1).integers(
        0, tapi.cfg.vocab_size, (2, 24)).astype(np.int32)
    before = dict(launches)
    got = tapi.prefill_fn(tparams, {"tokens": torch.tensor(tokens)})
    assert launches == before                      # CPU: plain version
    want = japi.prefill_fn(jparams, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    impl = _moe_impl_for(tapi.cfg, False)
    assert impl == ("dense" if arch == "dbrx-132b" else "ragged")
    _, aux = forward_lm(tparams, tapi.cfg, torch.tensor(tokens),
                        moe_impl=impl)
    _, jaux = jax_forward(jparams, japi.cfg, tokens, moe_impl=impl,
                          remat=False)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)


def _jax_layers(jcaches, n_layers):
    """JAX caches (prefix list + stacked period) -> one dict per layer."""
    import jax

    layers = list(jcaches["prefix"])
    period = jcaches["period"]
    n_rep = (n_layers - len(layers)) // len(period)
    for r in range(n_rep):
        for c in period:
            layers.append(jax.tree.map(lambda a, r=r: np.asarray(a[r]), c))
    return layers


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(bridged, arch, paged):
    """Per-row cache_len and rows switching inactive (every row is routed,
    as in JAX), on the dense or the paged caches: logits at every step,
    the K/V caches at the end (paged pools without the scratch row)."""
    import jax

    japi, jparams, tapi, tparams = bridged[arch]
    B, slots, bs, steps = 3, 16, 4, 10
    rng = np.random.default_rng(2)
    batch = {}
    if paged:
        nb = B * slots // bs
        batch["block_tables"] = rng.permutation(nb).reshape(
            B, slots // bs).astype(np.int32)
        jcaches = japi.init_paged_caches(B, nb, bs, np.float32)
        tcaches = tapi.init_paged_caches(B, nb, bs)
    else:
        jcaches = japi.init_caches(B, slots, np.float32)
        tcaches = tapi.init_caches(B, slots)
    jdecode = jax.jit(japi.decode_fn)
    lens = np.array([2, 0, 1], np.int32)
    for s in range(steps):
        active = np.array([True, not 3 <= s < 6, s % 4 != 3])
        batch.update(tokens=rng.integers(0, 512, (B, 1)).astype(np.int32),
                     cache_len=lens.copy(), active=active)
        jl, jcaches = jdecode(jparams, jcaches, batch)
        tl, tcaches = tapi.decode_fn(
            tparams, tcaches, {k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
        lens += active
    for t, j in zip(tcaches, _jax_layers(jcaches, tapi.cfg.num_layers)):
        for key in ("k_pool", "v_pool") if paged else ("k", "v"):
            got, want = t[key].numpy(), np.asarray(j[key])
            if paged:
                got, want = got[:-1], want[:-1]
            np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("arch", ARCHS)
def test_export_moe_matches_jax(bridged, arch):
    """Node names, op classes, flops and ``supported`` flags equal JAX's:
    per MoE layer an unsupported router node, E gate-up -> down chains
    and a combine; the graph's logits match the JAX oracle's and the
    planner's reference and parallax modes equal the port's oracle."""
    import jax

    from repro.models.dag_export import export_graph as jax_export
    from repro_torch.core import ParallaxConfig, PlanExecutor, compile_plan
    from repro_torch.core.executor import to_device
    from repro_torch.core.scheduler import DEFAULT_MAX_PARALLEL
    from repro_torch.models.dag_export import export_decoder_graph

    japi, jparams, tapi, tparams = bridged[arch]
    cfg = tapi.cfg
    gj, make_j = jax_export(japi.cfg, jparams, 1, 12)
    gt, make_t = export_decoder_graph(cfg, tparams, 1, 12)

    def nodes(g):
        return [(n.name, n.op_class, n.flops, n.supported)
                for n in g.nodes.values()]

    assert nodes(gt) == nodes(gj)
    names = [n.name for n in gt.nodes.values()]
    E = cfg.moe.num_experts
    for i in range(cfg.num_layers):
        if cfg.is_moe_layer(i):
            assert f"L{i}.router" in names and f"L{i}.moe_combine" in names
            assert sum(n.startswith(f"L{i}.e") for n in names) == 2 * E
    routers = [n for n in gt.nodes.values() if n.name.endswith(".router")]
    assert routers and not any(n.supported for n in routers)
    env = to_device(make_t(np.random.default_rng(0)), "cpu")
    oracle = gt.execute(env)[gt.outputs[0]]
    want = gj.execute(make_j(np.random.default_rng(0)))[gj.outputs[0]]
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), **FP32)
    plan = compile_plan(gt, ParallaxConfig(budget=1 << 30))
    # the expert chains run as parallel branches, up to the schedule's cap
    assert plan.schedule.max_width() == min(E, DEFAULT_MAX_PARALLEL)
    for mode in ("reference", "parallax"):
        out = PlanExecutor(plan, mode, device="cpu")(env).outputs[
            gt.outputs[0]]
        assert torch.equal(out, oracle), mode


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------

def _serve(api, params, engine, **knobs):
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import (ContinuousEngine, Request,
                                            ServingEngine)

    cls = ServingEngine if engine == "round" else ContinuousEngine
    eng = cls(api, params, config=_engine_config(EngineConfig, knobs),
              device="cpu")
    for i, prompt, max_new in workload(api.cfg.vocab_size):
        eng.submit(Request(i, prompt, max_new))
    done = eng.run()
    assert all(c.ok for c in done.values())
    if engine != "round":
        eng.assert_quiescent()
    return {str(k): v.tokens for k, v in done.items()}, eng


def test_engines_match_jax(jax_reference, bridged):
    """The kimi-like model (a dense layer, then an 8-expert layer with a
    shared expert) through every run of RUNS: streams and dispatches
    equal to the JAX engines'; within the port, paged and dense,
    megastep 8 and 1, sharing on and off and the round engine agree."""
    _, _, api, params = bridged["kimi-like"]
    streams = {}
    for key, engine, knobs in RUNS:
        got, eng = _serve(api, params, engine, **knobs)
        ref = jax_reference[key]
        assert got == ref["streams"], key
        assert eng.dispatches == ref["dispatches"], key
        streams[key] = got
    for key, _, _ in RUNS[1:]:
        assert streams[key] == streams["paged-8"], key


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.device import deterministic

    deterministic()
    return torch.device("cuda")


def _card_layer(card, dtype, E=8, k=2, d=256, f=128, shared=1):
    from repro_torch import configs
    from repro_torch.models.moe import MoE

    cfg = _moe_config(configs, E, k, d, f, shared)
    moe = MoE(cfg, torch.Generator(device=card).manual_seed(0), card,
              getattr(torch, dtype))
    return cfg, moe


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [8, 40, 300])
def test_moe_ragged_kernel_matches_plain_on_the_card(card, monkeypatch, T,
                                                     dtype):
    from repro_torch.kernels.branch_matmul import (branch_matmul_plain,
                                                   launches)
    from repro_torch.models import moe as moe_mod

    cfg, moe = _card_layer(card, dtype)
    x = torch.tensor(_tokens(T, 256), device=card).to(getattr(torch,
                                                             dtype))
    before = launches["branch_matmul"]
    got, aux = moe_mod.moe_ragged(moe, cfg, x)
    assert launches["branch_matmul"] == before + 3
    monkeypatch.setattr(moe_mod, "branch_matmul", branch_matmul_plain)
    want, aux_plain = moe_mod.moe_ragged(moe, cfg, x)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(aux, aux_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_bit_identical_across_capacity_on_the_card(card, dtype):
    """A token's output does not depend on the bucket capacity, nor on
    the other tokens routed beside it: the kernel sums each output in
    one FMA chain, whatever the tile."""
    from repro_torch.models.moe import Buckets, expert_ffn, route

    cfg, moe = _card_layer(card, dtype, E=16, k=4, d=512, f=320)
    x = torch.tensor(_tokens(24, 512), device=card).to(getattr(torch,
                                                              dtype))
    w, idx, _ = route(moe, cfg, x)
    outs = []
    for cap in (24, 24 + 37, 160):
        b = Buckets(idx, cfg.moe.num_experts, cap)
        outs.append(b.combine(expert_ffn(moe, b.gather(x)), w, x.dtype))
    b = Buckets(idx[:5], cfg.moe.num_experts, 5)
    alone = b.combine(expert_ffn(moe, b.gather(x[:5])), w[:5], x.dtype)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert torch.equal(alone, outs[0][:5])


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    child()
