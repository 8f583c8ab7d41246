"""Qwen2-VL (M-RoPE and vision-patch embeddings) against the JAX model.

``qwen2-vl-2b.reduced()`` (fp32, 2 layers, d_model 256, GQA 4/2 heads of
64, QKV biases, tied embeddings, M-RoPE sections (8, 12, 12), 8 stub
vision tokens), initialised by the JAX package and carried into the
port as numpy (``models/bridge.py``).  Inputs come from a numpy seed;
the frontend embeddings are JAX's stub draw, carried across as numpy
(a ``jax.random`` draw cannot be made in torch).

* ``apply_mrope`` against JAX's at the full (16, 24, 24) with head_dim
  128 and at the reduced (8, 12, 12) with head_dim 64, on three distinct
  streams; three equal streams give ``apply_rope``'s bits.
* ``stub_vision_frontend``'s ``positions3`` equal JAX's as integers.
* ``prefill_fn``'s logits and ``forward_lm``'s hidden states (8 vision
  tokens, then 8 text tokens) against JAX's; an M-RoPE config given no
  ``positions3`` raises with JAX's message.
* ``decode_fn`` over several steps on the dense cache with a scalar
  ``cache_len``, on a ring (a sliding window of 8 set on both sides),
  with a vector ``cache_len`` (ragged lengths, rows toggling
  ``active``) and on the paged pool, each with and without explicit
  ``positions3``: logits at every step and the caches at the end.
* ``loss_fn`` (labels of the text positions only) and every leaf of its
  gradient, normwise.
* ``params_from_numpy`` / ``numpy_from_params`` round-trip the QKV
  biases and the tied embedding bit for bit.
* ``ContinuousEngine`` (paged and dense) and ``ServingEngine`` at
  megastep 1 and 8 against the JAX engines, run in one child process
  shared by the engine cases (this file with ``--child``: bit-identical
  JAX streams need ``jax_cpu_enable_async_dispatch`` off, a process-wide
  switch): equal greedy streams and ``engine.dispatches``.  The engines
  pass no ``positions3``, as JAX's do, so they serve text prompts through
  the decode paths' broadcast; ``launch.serve`` serves the reduced config
  under each engine.

Tolerance rtol = atol = 2e-5 (the repository's fp32 one), on values and
on each gradient leaf's normwise distance: both sides compute in fp32 in
other orders.  The ``cuda``-marked cases hold the kernels against their
plain versions at Qwen2-VL's full-width shapes (GQA 12/2, D = 128) on
the card, bf16 also normwise within 5e-3 of the plain version evaluated
in fp32; they skip here.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import stub_vision_frontend  # noqa: E402
from repro_torch.models.common import (apply_mrope, apply_rope,  # noqa: E402
                                       rope_freqs)

ARCH = "qwen2-vl-2b"
TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 16                       # 8 vision tokens, 8 text tokens
WINDOW = 8                         # the ring case's sliding window
MAX_BATCH, BLOCK, MAX_CONTEXT = 3, 4, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's torch work (the backward pass
    of the loss case; see ``tests/test_torch_training.py``).  Restored
    after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qm():
    """The JAX model and the port's on one set of weights, JAX's stub
    frontend for B rows of S positions, and text tokens (JAX imported
    here, so that the card's machine, which has no JAX, still collects
    the ``cuda`` cases)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build_model
    from repro.models.model import stub_vision_frontend as jax_stub
    from repro_torch.models.bridge import params_from_numpy

    jcfg = jax_config(ARCH).reduced()
    japi = jax_build_model(jcfg)
    jp = japi.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    cfg = get_config(ARCH).reduced()
    emb, pos3 = jax_stub(jax.random.key(1), jcfg, B, S)
    n_front = cfg.num_frontend_tokens
    rng = np.random.default_rng(0)
    return types.SimpleNamespace(
        jax=jax, jcfg=jcfg, japi=japi, jp=jp, tree=tree, cfg=cfg,
        api=build_model(cfg, device="cpu"),
        p=params_from_numpy(cfg, tree, device="cpu"),
        emb=np.array(emb), pos3=np.array(pos3),
        tokens=rng.integers(0, cfg.vocab_size, (B, S - n_front))
        .astype(np.int32))


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# M-RoPE and the stub frontend
# --------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (64, (8, 12, 12))],
                         ids=["full", "reduced"])
def test_apply_mrope_matches_jax(head_dim, sections):
    """Three distinct streams (grid-like t, h, w ids), theta 1e6."""
    from repro.models.common import apply_mrope as jax_mrope

    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 12, 3, head_dim)).astype(np.float32)
    pos3 = rng.integers(0, 40, (3, 2, 12)).astype(np.int32)
    want = jax_mrope(x, pos3, sections, 1e6)
    inv = torch.from_numpy(rope_freqs(head_dim, 1e6))
    got = apply_mrope(torch.tensor(x), torch.tensor(pos3), sections, inv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="rotary half"):
        apply_mrope(torch.tensor(x), torch.tensor(pos3),
                    (sections[0] + 1,) + sections[1:], inv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (64, (8, 12, 12))],
                         ids=["full", "reduced"])
def test_equal_streams_are_rope_bit_for_bit(head_dim, sections, dtype):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 12, 3, head_dim))).to(dtype)
    pos = torch.tensor(rng.integers(0, 5000, (2, 12)).astype(np.int32))
    inv = torch.from_numpy(rope_freqs(head_dim, 1e6))
    got = apply_mrope(x, pos.expand(3, 2, 12), sections, inv)
    assert got.dtype == dtype
    assert torch.equal(got, apply_rope(x, pos, inv))


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_stub_vision_frontend_matches_jax(reduced):
    """The same integer positions as JAX's stub (a 32 x 32 grid at full
    width, text from 32 on); embeddings of the shape and dtype JAX's
    have, N(0, 1) * 0.02 drawn from the caller's generator."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_config
    from repro.models.model import stub_vision_frontend as jax_stub

    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    total = cfg.num_frontend_tokens + 24
    jemb, jpos = jax_stub(jax.random.key(0), jcfg, 2, total)
    emb, pos = stub_vision_frontend(torch.Generator().manual_seed(0), cfg,
                                    2, total)
    assert pos.dtype == torch.int32 and pos.shape == (3, 2, total)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert emb.shape == jemb.shape == (2, cfg.num_frontend_tokens,
                                       cfg.d_model)
    assert str(emb.dtype)[6:] == str(jemb.dtype) == cfg.dtype
    assert 0.015 < emb.float().std().item() < 0.025
    if not reduced:
        assert pos[:, 0, cfg.num_frontend_tokens].tolist() == [32, 32, 32]


# --------------------------------------------------------------------------
# prefill, forward and loss
# --------------------------------------------------------------------------

def test_prefill_and_hidden_states_match_jax(qm):
    from repro.models import transformer as jtr
    from repro_torch.kernels.flash_attention import launches
    from repro_torch.models import transformer

    batch = {"tokens": qm.tokens, "frontend_embeds": qm.emb,
             "positions3": qm.pos3}
    before = dict(launches)
    got = qm.api.prefill_fn(qm.p, _torch_batch(batch))
    assert launches == before                      # CPU: plain version
    assert got.shape == (B, qm.cfg.vocab_size)
    want = qm.japi.prefill_fn(qm.jp, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hidden, aux = transformer.forward_lm(
        qm.p, qm.cfg, torch.tensor(qm.tokens), torch.tensor(qm.emb),
        torch.tensor(qm.pos3))
    jhidden, jaux = jtr.forward_lm(qm.jp, qm.jcfg, qm.tokens, qm.emb,
                                   qm.pos3)
    assert hidden.shape == (B, S, qm.cfg.d_model)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), **TOL)
    assert float(aux) == float(jaux) == 0.0


def test_mrope_needs_positions3(qm):
    """Prefill and the loss refuse an M-RoPE config without positions3,
    with the message of JAX's assertion."""
    batch = {"tokens": qm.tokens, "frontend_embeds": qm.emb}
    with pytest.raises(AssertionError, match="3-stream") as want:
        qm.japi.prefill_fn(qm.jp, batch)
    with pytest.raises(ValueError) as got:
        qm.api.prefill_fn(qm.p, _torch_batch(batch))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="3-stream"):
        qm.api.loss_fn(qm.p, _torch_batch(dict(batch, labels=qm.tokens)))


def _leaf_errors(want, got):
    """{key path: normwise distance} over two trees of one structure."""
    jax = pytest.importorskip("jax")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    out = {}
    for (path, w), g in zip(flat_w, flat_g):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        assert w.shape == g.shape, jax.tree_util.keystr(path)
        out[jax.tree_util.keystr(path)] = (
            np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-30))
    return out


def test_loss_fn_and_grads_match_jax(qm):
    """Labels of the text positions only (the frontend carries no loss),
    row 0's first two masked; the gradient reaches every leaf."""
    import jax.numpy as jnp

    from repro_torch.models import bridge
    from repro_torch.training import loss_and_grads

    labels = np.random.default_rng(2).integers(
        0, qm.cfg.vocab_size, qm.tokens.shape).astype(np.int32)
    labels[0, :2] = -1
    batch = {"tokens": qm.tokens, "labels": labels,
             "frontend_embeds": qm.emb, "positions3": qm.pos3}
    (jloss, jm), jg = qm.jax.value_and_grad(
        lambda p: qm.japi.loss_fn(p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(qm.jp)
    params = bridge.params_from_numpy(qm.cfg, qm.tree, device="cpu")
    loss, metrics, grads = loss_and_grads(qm.api, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert metrics.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **TOL)
    errs = _leaf_errors(jg, bridge.numpy_from_params(qm.cfg, grads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL["rtol"], (worst, errs[worst])
    assert all(torch.count_nonzero(g) for g in grads.values())


def test_bridge_round_trip(qm):
    """The QKV biases cross, the tied embedding has no lm_head, and
    ``numpy_from_params`` gives back JAX's pytree bit for bit."""
    from repro_torch.models.bridge import numpy_from_params

    names = dict(qm.p.named_parameters())
    assert qm.p.lm_head is None and "lm_head" not in qm.tree
    for b in ("bq", "bk", "bv"):
        assert f"layers.0.attn.{b}" in names
    assert torch.count_nonzero(names["layers.1.attn.bk"]) == 0  # JAX: zeros
    back = numpy_from_params(qm.cfg, qm.p)
    assert qm.jax.tree.structure(back) == qm.jax.tree.structure(qm.tree)
    for a, b in zip(qm.jax.tree.leaves(qm.tree), qm.jax.tree.leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the decode step: dense scalar, ring, vector and paged
# --------------------------------------------------------------------------

def _explicit(rng, b):
    """Three distinct streams a step: (3, b, 1) int32 ids."""
    return rng.integers(0, 64, (3, b, 1)).astype(np.int32)


def _schedule(path, rng, explicit):
    """(batch, the numpy inputs of each step) of one decode path: every
    row at one position (scalar, ring; 14 steps wrap the ring's 8 slots)
    or ragged lengths with rows toggling ``active`` (vector, paged)."""
    scalar = path in ("scalar", "ring")
    b = 2 if scalar else 3
    lens = np.array([2, 0, 5], np.int32)
    out = []
    for s in range(14):
        batch = {"tokens": rng.integers(0, 512, (b, 1)).astype(np.int32)}
        if scalar:
            batch["cache_len"] = np.int32(s)
        else:
            active = np.array([True, not 5 <= s < 9, s % 4 != 3])
            batch.update(cache_len=lens.copy(), active=active)
            lens = lens + active
        if explicit:
            batch["positions3"] = _explicit(rng, b)
        out.append(batch)
    return b, out


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["broadcast", "explicit"])
@pytest.mark.parametrize("path", ["scalar", "ring", "vector", "paged"])
def test_decode_matches_jax(qm, path, explicit):
    """Logits at every step and the caches after the last.  Without
    ``positions3`` every path puts its rows' own positions on the three
    streams (the vector and paged rows sit at ragged lengths, so a
    scalar broadcast would show); with them, three distinct streams."""
    jax = qm.jax
    japi, api, p = qm.japi, qm.api, qm.p
    if path == "ring":                     # the same params, windowed
        from repro.models import build_model as jax_build_model

        japi = jax_build_model(dataclasses.replace(qm.jcfg,
                                                   sliding_window=WINDOW))
        api = build_model(dataclasses.replace(qm.cfg, sliding_window=WINDOW),
                          device="cpu")
    rng = np.random.default_rng(3)
    b, steps = _schedule(path, rng, explicit)
    tables = None
    if path == "paged":
        bpr = 6
        tables = rng.permutation(b * bpr).reshape(b, bpr).astype(np.int32)
        jcaches = japi.init_paged_caches(b, b * bpr, BLOCK, np.float32)
        tcaches = api.init_paged_caches(b, b * bpr, BLOCK)
    else:
        slots = 24
        jcaches = japi.init_caches(b, slots, np.float32, ring=path == "ring")
        tcaches = api.init_caches(b, slots, ring=path == "ring")
    jdecode = jax.jit(japi.decode_fn)
    for batch in steps:
        if tables is not None:
            batch = dict(batch, block_tables=tables)
        jl, jcaches = jdecode(qm.jp, jcaches, batch)
        tl, tcaches = api.decode_fn(p, tcaches, _torch_batch(batch))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    keys = ("k_pool", "v_pool") if path == "paged" else ("k", "v")
    period = jcaches["period"][0]
    for i, cache in enumerate(tcaches):
        for key in keys:
            want = np.asarray(period[key][i])
            got = cache[key].numpy()
            if path == "paged":                    # the scratch row aside
                want, got = want[:-1], got[:-1]
            np.testing.assert_allclose(got, want, **TOL)


def test_explicit_equal_positions3_change_nothing(qm):
    """One step with ``positions3`` equal to ``cache_len`` on every stream
    gives the bits of the step without them, on each path."""
    rng = np.random.default_rng(4)
    toks = torch.tensor(rng.integers(0, 512, (3, 1)).astype(np.int32))
    lens = torch.tensor([5, 0, 9], dtype=torch.int32)
    for path in ("scalar", "vector", "paged"):
        batch = {"tokens": toks, "cache_len": lens}
        same = lens[None, :, None].expand(3, 3, 1)
        if path == "scalar":
            batch["cache_len"] = 7
            same = torch.full((3, 3, 1), 7, dtype=torch.int32)
        if path == "paged":
            batch["block_tables"] = torch.arange(12, dtype=torch.int32
                                                 ).reshape(3, 4)
        outs = []
        for p3 in (None, same):
            caches = (qm.api.init_paged_caches(3, 12, BLOCK)
                      if path == "paged" else qm.api.init_caches(3, 16))
            step = batch if p3 is None else dict(batch, positions3=p3)
            outs.append(qm.api.decode_fn(qm.p, caches, step)[0])
        assert torch.equal(outs[0], outs[1]), path


# --------------------------------------------------------------------------
# the engines against JAX's (child process)
# --------------------------------------------------------------------------

ENGINES = [("paged", 1), ("paged", 8), ("dense", 1), ("dense", 8),
           ("round", None)]


def workload(vocab: int):
    """(id, prompt, max_new) triples: 5 mixed lengths, then 4 requests
    that share a 16-token prefix (the paged engine shares its blocks)."""
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, vocab, int(rng.integers(3, 14))),
             int(rng.integers(2, 9))) for i in range(5)]
    prefix = rng.integers(0, vocab, 16)
    reqs += [(5 + i, np.concatenate([prefix, rng.integers(0, vocab,
                                                          1 + i % 3)]),
              3 + (i * 5) % 9) for i in range(4)]
    return [(i, p.astype(np.int32), n) for i, p, n in reqs]


def _engine_config(cls_config, kind, megastep):
    kw = dict(hbm_budget=1 << 30, max_batch=MAX_BATCH, block_size=BLOCK,
              max_context=MAX_CONTEXT)
    if kind != "round":
        kw.update(megastep=megastep, paged=kind == "paged")
    return cls_config(**kw)


def child() -> None:
    """JAX reference: streams and dispatches of each engine."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax

    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build_model
    from repro.runtime.config import EngineConfig
    from repro.runtime.engine import (ContinuousEngine, Request,
                                      ServingEngine)
    from repro.runtime.stepper import Stepper

    cfg = jax_config(ARCH).reduced()
    api = jax_build_model(cfg)
    params = api.init(jax.random.key(0))
    stepper = Stepper(api)
    out = {}
    for kind, megastep in ENGINES:
        cls = ServingEngine if kind == "round" else ContinuousEngine
        eng = cls(api, params, stepper=stepper,
                  config=_engine_config(EngineConfig, kind, megastep))
        for i, prompt, max_new in workload(cfg.vocab_size):
            eng.submit(Request(i, prompt, max_new))
        done = eng.run()
        out[f"{kind}-{megastep}"] = {
            "streams": {str(k): v.tokens for k, v in done.items()},
            "dispatches": eng.dispatches}
    print(json.dumps(out))


@pytest.fixture(scope="module")
def jax_engines():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, "--child"],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_streams():
    """The port's runs of every engine, kept for the cases below."""
    return {}


@pytest.mark.parametrize("kind,megastep", ENGINES,
                         ids=[f"{k}-{n}" for k, n in ENGINES])
def test_engine_matches_jax(qm, jax_engines, port_streams, kind, megastep):
    from repro_torch.kernels.decode_attention import launches as da
    from repro_torch.kernels.paged_attention import launches as pa
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import (ContinuousEngine, Request,
                                            ServingEngine)

    cls = ServingEngine if kind == "round" else ContinuousEngine
    before = dict(da), dict(pa)
    eng = cls(qm.api, qm.p, device="cpu",
              config=_engine_config(EngineConfig, kind, megastep))
    for i, prompt, max_new in workload(qm.cfg.vocab_size):
        eng.submit(Request(i, prompt, max_new))
    done = eng.run()
    assert all(c.ok for c in done.values())
    if kind != "round":
        eng.assert_quiescent()
    assert (dict(da), dict(pa)) == before          # CPU: plain versions
    streams = {str(k): v.tokens for k, v in done.items()}
    ref = jax_engines[f"{kind}-{megastep}"]
    assert streams == ref["streams"]
    assert eng.dispatches == ref["dispatches"]
    if kind == "paged":
        assert eng.kv.shared_block_hits > 0
    port_streams[kind, megastep] = streams
    # one greedy stream across engines, megastep and the cache's layout
    assert all(s == streams for s in port_streams.values())


@pytest.mark.parametrize("engine,paged", [("continuous", True),
                                          ("continuous", False),
                                          ("round", True)],
                         ids=["paged", "no-paged", "round"])
def test_serve_entry_point_serves_qwen2_vl(engine, paged):
    """``launch.serve`` on the reduced config, as JAX's CLI serves it."""
    from repro_torch.launch.serve import serve

    done = serve(ARCH, n_requests=3, max_new=4, engine_mode=engine,
                 paged=paged, device="cpu")
    assert sorted(done) == [0, 1, 2] and all(c.ok for c in done.values())
    assert all(len(c.tokens) == 4 for c in done.values())


# --------------------------------------------------------------------------
# on the card: the kernels at Qwen2-VL's full-width shapes
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


CARD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 outputs are a few 1e-2 in the later causal rows, so the elementwise
# 2e-2 is about a value's size: bf16 is also held normwise to the plain
# version evaluated in fp32 on the same bf16 inputs
BF16_NORMWISE = 5e-3
H, K, D = 12, 2, 128               # qwen2-vl-2b: GQA 12/2, head_dim 128


def close_on_card(got, plain, *args):
    """``got`` against ``plain(*args)`` at ``CARD_TOL``; in bf16 also
    normwise within ``BF16_NORMWISE`` of ``plain`` evaluated in fp32 on
    the same values."""
    want = plain(*args)
    torch.cuda.synchronize()
    tol = CARD_TOL[got.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if got.dtype == torch.bfloat16:
        ref = plain(*(a.float() if a.is_floating_point() else a
                      for a in args))
        assert ((got.float() - ref).norm() / ref.norm()).item() \
            <= BF16_NORMWISE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_flash_attention_on_the_card(cuda, dtype):
    """B=2, S=T=2048 causal, the prefill_fn shape; two launches equal."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, H, 2048, D, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, K, 2048, D, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    close_on_card(got, lambda *a: flash_attention_plain(*a, causal=True),
                  q, k, v)
    assert torch.equal(got, flash_attention(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_on_the_card(cuda, dtype):
    """B=8 rows at ragged lengths through a 160-slot dense cache and the
    same K/V laid into a block pool: each kernel against its plain
    version, the two bit for bit, a row alone equal to its row in the
    batch; then ``paged_append`` at K=2, D=128 against its plain
    version, bit-exact."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_append, paged_append_plain, paged_decode_attention,
        paged_decode_attention_plain)

    Bc, T, bs = 8, 160, 16
    bpr = T // bs
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(Bc, H, D, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(Bc, T, K, D, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    lens = torch.randint(0, T, (Bc,), generator=gen, device=cuda,
                         dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32, device=cuda)
    got = decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), pos,
                           lens, tile=bs)
    close_on_card(got, decode_attention_plain, q, k.transpose(1, 2),
                  v.transpose(1, 2), pos, lens)
    tables = torch.randperm(Bc * bpr, generator=gen, device=cuda).reshape(
        Bc, bpr).int()
    pools = []
    for c in (k, v):
        pool = torch.zeros(Bc * bpr + 1, bs, K, D, dtype=dtype, device=cuda)
        pool[tables.long().reshape(-1)] = c.reshape(Bc * bpr, bs, K, D)
        pools.append(pool)
    paged = paged_decode_attention(q, *pools, tables, lens)
    close_on_card(paged, lambda q_, kp, vp: paged_decode_attention_plain(
        q_, kp, vp, tables, lens), q, *pools)
    assert torch.equal(paged, got)
    one = paged_decode_attention(q[3:4], *pools, tables[3:4], lens[3:4])
    assert torch.equal(one[0], paged[3])
    k_new, v_new = (torch.randn(Bc, 1, K, D, generator=gen, device=cuda)
                    .to(dtype) for _ in range(2))
    n_valid = torch.ones(Bc, dtype=torch.int32, device=cuda)
    n_valid[2] = 0
    want_pools = [p.clone() for p in pools]
    paged_append_plain(*want_pools, k_new, v_new, tables, lens, n_valid)
    paged_append(*pools, k_new, v_new, tables, lens, n_valid)
    for got_p, want_p in zip(pools, want_pools):
        assert torch.equal(got_p[:-1], want_p[:-1])


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    child()
