"""The dense-cache serving path and full-sequence prefill against JAX.

Models: ``stablelm-3b.reduced()`` (MHA, fp32, 2 layers, d_model 256),
``h2o-danube-3-4b.reduced()`` (sliding window 16; ``reduced()`` keeps
4 KV heads for 4 query heads) and the same with 2 KV heads (GQA),
initialised by the JAX package and bridged into the port as numpy.

* ``prefill_fn`` — last-token logits of a 24-token prompt (past the
  window) against JAX's.
* the dense ``decode_fn`` — the vector path (per-row ``cache_len``, rows
  switching inactive) and the scalar path (one position for all rows;
  on a ring cache that wraps for the windowed model) against JAX's,
  logits at every step and the caches at the end.
* within the port, ``prefill_fn`` against step-by-step dense decode of
  the same prompt.
* the engines: ``ServingEngine`` and ``ContinuousEngine(paged=False)``
  at megastep 1 and 8 against the JAX engines, run in a child process
  (this file with ``--child``: bit-identical JAX streams need
  ``jax_cpu_enable_async_dispatch`` off, a process-wide switch) — equal
  greedy streams and equal ``engine.dispatches``; within the port,
  dense, paged and round streams identical.  The round engine runs with
  the continuous engine's ``max_context``, as the JAX identity test
  does: on the CPU the plain attention reduces over the whole cache
  width, so only equal widths give equal bits (on the card the kernels
  stop at each row's length; ``chip_smoke.py`` checks the dynamic
  width there).  A dynamically sized round (``max_context=None``) is
  held to JAX's dispatch count and streams as well.

``LOGIT_TOL``: both sides compute in fp32 with other reduction orders
(the port attends through the kernels' plain versions, the JAX model
through masked softmax over the cache); the repository's fp32 kernel
tolerance, 2e-5, holds with a margin at these sizes.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("stablelm-3b", "h2o-danube-3-4b", "h2o-danube-3-4b-gqa")
MAX_BATCH, BLOCK, MAX_CONTEXT = 3, 4, 32
MEGASTEPS = (1, 8)


def _config(get_config, arch):
    if arch.endswith("-gqa"):
        return dataclasses.replace(get_config(arch[:-4]).reduced(),
                                   num_kv_heads=2)
    return get_config(arch).reduced()


def workload(vocab: int):
    """(id, prompt, max_new) triples of mixed lengths."""
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, vocab, int(rng.integers(3, 20)))
             .astype(np.int32), int(rng.integers(2, 10))) for i in range(7)]


def child() -> None:
    """JAX reference: streams and dispatches of the dense engines."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax

    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.config import EngineConfig
    from repro.runtime.engine import (ContinuousEngine, Request,
                                      ServingEngine)
    from repro.runtime.stepper import Stepper

    cfg = get_config("stablelm-3b").reduced()
    api = build_model(cfg)
    params = api.init(jax.random.key(0))
    stepper = Stepper(api)
    out = {}

    def run(key, eng):
        for i, prompt, max_new in workload(cfg.vocab_size):
            eng.submit(Request(i, prompt, max_new))
        done = eng.run()
        out[key] = {"streams": {str(k): v.tokens for k, v in done.items()},
                    "dispatches": eng.dispatches}

    for ctx in (MAX_CONTEXT, None):
        run(f"round-{ctx}", ServingEngine(
            api, params, stepper=stepper, config=EngineConfig(
                hbm_budget=1 << 30, max_batch=MAX_BATCH, max_context=ctx,
                block_size=BLOCK)))
    for n in MEGASTEPS:
        run(f"dense-{n}", ContinuousEngine(
            api, params, stepper=stepper, config=EngineConfig(
                hbm_budget=1 << 30, max_batch=MAX_BATCH, block_size=BLOCK,
                max_context=MAX_CONTEXT, megastep=n, paged=False)))
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

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.bridge import params_from_numpy

    out = {}
    for arch in ARCHS:
        japi = jax_build_model(_config(jax_get_config, arch))
        jparams = japi.init(jax.random.key(0))
        cfg = _config(get_config, arch)
        tapi = build_model(cfg, device="cpu")
        tparams = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        out[arch] = (japi, jparams, tapi, tparams)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(bridged, arch):
    from repro_torch.kernels.flash_attention import launches

    japi, jparams, tapi, tparams = bridged[arch]
    tokens = np.random.default_rng(1).integers(
        0, tapi.cfg.vocab_size, (2, 24)).astype(np.int32)
    before = dict(launches)
    got = tapi.prefill_fn(tparams, {"tokens": torch.tensor(tokens)})
    assert launches == before                      # CPU: plain version
    assert got.shape == (2, tapi.cfg.vocab_size)
    want = japi.prefill_fn(jparams, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


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


def _compare_caches(tcaches, jcaches, n_layers, keys):
    for t, j in zip(tcaches, _jax_layers(jcaches, n_layers)):
        for key in keys:
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                       **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_vector_decode_matches_jax(bridged, arch):
    """Per-row cache_len and rows switching inactive, as the slot table
    drives them; row 0 fills the last slot, then idles at the stale
    ``cache_len == slots`` (its write must leave the cache untouched)."""
    import jax

    japi, jparams, tapi, tparams = bridged[arch]
    B, slots, steps = 3, 24, 24
    rng = np.random.default_rng(2)
    jcaches = japi.init_caches(B, slots, np.float32)
    tcaches = tapi.init_caches(B, slots)
    jdecode = jax.jit(japi.decode_fn)
    lens = np.array([2, 0, 1], np.int32)
    for s in range(steps):
        active = np.array([True, not 6 <= s < 10, s % 4 != 3])
        active &= lens < slots
        batch = {"tokens": rng.integers(0, 512, (B, 1)).astype(np.int32),
                 "cache_len": lens.copy(), "active": active}
        jl, jcaches = jdecode(jparams, jcaches, batch)
        tl, tcaches = tapi.decode_fn(
            tparams, tcaches, {k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        lens += active
    assert lens[0] == slots
    _compare_caches(tcaches, jcaches, tapi.cfg.num_layers, ("k", "v"))


@pytest.mark.parametrize("arch,ring", [("stablelm-3b", False),
                                       ("h2o-danube-3-4b", False),
                                       ("h2o-danube-3-4b-gqa", True)])
def test_dense_scalar_decode_matches_jax(bridged, arch, ring):
    """Scalar cache_len: every row at one position; the ring cache of the
    windowed model (16 slots) wraps over 24 steps."""
    import jax

    japi, jparams, tapi, tparams = bridged[arch]
    jdecode = jax.jit(japi.decode_fn)
    B, max_len, steps = 2, 24, 24
    rng = np.random.default_rng(3)
    jcaches = japi.init_caches(B, max_len, np.float32, ring=ring)
    tcaches = tapi.init_caches(B, max_len, ring=ring)
    assert tcaches[0]["k"].shape[1] == (16 if ring else max_len)
    for s in range(steps):
        toks = rng.integers(0, 512, (B, 1)).astype(np.int32)
        jl, jcaches = jdecode(jparams, jcaches,
                              {"tokens": toks, "cache_len": np.int32(s)})
        tl, tcaches = tapi.decode_fn(tparams, tcaches,
                                     {"tokens": torch.tensor(toks),
                                      "cache_len": s})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _compare_caches(tcaches, jcaches, tapi.cfg.num_layers, ("k", "v", "pos"))
    with pytest.raises(ValueError, match="active"):
        tapi.decode_fn(tparams, tcaches, {
            "tokens": torch.tensor(toks), "cache_len": steps,
            "active": torch.ones(B, dtype=torch.bool)})


def test_fill_kv_cache_matches_jax(bridged):
    """A prefill segment written into a dense cache at an offset: K/V and
    the slot positions, as JAX's fill_kv_cache writes them."""
    from repro.models.attention import fill_kv_cache as jax_fill
    from repro.models.attention import init_kv_cache as jax_init
    from repro_torch.models.attention import fill_kv_cache, init_kv_cache

    _, _, tapi, _ = bridged["h2o-danube-3-4b-gqa"]
    cfg = tapi.cfg
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((2, 5, cfg.num_kv_heads,
                                 cfg.resolved_head_dim()))
            .astype(np.float32) for _ in range(2))
    want = jax_fill(jax_init(cfg, 2, 12, np.float32), k, v, start=3)
    got = fill_kv_cache(init_kv_cache(cfg, 2, 12, torch.float32, "cpu"),
                        torch.tensor(k), torch.tensor(v), start=3)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    with pytest.raises(ValueError):
        fill_kv_cache(got, torch.tensor(k), torch.tensor(v), start=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_stepwise_dense_decode(bridged, arch):
    """Within the port: prefill_fn's last-token logits equal the logits
    of feeding the prompt one token at a time through the dense cache."""
    _, _, tapi, tparams = bridged[arch]
    S = 20
    tokens = torch.tensor(np.random.default_rng(4).integers(
        0, tapi.cfg.vocab_size, (2, S)).astype(np.int32))
    caches = tapi.init_caches(2, S)
    for s in range(S):
        logits, caches = tapi.decode_fn(
            tparams, caches, {"tokens": tokens[:, s:s + 1],
                              "cache_len": torch.full((2,), s,
                                                      dtype=torch.int32)})
    torch.testing.assert_close(tapi.prefill_fn(tparams, {"tokens": tokens}),
                               logits, **LOGIT_TOL)


def _serve(api, params, engine, **knobs):
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import (ContinuousEngine, Request,
                                            ServingEngine)

    config = EngineConfig(**{"hbm_budget": 1 << 30, "max_batch": MAX_BATCH,
                             "block_size": BLOCK,
                             "max_context": MAX_CONTEXT, **knobs})
    cls = ServingEngine if engine == "round" else ContinuousEngine
    eng = cls(api, params, config=config, device="cpu")
    for i, prompt, max_new in workload(api.cfg.vocab_size):
        eng.submit(Request(i, prompt, max_new))
    done = eng.run()
    assert all(c.ok for c in done.values())
    if engine != "round":
        eng.assert_quiescent()
    return {str(k): v.tokens for k, v in done.items()}, eng


@pytest.mark.parametrize("megastep", MEGASTEPS)
def test_dense_continuous_engine_matches_jax(jax_reference, bridged,
                                             megastep):
    from repro_torch.kernels.decode_attention import launches

    _, _, api, params = bridged["stablelm-3b"]
    before = dict(launches)
    streams, eng = _serve(api, params, "continuous", megastep=megastep,
                          paged=False)
    assert launches == before                      # CPU: plain version
    ref = jax_reference[f"dense-{megastep}"]
    assert streams == ref["streams"]
    assert eng.dispatches == ref["dispatches"]
    assert eng.tables is None and not eng.prefix_sharing
    # megasteps ran on the dense flavour only (N clips near completions)
    assert all(not paged for paged, _ in eng.stepper.megastep_sizes)
    assert bool(eng.stepper.megastep_sizes) == (megastep > 1)
    # the paged engine on the same workload: bit-identical streams
    paged, _ = _serve(api, params, "continuous", megastep=megastep)
    assert paged == streams


@pytest.mark.parametrize("max_context", [MAX_CONTEXT, None])
def test_round_engine_matches_jax(jax_reference, bridged, max_context):
    _, _, api, params = bridged["stablelm-3b"]
    streams, eng = _serve(api, params, "round", max_context=max_context)
    ref = jax_reference[f"round-{max_context}"]
    assert streams == ref["streams"]
    assert eng.dispatches == ref["dispatches"]
    if max_context is not None:     # equal widths: equal to continuous
        continuous, _ = _serve(api, params, "continuous", megastep=8,
                               paged=False)
        assert streams == continuous


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    child()
