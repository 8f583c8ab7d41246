"""The port's fault plane and graceful degradation against the JAX engine.

Every in-process engine case of ``tests/test_chaos.py`` (submit
validation, backpressure, deadlines, cancels, budget shrinks with and
without the host KV tier, cache eviction before demotion, the full-tier
fallback, stalls, poison retry and exhaustion, the poisoned megastep,
NaN weights, both engines' iteration caps) and a seeded chaos fuzz run
on both packages, through ``stablelm-3b.reduced()`` on the same weights
(JAX's ``jax.random.key(0)`` init, bridged as numpy into the port's
``nn.Module``).  The JAX side runs in a child process (this file with
``--child``) with ``jax_cpu_enable_async_dispatch`` off, because greedy
stream bits are only stable under synchronous dispatch there.

Each case is one function run on either package's serving surface
(:class:`Package`): it asserts the JAX test's own invariants and returns
what it observed — every request's status, reason and stream, and the
engine's ``stats()`` without the stepper's entry (histograms by bucket
counts).  The port's observation must equal the JAX child's exactly.

The fuzz: ``FaultPlane.random`` schedules at pinned seeds, every fault
kind alone and combined, each replayed at megastep 1 and 8 with and
without a host tier.  Beyond equality with JAX, within the port every
id resolves with a status in ``COMPLETION_STATUSES``, the engine drains
to quiescence, completed streams equal the fault-free run, partial
streams are prefixes of it, and a tiered run re-prefills no token and
restores every spill.
"""

import copy
import importlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

MAX_BATCH, BLOCK, MAX_CONTEXT = 3, 4, 32
MEGASTEPS = (1, 8)
KIND_CONFIGS = (("budget",), ("poison",), ("cancel",),
                ("budget", "poison"), ("budget", "poison", "cancel"))
#: pinned (seed, kinds) schedules: three seeds for each kind alone and
#: for each combination — CI replays exactly these
SCHEDULES = tuple((100 * ci + si, kinds)
                  for ci, kinds in enumerate(KIND_CONFIGS)
                  for si in range(3))
TIER_BLOCKS = 64            # host tier: ample for every preemption


class Package:
    """The serving surface of ``repro`` or ``repro_torch``: the cases
    below run unchanged on either."""

    def __init__(self, name: str):
        def mod(path):
            return importlib.import_module(f"{name}.{path}")

        eng = mod("runtime.engine")
        self.name = name
        self.ContinuousEngine = eng.ContinuousEngine
        self.ServingEngine = eng.ServingEngine
        self.Request = eng.Request
        self.COMPLETION_STATUSES = eng.COMPLETION_STATUSES
        self.EngineConfig = mod("runtime.config").EngineConfig
        faults = mod("runtime.faults")
        self.FaultEvent, self.FaultPlane = faults.FaultEvent, faults.FaultPlane
        self.BlockKVCache = mod("runtime.kv_cache").BlockKVCache
        self.device = {"device": "cpu"} if name == "repro_torch" else {}

    def config(self, **kw):
        """Every knob explicit, so no ``PARALLAX_*`` env var leaks in."""
        base = dict(hbm_budget=1 << 30, max_batch=MAX_BATCH,
                    block_size=BLOCK, max_context=MAX_CONTEXT, megastep=8,
                    host_pool=0, fault_seed=None, prefix_cache=False,
                    retry_backoff_s=0.0)
        base.update(kw)
        return self.EngineConfig(**base)

    def engine(self, m, faults=None, telemetry=None, **kw):
        return self.ContinuousEngine(m.api, m.params, config=self.config(**kw),
                                     stepper=m.stepper, faults=faults,
                                     telemetry=telemetry, **self.device)

    def round_engine(self, m, **kw):
        conf = self.EngineConfig(hbm_budget=1 << 30, max_batch=2,
                                 max_context=32, **kw)
        return self.ServingEngine(m.api, m.params, config=conf,
                                  stepper=m.stepper, **self.device)

    def nan_params(self, params):
        """Every floating weight NaN: JAX maps the pytree, the port
        writes NaN into a copy of its ``nn.Module``'s parameters in
        place."""
        if self.name == "repro_torch":
            bad = copy.deepcopy(params)
            with torch.no_grad():
                for p in bad.parameters():
                    if p.is_floating_point():
                        p.fill_(float("nan"))
            return bad
        import jax
        import jax.numpy as jnp
        return jax.tree_util.tree_map(
            lambda x: jnp.full_like(x, jnp.nan)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
            params)


def stats_view(eng) -> dict:
    """``engine.stats()`` without the stepper's entry (its counters count
    jit traces in JAX) and the port's host-read counters (``sync.*``, none
    in JAX; tests/test_torch_model_spans.py checks them), histograms by
    bucket counts."""
    s = eng.stats()
    s.pop("stepper", None)
    s["counters"] = {k: v for k, v in s["counters"].items()
                     if not k.startswith("sync.")}
    s["histograms"] = {k: v["counts"] for k, v in s["histograms"].items()}
    return s


def observe(done, eng=None) -> dict:
    """JSON-normal record of a run: status, reason and stream per id."""
    out = {"done": {str(k): [c.status, c.reason, [int(t) for t in c.tokens]]
                    for k, c in sorted(done.items())}}
    if eng is not None:
        out["stats"] = stats_view(eng)
    return json.loads(json.dumps(out))


def prompts(cfg, n, plen=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
            for _ in range(n)]


def tight_budget(P, cfg):
    """Room for 12 blocks after the margin: budget shrinks bite."""
    probe = P.BlockKVCache(cfg, 0, block_size=BLOCK)
    return probe, int((12 * probe.block_bytes
                       + MAX_BATCH * probe.state_bytes) / 0.6) + 1


# -- the in-process engine cases of tests/test_chaos.py ----------------------

def case_submit_validation(P, m):
    eng = P.engine(m, max_batch=2, max_context=16)
    ok = np.arange(4, dtype=np.int32)
    errors = []
    for req, match in (
            (P.Request(0, ok.reshape(2, 2)), "1-D"),
            (P.Request(0, np.array([], np.int32)), "empty"),
            (P.Request(0, ok.astype(np.float32)), "integer"),
            (P.Request(0, ok, max_new_tokens=-1), "max_new_tokens"),
            (P.Request(0, ok, max_new_tokens=2, deadline_s=0.0),
             "deadline_s"),
            (P.Request(0, ok, max_new_tokens=13), "max_context")):
        with pytest.raises(ValueError, match=match) as e:
            eng.submit(req)
        errors.append(str(e.value))
    assert not eng.waiting                # nothing half-admitted
    return {"errors": errors}


def case_backpressure(P, m):
    eng = P.engine(m, max_queue=2)
    accepted = [eng.submit(P.Request(i, p, max_new_tokens=2))
                for i, p in enumerate(prompts(m.cfg, 5))]
    assert accepted == [True, True, False, False, False]
    assert eng.rejected == 3
    done = eng.run()
    assert sorted(done) == list(range(5))
    for i in (2, 3, 4):
        assert (done[i].status, done[i].reason) == ("rejected", "queue_full")
        assert done[i].tokens == [] and not done[i].ok
    assert all(done[i].ok and len(done[i].tokens) == 2 for i in (0, 1))
    eng.assert_quiescent()
    return observe(done, eng) | {"accepted": accepted}


def case_deadline(P, m):
    eng = P.engine(m)
    for i, p in enumerate(prompts(m.cfg, 4)):
        eng.submit(P.Request(i, p, max_new_tokens=6, deadline_s=1e-9))
    done = eng.run()
    assert all((done[i].status, done[i].reason) == ("cancelled", "deadline")
               for i in range(4))
    assert eng.cancellations == 4
    eng.assert_quiescent()
    generous = P.engine(m)
    generous.submit(P.Request(0, prompts(m.cfg, 1)[0], max_new_tokens=3,
                              deadline_s=300.0))
    done2 = generous.run()
    assert done2[0].ok
    generous.assert_quiescent()
    return {"expired": observe(done, eng), "generous": observe(done2)}


def case_cancel(P, m):
    eng = P.engine(m, max_batch=2)
    for i, p in enumerate(prompts(m.cfg, 4)):
        eng.submit(P.Request(i, p, max_new_tokens=20))
    assert not eng.cancel(99)             # unknown id
    assert eng.cancel(3)                  # still waiting: empty stream
    eng.step()
    eng.step()
    assert eng.cancel(0)                  # mid-decode: blocks reclaimed
    assert not eng.cancel(0)              # already resolved
    done = eng.run()
    assert done[3].status == "cancelled" and done[3].tokens == []
    assert done[0].status == "cancelled"
    assert 0 < len(done[0].tokens) < 20   # partial stream rides along
    assert all(done[i].ok and len(done[i].tokens) == 20 for i in (1, 2))
    assert eng.cancellations == 2
    eng.assert_quiescent()
    return observe(done, eng)


def _shrink_restore(P, m, host_pool_blocks, shrink_blocks):
    probe, hbm = tight_budget(P, m.cfg)
    eng = P.engine(m, megastep=1, hbm_budget=hbm,
                   host_pool=host_pool_blocks * probe.block_bytes)
    full = eng.kv.budget
    eng.faults = P.FaultPlane([
        P.FaultEvent(3, "budget", budget_bytes=shrink_blocks(probe)),
        P.FaultEvent(9, "budget", budget_bytes=full),
    ])
    for i, p in enumerate(prompts(m.cfg, 3, plen=6)):
        eng.submit(P.Request(i, p, max_new_tokens=10))
    done = eng.run()
    assert all(done[i].ok and len(done[i].tokens) == 10 for i in range(3))
    eng.assert_quiescent()
    return done, eng, full


def case_shrink_restore(P, m):
    done, eng, full = _shrink_restore(
        P, m, 0, lambda p: 2 * p.block_bytes + 3 * p.state_bytes)
    assert eng.budget_events == 2 and eng.kv.budget == full
    return observe(done, eng)


def case_shrink_spills(P, m):
    done, eng, _ = _shrink_restore(P, m, TIER_BLOCKS,
                                   lambda p: 2 * p.block_bytes)
    assert eng.spill_enabled
    assert eng.spills > 0 and eng.restores == eng.spills
    assert eng.reprefill_tokens == 0      # nothing replayed through prefill
    assert eng.prefill_tokens_saved > 0
    assert eng.kv.host_peak_bytes > 0 and eng.kv.host_in_use == 0
    return observe(done, eng)


def case_tier_full_demotes(P, m):
    probe, hbm = tight_budget(P, m.cfg)
    eng = P.engine(m, megastep=1, hbm_budget=hbm, host_pool=1)
    assert eng.spill_enabled              # armed, but no capacity
    full = eng.kv.budget
    eng.faults = P.FaultPlane([
        P.FaultEvent(3, "budget", budget_bytes=2 * probe.block_bytes),
        P.FaultEvent(9, "budget", budget_bytes=full),
    ])
    for i, p in enumerate(prompts(m.cfg, 3, plen=6)):
        eng.submit(P.Request(i, p, max_new_tokens=10))
    done = eng.run()
    assert all(done[i].ok and len(done[i].tokens) == 10 for i in range(3))
    assert eng.spills == 0 and eng.restores == 0
    assert eng.reprefill_tokens > 0       # demote path replayed tokens
    eng.assert_quiescent()
    return observe(done, eng)


def case_stalls_visible(P, m):
    done, eng, _ = _shrink_restore(P, m, TIER_BLOCKS, lambda p: 1)
    assert eng.stalls > 0
    assert eng.stats()["counters"]["engine.stalls"] == eng.stalls
    return observe(done, eng)


def case_evict_cache_before_demoting(P, m):
    probe = P.BlockKVCache(m.cfg, 0, block_size=BLOCK)
    eng = P.engine(m, hbm_budget=12 * probe.block_bytes, megastep=1,
                   prefix_cache=True)
    assert eng.prefix_cache
    first = {}
    for i, p in enumerate(prompts(m.cfg, 2, plen=9, seed=3)):
        eng.submit(P.Request(i, p, max_new_tokens=4))
        first.update(eng.run())
        assert first[i].ok
    assert eng.kv.cached_blocks > 0
    eng.assert_quiescent()
    eng.faults = P.FaultPlane([P.FaultEvent(
        eng.iterations + 2, "budget", budget_bytes=9 * probe.block_bytes)])
    for i, p in enumerate(prompts(m.cfg, 2, plen=6, seed=4)):
        eng.submit(P.Request(10 + i, p, max_new_tokens=10))
    done = eng.run()
    assert all(done[10 + i].ok and len(done[10 + i].tokens) == 10
               for i in range(2))
    assert eng.kv.prefix_cache_evictions > 0
    assert eng.preemptions == 0
    assert eng.kv.in_use <= eng.kv.budget
    eng.assert_quiescent()
    return {"first": observe(first), "second": observe(done, eng)}


def case_cache_tier_budget_chaos(P, m):
    probe = P.BlockKVCache(m.cfg, 0, block_size=BLOCK)
    out = {}
    for seed in (0, 1, 2):
        eng = P.engine(m, hbm_budget=12 * probe.block_bytes, megastep=1,
                       prefix_cache=True)
        eng.faults = P.FaultPlane.random(
            seed, budget_bytes=eng.kv.budget, request_ids=list(range(6)),
            max_batch=MAX_BATCH, kinds=("budget",))
        rng = np.random.default_rng(seed)
        pfx = rng.integers(0, m.cfg.vocab_size, 8).astype(np.int32)
        for i in range(6):
            tail = rng.integers(0, m.cfg.vocab_size,
                                1 + i % 3).astype(np.int32)
            eng.submit(P.Request(i, np.concatenate([pfx, tail]),
                                 max_new_tokens=5))
        done = eng.run(max_iters=2000)
        assert sorted(done) == list(range(6))
        assert all(c.status in P.COMPLETION_STATUSES
                   and c.reason != "max_iters" for c in done.values())
        eng.assert_quiescent()
        out[str(seed)] = observe(done, eng)
    return out


def case_shrink_without_restore_raises(P, m):
    eng = P.engine(m)
    eng.faults = P.FaultPlane([P.FaultEvent(2, "budget", budget_bytes=0)])
    eng.submit(P.Request(0, prompts(m.cfg, 1, plen=6)[0],
                         max_new_tokens=10))
    with pytest.raises(MemoryError):
        eng.run()
    return {"iterations": eng.iterations, "budget": eng.kv.budget}


def _poisoned(P, m, megastep, event, max_new):
    eng = P.engine(m, megastep=megastep)
    eng.faults = P.FaultPlane([event])
    for i, p in enumerate(prompts(m.cfg, 3)):
        eng.submit(P.Request(i, p, max_new_tokens=max_new))
    done = eng.run()
    eng.assert_quiescent()
    return done, eng


def case_poison_retry(P, m):
    done, eng = _poisoned(P, m, 1, P.FaultEvent(3, "poison",
                                                 rows=(0, 1, 2)), 6)
    assert all(done[i].ok and len(done[i].tokens) == 6 for i in range(3))
    assert eng.watchdog_trips >= 1 and eng.retry_dispatches >= 1
    assert eng.rows_failed == 0
    return observe(done, eng)


def case_poison_exhaustion(P, m):
    done, eng = _poisoned(P, m, 1, P.FaultEvent(3, "poison", rows=(1,),
                                                 repeats=9), 6)
    failed = [i for i in range(3) if done[i].status == "failed"]
    assert len(failed) == 1
    assert done[failed[0]].reason == "poisoned_logits"
    assert len(done[failed[0]].tokens) < 6
    assert all(done[i].ok and len(done[i].tokens) == 6
               for i in range(3) if i not in failed)
    assert eng.rows_failed == 1
    return observe(done, eng)


def case_poison_megastep_falls_back(P, m):
    done, eng = _poisoned(P, m, 8, P.FaultEvent(2, "poison",
                                                 rows=(0, 1, 2)), 8)
    assert all(done[i].ok and len(done[i].tokens) == 8 for i in range(3))
    assert eng.megastep_fallbacks == 1 and eng.watchdog_trips >= 1
    assert eng.rows_failed == 0
    return observe(done, eng)


def case_nan_weights(P, m):
    bad = SimpleNamespace(cfg=m.cfg, api=m.api, stepper=m.stepper,
                          params=P.nan_params(m.params))
    eng = P.engine(bad, max_batch=2)
    eng.submit(P.Request(0, np.arange(4, dtype=np.int32) + 1,
                         max_new_tokens=4))
    done = eng.run()
    assert (done[0].status, done[0].reason) == ("failed", "poisoned_logits")
    assert done[0].tokens == []           # poisoned from the first token
    assert eng.watchdog_trips >= 1
    eng.assert_quiescent()
    return observe(done, eng)


def case_iteration_cap(P, m):
    eng = P.engine(m, max_batch=2)
    for i, p in enumerate(prompts(m.cfg, 4)):
        eng.submit(P.Request(i, p, max_new_tokens=20))
    done = eng.run(max_iters=2)
    assert sorted(done) == list(range(4))
    assert all((c.status, c.reason) == ("failed", "max_iters")
               for c in done.values())
    eng.assert_quiescent()
    return observe(done, eng)


def case_round_engine_cap(P, m):
    eng = P.round_engine(m)
    for i, p in enumerate(prompts(m.cfg, 2)):
        eng.submit(P.Request(i, p, max_new_tokens=4))
    done = eng.run(max_rounds=0)
    assert all((c.status, c.reason) == ("failed", "max_rounds")
               for c in done.values())
    return observe(done)


def case_kv_set_budget(P, m):
    kv = P.BlockKVCache(m.cfg, 1 << 30, block_size=BLOCK)
    kv.assert_quiescent()
    full = kv.budget
    kv.admit(0, 8)
    with pytest.raises(AssertionError):
        kv.assert_quiescent()             # live table = leak
    kv.set_budget(kv.in_use // 2)         # below in_use: never evicts
    seen = [kv.headroom, kv.in_use]
    assert kv.headroom < 0 and kv.in_use == 2 * kv.block_bytes
    kv.set_budget(full)
    with pytest.raises(ValueError):
        kv.set_budget(-1)
    kv.free(0)
    kv.assert_quiescent()
    return {"seen": seen, "budget": kv.budget}


def case_cancel_mid_megastep(P, m):
    """A victim cancelled between megasteps and right after a megastep
    reserved its blocks leaves the survivors bit-identical across
    megastep 1 and 8; the victim keeps a nonempty strict prefix."""
    rng = np.random.default_rng(4)
    reqs = [(50 + i, rng.integers(0, m.cfg.vocab_size, 6).astype(np.int32))
            for i in range(3)]
    victim = reqs[0][0]

    def play(megastep, plane):
        eng = P.engine(m, megastep=megastep, faults=plane)
        for rid, p in reqs:
            eng.submit(P.Request(rid, p, max_new_tokens=24))
        done = eng.run()
        eng.assert_quiescent()
        return done, eng

    ref, _ = play(1, None)
    out = {}
    for label, megastep, when in (("n1", 1, "start"), ("n8", 8, "start"),
                                  ("n8-post-reserve", 8, "post_reserve")):
        done, eng = play(megastep, P.FaultPlane([P.FaultEvent(
            3, "cancel", request_id=victim, when=when)]))
        assert all(done[r].tokens == ref[r].tokens for r, _ in reqs[1:])
        cut = done[victim]
        assert cut.status == "cancelled"
        assert 0 < len(cut.tokens) < len(ref[victim].tokens)
        assert cut.tokens == ref[victim].tokens[:len(cut.tokens)]
        out[label] = observe(done, eng)
    return out


CASES = {f.__name__[len("case_"):]: f for f in (
    case_submit_validation, case_backpressure, case_deadline, case_cancel,
    case_shrink_restore, case_shrink_spills, case_tier_full_demotes,
    case_stalls_visible, case_evict_cache_before_demoting,
    case_cache_tier_budget_chaos, case_shrink_without_restore_raises,
    case_poison_retry, case_poison_exhaustion,
    case_poison_megastep_falls_back, case_nan_weights, case_iteration_cap,
    case_round_engine_cap, case_kv_set_budget, case_cancel_mid_megastep)}


# -- the chaos fuzz ------------------------------------------------------------

def fuzz_requests(P, cfg):
    rng = np.random.default_rng(0)
    return [P.Request(i, rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(3, 9))).astype(np.int32),
                      max_new_tokens=int(rng.integers(3, 9)))
            for i in range(6)]


def fuzz_play(P, m, megastep, plane, tier):
    probe, hbm = tight_budget(P, m.cfg)
    eng = P.engine(m, megastep=megastep, faults=plane, hbm_budget=hbm,
                   host_pool=TIER_BLOCKS * probe.block_bytes if tier else 0)
    reqs = fuzz_requests(P, m.cfg)
    for r in reqs:
        eng.submit(P.Request(r.id, r.prompt, r.max_new_tokens))
    return eng.run(max_iters=2000), eng


def fuzz_plane(P, eng, index):
    seed, kinds = SCHEDULES[index]
    return P.FaultPlane.random(
        seed, budget_bytes=eng.kv.budget, request_ids=list(range(6)),
        max_batch=MAX_BATCH, kinds=kinds)


def fuzz_reference(P, m):
    done, eng = fuzz_play(P, m, 1, None, False)
    eng.assert_quiescent()
    assert all(c.ok for c in done.values())
    return done, eng


def fuzz_schedule(P, m, index, ref_eng):
    """One schedule at megastep 1 and 8, tier off and on: each run's
    engine and completions, keyed ``m{N}-tier{0|1}``."""
    plane = fuzz_plane(P, ref_eng, index)
    return {f"m{n}-tier{int(tier)}": fuzz_play(P, m, n, plane, tier)
            for n in MEGASTEPS for tier in (False, True)}


# -- the JAX side: a child process -------------------------------------------

def child() -> None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.stepper import Stepper

    cfg = get_config("stablelm-3b").reduced()
    api = build_model(cfg)
    m = SimpleNamespace(cfg=cfg, api=api, params=api.init(jax.random.key(0)),
                        stepper=Stepper(api))
    P = Package("repro")
    out = {"cases": {name: fn(P, m) for name, fn in CASES.items()}}
    ref_done, ref_eng = fuzz_reference(P, m)
    out["fuzz_ref"] = observe(ref_done, ref_eng)
    out["fuzz"] = [{k: observe(d, e) for k, (d, e) in
                    fuzz_schedule(P, m, i, ref_eng).items()}
                   for i in range(len(SCHEDULES))]
    out["planes"] = [[repr(e) for e in fuzz_plane(P, ref_eng, i).events]
                     for i in range(len(SCHEDULES))]
    print(json.dumps(out))


@pytest.fixture(scope="module")
def jax_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, "--child"],
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    """The port's serving surface and model on the JAX model's weights."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.runtime.stepper import Stepper

    torch.set_num_threads(1)
    jparams = jax_build_model(jax_get_config("stablelm-3b").reduced()) \
        .init(jax.random.key(0))
    cfg = get_config("stablelm-3b").reduced()
    api = build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return Package("repro_torch"), SimpleNamespace(
        cfg=cfg, api=api, params=params, stepper=Stepper(api))


@pytest.fixture(scope="module")
def fuzz_ref(port):
    P, m = port
    return fuzz_reference(P, m)


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_case_matches_jax(jax_reference, port, name):
    P, m = port
    assert CASES[name](P, m) == jax_reference["cases"][name]


def test_nan_weights_leave_the_port_model_intact(port):
    """The NaN case poisons a copy: the served model still decodes."""
    P, m = port
    assert all(torch.isfinite(p).all() for p in m.params.parameters())


def test_fault_plane_schedules_match_jax(jax_reference, port, fuzz_ref):
    P, _ = port
    _, ref_eng = fuzz_ref
    got = [[repr(e) for e in fuzz_plane(P, ref_eng, i).events]
           for i in range(len(SCHEDULES))]
    assert got == jax_reference["planes"]
    kinds = {e.kind for i in range(len(SCHEDULES))
             for e in fuzz_plane(P, ref_eng, i).events}
    assert kinds == {"budget", "poison", "cancel"}


def chaos_violation(P, done, ref, eng, tier) -> "str | None":
    """The first broken fuzz invariant of one run, or None."""
    for rid, want in ref.items():
        if rid not in done:
            return f"request {rid} dropped"
        c = done[rid]
        if c.status not in P.COMPLETION_STATUSES:
            return f"request {rid}: unknown status {c.status!r}"
        if c.reason == "max_iters":
            return f"request {rid}: engine wedged"
        if c.status == "completed" and c.tokens != want:
            return f"request {rid}: completed stream diverged"
        if c.status in ("cancelled", "failed") \
                and c.tokens != want[:len(c.tokens)]:
            return f"request {rid}: {c.status} stream not a prefix"
        if c.status == "rejected" and c.tokens:
            return f"request {rid}: rejected with tokens"
    try:
        eng.assert_quiescent()
    except AssertionError as e:
        return f"not quiescent: {e}"
    if tier and eng.reprefill_tokens:
        return f"{eng.reprefill_tokens} tokens re-prefilled with a tier"
    if tier and eng.spills != eng.restores:
        return f"{eng.spills} spills, {eng.restores} restores"
    return None


def test_fuzz_reference_matches_jax(jax_reference, fuzz_ref):
    done, eng = fuzz_ref
    assert observe(done, eng) == jax_reference["fuzz_ref"]


@pytest.mark.parametrize("index", range(len(SCHEDULES)),
                         ids=[f"{'+'.join(k)}-{s}" for s, k in SCHEDULES])
def test_chaos_fuzz_matches_jax(jax_reference, port, fuzz_ref, index):
    P, m = port
    ref_done, ref_eng = fuzz_ref
    ref = {rid: c.tokens for rid, c in ref_done.items()}
    runs = fuzz_schedule(P, m, index, ref_eng)
    for key, (done, eng) in runs.items():
        bad = chaos_violation(P, done, ref, eng, key.endswith("tier1"))
        assert bad is None, (key, bad)
        assert observe(done, eng) == jax_reference["fuzz"][index][key], key


def test_chaos_fuzz_tier_spills(jax_reference):
    """The tiered budget schedules do spill and restore (the fuzz would
    pass vacuously on a tier nothing used); the port's counters equal
    these, run by run."""
    spills = [run["stats"]["counters"]["engine.spills"]
              for i, (_, kinds) in enumerate(SCHEDULES) if "budget" in kinds
              for key, run in jax_reference["fuzz"][i].items()
              if key.endswith("tier1")]
    assert sum(spills) > 0


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    child()
