"""The port's persistent prefix cache, megastep bookkeeping and
``EngineConfig`` against the JAX package.

Engines (``stablelm-3b.reduced()``, JAX's weights bridged in; the JAX
side in a child process, this file with ``--child``, async dispatch
off): the identity sweeps of ``tests/serving_identity_child.py
--cache`` — sequential arrivals that revive cached blocks, two
concurrent waves, LRU evictions under a tight budget — plus the host
second chance (evicted blocks captured to the host tier and scattered
back on revival), and the megastep cases of ``tests/test_megastep.py``:
the termination fuzz (EOS and max-token at every offset within N,
bit-identical to N=1, reserved blocks returned every iteration), the
re-admission headroom after a demotion, EOS never sampled, N=1 never
fusing.  Streams and counters equal JAX's, and cache on equals cache
off within each package.

The radix cache itself (``BlockKVCache``: revival, leaf-first LRU
eviction, eviction before live demotion, the host tier's LRU, the audit)
runs the cases of ``tests/test_prefix_cache.py`` on both packages in
this process and compares what they observe.

``EngineConfig``: the precedence matrix (explicit, including falsy
values, beats env beats default), every field as a CLI flag, and the
§3.3 default budget — the host's free memory on the CPU, as JAX's, and
the card's free memory for an engine or a plan on a CUDA device.
"""

import argparse
import builtins
import importlib
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

MAX_BATCH, BLOCK, MAX_CONTEXT = 3, 4, 32
BS = 4


class Package:
    """The cache and engine surface of ``repro`` or ``repro_torch``."""

    def __init__(self, name: str):
        def mod(path):
            return importlib.import_module(f"{name}.{path}")

        eng = mod("runtime.engine")
        self.name = name
        self.engine_mod = eng
        self.ContinuousEngine = eng.ContinuousEngine
        self.Request = eng.Request
        self.FREE, self.PREFILL = eng.FREE, eng.PREFILL
        self.config_mod = mod("runtime.config")
        self.EngineConfig = self.config_mod.EngineConfig
        self.BlockKVCache = mod("runtime.kv_cache").BlockKVCache
        self.SpanRecorder = mod("runtime.telemetry").SpanRecorder
        self.scheduler = mod("core.scheduler")
        self.get_config = mod("configs").get_config
        self.device = {"device": "cpu"} if name == "repro_torch" else {}

    def config(self, **kw):
        base = dict(hbm_budget=1 << 30, max_batch=MAX_BATCH,
                    block_size=BLOCK, max_context=MAX_CONTEXT, megastep=8,
                    host_pool=0, fault_seed=None, prefix_cache=False,
                    retry_backoff_s=0.0)
        base.update(kw)
        return self.EngineConfig(**base)

    def engine(self, m, cls=None, **kw):
        return (cls or self.ContinuousEngine)(
            m.api, m.params, config=self.config(**kw), stepper=m.stepper,
            **self.device)


def counters(eng) -> dict:
    """The engine's and the kv's counters and gauges (not the port's
    host-read counters, ``sync.*``, which JAX has none of;
    tests/test_torch_model_spans.py checks them)."""
    s = eng.stats()
    counts = {k: v for k, v in s["counters"].items()
              if not k.startswith("sync.")}
    return json.loads(json.dumps({"counters": counts,
                                  "gauges": s["gauges"]}))


def tokens(done, ids) -> dict:
    return {str(i): [int(t) for t in done[i].tokens] for i in ids}


def mixed_requests(P, cfg, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [P.Request(i, rng.integers(0, cfg.vocab_size, int(
        rng.integers(3, 14))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 9))) for i in range(n)]


def tight(P, cfg):
    probe = P.BlockKVCache(cfg, 0, block_size=BLOCK)
    return int((12 * probe.block_bytes
                + MAX_BATCH * probe.state_bytes) / 0.6) + 1


def seq_drive(P, eng, reqs):
    """Each request finishes before the next arrives: nothing live
    shares, so every hit is the cache's."""
    done = {}
    for r in reqs:
        eng.submit(P.Request(r.id, r.prompt, r.max_new_tokens))
        done.update(eng.run())
    eng.assert_quiescent()
    return tokens(done, [r.id for r in reqs])


# -- engine cases (both packages) ----------------------------------------------

def cache_cases(P, m) -> dict:
    out = {}
    rng = np.random.default_rng(11)
    pfx = rng.integers(0, m.cfg.vocab_size, 16).astype(np.int32)
    seqr = [P.Request(300 + i, np.concatenate([pfx, rng.integers(
        0, m.cfg.vocab_size, 1 + i % 3).astype(np.int32)]),
        max_new_tokens=3 + (i * 5) % 7) for i in range(6)]
    for n in (1, 8):
        for cache in (False, True):
            eng = P.engine(m, megastep=n, prefix_cache=cache)
            out[f"seq-m{n}-cache{int(cache)}"] = {
                "streams": seq_drive(P, eng, seqr), "counters": counters(eng)}
    ref = out["seq-m1-cache0"]["streams"]
    assert all(v["streams"] == ref for v in out.values())
    on = out["seq-m8-cache1"]["counters"]["counters"]
    assert on["kv.prefix_cache_hits"] > 0
    assert on["engine.prefill_tokens_saved_cache"] > 0

    # two concurrent waves: wave 2 resubmits wave 1's prompts
    reqs = mixed_requests(P, m.cfg)
    waves = {}
    for cache in (False, True):
        eng = P.engine(m, prefix_cache=cache)
        streams = {}
        for base in (0, 100):
            for r in reqs:
                eng.submit(P.Request(base + r.id, r.prompt, r.max_new_tokens))
            streams.update(tokens(eng.run(), [base + r.id for r in reqs]))
        eng.assert_quiescent()
        waves[cache] = {"streams": streams, "counters": counters(eng)}
    assert waves[True]["streams"] == waves[False]["streams"]
    assert waves[True]["counters"]["counters"]["kv.prefix_cache_hits"] > 0
    out["waves"] = waves[True]

    # a tight budget over unique prompts: LRU evictions mid-workload
    t_on = P.engine(m, hbm_budget=tight(P, m.cfg), prefix_cache=True)
    t_off = P.engine(m, hbm_budget=tight(P, m.cfg))
    s_on = seq_drive(P, t_on, reqs)
    assert s_on == seq_drive(P, t_off, reqs)
    assert t_on.kv.prefix_cache_evictions > 0
    out["evict"] = {"streams": s_on, "counters": counters(t_on)}

    # the host second chance: evicted cached blocks are captured to the
    # host tier; the same prompts again revive them from there
    host = P.engine(m, hbm_budget=tight(P, m.cfg), prefix_cache=True,
                    host_pool=64 * P.BlockKVCache(
                        m.cfg, 0, block_size=BLOCK).block_bytes)
    again = [P.Request(200 + r.id, r.prompt, r.max_new_tokens) for r in reqs]
    s_host = seq_drive(P, host, reqs + again)
    s_ref = seq_drive(P, P.engine(m, hbm_budget=tight(P, m.cfg)),
                      reqs + again)
    assert s_host == s_ref
    assert host.kv.prefix_cache_host_hits > 0
    assert host.kv.host_in_use == host.kv.host_blocks_live * \
        host.kv.block_bytes
    out["host"] = {"streams": s_host, "counters": counters(host)}
    return out


def audit_engine(P):
    """The fuzz's engine: after every iteration no slot holds blocks past
    its written tokens (or its pending prompt while prefilling), and no
    request finishes with prompt tokens unconsumed."""

    class AuditEngine(P.ContinuousEngine):
        def _finish(self, slot):
            assert self.slot_off[slot] == len(self._slot_prompt[slot])
            super()._finish(slot)

        def step(self):
            super().step()
            for s in range(self.max_batch):
                if self.slot_phase[s] == P.FREE:
                    continue
                need = int(self.slot_len[s])
                if self.slot_phase[s] == P.PREFILL:
                    need = max(need, len(self._slot_prompt[s]))
                assert len(self.kv.block_tables[s]) == \
                    self.kv.blocks_for(max(need, 1)), (s, need)

    return AuditEngine


def megastep_cases(P, m) -> dict:
    """The termination fuzz (tests/serving_identity_child.py --fuzz)."""
    Audit = audit_engine(P)
    rng = np.random.default_rng(0)

    def run(reqs, megastep):
        eng = P.engine(m, cls=Audit, megastep=megastep)
        for r in reqs:
            eng.submit(P.Request(r.id, r.prompt, r.max_new_tokens,
                                 eos_id=r.eos_id))
        done = eng.run()
        eng.assert_quiescent()
        assert eng.kv.in_use == 0
        return tokens(done, [r.id for r in reqs]), eng

    out = []
    for case in range(8):
        n = int(rng.integers(2, 9))
        reqs = [P.Request(i, rng.integers(0, m.cfg.vocab_size, int(
            rng.integers(1, 12))).astype(np.int32),
            max_new_tokens=1 + (i + case) % (n + 1)) for i in range(6)]
        # a prefill-only request whose prompt outlives one megastep
        reqs.append(P.Request(6, rng.integers(0, m.cfg.vocab_size, n + 3)
                              .astype(np.int32), max_new_tokens=0))
        base, e1 = run(reqs, 1)
        fused, en = run(reqs, n)
        assert fused == base, f"case {case}: N={n} diverged from N=1"
        assert en.kv.peak_bytes <= e1.kv.peak_bytes \
            + MAX_BATCH * (n - 1) * en.kv.block_bytes
        eos_runs = []
        longest = max(base, key=lambda i: len(base[i]))
        for tok in base[longest]:
            er = [P.Request(r.id, r.prompt, r.max_new_tokens, eos_id=int(tok))
                  for r in reqs]
            b, _ = run(er, 1)
            f, _ = run(er, n)
            assert f == b, f"case {case}: EOS {tok} diverged"
            eos_runs.append(b)
        out.append({"n": n, "streams": base, "eos": eos_runs,
                    "dispatches": [e1.dispatches, en.dispatches]})
    return {"fuzz": out}


def headroom_case(P, m) -> dict:
    """A megastep planned while a demoted request waits never eats the
    headroom that request needs to re-admit."""

    class HeadroomAudit(P.ContinuousEngine):
        planned = 0

        def _plan_megastep(self):
            head = next((q for q in self.waiting if q.preempted), None)
            before = self.kv.headroom
            n, plans = super()._plan_megastep()
            if n >= 2 and head is not None:
                self.planned += 1
                need = self.kv.bytes_for(head.pending_len())
                assert self.kv.headroom >= need \
                    or self.kv.headroom == before
            return n, plans

    probe = P.BlockKVCache(m.cfg, 1 << 30, block_size=BLOCK)
    eng = P.engine(m, cls=HeadroomAudit,
                   hbm_budget=int(7 * probe.block_bytes / 0.6) + 1)
    rng = np.random.default_rng(3)
    for i in range(5):
        eng.submit(P.Request(i, rng.integers(0, m.cfg.vocab_size, 6)
                             .astype(np.int32), max_new_tokens=10))
    done = eng.run()
    assert sorted(done) == list(range(5))
    assert all(len(c.tokens) == 10 for c in done.values())
    assert eng.preemptions > 0 and eng.planned > 0
    eng.assert_quiescent()
    out = {"streams": tokens(done, range(5)), "counters": counters(eng)}

    # EOS outside the vocab: every stream runs to max_new; N=1 never fuses
    rng = np.random.default_rng(1)
    for n in (1, 8):
        eng = P.engine(m, max_batch=2, megastep=n)
        for i in range(3):
            eng.submit(P.Request(i, rng.integers(0, m.cfg.vocab_size, 5)
                                 .astype(np.int32), max_new_tokens=5,
                                 eos_id=-5))
        done = eng.run()
        assert all(len(done[i].tokens) == 5 for i in range(3))
        assert (eng.megasteps == 0) == (n == 1)
        eng.assert_quiescent()
        out[f"eos-m{n}"] = {"streams": tokens(done, range(3)),
                            "counters": counters(eng)}
    return out


ENGINE_CASES = {"cache": cache_cases, "megastep": megastep_cases,
                "headroom": headroom_case}


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
    print(json.dumps({k: fn(P, m) for k, fn in ENGINE_CASES.items()}))


@pytest.fixture(scope="module")
def jax_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, "--child"],
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def packages():
    return Package("repro"), Package("repro_torch")


@pytest.fixture(scope="module")
def port(packages):
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
    return packages[1], SimpleNamespace(cfg=cfg, api=api, params=params,
                                        stepper=Stepper(api))


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_cases_match_jax(jax_reference, port, name):
    P, m = port
    assert ENGINE_CASES[name](P, m) == jax_reference[name]


# -- the radix cache itself, on both packages ---------------------------------

def kv(P, budget_blocks=64, host_blocks=0, prefix_cache=True):
    k = P.BlockKVCache(P.get_config("stablelm-3b").reduced(), 0,
                       block_size=BS, prefix_cache=prefix_cache)
    k.budget = budget_blocks * k.block_bytes
    k.host_budget = host_blocks * k.block_bytes
    return k


def toks(rng_or_seed, n):
    rng = (rng_or_seed if isinstance(rng_or_seed, np.random.Generator)
           else np.random.default_rng(rng_or_seed))
    return rng.integers(0, 1000, n).astype(np.int32)


def lifecycle(k, slot, t):
    """Admit, prefill (publish) and free one request; the prompt tokens
    the cache already held."""
    matched = k.admit(slot, len(t), tokens=t)
    k.publish(slot, t, len(t))
    k.free(slot)
    return matched


def hooks(k):
    store = {"captured": [], "scattered": []}

    def capture(ids):
        store["captured"].extend(ids)
        return {i: ("payload", i) for i in ids}

    k.capture_hook = capture
    k.scatter_hook = store["scattered"].extend
    return store


def invariants(k):
    """The structural invariants of tests/test_prefix_cache.py."""
    assert set(k._cached) <= set(k._registry)
    assert sorted(k._slab_hash.values()) == sorted(k._registry)
    for h in k._cached:
        assert k._registry[h].id not in k._ref
    assert k.pool.in_use == (len(k._ref) + len(k._cached)) * k.block_bytes
    kids = set()
    for s in k._children.values():
        kids |= s
    assert kids == set(k._parent) <= set(k._registry)
    assert len(set(k._cached.values())) == len(k._cached)
    assert set(k._host) == set(k._host_lru)
    assert k._host_in_use == len(k._host) * k.block_bytes <= k.host_budget


def kv_counts(k) -> dict:
    return {name: k.metrics.counter(name).value for name in (
        "kv.prefix_cache_hits", "kv.prefix_cache_host_hits",
        "kv.prefix_cache_evictions", "kv.prefix_cache_host_evictions")} | {
        "cached": k.cached_blocks, "in_use": k.pool.in_use,
        "host_live": k.host_blocks_live}


def kv_revival(P):
    k = kv(P)
    t = toks(0, 13)
    seen = [lifecycle(k, 0, t), k.cached_blocks]
    seen.append(k.admit(1, len(t), tokens=t))
    assert seen == [0, 3, 3 * BS] and k.cached_blocks == 0
    invariants(k)
    k.publish(1, t, len(t))
    k.free(1)
    seen.append(kv_counts(k))
    k.clear_cache()
    k.assert_quiescent()
    off = kv(P, prefix_cache=False)
    lifecycle(off, 0, t)
    assert off.cached_blocks == 0 and off.admit(1, len(t), tokens=t) == 0
    off.free(1)
    off.assert_quiescent()
    return seen


def kv_leaf_first_lru(P):
    k = kv(P)
    rng = np.random.default_rng(1)
    stem = toks(rng, 2 * BS)
    a = np.concatenate([stem, toks(rng, BS), [1]]).astype(np.int32)
    b = np.concatenate([stem, toks(rng, BS), [2]]).astype(np.int32)
    lifecycle(k, 0, a)
    assert lifecycle(k, 1, b) == 2 * BS
    assert k.cached_blocks == 4

    def leaf(t):
        return k._chain_step(k._chain_step(k._chain_step(
            b"kv0", t, 0), t, 1), t, 2)

    la, lb = leaf(a), leaf(b)
    assert k.evict_cached()
    assert la not in k._registry and lb in k._registry
    assert k.evict_cached() and lb not in k._registry
    assert k.evict_cached() and k.evict_cached()
    assert not k.evict_cached()
    k.assert_quiescent()
    return kv_counts(k)


def kv_readmit_after_eviction(P):
    k = kv(P)
    t = toks(2, 4 * BS + 1)
    lifecycle(k, 0, t)
    assert k.evict_cached() and k.cached_blocks == 3
    assert k.admit(1, len(t), tokens=t) == 3 * BS
    invariants(k)
    k.publish(1, t, len(t))
    k.free(1)
    assert k.cached_blocks == 4
    counts = kv_counts(k)
    k.clear_cache()
    k.assert_quiescent()
    return counts


def kv_shrink_evicts_cache_first(P):
    k = kv(P, budget_blocks=8)
    lifecycle(k, 0, toks(3, 3 * BS))
    live = toks(4, 2 * BS + 1)
    k.admit(1, len(live), tokens=live)
    ids = k.table_ids(1)
    k.set_budget(4 * k.block_bytes)
    assert k.cached_blocks == 1 and k.table_ids(1) == ids
    k.set_budget(2 * k.block_bytes)
    assert k.table_ids(1) == ids and k.in_use > k.budget
    k.free(1)
    assert k.in_use <= k.budget
    invariants(k)
    counts = kv_counts(k)
    k.clear_cache()
    k.assert_quiescent()
    return counts


def kv_admit_reclaims_cold_cache(P):
    k = kv(P, budget_blocks=4)
    lifecycle(k, 0, toks(5, 4 * BS))
    fresh = toks(6, 3 * BS + 1)
    assert k.admit(1, len(fresh), tokens=fresh) == 0
    with pytest.raises(MemoryError):
        k.admit(2, 4 * BS, tokens=toks(7, 4 * BS))
    k.free(1)
    k.clear_cache()
    k.assert_quiescent()
    rows = kv(P)
    rows.row_cap = 4
    lifecycle(rows, 0, toks(8, 4 * BS))
    rows.admit(1, 3 * BS + 1, tokens=toks(9, 3 * BS + 1))
    assert max(rows.table_ids(1)) < 4
    return [kv_counts(k), rows.table_ids(1)]


def kv_host_second_chance(P):
    k = kv(P, host_blocks=8)
    store = hooks(k)
    t = toks(10, 3 * BS + 2)
    lifecycle(k, 0, t)
    k.clear_cache()
    assert k.pool.in_use == 0 and k.host_blocks_live == 3
    assert k.admit(1, len(t), tokens=t) == 3 * BS
    assert k.prefix_cache_host_hits == 3 and k.host_blocks_live == 0
    assert sorted(p for _, p in store["scattered"]) == \
        sorted(("payload", i) for i in store["captured"])
    invariants(k)
    k.free(1)
    k.clear_cache()
    k.assert_quiescent()
    bounded = kv(P, host_blocks=2)
    hooks(bounded)
    lifecycle(bounded, 0, toks(11, 5 * BS))
    bounded.clear_cache()
    assert bounded.host_blocks_live == 2
    invariants(bounded)
    bare = kv(P, host_blocks=4)           # a host budget but no hooks
    lifecycle(bare, 0, toks(12, 2 * BS))
    bare.clear_cache()
    assert bare.host_blocks_live == 0
    return [kv_counts(k), kv_counts(bounded), store["captured"]]


def kv_evict_span_and_audit(P):
    k = kv(P, host_blocks=1)
    hooks(k)
    k.rec = P.SpanRecorder(True)
    lifecycle(k, 0, toks(13, 2 * BS))
    k.clear_cache()
    evs = [e["args"] for e in k.rec.events if e["kind"] == "cache_evict"]
    assert [e["to_host"] for e in evs] == [True, True]
    assert all(e["bytes"] == k.block_bytes for e in evs)
    bad = kv(P)
    lifecycle(bad, 0, toks(15, 2 * BS))
    bad.assert_quiescent()                # a non-empty tier is fine
    del bad._registry[next(iter(bad._cached))]
    with pytest.raises(AssertionError):
        bad.assert_quiescent()
    return [evs, kv_counts(k)]


CODES = ("admit", "finish", "evict", "shrink", "clear", "admit", "finish",
         "admit")


def kv_random_traces(P):
    """The seeded op-trace fuzz: invariants after every op, a clean
    drain at the end; the counters it ends with."""
    out = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        ops = [(CODES[rng.integers(len(CODES))], int(rng.integers(100)))
               for _ in range(60)]
        rng = np.random.default_rng(seed)
        k = kv(P, budget_blocks=10, host_blocks=3)
        hooks(k)
        stems = [toks(rng, 2 * BS) for _ in range(2)]
        prompts = [np.concatenate([s, toks(rng, BS + t)]).astype(np.int32)
                   for s in stems for t in range(3)]
        live, nxt = {}, 0
        for code, arg in ops:
            if code == "admit":
                t = prompts[arg % len(prompts)]
                try:
                    k.admit(nxt, len(t), tokens=t)
                    live[nxt] = t
                    nxt += 1
                except MemoryError:
                    pass
            elif code == "finish" and live:
                slot = sorted(live)[arg % len(live)]
                t = live.pop(slot)
                k.publish(slot, t, len(t))
                k.free(slot)
            elif code == "evict":
                k.evict_cached()
            elif code == "shrink":
                k.set_budget((4 + arg % 7) * k.block_bytes)
            elif code == "clear":
                k.clear_cache()
            invariants(k)
        for slot in sorted(live):
            k.free(slot)
        k.set_budget(10 * k.block_bytes)
        if k.in_use > k.budget:
            k.clear_cache()
        k.assert_quiescent()
        out.append(kv_counts(k))
    return out


KV_CASES = {f.__name__: f for f in (
    kv_revival, kv_leaf_first_lru, kv_readmit_after_eviction,
    kv_shrink_evicts_cache_first, kv_admit_reclaims_cold_cache,
    kv_host_second_chance, kv_evict_span_and_audit, kv_random_traces)}


@pytest.mark.parametrize("name", sorted(KV_CASES))
def test_radix_cache_matches_jax(packages, name):
    jax_pkg, port_pkg = packages
    got = json.loads(json.dumps(KV_CASES[name](port_pkg)))
    assert got == json.loads(json.dumps(KV_CASES[name](jax_pkg)))


def test_release_to_returns_trailing_blocks(packages):
    for P in packages:
        k = P.BlockKVCache(P.get_config("stablelm-3b").reduced(),
                           budget_bytes=1 << 30, block_size=4)
        k.admit(0, 5)
        assert k.grow(0, 13) and k.in_use == 4 * k.block_bytes
        assert k.release_to(0, 6) == 2 and k.release_to(0, 6) == 0
        k.free(0)
        k.admit(1, 16)
        assert k.reuse_count == 4


# -- EngineConfig ---------------------------------------------------------------

ENVS = ("PARALLAX_MEGASTEP", "PARALLAX_HOST_POOL", "PARALLAX_FAULT_SEED",
        "PARALLAX_MEM_BUDGET", "PARALLAX_PREFIX_CACHE")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ENVS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def resolved(c) -> dict:
    return {f: getattr(c, f) for f, *_ in c.field_specs()}


@pytest.mark.parametrize("env,kw,want", [
    ({}, dict(hbm_budget=1 << 30),
     dict(megastep=8, host_pool=0, fault_seed=None, max_batch=8,
          block_size=16, max_context=64, max_queue=None)),
    ({"PARALLAX_MEGASTEP": "3", "PARALLAX_HOST_POOL": "1M",
      "PARALLAX_FAULT_SEED": "17", "PARALLAX_MEM_BUDGET": "512M"}, {},
     dict(megastep=3, host_pool=1 << 20, fault_seed=17,
          hbm_budget=512 << 20)),
    ({"PARALLAX_MEGASTEP": "3", "PARALLAX_HOST_POOL": "256M",
      "PARALLAX_FAULT_SEED": "17"},
     dict(megastep=1, host_pool=0, fault_seed=None, hbm_budget=1 << 30),
     dict(megastep=1, host_pool=0, fault_seed=None)),
    ({"PARALLAX_PREFIX_CACHE": "1"}, dict(hbm_budget="512M",
                                          host_pool="64K",
                                          max_context="none"),
     dict(prefix_cache=True, hbm_budget=512 << 20, host_pool=64 << 10,
          max_context=None)),
], ids=["defaults", "env-beats-default", "explicit-falsy-beats-env",
        "suffixes-and-none"])
def test_config_precedence_matches_jax(packages, clean_env, env, kw, want):
    for var, value in env.items():
        clean_env.setenv(var, value)
    jax_c, port_c = (P.EngineConfig(**kw) for P in packages)
    assert resolved(port_c) == resolved(jax_c)
    assert {k: getattr(port_c, k) for k in want} == want


@pytest.mark.parametrize("kw", [
    dict(hbm_budget=0), dict(margin=1.0), dict(margin=-0.1),
    dict(host_pool=-1), dict(max_batch=0), dict(prefill_chunk=0),
    dict(block_size=0), dict(megastep=0), dict(max_context=0),
    dict(max_queue=-1), dict(dispatch_retries=-1),
    dict(retry_backoff_s=-0.5)])
def test_config_validation_rejects(packages, kw):
    for P in packages:
        with pytest.raises(ValueError, match="EngineConfig"):
            P.EngineConfig(**kw)


def test_bad_env_value_names_the_var(clean_env):
    from repro_torch.runtime.config import EngineConfig

    clean_env.setenv("PARALLAX_MEGASTEP", "soon")
    with pytest.raises(ValueError, match="PARALLAX_MEGASTEP"):
        EngineConfig()


def test_field_table_equals_jax(packages):
    jax_pkg, port_pkg = packages
    assert [s[:3] for s in port_pkg.EngineConfig.field_specs()] == \
        [s[:3] for s in jax_pkg.EngineConfig.field_specs()]


def _cli(P, argv):
    ap = argparse.ArgumentParser()
    P.EngineConfig.add_cli_args(ap)
    return ap.parse_args(argv)


@pytest.mark.parametrize("field", [
    s[0] for s in Package("repro_torch").EngineConfig.field_specs()])
def test_every_field_is_a_cli_flag(packages, clean_env, field):
    """Each field's flag exists, defaults to absent (UNSET), and a given
    flag resolves as JAX's does."""
    values = {"margin": "0.25", "retry_backoff_s": "0.5",
              "max_context": "none", "fault_seed": "5",
              "hbm_budget": "128M", "host_pool": "1M"}
    bools = ("paged", "prefix_sharing", "prefix_cache")
    flag = "--" + field.replace("_", "-")
    argv = [("--no-" + field.replace("_", "-")) if field in bools
            else flag] + ([] if field in bools else [values.get(field, "3")])
    got = []
    for P in packages:
        assert getattr(_cli(P, []), field) is None
        c = P.EngineConfig.from_cli_args(_cli(P, argv), hbm_budget=1 << 30) \
            if field != "hbm_budget" else \
            P.EngineConfig.from_cli_args(_cli(P, argv))
        got.append(getattr(c, field))
    assert got[0] == got[1]


def test_cli_roundtrip_and_precedence(clean_env):
    P = Package("repro_torch")
    clean_env.setenv("PARALLAX_MEGASTEP", "3")
    clean_env.setenv("PARALLAX_HOST_POOL", "256M")
    args = _cli(P, ["--max-batch", "5", "--host-pool", "0", "--hbm-budget",
                    "128M", "--no-paged", "--max-context", "none"])
    c = P.EngineConfig.from_cli_args(args)
    assert (c.max_batch, c.host_pool, c.megastep, c.hbm_budget, c.paged,
            c.max_context) == (5, 0, 3, 128 << 20, False, None)
    assert P.EngineConfig.from_cli_args(args, max_batch=9).max_batch == 9


# -- the §3.3 default budget: the host's on the CPU, the card's on CUDA -------

MEMINFO = "MemTotal:  65000000 kB\nMemAvailable:  12345678 kB\n"


@pytest.fixture
def fake_meminfo(clean_env):
    real = builtins.open

    def fake(path, *a, **k):
        if path == "/proc/meminfo":
            return io.StringIO(MEMINFO)
        return real(path, *a, **k)

    clean_env.setattr(builtins, "open", fake)
    return clean_env


def test_cpu_budget_default_equals_jax(packages, fake_meminfo):
    jax_pkg, port_pkg = packages
    want = 12345678 * 1024
    assert port_pkg.scheduler.query_available_memory() == want
    assert port_pkg.scheduler.query_available_memory("cpu") == want
    assert jax_pkg.scheduler.query_available_memory() == want
    assert port_pkg.scheduler.memory_budget(margin=0.4, device="cpu") == \
        jax_pkg.scheduler.memory_budget(margin=0.4)
    c = port_pkg.EngineConfig()
    assert c.hbm_budget == jax_pkg.EngineConfig().hbm_budget == want
    assert c.on_device("cpu") is c


def test_cuda_budget_reads_the_card(packages, fake_meminfo):
    """A CUDA device takes ``torch.cuda.mem_get_info``'s free bytes;
    ``PARALLAX_MEM_BUDGET`` and an explicit budget still win."""
    from repro_torch.core import ParallaxConfig, compile_plan

    _, P = packages
    card = 3 << 30
    asked = []

    def mem_get_info(device=None):
        asked.append(torch.device(device))
        return card, 80 << 30

    fake_meminfo.setattr(torch.cuda, "mem_get_info", mem_get_info)
    assert P.scheduler.query_available_memory("cuda") == card
    assert P.scheduler.query_available_memory(torch.device("cuda:0")) == card
    assert asked[-1] == torch.device("cuda:0")
    assert P.scheduler.memory_budget(margin=0.5, device="cuda") == card // 2
    assert P.EngineConfig().on_device("cuda").hbm_budget == card
    assert P.EngineConfig(hbm_budget=5).on_device("cuda").hbm_budget == 5
    sys.path.insert(0, os.path.dirname(__file__))
    from torch_graph_zoo import multihead_graph

    g, _ = multihead_graph()
    assert compile_plan(g, ParallaxConfig(device="cuda")).schedule.budget \
        == P.scheduler.memory_budget(available=card)
    assert compile_plan(g, ParallaxConfig()).schedule.budget \
        == P.scheduler.memory_budget(available=12345678 * 1024)
    fake_meminfo.setenv("PARALLAX_MEM_BUDGET", "1G")
    assert P.scheduler.query_available_memory("cuda") == 1 << 30
    assert P.EngineConfig().on_device("cuda").hbm_budget == 1 << 30


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    child()
