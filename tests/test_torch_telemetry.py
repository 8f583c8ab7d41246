"""The port's telemetry plane against the JAX engine's.

On ``stablelm-3b.reduced()`` with JAX's weights bridged in, the same
workloads run through both packages' engines: a megastep run (N=8), a
sync run (N=1), a run that preempts through the host tier under a
budget fault (spill, stall, restore), and the round engine.  For each,
the port's ``engine.stats()`` (without the stepper's entry, histograms
by bucket counts), its recorded events (every field but the host-clock
readings: ``ts``, ``dur`` and the TTFTs) and its saved Chrome trace
(validated by ``validate_chrome_trace``: event names and counts per
phase) equal the JAX engine's, and a traced run gives the same streams
and dispatch counts as an untraced one.  Within the port the span taxonomy of
``tests/test_telemetry.py`` holds.  The port's model-step spans and
host reads (``MODEL_KINDS``, ``SYNC_KINDS``: events and ``sync.*``
counters JAX has no counterpart of) are left out of the comparison with
JAX, which holds every kind and counter JAX records; they are checked
here against the engine's own dispatches and in
``tests/test_torch_model_spans.py``.  The JAX side runs in a child process
(this file with ``--child``) with ``jax_cpu_enable_async_dispatch`` off.
"""

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
SCENARIOS = ("m1", "m8", "fault", "round")


class Package:
    """The telemetry surface of ``repro`` or ``repro_torch``."""

    def __init__(self, name: str):
        def mod(path):
            return importlib.import_module(f"{name}.{path}")

        eng, tele = mod("runtime.engine"), mod("runtime.telemetry")
        self.name = name
        self.ContinuousEngine = eng.ContinuousEngine
        self.ServingEngine = eng.ServingEngine
        self.Request = eng.Request
        self.EngineConfig = mod("runtime.config").EngineConfig
        faults = mod("runtime.faults")
        self.FaultEvent, self.FaultPlane = faults.FaultEvent, faults.FaultPlane
        self.BlockKVCache = mod("runtime.kv_cache").BlockKVCache
        self.tele = tele
        self.device = {"device": "cpu"} if name == "repro_torch" else {}
        # the port's model-step and host-read kinds (none in JAX)
        self.port_only = frozenset(getattr(tele, "MODEL_KINDS", ())) | \
            frozenset(getattr(tele, "SYNC_KINDS", ()))

    def engine(self, m, telemetry=None, **kw):
        base = dict(hbm_budget=1 << 30, max_batch=MAX_BATCH,
                    block_size=BLOCK, max_context=MAX_CONTEXT, megastep=8,
                    host_pool=0, fault_seed=None, prefix_cache=False,
                    retry_backoff_s=0.0)
        base.update(kw)
        return self.ContinuousEngine(
            m.api, m.params, config=self.EngineConfig(**base),
            stepper=m.stepper, telemetry=telemetry, **self.device)

    def round_engine(self, m, telemetry=None):
        conf = self.EngineConfig(hbm_budget=1 << 30, max_batch=MAX_BATCH,
                                 max_context=MAX_CONTEXT)
        return self.ServingEngine(m.api, m.params, config=conf,
                                  stepper=m.stepper, telemetry=telemetry,
                                  **self.device)


def prompts(cfg, n, plen=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
            for _ in range(n)]


def stats_view(eng, drop=frozenset()) -> dict:
    """``engine.stats()`` without the stepper's entry and the counters
    named in ``drop``, histograms by bucket counts."""
    s = eng.stats()
    s.pop("stepper", None)
    s["counters"] = {k: v for k, v in s["counters"].items()
                     if k not in drop}
    s["histograms"] = {k: v["counts"] for k, v in s["histograms"].items()}
    return s


def scenario(P, m, name, telemetry):
    """One workload on a fresh engine; returns (engine, completions)."""
    if name == "round":
        eng = P.round_engine(m, telemetry)
        for i, p in enumerate(prompts(m.cfg, 4)):
            eng.submit(P.Request(i, p, max_new_tokens=4))
        return eng, eng.run()
    if name == "fault":
        # a shrink below one block demotes every active row into the
        # host tier, nothing readmits until the scheduled restore
        # (stalled points), then the rows come back from the host
        probe = P.BlockKVCache(m.cfg, 0, block_size=BLOCK)
        eng = P.engine(m, telemetry, megastep=1,
                       host_pool=64 * probe.block_bytes,
                       hbm_budget=int(12 * probe.block_bytes / 0.6) + 1)
        full = eng.kv.budget
        eng.faults = P.FaultPlane([
            P.FaultEvent(3, "budget", budget_bytes=probe.block_bytes),
            P.FaultEvent(9, "budget", budget_bytes=full)])
        for i, p in enumerate(prompts(m.cfg, 3, plen=6)):
            eng.submit(P.Request(i, p, max_new_tokens=10))
        return eng, eng.run()
    # prefill_chunk 4 < the prompt, so the chunked prefill path engages
    eng = P.engine(m, telemetry, megastep=int(name[1:]), prefill_chunk=4)
    for i, p in enumerate(prompts(m.cfg, 4)):
        eng.submit(P.Request(i, p, max_new_tokens=4))
    return eng, eng.run()


def events_view(events) -> list:
    """Recorded events without their host-clock readings: the ``ts`` /
    ``dur`` stamps and the ``first_token`` points' TTFTs."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items()
                         if not k.startswith("ttft")}
        out.append(e)
    return out


def record(P, m, name, trace_path) -> dict:
    """A scenario traced and untraced: what both packages must agree on
    (the invariances are asserted here, so they hold for both)."""
    base, base_done = scenario(P, m, name, None)
    tele = P.tele.Telemetry(trace=True)
    eng, done = scenario(P, m, name, tele)
    if hasattr(eng, "assert_quiescent"):
        base.assert_quiescent()
        eng.assert_quiescent()
        assert (base.iterations, base.fused_iterations) == \
            (eng.iterations, eng.fused_iterations)
    assert {k: c.tokens for k, c in base_done.items()} == \
        {k: c.tokens for k, c in done.items()}, "tracing changed a stream"
    assert base.dispatches == eng.dispatches
    assert stats_view(base) == stats_view(eng)
    want = {"round": ("prefill_chunk", "decode"),
            "m1": ("iteration", "kv_pool", "decode"),
            "m8": ("iteration", "kv_pool", "megastep"),
            "fault": ("iteration", "kv_pool", "spill", "restore")}[name]
    tele.save_chrome_trace(trace_path)
    P.tele.validate_chrome_trace(trace_path, require_names=want)
    shared = [e for e in tele.events if e["kind"] not in P.port_only]
    summary = P.tele.validate_chrome_trace(P.tele.chrome_trace(shared))
    return json.loads(json.dumps({
        "streams": {str(k): [c.status, [int(t) for t in c.tokens]]
                    for k, c in sorted(done.items())},
        "dispatches": eng.dispatches,
        "stats": stats_view(eng, P.port_only),
        "events": events_view(shared),
        "trace": {"phases": summary["phases"], "names": summary["names"],
                  "events": summary["events"]},
        "port": {"events": tele.events if P.port_only else [],
                 "counters": {k: v for k, v in
                              eng.stats()["counters"].items()
                              if k in P.port_only}}}))


def child(trace_dir: str) -> None:
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
    print(json.dumps({s: record(P, m, s, os.path.join(trace_dir, s + ".json"))
                      for s in SCENARIOS}))


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    trace_dir = str(tmp_path_factory.mktemp("jax_traces"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, "--child", trace_dir],
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
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
def port_records(port, tmp_path_factory):
    P, m = port
    d = tmp_path_factory.mktemp("torch_traces")
    return {s: record(P, m, s, str(d / f"{s}.json")) for s in SCENARIOS}


@pytest.mark.parametrize("part", ["streams", "dispatches", "stats", "events",
                                  "trace"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_matches_jax(jax_reference, port_records, name, part):
    assert port_records[name][part] == jax_reference[name][part]


def test_stats_deterministic_across_runs(port):
    """Two identical seeded runs give identical snapshots, with the
    expected families."""
    P, m = port
    snaps = [stats_view(scenario(P, m, "m8", None)[0]) for _ in range(2)]
    assert snaps[0] == snaps[1]
    assert snaps[0]["counters"]["engine.requests_resolved"] == 4
    assert snaps[0]["gauges"]["kv.blocks_live"]["high_water"] > 0
    assert snaps[0]["derived"]["degraded_activations"] == 0


def test_span_taxonomy(port_records):
    """Every span kind the engine can emit over the megastep, sync and
    fault runs, each event shaped per its kind, per-request timelines
    from submit to complete."""
    from repro_torch.runtime.telemetry import (DURATION_KINDS,
                                               MODEL_KINDS, REQUEST_KINDS,
                                               SPAN_KINDS, SYNC_KINDS)

    seen = set()
    for name in ("m1", "m8", "fault"):
        for e in port_records[name]["events"]:
            seen.add(e["kind"])
            assert e["kind"] in SPAN_KINDS
            if e["kind"] in REQUEST_KINDS:
                assert "request_id" in e
        timelines = {}
        for e in port_records[name]["events"]:
            if "request_id" in e:
                timelines.setdefault(e["request_id"], []).append(e["kind"])
        assert all(t[0] == "submit" and t[-1] == "complete"
                   for t in timelines.values())
    # segment is the hetero runtime's; cache_evict needs the prefix cache;
    # the port-only kinds are the next test's
    assert seen == set(SPAN_KINDS) - {"segment", "cache_evict"} \
        - set(MODEL_KINDS) - set(SYNC_KINDS)
    port = {e["kind"] for name in ("m1", "m8", "fault")
            for e in port_records[name]["port"]["events"]
            if e["kind"] in set(MODEL_KINDS) | set(SYNC_KINDS)}
    # stablelm: attention and dense channels, no MoE capacity read
    assert port == {"embed", "attn", "mlp", "head", "sync.engine_copy",
                    "sync.kv_spill", "sync.kv_restore", "sync.step_inputs"}
    fault = port_records["fault"]["events"]
    stalled = [e for e in fault if e["kind"] == "stalled"]
    assert stalled and all(e["args"]["cause"] == "budget_shrunk"
                           and e["args"]["restore_eta_iteration"] == 9
                           for e in stalled)
    assert port_records["fault"]["stats"]["counters"]["engine.stalls"] \
        == len(stalled)
    assert {"spill", "restore"} <= set(DURATION_KINDS)


@pytest.mark.parametrize("name", SCENARIOS)
def test_host_reads_inside_their_dispatch(port, port_records, name):
    """Port only: every ``sync.*`` copy is counted and lies inside the
    span that made it: the continuous engine's 3 result copies a
    megastep, 2 a decode step and 2 or none a prefill chunk (the round
    engine's 1 a decode step, 1 or none a chunk), the stepper's input
    copies in every dispatch, and a spill or restore that moved blocks
    copies the block ids and 2 pools per attention layer."""
    _, m = port
    rec = port_records[name]["port"]
    reads = [e for e in rec["events"] if e["kind"].startswith("sync.")]
    assert rec["counters"] == {k: sum(e["kind"] == k for e in reads)
                               for k in {e["kind"] for e in reads}}
    tier = {0, 1 + 2 * m.cfg.num_layers}
    want = {"megastep": {3}, "decode": {2}, "prefill_chunk": {0, 2},
            "spill": tier, "restore": tier}
    if name == "round":
        want.update(decode={1}, prefill_chunk={0, 1})
    covered = 0
    for e in rec["events"]:
        if e["kind"] not in want:
            continue
        mine = [r for r in reads if e["ts"] <= r["ts"] <= e["ts"] + e["dur"]]
        covered += len(mine)
        kinds = [r["kind"] for r in mine]
        if e["kind"] in ("spill", "restore"):
            assert len(mine) in tier
            assert bool(mine) == bool(e["args"]["transferred"])
            assert set(kinds) <= {f"sync.kv_{e['kind']}"}
        else:
            assert kinds.count("sync.engine_copy") in want[e["kind"]], e
            assert kinds.count("sync.step_inputs") >= 3
            assert set(kinds) <= {"sync.engine_copy", "sync.step_inputs"}
    assert covered == len(reads)


def test_host_clock_stamps(port):
    """Durations are stamped and non-negative in a real engine trace."""
    P, m = port
    tele = P.tele.Telemetry(trace=True)
    scenario(P, m, "m8", tele)
    from repro_torch.runtime.telemetry import DURATION_KINDS

    for e in tele.events:
        assert e["ts"] > 0.0
        assert ("dur" in e) == (e["kind"] in DURATION_KINDS)
        assert e.get("dur", 0.0) >= 0.0


def test_fused_iterations_semantics(port):
    """iterations counts step() calls, fused_iterations the decode
    iterations executed; fusion takes fewer step() calls."""
    P, m = port
    e1, _ = scenario(P, m, "m1", None)
    e8, _ = scenario(P, m, "m8", None)
    assert e1.megasteps == 0 and 0 < e1.fused_iterations <= e1.iterations
    assert e8.megasteps > 0 and e8.fused_iterations >= e8.megastep_steps > 0
    assert e8.iterations < e1.iterations
    assert e8.stats()["counters"]["engine.fused_iterations"] \
        == e8.fused_iterations


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    child(sys.argv[2])
