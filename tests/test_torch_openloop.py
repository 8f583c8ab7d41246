"""The port's open-loop arrivals, deadlines and step/drain surface against
the JAX package.

Workloads: ``OpenLoopWorkload.poisson`` and the JSONL trace round trip
give the same arrivals and prompts in both packages for a seed, and a
trace written by either package reads back in the other.

Engines: ``run_open_loop`` through the port's ``ContinuousEngine`` on
``stablelm-3b.reduced()`` with JAX's weights bridged in (the cases of
``tests/test_openloop.py``'s child): every id resolves, completed streams
equal the closed-loop run at megastep 1 and 8 and equal the JAX
engine's, a trace replays to the same streams, the step/drain surface
matches ``run()`` on both engines, and deadline cancellations are
accounted.  The JAX side runs in a child process (this file with
``--child``) with ``jax_cpu_enable_async_dispatch`` off.  Open-loop
batching depends on the wall clock, so these cases compare streams and
statuses, never dispatch counts.

Accounting: the stub-engine cases of ``tests/test_openloop.py`` run on
the port's ``run_open_loop``.
"""

import importlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

N_REQUESTS, RATE_RPS, SEED = 8, 120.0, 7
MEGASTEPS = (1, 8)


class Package:
    """The open-loop surface of ``repro`` or ``repro_torch``."""

    def __init__(self, name: str):
        def mod(path):
            return importlib.import_module(f"{name}.{path}")

        eng, wl = mod("runtime.engine"), mod("runtime.workload")
        self.name = name
        self.ContinuousEngine = eng.ContinuousEngine
        self.ServingEngine = eng.ServingEngine
        self.Request, self.Completion = eng.Request, eng.Completion
        self.EngineConfig = mod("runtime.config").EngineConfig
        self.OpenLoopWorkload = wl.OpenLoopWorkload
        self.Arrival = wl.Arrival
        self.run_open_loop = wl.run_open_loop
        self.device = {"device": "cpu"} if name == "repro_torch" else {}

    def engine(self, m, megastep=8):
        conf = self.EngineConfig(hbm_budget=1 << 30, max_batch=3,
                                 block_size=4, max_context=32,
                                 megastep=megastep, host_pool=0,
                                 fault_seed=None, prefix_cache=False)
        return self.ContinuousEngine(m.api, m.params, config=conf,
                                     stepper=m.stepper, **self.device)

    def round_engine(self, m):
        conf = self.EngineConfig(hbm_budget=1 << 30, max_batch=3,
                                 max_context=None)
        return self.ServingEngine(m.api, m.params, config=conf,
                                  stepper=m.stepper, **self.device)

    def workload(self, vocab, seed=SEED, **kw):
        return self.OpenLoopWorkload.poisson(RATE_RPS, N_REQUESTS, vocab,
                                             seed=seed, **kw)


def streams(done) -> dict:
    return {str(rid): [int(t) for t in c.tokens]
            for rid, c in sorted(done.items())}


def statuses(done) -> dict:
    return {str(rid): [c.status, c.reason] for rid, c in sorted(done.items())}


def closed(P, eng, reqs) -> dict:
    for r in reqs:
        eng.submit(P.Request(r.id, r.prompt, r.max_new_tokens,
                             deadline_s=r.deadline_s))
    return eng.run()


def step_drain(eng, reqs) -> dict:
    """submit everything, then step until quiet, draining every step."""
    for r in reqs:
        eng.submit(r)
    done = {c.request_id: c for c in eng.drain_completions()}
    while eng.has_work():
        eng.step()
        for c in eng.drain_completions():
            assert c.request_id not in done, "completion drained twice"
            done[c.request_id] = c
    assert eng.drain_completions() == []
    if hasattr(eng, "assert_quiescent"):       # the round engine has none
        eng.assert_quiescent()
    return done


def engine_cases(P, m, trace_dir) -> dict:
    """Every engine-level reading both packages must agree on."""
    out = {}
    mk = lambda: [a.request for a in P.workload(m.cfg.vocab_size)]  # noqa: E731
    for n in MEGASTEPS:
        ref = closed(P, P.engine(m, n), mk())
        inc = step_drain(P.engine(m, n), mk())
        assert streams(inc) == streams(ref), f"megastep {n}: drain != run"
        wl = P.workload(m.cfg.vocab_size)
        eng = P.engine(m, n)
        res = P.run_open_loop(eng, wl)
        eng.assert_quiescent()
        assert sorted(res.completions) == [a.request.id for a in wl]
        assert all(c.ok for c in res.completions.values())
        assert all(c.ttft_submit_s > 0 for c in res.completions.values())
        for a in wl:
            assert res.submit_t[a.request.id] >= a.t_s - 1e-9
        assert streams(res.completions) == streams(ref), \
            f"megastep {n}: open loop != closed loop"
        out[f"m{n}"] = streams(ref)
    r_ref = closed(P, P.round_engine(m), mk())
    assert streams(step_drain(P.round_engine(m), mk())) == streams(r_ref)
    out["round"] = streams(r_ref)

    # the trace round trip through an engine
    path = os.path.join(trace_dir, f"{P.name}.jsonl")
    P.workload(m.cfg.vocab_size).save_trace(path)
    replay = P.OpenLoopWorkload.from_trace(path)
    res = P.run_open_loop(P.engine(m), replay)
    assert streams(res.completions) == out["m8"]
    assert res.by_status() == {"completed": N_REQUESTS}

    # deadlines: even ids expire before admission, odd ids never do
    wl = P.workload(m.cfg.vocab_size)
    tight = P.OpenLoopWorkload([P.Arrival(a.t_s, P.Request(
        a.request.id, a.request.prompt, a.request.max_new_tokens,
        deadline_s=1e-9 if a.request.id % 2 == 0 else 300.0)) for a in wl])
    eng = P.engine(m)
    res = P.run_open_loop(eng, tight)
    eng.assert_quiescent()
    by = res.by_status()
    assert sum(by.values()) == N_REQUESTS == len(res.completions)
    assert by["cancelled"] == N_REQUESTS // 2 == eng.cancellations
    for rid, c in res.completions.items():
        if rid % 2 == 0:
            assert (c.status, c.reason, c.tokens) == \
                ("cancelled", "deadline", [])
        else:
            assert c.ok and c.tokens == out["m8"][str(rid)]
    out["deadline"] = {"statuses": statuses(res.completions),
                       "streams": streams(res.completions)}
    return out


def workload_record(wl) -> list:
    return [[a.t_s, a.request.id, a.request.max_new_tokens,
             a.request.deadline_s, np.asarray(a.request.prompt).tolist()]
            for a in wl]


# -- the JAX side: a child process -------------------------------------------

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
    print(json.dumps(engine_cases(Package("repro"), m, trace_dir)))


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
def port_cases(port, tmp_path_factory):
    P, m = port
    return engine_cases(P, m, str(tmp_path_factory.mktemp("torch_traces")))


@pytest.mark.parametrize("key", ["m1", "m8", "round", "deadline"])
def test_engine_streams_match_jax(jax_reference, port_cases, key):
    """Open loop, closed loop, step/drain and the trace replay agree
    within the port (asserted while the cases ran) and with JAX."""
    assert port_cases[key] == jax_reference[key]


def test_megastep_does_not_change_streams(port_cases):
    assert port_cases["m1"] == port_cases["m8"] == port_cases["round"]


# -- workloads across the two packages ---------------------------------------

@pytest.fixture(scope="module")
def packages():
    return Package("repro"), Package("repro_torch")


@pytest.mark.parametrize("seed,deadline", [(0, None), (3, 0.5), (SEED, None)])
def test_poisson_workload_equals_jax(packages, seed, deadline):
    jw, tw = (P.OpenLoopWorkload.poisson(25.0, 40, 512, seed=seed,
                                         deadline_s=deadline)
              for P in packages)
    assert workload_record(tw) == workload_record(jw)


@pytest.mark.parametrize("writer", [0, 1], ids=["jax-writes", "port-writes"])
def test_trace_reads_back_in_the_other_package(packages, tmp_path, writer):
    src, dst = packages[writer], packages[1 - writer]
    wl = src.OpenLoopWorkload.poisson(25.0, 12, vocab_size=128, seed=1,
                                      deadline_s=0.5)
    path = str(tmp_path / "trace.jsonl")
    wl.save_trace(path)
    back = dst.OpenLoopWorkload.from_trace(path)
    mine = src.OpenLoopWorkload.from_trace(path)
    assert workload_record(back) == workload_record(mine)
    for x, y in zip(wl, back):
        assert x.t_s == pytest.approx(y.t_s, abs=1e-9)
        assert np.array_equal(x.request.prompt, y.request.prompt)
        assert x.request.deadline_s == y.request.deadline_s


def test_prompt_len_trace_derives_the_same_prompts(packages, tmp_path):
    path = str(tmp_path / "lens.jsonl")
    with open(path, "w") as f:
        for i, (t, n, new) in enumerate(((0.0, 6, 4), (0.5, 9, 2))):
            f.write(json.dumps({"t_s": t, "id": i, "prompt_len": n,
                                "max_new": new}) + "\n")
    jw, tw = (P.OpenLoopWorkload.from_trace(path, vocab_size=64, seed=9)
              for P in packages)
    assert workload_record(tw) == workload_record(jw)
    for P in packages:
        with pytest.raises(ValueError, match="vocab_size"):
            P.OpenLoopWorkload.from_trace(path)


# -- the clock loop's accounting on the port's module (stub engine) ----------

class StubEngine:
    """Step-counted engine double: each request finishes after
    ``steps_per_req`` step() calls; a deadline resolves it as
    ``cancelled``, as the real engine does."""

    def __init__(self, Completion, steps_per_req=2, max_active=2):
        self.Completion = Completion
        self.waiting, self.active, self._done = [], {}, []
        self.num_active = 0
        self.max_active = max_active
        self.steps_per_req = steps_per_req
        self._submit_t = {}

    def submit(self, req):
        self.waiting.append(req)
        self._submit_t[req.id] = time.perf_counter()

    def has_work(self):
        return bool(self.waiting) or bool(self.active)

    def step(self):
        while self.waiting and len(self.active) < self.max_active:
            r = self.waiting.pop(0)
            self.active[r.id] = [r, self.steps_per_req]
        for rid in list(self.active):
            r, left = self.active[rid]
            age = time.perf_counter() - self._submit_t[rid]
            if r.deadline_s is not None and age > r.deadline_s:
                del self.active[rid]
                self._done.append(self.Completion(
                    rid, tokens=[0], status="cancelled", reason="deadline"))
                continue
            self.active[rid][1] = left - 1
            if left - 1 <= 0:
                del self.active[rid]
                self._done.append(self.Completion(
                    rid, tokens=[0] * r.max_new_tokens, ttft_submit_s=age))
        self.num_active = len(self.active)

    def drain_completions(self):
        out, self._done = self._done, []
        return out


@pytest.fixture(scope="module")
def P():
    return Package("repro_torch")


def test_run_open_loop_accounting_and_order(P):
    wl = P.OpenLoopWorkload.poisson(2000.0, 20, vocab_size=8, seed=0)
    res = P.run_open_loop(StubEngine(P.Completion), wl)
    assert sorted(res.completions) == [a.request.id for a in wl]
    assert res.by_status() == {"completed": 20}
    assert set(res.submit_t) == set(res.finish_t) == set(res.completions)
    for rid in res.completions:
        assert res.finish_t[rid] >= res.submit_t[rid]
    assert res.wall_s > 0 and res.iterations > 0
    assert res.queue_samples, "queue depth never sampled"


def test_run_open_loop_respects_arrival_times(P):
    wl = P.OpenLoopWorkload.poisson(50.0, 10, vocab_size=8, seed=2)
    res = P.run_open_loop(StubEngine(P.Completion, steps_per_req=1), wl)
    for a in wl:
        assert res.submit_t[a.request.id] >= a.t_s - 1e-9


def test_run_open_loop_deadline_cancellations_accounted(P):
    wl = P.OpenLoopWorkload.poisson(5000.0, 30, vocab_size=8, seed=1,
                                    deadline_s=0.005)
    res = P.run_open_loop(StubEngine(P.Completion, steps_per_req=50_000,
                                     max_active=1), wl)
    by = res.by_status()
    assert sum(by.values()) == 30 == len(res.completions)
    assert by.get("cancelled", 0) > 0


def test_workload_validation_and_percentile(P):
    from repro_torch.runtime.workload import percentile

    def r(i):
        return P.Request(i, np.zeros(3, np.int32), max_new_tokens=2)

    with pytest.raises(ValueError, match="time-ordered"):
        P.OpenLoopWorkload([P.Arrival(1.0, r(0)), P.Arrival(0.5, r(1))])
    with pytest.raises(ValueError, match="duplicate"):
        P.OpenLoopWorkload([P.Arrival(0.0, r(0)), P.Arrival(0.5, r(0))])
    with pytest.raises(ValueError, match="rate_rps"):
        P.OpenLoopWorkload.poisson(0.0, 4, vocab_size=16)
    assert percentile([], 95) == 0.0
    assert percentile([1.0, None, 3.0], 50) == 2.0


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    child(sys.argv[2])
