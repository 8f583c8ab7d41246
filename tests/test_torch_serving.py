"""The port's ContinuousEngine against the JAX engine, on bridged weights.

The JAX reference runs in a child process (this file with ``--child``),
because bit-identical JAX streams need ``jax_cpu_enable_async_dispatch``
off, a process-wide switch (see ``tests/serving_identity_child.py``).  The
child serves a seeded workload — mixed lengths plus a family of requests
sharing a 16-token prompt prefix — through ``stablelm-3b.reduced()`` at
megastep 1 and 8 and prints greedy streams and dispatch counts as JSON.
The port serves the same workload on the same parameters (initialised
from the same ``jax.random`` key, bridged as numpy) and must emit
identical streams with equal ``engine.dispatches``.  Within the port,
streams must not depend on megastep N or prefix sharing, a poisoned
megastep must fall back and end bit-identical to the fault-free run,
preemption (host-tier spill or discard) must not change a stream, and
every engine must drain to quiescence.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

MAX_BATCH, BLOCK, MAX_CONTEXT = 3, 4, 32
MEGASTEPS = (1, 8)


def workload(vocab: int):
    """(id, prompt, max_new) triples: 6 mixed lengths, then 6 requests
    that share a 16-token prefix (later ones overlap live holders)."""
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, vocab, int(rng.integers(3, 14))),
             int(rng.integers(2, 9))) for i in range(6)]
    prefix = rng.integers(0, vocab, 16)
    reqs += [(6 + i, np.concatenate([prefix, rng.integers(0, vocab,
                                                          1 + i % 3)]),
              3 + (i * 5) % 9) for i in range(6)]
    return [(i, p.astype(np.int32), n) for i, p, n in reqs]


def child() -> None:
    """JAX reference: streams and dispatches at each megastep N."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax

    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.config import EngineConfig
    from repro.runtime.engine import ContinuousEngine, Request
    from repro.runtime.stepper import Stepper

    cfg = get_config("stablelm-3b").reduced()
    api = build_model(cfg)
    params = api.init(jax.random.key(0))
    stepper = Stepper(api)
    out = {}
    for n in MEGASTEPS:
        eng = ContinuousEngine(api, params, stepper=stepper, config=EngineConfig(
            hbm_budget=1 << 30, max_batch=MAX_BATCH, block_size=BLOCK,
            max_context=MAX_CONTEXT, megastep=n))
        for i, prompt, max_new in workload(cfg.vocab_size):
            eng.submit(Request(i, prompt, max_new))
        done = eng.run()
        eng.assert_quiescent()
        out[str(n)] = {"streams": {str(k): v.tokens
                                   for k, v in done.items()},
                       "dispatches": eng.dispatches,
                       "shared_hits": eng.kv.shared_block_hits}
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
def port():
    """The port's API and the JAX model's parameters, bridged."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.bridge import params_from_numpy

    jparams = jax_build_model(jax_get_config("stablelm-3b").reduced()) \
        .init(jax.random.key(0))
    cfg = get_config("stablelm-3b").reduced()
    api = build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return api, params


def serve(api, params, megastep, faults=None, **knobs):
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ContinuousEngine, Request

    knobs = {"hbm_budget": 1 << 30, **knobs}
    eng = ContinuousEngine(api, params, device="cpu", config=EngineConfig(
        max_batch=MAX_BATCH, block_size=BLOCK, max_context=MAX_CONTEXT,
        megastep=megastep, **knobs))
    eng.faults = faults
    for i, prompt, max_new in workload(api.cfg.vocab_size):
        eng.submit(Request(i, prompt, max_new))
    done = eng.run()
    eng.assert_quiescent()
    assert all(c.ok for c in done.values())
    return {str(k): v.tokens for k, v in done.items()}, eng


@pytest.mark.parametrize("megastep", MEGASTEPS)
def test_streams_and_dispatches_match_jax_engine(jax_reference, port,
                                                 megastep):
    api, params = port
    streams, eng = serve(api, params, megastep)
    ref = jax_reference[str(megastep)]
    assert streams == ref["streams"]
    assert eng.dispatches == ref["dispatches"]
    assert eng.kv.shared_block_hits == ref["shared_hits"] > 0
    if megastep > 1:
        assert eng.megasteps > 0


def test_streams_independent_of_megastep_and_sharing(port):
    api, params = port
    base, _ = serve(api, params, 8)
    for n, sharing in ((1, True), (1, False), (8, False), (4, True)):
        streams, eng = serve(api, params, n, prefix_sharing=sharing)
        assert streams == base, (n, sharing)
        assert (eng.kv.shared_block_hits > 0) == sharing


def test_poisoned_megastep_falls_back_bit_identical(port):
    from repro_torch.runtime.faults import FaultEvent, FaultPlane

    api, params = port
    clean, _ = serve(api, params, 8)
    plane = FaultPlane([FaultEvent(2, "poison", rows=(0, 1, 2))])
    streams, eng = serve(api, params, 8, faults=plane)
    assert eng.megastep_fallbacks == 1 and eng.watchdog_trips == 1
    assert eng.rows_failed == 0
    assert streams == clean


@pytest.mark.parametrize("host_pool", [0, 1 << 20])
def test_preemption_under_a_tight_budget_keeps_streams(port, host_pool):
    """A pool too small for three live requests preempts: with the host
    tier the victims' blocks go to the host and come back through
    ``index_select``/``index_copy_`` (zero re-prefill); without it they
    are discarded and re-prefilled.  Streams stay bit-identical."""
    api, params = port
    clean, _ = serve(api, params, 8)
    streams, eng = serve(api, params, 8, hbm_budget=260_000,
                         host_pool=host_pool)
    assert eng.preemptions > 0
    if host_pool:
        assert eng.spills == eng.restores == eng.preemptions
        assert eng.reprefill_tokens == 0
    else:
        assert eng.spills == 0 and eng.reprefill_tokens > 0
    assert streams == clean


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    child()
