"""The model step's spans and host reads in the port's telemetry plane.

Port-only (the JAX engine records none of these kinds, so
``tests/test_torch_telemetry.py`` holds the kinds both record against
JAX): tiny MoE, dense-MoE and hybrid models served by
``ContinuousEngine`` on the CPU, where every event validates against the
taxonomy, the model's spans nest in layer order inside their dispatch,
each MoE layer reads its bucket capacity back once per step above
``CAPACITY_STEP`` rows and never at or below it (beside the megastep's
8 input copies and 3 result copies), tracing changes no
stream or counter, and the disabled plane records nothing and reads no
clock.  On the card (``cuda``): a span mapped to the epoch clock holds a
kernel's device start in a ``torch.profiler`` trace, and the ``sync.*``
reads of a megastep are exactly what ``torch.cuda.set_sync_debug_mode``
reports.  No JAX here.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models import build_model
from repro_torch.models.moe import CAPACITY_STEP
from repro_torch.runtime import telemetry
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import ContinuousEngine, Request
from repro_torch.runtime.telemetry import (DURATION_KINDS, MODEL_KINDS,
                                           SPAN_KINDS, SYNC_KINDS,
                                           Telemetry, install, to_host)

MOE = MoEConfig(num_experts=8, num_experts_per_tok=2, d_ff_expert=32,
                layer_freq=1, layer_offset=0)
CONFIGS = {
    # two MoE layers on moe_ragged (E > 4)
    "moe": dict(arch_type="moe", num_layers=2, d_ff=0, moe=MOE),
    # four experts: moe_dense, no dispatch span
    "dense-moe": dict(arch_type="moe", num_layers=2, d_ff=0,
                      moe=MoEConfig(num_experts=4, num_experts_per_tok=2,
                                    d_ff_expert=32, layer_freq=1,
                                    layer_offset=0)),
    # Mamba and attention mixers, dense and MoE channels
    "hybrid": dict(arch_type="hybrid", num_layers=4, d_ff=96,
                   attn_period=4, attn_offset=1,
                   moe=MoEConfig(num_experts=8, num_experts_per_tok=2,
                                 d_ff_expert=32, layer_freq=2,
                                 layer_offset=1),
                   ssm=SSMConfig(d_state=8, head_dim=16, expand=2, chunk=8,
                                 conv_width=4, n_groups=1)),
}


def tiny(name: str, device="cpu"):
    cfg = ModelConfig(name=f"tiny-{name}", d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, vocab_size=256,
                      rope_theta=500000.0, dtype="float32",
                      **CONFIGS[name])
    api = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    return api, api.init(gen)


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    return {name: tiny(name) for name in CONFIGS}


def serve(api, params, rows, megastep, tele, device="cpu", new=9):
    """``rows`` requests of 6 prompt tokens on a ``rows``-wide engine."""
    eng = ContinuousEngine(
        api, params, EngineConfig(max_batch=rows, max_context=64,
                                  paged=True, megastep=megastep,
                                  hbm_budget=1 << 30),
        telemetry=tele, device=device)
    rng = np.random.default_rng(rows)
    for i in range(rows):
        eng.submit(Request(i, rng.integers(0, 256, 6).astype(np.int32),
                           max_new_tokens=new))
    return eng, eng.run()


def inside(outer, events):
    """The events that start inside the duration event ``outer``."""
    end = outer["ts"] + outer["dur"]
    return [e for e in events if outer["ts"] <= e["ts"] <= end
            and e is not outer]


def blocks(api):
    """The span kinds each block closes, in order (``moe_dense``, up to 4
    experts, has no dispatch)."""
    moe = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    if api.cfg.moe.num_experts <= 4:
        moe.remove("moe.dispatch")
    out = []
    for layer in api.init(None).layers:
        mixer, channel = layer.kind
        out.append([mixer] + {"none": [], "dense": ["mlp"],
                              "moe": moe}[channel])
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_events_follow_the_taxonomy(models, name):
    api, params = models[name]
    tele = Telemetry(trace=True)
    serve(api, params, 40, 4, tele)
    kinds = set()
    n_layers = api.cfg.num_layers
    for e in tele.events:
        kinds.add(e["kind"])
        assert e["kind"] in SPAN_KINDS
        assert ("dur" in e) == (e["kind"] in DURATION_KINDS)
        if e["kind"] in MODEL_KINDS and e["kind"] not in ("embed", "head"):
            assert 0 <= e["args"]["layer"] < n_layers
        elif e["kind"] in MODEL_KINDS or e["kind"] in SYNC_KINDS:
            assert "args" not in e
    want = {k for b in blocks(api) for k in b} | {
        "embed", "head", "sync.engine_copy", "sync.step_inputs"}
    if name != "dense-moe":
        want.add("sync.moe_capacity")       # 40 rows > CAPACITY_STEP
    assert want == kinds & (set(MODEL_KINDS) | set(SYNC_KINDS))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_spans_nest_in_layer_order(models, name):
    """Inside each dispatch span: N steps of embed, every block's spans
    in layer order, head; each span inside its dispatch."""
    api, params = models[name]
    tele = Telemetry(trace=True)
    serve(api, params, 40, 4, tele)
    step = ["embed"] + [k for b in blocks(api) for k in b] + ["head"]
    layers = [None] + [i for i, b in enumerate(blocks(api)) for _ in b] \
        + [None]
    dispatches = [e for e in tele.events
                  if e["kind"] in ("megastep", "prefill_chunk", "decode")]
    assert any(e["kind"] == "megastep" for e in dispatches)
    model = [e for e in tele.events if e["kind"] in MODEL_KINDS]
    seen = 0
    for d in dispatches:
        mine = inside(d, model)
        seen += len(mine)
        assert all(e["ts"] + e["dur"] <= d["ts"] + d["dur"] for e in mine)
        assert len(mine) % len(step) == 0 and mine
        for i, e in enumerate(mine):
            assert e["kind"] == step[i % len(step)]
            assert e.get("args", {}).get("layer") == layers[i % len(step)]
        for a, b in zip(mine, mine[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        if d["kind"] == "megastep":
            assert len(mine) == d["args"]["n"] * len(step)
    assert seen == len(model)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_spans_in_layer_order(models, name):
    """``prefill_fn`` under an installed plane: the same naming, one
    chain, the ``head`` span closed after the logits."""
    api, params = models[name]
    tele = Telemetry(trace=True)
    tokens = torch.arange(80).reshape(2, 40) % 256
    with install(tele):
        logits = api.prefill_fn(params, {"tokens": tokens})
    assert torch.equal(logits, api.prefill_fn(params, {"tokens": tokens}))
    model = [e for e in tele.events if e["kind"] in MODEL_KINDS]
    assert [e["kind"] for e in model] == \
        ["embed"] + [k for b in blocks(api) for k in b] + ["head"]
    assert [e.get("args", {}).get("layer") for e in model] == \
        [None] + [i for i, b in enumerate(blocks(api)) for _ in b] + [None]
    for a, b in zip(model, model[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    moe_layers = sum("moe.route" in b for b in blocks(api))
    reads = 0 if name == "dense-moe" else moe_layers     # 80 rows > 32
    assert [e["kind"] for e in tele.events if e["kind"] in SYNC_KINDS] \
        == ["sync.moe_capacity"] * reads


def megastep_reads(tele):
    """Per megastep span: (n, {sync kind: reads inside it})."""
    out = []
    syncs = [e for e in tele.events if e["kind"] in SYNC_KINDS]
    for m in tele.events:
        if m["kind"] == "megastep":
            got = {}
            for e in inside(m, syncs):
                got[e["kind"]] = got.get(e["kind"], 0) + 1
            out.append((m["args"]["n"], got))
    return out


def test_no_capacity_read_at_the_step_rows(models):
    api, params = models["moe"]
    tele = Telemetry(trace=True)
    eng, _ = serve(api, params, CAPACITY_STEP, 4, tele)
    per = megastep_reads(tele)
    # 8 inputs copied in (7 and the block table), 3 results copied out
    assert per and all(got == {"sync.step_inputs": 8, "sync.engine_copy": 3}
                       for _, got in per)
    assert "sync.moe_capacity" not in eng.stats()["counters"]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_capacity_read_per_moe_layer_and_step_at_40_rows(models, n):
    api, params = models["moe"]
    tele = Telemetry(trace=True)
    eng, _ = serve(api, params, 40, n, tele, new=2 * n + 1)
    per = megastep_reads(tele)
    assert per and all(got == {"sync.moe_capacity": 2 * m,
                               "sync.engine_copy": 3, "sync.step_inputs": 8}
                       for m, got in per)
    assert {m for m, _ in per} == {n}
    counters = eng.stats()["counters"]
    for kind in ("sync.moe_capacity", "sync.engine_copy",
                 "sync.step_inputs"):
        assert counters[kind] == sum(e["kind"] == kind for e in tele.events)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tracing_changes_no_stream_or_counter(models, name):
    api, params = models[name]
    runs = [serve(api, params, 40, 4, Telemetry(trace=t)) for t in (0, 1)]
    (off, off_done), (on, on_done) = runs
    assert {k: c.tokens for k, c in off_done.items()} == \
        {k: c.tokens for k, c in on_done.items()}
    assert off.dispatches == on.dispatches
    assert off.stepper.dispatches == on.stepper.dispatches
    assert off.stats()["counters"] == on.stats()["counters"]


def _boom(*_):
    raise AssertionError("the disabled plane read a clock")


def test_disabled_plane_records_nothing_and_reads_no_clock(models,
                                                           monkeypatch):
    api, params = models["moe"]
    monkeypatch.setattr(telemetry, "time", SimpleNamespace(
        perf_counter=_boom, perf_counter_ns=_boom, time_ns=_boom))
    tokens = torch.arange(80).reshape(2, 40) % 256    # 80 rows: 2 reads
    api.prefill_fn(params, {"tokens": tokens})        # the default plane
    assert telemetry.recorder() is telemetry._DISABLED.rec
    assert telemetry._DISABLED.metrics.names() == []
    assert telemetry._DISABLED.events == []
    off = Telemetry()
    with install(off):
        api.prefill_fn(params, {"tokens": tokens})
    assert off.events == []
    assert off.metrics.snapshot()["counters"] == {"sync.moe_capacity": 2}
    eng, _ = serve(api, params, 40, 4, Telemetry())
    assert eng.telemetry.events == []
    assert eng.stats()["counters"]["sync.moe_capacity"] > 0


def test_install_restores_the_previous_plane():
    a, b = Telemetry(), Telemetry()
    with install(a):
        assert telemetry.recorder() is a.rec
        with pytest.raises(RuntimeError):
            with install(b):
                assert telemetry.recorder() is b.rec
                raise RuntimeError
        assert telemetry.recorder() is a.rec
    assert telemetry.recorder() is telemetry._DISABLED.rec


def test_to_host_counts_a_known_site_only():
    tele = Telemetry(trace=True)
    with install(tele):
        assert to_host("sync.kv_spill", torch.ones(3)).sum() == 3
        with pytest.raises(ValueError):
            to_host("sync.elsewhere", torch.ones(3))
    assert tele.metrics.snapshot()["counters"] == {"sync.kv_spill": 1}
    assert [e["kind"] for e in tele.events] == ["sync.kv_spill"]


def test_epoch_clock_export():
    import time

    tele = Telemetry(trace=True)
    assert abs(tele.to_epoch_ns(time.perf_counter()) - time.time_ns()) \
        < 5_000_000
    t0 = tele.rec.now()
    tele.rec.span("megastep", t0, n=2)
    rel, epoch = tele.chrome_trace(), tele.chrome_trace(epoch=True)
    x_rel = [e for e in rel["traceEvents"] if e["ph"] == "X"][0]
    x_ep = [e for e in epoch["traceEvents"] if e["ph"] == "X"][0]
    assert x_rel["ts"] == 0.0 and x_ep["dur"] == x_rel["dur"]
    assert abs(x_ep["ts"] - tele.to_epoch_ns(t0) / 1e3) < 1.0
    telemetry.validate_chrome_trace(epoch, require_names=("megastep",))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans are held to the "
                    "card's own clock and synchronizations")
    return "cuda"


@pytest.mark.cuda
def test_span_clock_holds_a_kernel_start(card):
    from torch.profiler import ProfilerActivity, profile

    tele = Telemetry(trace=True)
    torch.cuda._sleep(1000)                           # load the module
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)      # the first launch traced sets up CUPTI
        torch.cuda.synchronize()
        t0 = tele.rec.now()
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        tele.rec.span("decode", t0)
    span = tele.events[-1]
    lo = tele.to_epoch_ns(span["ts"])
    hi = tele.to_epoch_ns(span["ts"] + span["dur"])
    kernels = [e for e in prof.profiler.kineto_results.events()
               if "CUDA" in str(e.device_type())]
    start = max(kernels, key=lambda e: e.duration_ns()).start_ns()
    where = f"device start {start - lo} ns after the span's, span {hi - lo} ns"
    print(where)
    assert lo <= start <= hi, where
    assert start - lo < 50_000, where


@pytest.mark.cuda
def test_host_reads_match_sync_debug_mode(card):
    api, params = tiny("moe", card)
    tele = Telemetry(trace=True)
    eng = ContinuousEngine(
        api, params, EngineConfig(max_batch=40, max_context=64, paged=True,
                                  megastep=4, hbm_budget=1 << 30),
        telemetry=tele, device=card)
    rng = np.random.default_rng(1)
    for i in range(40):
        eng.submit(Request(i, rng.integers(0, 256, 6).astype(np.int32),
                           max_new_tokens=16))
    eng.step()                       # admission, prompts, kernel builds
    torch.cuda.synchronize()
    n0 = len(tele.events)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    new = tele.events[n0:]
    assert [e["kind"] for e in new if e["kind"] in (
        "megastep", "decode", "prefill_chunk")] == ["megastep"]
    reported = [w for w in caught if "called a synchronizing CUDA "
                "operation" in str(w.message)]
    syncs = [e for e in new if e["kind"] in SYNC_KINDS]
    print(f"{len(reported)} synchronizing operations reported, "
          f"{len(caught) - len(reported)} other warnings; sync spans",
          {k: sum(e["kind"] == k for e in syncs) for k in SYNC_KINDS})
    assert len(syncs) == len(reported), [
        (w.filename, w.lineno) for w in reported]
