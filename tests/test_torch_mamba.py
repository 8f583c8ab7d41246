"""Mamba2 in the port against the JAX package, on bridged parameters.

Models: ``mamba2-370m.reduced()`` (2 Mamba2 layers, d_model 256, head
dim 16, d_state 16, chunk 8, fp32, no channel mix) and two hybrids —
``jamba-v0.1-52b.reduced()`` with ``moe=MoEConfig()`` (a Mamba layer
with a dense MLP, then an attention layer), so that mixed caches are
covered, and ``jamba-moe``, Jamba's interleave with its MoE kept at
reduced widths (4 layers: Mamba + dense MLP, Mamba + MoE, attention +
dense MLP, Mamba + MoE; 4 experts top-2) — initialised by the JAX
package and bridged into the port.  One more test holds the 16-layer
Jamba at ``structural()`` widths (JAX's scan period of 8 blocks, twice;
16 experts, so the port's ``moe_ragged``) to JAX's prefill.

* the mixer: ``_causal_conv``, ``mamba_block`` (fp32 and bf16) and
  ``mamba_decode_step`` against JAX's; within the port, step-by-step
  decode against the full-sequence block;
* the model: ``prefill_fn``, and ``decode_fn`` on the dense and the
  paged caches (per-row ``cache_len``, rows switching inactive), logits
  at every step and the caches at the end;
* the serving runtime: ``Stepper.reset_rows``; a request served in a
  slot after another gets its solo stream; a poisoned megastep and a
  retried single step end bit-identical to the clean run, because the
  engine puts back the caches from before the dispatch; sharing, the
  prefix cache and the host tier stay off for a model with per-row
  state; the engines' streams and ``engine.dispatches`` (reset
  dispatches included) against the JAX engines, run in a child process
  (this file with ``--child``: bit-identical JAX streams need
  ``jax_cpu_enable_async_dispatch`` off, a process-wide switch);
* the DAG: ``export_decoder_graph`` (``_export_mamba``) node by node
  against JAX's, executed against the JAX oracle and through the
  planner.

Tolerances: fp32 2e-5 where no SSD scan runs (the conv, the decode
step, decode logits); 2e-4 wherever the chunked scan is on the path
(``tests/test_kernels.py``: the scan's within-chunk cumsum and products
sum in other orders); bf16 2e-2; the JAX suite's rtol 2e-3, atol 2e-4
for decode against the full-sequence block.
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
SCAN = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCHS = ("mamba2-370m", "jamba-hybrid", "jamba-moe")
MAX_BATCH, BLOCK, MAX_CONTEXT = 3, 4, 32


def _config(configs, arch):
    """A reduced config from ``configs`` (the JAX or the port package)."""
    if arch == "jamba-hybrid":
        return dataclasses.replace(
            configs.get_config("jamba-v0.1-52b").reduced(),
            moe=configs.MoEConfig())
    if arch == "jamba-moe":
        # Jamba's own interleave at reduced widths: Mamba + dense MLP,
        # Mamba + MoE, attention + dense MLP, Mamba + MoE
        red = configs.get_config("jamba-v0.1-52b").reduced()
        return dataclasses.replace(
            red, num_layers=4, attn_period=4, attn_offset=2,
            moe=dataclasses.replace(red.moe, layer_freq=2, layer_offset=1))
    return configs.get_config(arch).reduced()


def workload(vocab: int):
    """(id, prompt, max_new) triples of mixed lengths."""
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, vocab, int(rng.integers(3, 20)))
             .astype(np.int32), int(rng.integers(2, 10))) for i in range(7)]


def reuse_workload(vocab: int):
    """Two requests for one slot: the second is served after the first.
    Its 2-token prompt is shorter than the conv window, so a stale
    window would show in its stream."""
    rng = np.random.default_rng(1)
    return [(i, rng.integers(0, vocab, n).astype(np.int32), 6)
            for i, n in enumerate((11, 2))]


# (key, arch, engine knobs); engine "round" or "continuous"
RUNS = [
    ("paged-1", "mamba2-370m", "continuous", dict(megastep=1)),
    ("paged-8", "mamba2-370m", "continuous", dict(megastep=8)),
    ("dense-1", "mamba2-370m", "continuous", dict(megastep=1, paged=False)),
    ("dense-8", "mamba2-370m", "continuous", dict(megastep=8, paged=False)),
    ("round-32", "mamba2-370m", "round", dict()),
    ("round-None", "mamba2-370m", "round", dict(max_context=None)),
    ("reuse", "mamba2-370m", "continuous", dict(megastep=8, max_batch=1)),
    ("hybrid-paged-8", "jamba-hybrid", "continuous", dict(megastep=8)),
    ("hybrid-dense-1", "jamba-hybrid", "continuous",
     dict(megastep=1, paged=False)),
    ("hybrid-round-32", "jamba-hybrid", "round", dict()),
    ("moe-paged-8", "jamba-moe", "continuous", dict(megastep=8)),
    ("moe-dense-1", "jamba-moe", "continuous", dict(megastep=1, paged=False)),
    ("moe-round-32", "jamba-moe", "round", dict()),
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

    models = {}
    out = {}
    for key, arch, engine, knobs in RUNS:
        if arch not in models:
            api = build_model(_config(configs, arch))
            models[arch] = (api, api.init(jax.random.key(0)), Stepper(api))
        api, params, stepper = models[arch]
        cls = ServingEngine if engine == "round" else ContinuousEngine
        eng = cls(api, params, stepper=stepper,
                  config=_engine_config(EngineConfig, knobs))
        reqs = (reuse_workload if key == "reuse" else workload)(
            api.cfg.vocab_size)
        for i, prompt, max_new in reqs:
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


def _jax_layer(jparams, cfg, i):
    """Layer ``i``'s parameter dict out of the JAX pytree."""
    import jax

    from repro.models.transformer import structure

    _, prefix_len, period, _ = structure(cfg)
    if i < prefix_len:
        return jparams["prefix"][i]
    r, j = divmod(i - prefix_len, period)
    return jax.tree.map(lambda a: a[r], jparams["period"][j])


# --------------------------------------------------------------------------
# the mixer
# --------------------------------------------------------------------------

def test_causal_conv_matches_jax():
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    rng = np.random.default_rng(0)
    xBC = rng.standard_normal((2, 13, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    got = ssm._causal_conv(*(torch.tensor(a) for a in (xBC, w, b)))
    want = jssm._causal_conv(*(jnp.asarray(a) for a in (xBC, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_jax(bridged, dtype):
    """fp32 through the SSD at 2e-4; bf16 activations (the port's bf16
    weight copies against JAX's fp32 masters cast at use) at 2e-2."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    from repro_torch.models.bridge import params_from_numpy

    japi, jparams, tapi, _ = bridged["mamba2-370m"]
    cfg = tapi.cfg
    lm = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                           device="cpu", dtype=dtype)
    x = (np.random.default_rng(1).standard_normal((2, 24, cfg.d_model))
         * 0.3).astype(np.float32)
    for i in range(cfg.num_layers):
        got = ssm.mamba_block(lm.layers[i].mamba, cfg,
                              torch.tensor(x).to(lm.embed.dtype))
        want = jssm.mamba_block(_jax_layer(jparams, japi.cfg, i)["mamba"],
                                japi.cfg, jnp.asarray(x).astype(dtype))
        assert got.dtype == lm.embed.dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **(SCAN if dtype == "float32" else BF16))


def test_mamba_decode_step_matches_jax(bridged):
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    japi, jparams, tapi, tparams = bridged["mamba2-370m"]
    cfg = tapi.cfg
    _, H, conv_dim = ssm._dims(cfg)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 1, cfg.d_model)) * 0.3).astype(np.float32)
    cache = {"state": rng.standard_normal(
                 (3, H, cfg.ssm.head_dim, cfg.ssm.d_state)).astype(
                     np.float32),
             "conv": rng.standard_normal(
                 (3, cfg.ssm.conv_width - 1, conv_dim)).astype(np.float32)}
    tcache = {k: torch.tensor(v) for k, v in cache.items()}
    y, new = ssm.mamba_decode_step(tparams.layers[1].mamba, cfg,
                                   torch.tensor(x), tcache)
    jy, jnew = jssm.mamba_decode_step(
        _jax_layer(jparams, japi.cfg, 1)["mamba"], japi.cfg, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
    for k in ("state", "conv"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   **FP32)
        np.testing.assert_array_equal(tcache[k].numpy(), cache[k])


def test_decode_matches_block():
    """Stepwise recurrent decode == full-sequence chunked block (the JAX
    suite's test, on the port's own random init; 16 steps cross a chunk
    boundary)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("mamba2-370m").reduced()
    params = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, "cpu",
                            torch.float32)
    S = 16
    x = torch.randn(1, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)) * 0.3
    full = ssm.mamba_block(params, cfg, x)
    cache = ssm.init_mamba_cache(cfg, 1, torch.float32, "cpu")
    outs = []
    for t in range(S):
        y, cache = ssm.mamba_decode_step(params, cfg, x[:, t:t + 1], cache)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-3,
                               atol=2e-4)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(bridged, arch):
    from repro_torch.kernels.ssd_scan import launches

    japi, jparams, tapi, tparams = bridged[arch]
    tokens = np.random.default_rng(1).integers(
        0, tapi.cfg.vocab_size, (2, 24)).astype(np.int32)
    before = dict(launches)
    got = tapi.prefill_fn(tparams, {"tokens": torch.tensor(tokens)})
    assert launches == before                      # CPU: plain version
    want = japi.prefill_fn(jparams, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tapi.prefill_fn(tparams, {"tokens": torch.tensor(tokens[:, :20])})


def test_jamba_16_layers_structural_matches_jax():
    """jamba-v0.1-52b at 16 layers and ``structural()`` widths: JAX keeps
    its period of 8 blocks stacked twice.  The bridge carries the pytree
    into the port's flat layers and back bit for bit, and prefill (2
    attention, 14 Mamba and 8 MoE layers of 16 experts) matches JAX's."""
    import jax

    from repro import configs as jax_configs
    from repro.models import build_model as jax_build_model
    from repro.models.transformer import structure
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models.bridge import numpy_from_params, params_from_numpy

    def config(c):
        return dataclasses.replace(
            c.get_config("jamba-v0.1-52b").structural(), num_layers=16)

    jcfg, cfg = config(jax_configs), config(configs)
    assert structure(jcfg)[1:] == (0, 8, 2)      # no prefix, 8 x 2
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    tapi = build_model(cfg, device="cpu")
    tparams = params_from_numpy(cfg, tree, device="cpu")
    assert [layer.kind for layer in tparams.layers] == [
        ("attn" if cfg.is_attn_layer(i) else "mamba",
         "moe" if cfg.is_moe_layer(i) else "dense") for i in range(16)]
    back = numpy_from_params(cfg, tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    got = tapi.prefill_fn(tparams, {"tokens": torch.tensor(tokens)})
    want = japi.prefill_fn(jparams, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


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
    """Per-row cache_len and rows switching inactive, on the dense or the
    paged caches: logits at every step, every cache at the end (the
    paged pools without their scratch row, which is never read)."""
    import jax

    japi, jparams, tapi, tparams = bridged[arch]
    B, slots, bs, steps = 3, 24, 4, 20
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
        active = np.array([True, not 6 <= s < 10, s % 4 != 3])
        batch.update(tokens=rng.integers(0, 512, (B, 1)).astype(np.int32),
                     cache_len=lens.copy(), active=active)
        jl, jcaches = jdecode(jparams, jcaches, batch)
        tl, tcaches = tapi.decode_fn(
            tparams, tcaches, {k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
        lens += active
    for t, j in zip(tcaches, _jax_layers(jcaches, tapi.cfg.num_layers)):
        for key, val in t.items():
            if key in ("k_pool", "v_pool"):
                np.testing.assert_allclose(val.numpy()[:-1],
                                           np.asarray(j[key])[:-1], **FP32)
            elif key != "tile":
                np.testing.assert_allclose(val.numpy(), np.asarray(j[key]),
                                           **FP32)


def test_decode_leaves_the_old_state_untouched(bridged):
    """A decode step returns new Mamba state and never writes the old
    tensors: the list passed in is a checkpoint of the pre-step state."""
    _, _, tapi, tparams = bridged["jamba-hybrid"]
    caches = tapi.init_caches(2, 8)
    before = [{k: v.clone() for k, v in c.items() if torch.is_tensor(v)}
              for c in caches]
    batch = {"tokens": torch.tensor([[3], [5]]),
             "cache_len": torch.tensor([0, 0], dtype=torch.int32),
             "active": torch.tensor([True, False])}
    _, new = tapi.decode_fn(tparams, caches, batch)
    mamba, attn = 0, 1                    # the hybrid's layer pattern
    assert new[attn] is caches[attn]      # the KV cache: in place
    assert new[mamba] is not caches[mamba]
    for k, v in before[mamba].items():
        assert torch.equal(caches[mamba][k], v)
        assert torch.equal(new[mamba][k][1], v[1])    # inactive row kept
        assert not torch.equal(new[mamba][k][0], v[0])


# --------------------------------------------------------------------------
# the serving runtime
# --------------------------------------------------------------------------

def test_reset_rows_zeroes_fresh_rows_only(bridged):
    from repro_torch.runtime.stepper import Stepper

    _, _, tapi, _ = bridged["jamba-hybrid"]
    for caches in (tapi.init_caches(3, 8), tapi.init_paged_caches(3, 6, 4)):
        for c in caches:
            for k, v in c.items():
                if torch.is_tensor(v) and v.is_floating_point():
                    v.normal_()
        stepper = Stepper(tapi)
        out = stepper.reset_rows(caches, np.array([False, True, False]))
        assert stepper.dispatches == 1
        for old, new in zip(caches, out):
            for k, v in old.items():
                if k in ("pos", "tile", "k_pool", "v_pool"):
                    assert new[k] is v                 # rowless: untouched
                    continue
                assert not torch.equal(v[1], torch.zeros_like(v[1]))
                assert torch.equal(new[k][1], torch.zeros_like(v[1]))
                assert torch.equal(new[k][0], v[0])
                assert torch.equal(new[k][2], v[2])


def _serve(api, params, engine="continuous", reqs=None, faults=None,
           **knobs):
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import (ContinuousEngine, Request,
                                            ServingEngine)

    cls = ServingEngine if engine == "round" else ContinuousEngine
    eng = cls(api, params, config=_engine_config(EngineConfig, knobs),
              device="cpu")
    if faults is not None:
        eng.faults = faults
    for i, prompt, max_new in (reqs or workload(api.cfg.vocab_size)):
        eng.submit(Request(i, prompt, max_new))
    done = eng.run()
    assert all(c.ok for c in done.values())
    if engine != "round":
        eng.assert_quiescent()
    return {str(k): v.tokens for k, v in done.items()}, eng


def test_engines_match_jax(jax_reference, bridged):
    """Every run of RUNS: streams and dispatches equal to the JAX
    engine's; within the port, one model's streams agree across paged
    and dense caches, megastep 8 and 1, continuous and round."""
    from repro_torch.kernels.ssd_scan import launches

    before = dict(launches)
    streams = {}
    for key, arch, engine, knobs in RUNS:
        _, _, api, params = bridged[arch]
        reqs = reuse_workload(api.cfg.vocab_size) if key == "reuse" \
            else None
        got, eng = _serve(api, params, engine, reqs, **knobs)
        ref = jax_reference[key]
        assert got == ref["streams"], key
        assert eng.dispatches == ref["dispatches"], key
        streams[key] = got
    assert launches == before                      # decode runs no scan
    for key in ("paged-1", "dense-8", "dense-1", "round-32", "round-None"):
        assert streams[key] == streams["paged-8"], key
    for tag in ("hybrid", "moe"):
        assert streams[f"{tag}-dense-1"] == streams[f"{tag}-paged-8"] \
            == streams[f"{tag}-round-32"], tag


@pytest.mark.parametrize("paged", [True, False])
def test_slot_reuse_gets_the_solo_stream(bridged, monkeypatch, paged):
    """A request served in a slot after another gets the stream it gets
    alone; without the reset dispatch the first tenant's state leaks."""
    from repro_torch.runtime.stepper import Stepper

    _, _, api, params = bridged["mamba2-370m"]
    first, second = reuse_workload(api.cfg.vocab_size)
    solo, _ = _serve(api, params, reqs=[second], max_batch=1, paged=paged)
    both, eng = _serve(api, params, reqs=[first, second], max_batch=1,
                       paged=paged)
    assert both["1"] == solo["1"]
    assert eng._needs_reset
    monkeypatch.setattr(Stepper, "reset_rows",
                        lambda self, caches, fresh: caches)
    leaked, _ = _serve(api, params, reqs=[first, second], max_batch=1,
                       paged=paged)
    assert leaked["1"] != solo["1"]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("megastep,repeats", [(8, 1), (8, 2), (1, 1)])
def test_poisoned_dispatch_falls_back_bit_identical(bridged, paged,
                                                    megastep, repeats):
    """A poisoned megastep (and, with ``repeats=2``, the single step it
    falls back to) or a poisoned single step is discarded and retried:
    the engine puts back the caches from before the dispatch, so the run
    ends bit-identical to the fault-free one."""
    from repro_torch.runtime.faults import FaultEvent, FaultPlane

    _, _, api, params = bridged["mamba2-370m"]
    clean, _ = _serve(api, params, megastep=megastep, paged=paged)
    # iteration 3 dispatches a megastep at N = 8 (2 is a single step)
    plane = FaultPlane([FaultEvent(3, "poison", rows=(0, 1, 2),
                                   repeats=repeats)])
    streams, eng = _serve(api, params, faults=plane, megastep=megastep,
                          paged=paged)
    assert eng.watchdog_trips == repeats and eng.rows_failed == 0
    assert eng.megastep_fallbacks == (megastep > 1)
    assert eng.retry_dispatches == repeats - (megastep > 1)
    assert streams == clean


def test_discarding_without_the_checkpoint_changes_streams(bridged,
                                                           monkeypatch):
    """The rollback is what keeps the poisoned run identical: with the
    pre-dispatch caches not put back, the poisoned megastep's state
    updates survive and the streams change."""
    from repro_torch.runtime.engine import ContinuousEngine
    from repro_torch.runtime.faults import FaultEvent, FaultPlane

    _, _, api, params = bridged["mamba2-370m"]
    clean, _ = _serve(api, params, megastep=8)
    monkeypatch.setattr(ContinuousEngine, "_discard_dispatch",
                        lambda self, snapshot: None)
    plane = FaultPlane([FaultEvent(3, "poison", rows=(0, 1, 2))])
    streams, eng = _serve(api, params, faults=plane, megastep=8)
    assert eng.megastep_fallbacks == 1
    assert streams != clean


def test_sharing_prefix_cache_and_spill_stay_off(bridged):
    """Per-row SSM state cannot ride shared or spilled KV blocks: every
    gate that needs the whole state in the blocks stays shut."""
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ContinuousEngine

    for arch in ARCHS:
        _, _, api, params = bridged[arch]
        eng = ContinuousEngine(api, params, device="cpu", config=EngineConfig(
            hbm_budget=1 << 30, max_batch=MAX_BATCH, block_size=BLOCK,
            max_context=MAX_CONTEXT, prefix_sharing=True, prefix_cache=True,
            host_pool=1 << 20))
        assert eng.kv.state_bytes > 0 and eng._needs_reset
        assert not eng.prefix_sharing and not eng.prefix_cache
        assert not eng.spill_enabled and not eng.kv.host_enabled


# --------------------------------------------------------------------------
# the DAG
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [16, 12])
@pytest.mark.parametrize("arch", ARCHS)
def test_export_mamba_matches_jax(bridged, arch, seq):
    """Node names, op classes, flops and ``supported`` flags equal JAX's;
    the graph's logits match the JAX oracle's (seq 12 is no multiple of
    the chunk: the scan runs one chunk of 12); the planner's reference
    and parallax modes equal the port's own oracle."""
    import jax

    from repro.models.dag_export import export_graph as jax_export
    from repro_torch.core import ParallaxConfig, PlanExecutor, compile_plan
    from repro_torch.core.executor import to_device
    from repro_torch.kernels.ssd_scan import launches
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.dag_export import export_decoder_graph

    japi, jparams, tapi, _ = bridged[arch]
    gj, make_j = jax_export(japi.cfg, jparams, 1, seq)
    lm = params_from_numpy(tapi.cfg, jax.tree.map(np.asarray, jparams),
                           device="cpu", dtype="float32")
    gt, make_t = export_decoder_graph(tapi.cfg, lm, 1, seq)

    def nodes(g):
        return [(n.name, n.op_class, n.flops, n.supported)
                for n in g.nodes.values()]

    assert nodes(gt) == nodes(gj)
    scans = [n for n in gt.nodes.values() if n.name.endswith("ssd_scan")]
    n_mamba = sum(not tapi.cfg.is_attn_layer(i)
                  for i in range(tapi.cfg.num_layers))
    assert len(scans) == n_mamba and not any(n.supported for n in scans)
    env = to_device(make_t(np.random.default_rng(0)), "cpu")
    before = dict(launches)
    oracle = gt.execute(env)[gt.outputs[0]]
    want = gj.execute(make_j(np.random.default_rng(0)))[gj.outputs[0]]
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), **SCAN)
    plan = compile_plan(gt, ParallaxConfig(budget=1 << 30))
    for mode in ("reference", "parallax"):
        out = PlanExecutor(plan, mode, device="cpu")(env).outputs[
            gt.outputs[0]]
        assert torch.equal(out, oracle), mode
    assert launches == before                      # CPU: plain version


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    child()
