"""The port's train step, trainer and checkpoints against the JAX package.

* Five train steps of stablelm-3b and mamba2-370m (reduced: fp32, 2
  layers, d_model 256, vocab 512) from JAX's initial parameters on
  ``SyntheticTokens`` batches: every step's loss within rtol 1e-4 of
  JAX's, the parameters after step 1 within 2e-4 max abs — the slack
  ``tests/test_training.py`` allows between two summation orders of one
  update.  The port's plain kernel versions stand in for the kernels.
* Twins of ``tests/test_training.py``: a step updates the parameters;
  four microbatches against one batch (loss rtol 1e-5, parameters 2e-4);
  ``launch.train.train`` on mamba2-370m learns 10 % in 25 steps.
* Checkpoints both ways: the port restores what JAX's
  ``save_checkpoint`` wrote, and JAX's ``load_checkpoint`` restores what
  the port wrote; each then gives the writer's loss (2e-5) and the same
  next step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import OptConfig as JaxOptConfig  # noqa: E402
from repro.training import init_opt_state as jax_init_opt  # noqa: E402
from repro.training import make_train_step as jax_train_step  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.bridge import (numpy_from_params,  # noqa: E402
                                       params_from_numpy)
from repro_torch.training import (OptConfig, init_opt_state,  # noqa: E402
                                  make_train_step)
from repro_torch.training.checkpoint import (load_checkpoint,  # noqa: E402
                                             save_checkpoint)

STEPS, B, S = 5, 4, 32
OPT = dict(lr=3e-3, warmup_steps=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's torch work.  Under xdist,
    with several workers sharing a few cores, torch's default of one
    thread a core in each worker slows these backward passes ~100x
    (measured on 8 cores: 10 mamba2 steps 2.7 s at one thread, 41 s at
    eight, with six other busy processes beside).  Restored after the
    file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=["stablelm-3b", "mamba2-370m"])
def runs(request):
    """Both packages trained STEPS steps from one initial state on one
    stream of batches: (cfg, JAX params after step 1, port params after
    step 1 (numpy), JAX losses, port losses)."""
    arch = request.param
    japi = jax_build_model(jax_get_config(arch).reduced())
    jp = japi.init(jax.random.key(0))
    jstate = jax_init_opt(jp, JaxOptConfig(**OPT))
    jstep = jax.jit(jax_train_step(japi, JaxOptConfig(**OPT)))
    cfg = get_config(arch).reduced()
    api = build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    state = init_opt_state(params, OptConfig(**OPT))
    step = make_train_step(api, OptConfig(**OPT))
    data = SyntheticTokens(cfg.vocab_size, S, B, seed=0)
    jl, tl, first = [], [], None
    for i, batch in zip(range(STEPS), data):
        jp, jstate, jm = jstep(jp, jstate, jax_batch(batch))
        params, state, tm = step(params, state, batch)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if i == 0:
            first = (jax.tree.map(np.asarray, jp),
                     numpy_from_params(cfg, params))
    return cfg, first, jl, tl


def test_train_steps_match_jax(runs):
    cfg, (jp1, tp1), jl, tl = runs
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    err = max(float(np.abs(a - b).max())
              for a, b in zip(jax.tree.leaves(jp1), jax.tree.leaves(tp1)))
    assert err < 2e-4, f"{cfg.name}: params after step 1 differ by {err}"
    assert tl[-1] < tl[0]


def _setup(seed=0):
    cfg = get_config("stablelm-3b").reduced()
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(seed))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    state = init_opt_state(params, opt_cfg)
    toks = torch.randint(0, cfg.vocab_size, (8, 16),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    return api, params, state, opt_cfg, {"tokens": toks, "labels": toks}


def test_train_step_updates_params():
    api, params, state, opt_cfg, batch = _setup()
    before = [p.detach().clone() for p in params.parameters()]
    params, state, m = make_train_step(api, opt_cfg)(params, state, batch)
    assert int(state["step"]) == 1
    assert bool(torch.isfinite(m["loss"]))
    assert max(float((a - b.detach()).abs().max()) for a, b in
               zip(before, params.parameters())) > 0


def test_microbatched_grads_match_full_batch():
    """Gradient accumulation over 4 slices == the full batch's update."""
    api, p1, s1, opt_cfg, batch = _setup()
    _, p2, s2, _, _ = _setup()
    p1, _, m1 = make_train_step(api, opt_cfg)(p1, s1, batch)
    p2, _, m2 = make_train_step(api, opt_cfg, microbatches=4)(p2, s2,
                                                               batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    assert m1.keys() == m2.keys()
    err = max(float((a - b).abs().max())
              for a, b in zip(p1.parameters(), p2.parameters())
              for a, b in [(a.detach(), b.detach())])
    assert err < 2e-4, f"microbatched update diverges: {err}"


def test_uneven_microbatches_raise_as_jax_does():
    """8 rows do not split into 3 microbatches: JAX's reshape raises, and
    so does the port, where it once trained on the first 6 rows."""
    api, params, state, opt_cfg, batch = _setup()
    with pytest.raises(ValueError, match="do not split into 3"):
        make_train_step(api, opt_cfg, microbatches=3)(params, state, batch)
    japi = jax_build_model(jax_get_config("stablelm-3b").reduced())
    jp = japi.init(jax.random.key(0))
    jopt = JaxOptConfig(lr=1e-3, warmup_steps=1)
    with pytest.raises(TypeError):
        jax_train_step(japi, jopt, microbatches=3)(
            jp, jax_init_opt(jp, jopt), jax_batch(
                {k: v.numpy() for k, v in batch.items()}))


def test_mrope_batch_does_not_split_into_microbatches():
    """A Qwen2-VL batch carries positions3 (3, B, S).  JAX splits every
    leaf on its leading dim, so at n=2 its reshape of the streams raises;
    the port raises for any n > 1 and names M-RoPE."""
    from repro.models.model import stub_vision_frontend as jax_stub
    from repro_torch.models import stub_vision_frontend

    Bq, Sq = 2, 16
    cfg = get_config("qwen2-vl-2b").reduced()
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    emb, pos3 = stub_vision_frontend(torch.Generator().manual_seed(1), cfg,
                                     Bq, Sq)
    toks = torch.randint(0, cfg.vocab_size,
                         (Bq, Sq - cfg.num_frontend_tokens),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks, "frontend_embeds": emb,
             "positions3": pos3}
    for n in (2, 3):
        with pytest.raises(ValueError, match="M-RoPE"):
            make_train_step(api, opt_cfg, microbatches=n)(
                params, init_opt_state(params, opt_cfg), batch)

    jcfg = jax_get_config("qwen2-vl-2b").reduced()
    japi = jax_build_model(jcfg)
    jp = japi.init(jax.random.key(0))
    jopt = JaxOptConfig(lr=1e-3, warmup_steps=1)
    jemb, jpos3 = jax_stub(jax.random.key(1), jcfg, Bq, Sq)
    jbatch = {"tokens": jnp.asarray(toks.numpy()),
              "labels": jnp.asarray(toks.numpy()),
              "frontend_embeds": jemb, "positions3": jpos3}
    with pytest.raises(TypeError):
        jax_train_step(japi, jopt, microbatches=2)(
            jp, jax_init_opt(jp, jopt), jbatch)


def test_even_microbatches_take_every_row_in_order():
    """On an even split the slices are the batch's rows in order, each
    once: concatenated they give the batch back bit for bit."""
    from repro_torch.training.train_step import _slice

    _, _, _, _, batch = _setup()
    for n in (1, 2, 4, 8):
        for k, v in batch.items():
            parts = [_slice(v, i, n) for i in range(n)]
            assert all(len(p) == len(v) // n for p in parts)
            assert torch.equal(torch.cat(parts), v), (k, n)


def test_training_loop_learns():
    losses = train("mamba2-370m", steps=25, batch=4, seq=32, reduced=True,
                   lr=5e-3, log_every=100, device="cpu")
    assert losses[-1] < losses[0] * 0.9


@pytest.fixture(scope="module")
def stablelm():
    """JAX's stablelm-3b reduced, its jitted step, and the port's."""
    japi = jax_build_model(jax_get_config("stablelm-3b").reduced())
    cfg = get_config("stablelm-3b").reduced()
    return (japi, jax.jit(jax_train_step(japi, JaxOptConfig(**OPT))), cfg,
            build_model(cfg, device="cpu"))


def _batches(cfg, n):
    data = SyntheticTokens(cfg.vocab_size, S, B, seed=5)
    return [next(data) for _ in range(n)]


def _port_loss(api, params, batch):
    with torch.no_grad():
        return float(api.loss_fn(params, batch)[0])


def test_port_restores_a_jax_checkpoint(stablelm, tmp_path):
    japi, jstep, cfg, api = stablelm
    b = _batches(cfg, 4)
    jp = japi.init(jax.random.key(0))
    jstate = jax_init_opt(jp, JaxOptConfig(**OPT))
    for batch in b[:2]:
        jp, jstate, _ = jstep(jp, jstate, jax_batch(batch))
    jax_ckpt.save_checkpoint(tmp_path, jp, jstate, step=2,
                             metadata={"by": "jax"})
    params = api.init(torch.Generator().manual_seed(3))    # other values
    state = init_opt_state(params, OptConfig(**OPT))
    params, state, meta = load_checkpoint(tmp_path, cfg, params, state)
    assert meta == {"step": 2, "by": "jax"} and int(state["step"]) == 2
    for k in ("m", "v"):
        for a, t in zip(jax.tree.leaves(jstate[k]),
                        jax.tree.leaves(numpy_from_params(cfg, state[k]))):
            np.testing.assert_array_equal(np.asarray(a), t)
    jloss = float(japi.loss_fn(jp, jax_batch(b[2]))[0])
    np.testing.assert_allclose(_port_loss(api, params, b[2]), jloss,
                               rtol=2e-5, atol=2e-5)
    jp, jstate, jm = jstep(jp, jstate, jax_batch(b[2]))
    params, state, tm = make_train_step(api, OptConfig(**OPT))(
        params, state, b[2])
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(_port_loss(api, params, b[3]),
                               float(japi.loss_fn(jp, jax_batch(b[3]))[0]),
                               rtol=1e-4)


def test_jax_restores_a_port_checkpoint(stablelm, tmp_path):
    japi, jstep, cfg, api = stablelm
    b = _batches(cfg, 4)
    params = api.init(torch.Generator().manual_seed(4))
    state = init_opt_state(params, OptConfig(**OPT))
    step = make_train_step(api, OptConfig(**OPT))
    for batch in b[:2]:
        params, state, _ = step(params, state, batch)
    save_checkpoint(tmp_path, cfg, params, state, step=2,
                    metadata={"by": "port"})
    tmpl = japi.init(jax.random.key(1))
    jp, jstate, meta = jax_ckpt.load_checkpoint(
        tmp_path, tmpl, jax_init_opt(tmpl, JaxOptConfig(**OPT)))
    assert meta == {"step": 2, "by": "port"} and int(jstate["step"]) == 2
    for a, t in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(numpy_from_params(cfg, params))):
        np.testing.assert_array_equal(np.asarray(a), t)
    np.testing.assert_allclose(float(japi.loss_fn(jp, jax_batch(b[2]))[0]),
                               _port_loss(api, params, b[2]), rtol=2e-5,
                               atol=2e-5)
    jp, jstate, jm = jstep(jp, jstate, jax_batch(b[2]))
    params, state, tm = step(params, state, b[2])
    np.testing.assert_allclose(float(jm["grad_norm"]),
                               float(tm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(japi.loss_fn(jp, jax_batch(b[3]))[0]),
                               _port_loss(api, params, b[3]), rtol=1e-4)
