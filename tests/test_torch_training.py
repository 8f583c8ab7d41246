"""The port's training pieces against the JAX package, on the CPU.

* ``SyntheticTokens``: the same seed gives JAX's batches bit for bit.
* ``apply_updates``: AdamW on random trees, fp32 and bf16 moments, with
  the warmup and the clip active, three steps against JAX's.
* ``models.bridge``: ``numpy_from_params`` inverts ``params_from_numpy``
  bit for bit on every config below.
* ``loss_fn`` and its gradient for stablelm-3b, mamba2-370m (S = 256),
  whisper-tiny, ``dbrx-132b.reduced()`` (4 experts: ``moe_dense``) and a
  kimi-like config (8 experts, ``layer_offset=1``, shared expert:
  ``moe_ragged`` on ``branch_matmul``), all reduced (fp32, 2 layers,
  d_model 256, vocab 512), on JAX's parameters carried across as numpy.
  Labels hold masked (-1) entries.

Tolerances are the repository's fp32 ones: 2e-5 for values (rtol and
atol), and for every gradient leaf its normwise distance to JAX's.  Both
sides compute in fp32 in other orders (the port's plain kernel versions
stand in for the kernels here); the measured worst leaf is ~6e-6 (the
Mamba ``A_log`` gradient), the losses agree within 5e-7.  The bf16
moments round the same fp32 value, which the two sides may reach in
another summation order, so they are held to one bf16 ulp.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
import repro_torch.configs as torch_configs  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JaxTokens  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.data import SyntheticTokens, to_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.bridge import (numpy_from_params,  # noqa: E402
                                       params_from_numpy)
from repro_torch.training import loss_and_grads, optimizer  # noqa: E402

TOL = 2e-5
ARCHS = ("stablelm-3b", "mamba2-370m", "whisper-tiny", "dbrx-132b",
         "kimi-like")
SEQ = {"mamba2-370m": 256}
B, S = 2, 16


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


def config(configs, arch):
    """A reduced config from ``configs`` (the JAX or the port package);
    "kimi-like" is ``tests/test_torch_moe.py``'s."""
    if arch == "kimi-like":
        cfg = configs.get_config("kimi-k2-1t-a32b").reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=8, layer_offset=1))
    return configs.get_config(arch).reduced()


def batch_for(cfg, seed=1, batch=B, seq=None):
    """Seeded numpy tokens and labels (row 0's first 3 labels masked);
    stub frames for whisper."""
    rng = np.random.default_rng(seed)
    seq = seq or SEQ.get(cfg.name, S)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels[0, :3] = -1
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))
           .astype(np.int32), "labels": labels}
    if cfg.is_encoder_decoder:
        out["frames"] = (rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def leaf_errors(want, got):
    """{key path: normwise distance} over two trees of one structure."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    out = {}
    for (path, w), g in zip(flat_w, flat_g):
        w = np.asarray(w, np.float64)
        g = np.asarray(g, np.float64)
        assert w.shape == g.shape, jax.tree_util.keystr(path)
        out[jax.tree_util.keystr(path)] = (
            np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-30))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """The JAX model and the port's on one set of JAX-initialised
    weights."""
    arch = request.param
    jcfg = config(jax_configs, arch)
    japi = jax_build_model(jcfg)
    jp = japi.init(jax.random.key(0))
    cfg = config(torch_configs, arch)
    tree = jax.tree.map(np.asarray, jp)
    return japi, jp, tree, cfg, build_model(cfg, device="cpu"), \
        params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_tokens_match_jax(seed):
    ours, ref = SyntheticTokens(512, 24, 4, seed), JaxTokens(512, 24, 4,
                                                             seed)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    moved = to_device(next(ours), "cpu")
    assert moved["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(moved["labels"].numpy(),
                                  next(ref)["labels"])


SHAPES = {"a": (4, 8), "b.c": (16,), "b.d": (3, 5, 7)}


def _nest(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(moment_dtype):
    """Three AdamW steps on a random tree, gradients large enough that
    the clip scales them, inside a three-step warmup."""
    rng = np.random.default_rng(7)
    cfg_kw = dict(lr=1e-2, warmup_steps=3, grad_clip=1.0,
                  moment_dtype=moment_dtype)
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in SHAPES.items()}
    jp = _nest({n: jnp.asarray(v) for n, v in p0.items()})
    jstate = jopt.init_opt_state(jp, jopt.OptConfig(**cfg_kw))
    tp = {n: torch.tensor(v) for n, v in p0.items()}
    tstate = optimizer.init_opt_state(tp, optimizer.OptConfig(**cfg_kw))
    ulp = 2.0 ** -8 if moment_dtype == "bfloat16" else TOL
    for _ in range(3):
        g = {n: (rng.standard_normal(s) * 3).astype(np.float32)
             for n, s in SHAPES.items()}
        jp, jstate, jm = jopt.apply_updates(
            jp, _nest({n: jnp.asarray(v) for n, v in g.items()}), jstate,
            jopt.OptConfig(**cfg_kw))
        tp, tstate, tm = optimizer.apply_updates(
            tp, {n: torch.tensor(v) for n, v in g.items()}, tstate,
            optimizer.OptConfig(**cfg_kw))
        assert float(jm["grad_norm"]) > 1.0            # the clip is active
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=TOL)
        assert int(tstate["step"]) == int(jstate["step"])
        for name in SHAPES:
            path = name.split(".")

            def at(tree):
                for k in path:
                    tree = tree[k]
                return np.asarray(tree, np.float32)
            np.testing.assert_allclose(tp[name].numpy(), at(jp), rtol=TOL,
                                       atol=TOL)
            # an fp32 parameter is its own master
            assert tstate["master"][name].data_ptr() == tp[name].data_ptr()
            for k in ("m", "v"):
                assert tstate[k][name].dtype == getattr(torch, moment_dtype)
                np.testing.assert_allclose(tstate[k][name].float().numpy(),
                                           at(jstate[k]), rtol=ulp,
                                           atol=1e-30)


def test_bridge_round_trip(models):
    """``numpy_from_params`` gives back JAX's pytree, structure and
    values, bit for bit."""
    _, _, tree, cfg, _, params = models
    back = numpy_from_params(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_loss_fn_and_grads_match_jax(models):
    japi, jp, _, cfg, api, params = models
    batch = batch_for(cfg)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(p, {k: jnp.asarray(v)
                                   for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, metrics, grads = loss_and_grads(api, params, batch)
    assert metrics.keys() == jm.keys()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=TOL, atol=TOL)
    errs = leaf_errors(jg, numpy_from_params(cfg, grads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])
    assert all(p.requires_grad for p in params.parameters())
