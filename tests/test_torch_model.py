"""The port's decoder model against the JAX model, on bridged parameters.

``stablelm-3b.reduced()`` (fp32, 2 layers, d_model 256) is initialised by
the JAX package, its parameter pytree crosses as numpy arrays into the
port (``repro_torch.models.bridge``), and 20 paged decode steps run
through both ``api.decode_fn``s on the same seeded numpy inputs: vector
``cache_len``, rows switching inactive and back, and two rows sharing a
physical block (a shared prompt prefix).  Logits must agree within
``LOGIT_TOL`` at every step and the pools (scratch row aside: its
contents are never read) at the end.

``LOGIT_TOL``: both sides compute in fp32, but the port attends with the
kernels' fp32 online softmax (q scaled before the dot) where the JAX
model takes a masked softmax over the gathered cache, and every matmul
sums in another order; over two layers and 20 steps that moves logits
of magnitude up to 1.3 by at most 1.5e-6 (measured on this test, CPU).
2e-5, the repository's fp32 kernel tolerance, leaves a tenfold margin.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels.paged_attention import launches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
B, BS, BPR, STEPS = 3, 4, 6, 20


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("stablelm-3b").reduced()
    tcfg = get_config("stablelm-3b").reduced()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return japi, jparams, tapi, tparams


def test_configs_are_copied_verbatim():
    for name, cfg in ARCHS.items():
        ref = dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(cfg) == ref
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(jax_get_config(name).reduced())


def test_bridge_copies_every_parameter(models):
    japi, jparams, tapi, tparams = models
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(jparams))
    n_port = sum(p.numel() for p in tparams.parameters())
    assert n_jax == n_port
    np.testing.assert_array_equal(
        tparams.layers[1].attn.wq.numpy(),
        np.asarray(jparams["period"][0]["attn"]["wq"][1]))
    assert tparams.layers[0].norm1.scale.dtype == torch.float32


def _schedule(rng):
    """Per-step tokens, cache_len and active masks; row 1 shares row 0's
    first block and joins once row 0 has written it."""
    toks = rng.integers(0, 512, (STEPS, B)).astype(np.int32)
    toks[:BS, 1] = toks[:BS, 0]
    lens = np.zeros(B, np.int32)
    lens[1] = BS
    plan = []
    for s in range(STEPS):
        active = np.array([True, s >= BS, not 8 <= s < 12])
        plan.append((toks[s], lens.copy(), active))
        lens += active
    return plan


def test_paged_decode_matches_jax_model(models):
    japi, jparams, tapi, tparams = models
    rng = np.random.default_rng(0)
    nb = B * BPR
    tables = rng.permutation(nb).reshape(B, BPR).astype(np.int32)
    tables[1, 0] = tables[0, 0]                    # shared prefix block
    jcaches = japi.init_paged_caches(B, nb, BS, np.float32)
    tcaches = tapi.init_paged_caches(B, nb, BS)
    jdecode = jax.jit(japi.decode_fn)
    before = dict(launches)
    for toks, lens, active in _schedule(rng):
        batch = {"tokens": toks[:, None], "cache_len": lens,
                 "active": active, "block_tables": tables}
        jlogits, jcaches = jdecode(jparams, jcaches, batch)
        tlogits, tcaches = tapi.decode_fn(
            tparams, tcaches, {k: torch.tensor(v) for k, v in batch.items()})
        assert tlogits.shape == (B, 512) and tlogits.dtype == torch.float32
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
    assert launches == before                      # CPU: plain versions
    jpools = jcaches["period"][0]
    for i, cache in enumerate(tcaches):
        for name in ("k_pool", "v_pool"):
            np.testing.assert_allclose(cache[name].numpy()[:-1],
                                       np.asarray(jpools[name][i])[:-1],
                                       **LOGIT_TOL)


def test_dense_and_scalar_paths_wait_for_their_slice(models):
    """The dense and scalar paths have landed (tests/
    test_torch_dense_serving.py), Mamba blocks (tests/
    test_torch_mamba.py) and MoE blocks (tests/test_torch_moe.py); what
    still waits: a paged cache takes no scalar cache_len (JAX's error),
    the loss waits for the training slice.  dbrx builds attention + MoE
    blocks with an fp32 router; mamba2 builds Mamba2 mixers with no
    channel mix, and per-row state (not a block pool) in its paged
    caches."""
    _, _, tapi, tparams = models
    caches = tapi.init_paged_caches(B, B * BPR, BS)
    batch = {"tokens": torch.zeros(B, 1, dtype=torch.int32),
             "cache_len": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="paged caches require"):
        tapi.decode_fn(tparams, caches, batch)
    with pytest.raises(NotImplementedError, match="training"):
        tapi.loss_fn(tparams, batch)
    # MoE blocks have landed (tests/test_torch_moe.py holds them to JAX)
    dbrx = build_model(get_config("dbrx-132b").reduced(), device="cpu") \
        .init(None)
    assert [layer.kind for layer in dbrx.layers] == [("attn", "moe")] * 2
    assert dbrx.layers[0].moe.router.dtype == torch.float32
    cfg = get_config("mamba2-370m").reduced()
    api = build_model(cfg, device="cpu")
    lm = api.init(None)
    assert [layer.kind for layer in lm.layers] == [("mamba", "none")] * 2
    assert not any(hasattr(layer, n) for layer in lm.layers
                   for n in ("attn", "mlp", "norm2"))
    assert lm.layers[0].mamba.A_log.dtype == torch.float32
    paged = api.init_paged_caches(B, B * BPR, BS)
    assert [sorted(c) for c in paged] == [["conv", "state"]] * 2
    assert paged[0]["state"].shape == (B, 32, 16, 16)
