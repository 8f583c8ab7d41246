"""The port's Whisper encoder-decoder against the JAX model.

``whisper-tiny.reduced()`` (fp32, 2 encoder + 2 decoder layers, d_model
256, 4 heads of 64, encoder_seq 32), initialised by the JAX package and
bridged into the port's ``EncDec`` as numpy (``models/bridge.py``).
Inputs come from a numpy seed; the JAX side runs in this process.

* ``encode``, ``cross_kv`` and ``prefill_fn``'s logits against JAX's;
* 8 teacher-forced ``decode_fn`` steps after ``prefill_encdec``, with a
  scalar ``cache_len`` and with a (B,) vector where rows switch
  ``active`` off and back on: logits at every step, and the caches
  (self K/V, positions, cross K/V) after the last;
* ``cross_attention`` at S = 1 (``decode_attention`` over every encoder
  position) and S = 5 (``flash_attention``, non-causal) against JAX's;
* ``stub_audio_frontend``'s shape and dtype; ``build_model`` defaults
  to the card; ``ContinuousEngine`` refuses the model with JAX's error.

Tolerance rtol = atol = 2e-5, the repository's fp32 tolerance: both
sides compute in fp32 in other orders (JAX scores in the model dtype and
divides by sqrt(D) after the dot; the port's plain kernel versions scale
q first).  The ``cuda``-marked cases hold both attention kernels against
their plain versions at whisper-tiny's full-width shapes on the card
(``chip_smoke.py`` holds the reduced model on the card against the
CPU); they skip here.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402
from repro_torch.models import stub_audio_frontend  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
ARCH, B, STEPS, DEC_SLOTS = "whisper-tiny", 3, 8, 16


@pytest.fixture(scope="module")
def wm():
    """The JAX model and the port's on one set of weights (JAX imported
    here, so that the card's machine, which has no JAX, still collects
    the ``cuda`` cases)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build_model
    from repro.models import encdec as jed
    from repro_torch.models.bridge import params_from_numpy

    jcfg = jax_config(ARCH).reduced()
    japi = jax_build_model(jcfg)
    jp = japi.init(jax.random.key(0))
    cfg = get_config(ARCH).reduced()
    api = build_model(cfg, device="cpu")
    p = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    frames = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
              * 0.02).astype(np.float32)
    return types.SimpleNamespace(jnp=jnp, jed=jed, jcfg=jcfg, japi=japi,
                                 jp=jp, cfg=cfg, api=api, p=p,
                                 frames=frames)


def test_encode_matches_jax(wm):
    want = wm.jed.encode(wm.jp, wm.jcfg, wm.jnp.asarray(wm.frames))
    got = encdec.encode(wm.p, wm.cfg, torch.tensor(wm.frames))
    assert got.shape == (B, wm.cfg.encoder_seq, wm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_kv_matches_jax(wm):
    enc = np.asarray(wm.jed.encode(wm.jp, wm.jcfg,
                                   wm.jnp.asarray(wm.frames)))
    for i, blk in enumerate(wm.p.decoder):
        layer = {k: v[i] for k, v in wm.jp["decoder"]["cross_attn"].items()}
        for want, got in zip(
                wm.jed.cross_kv(layer, wm.jcfg, wm.jnp.asarray(enc)),
                encdec.cross_kv(blk.cross_attn, wm.cfg, torch.tensor(enc))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_logits_match_jax(wm):
    tokens = np.random.default_rng(1).integers(
        0, wm.cfg.vocab_size, (B, 1)).astype(np.int32)
    want = wm.japi.prefill_fn(wm.jp, {"frames": wm.jnp.asarray(wm.frames),
                                      "tokens": wm.jnp.asarray(tokens)})
    got = wm.api.prefill_fn(wm.p, {"frames": torch.tensor(wm.frames),
                                   "tokens": torch.tensor(tokens)})
    assert got.shape == (B, wm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module", params=["scalar", "vector"])
def decoded(wm, request):
    """8 teacher-forced steps on both sides: (logits pairs, JAX caches,
    port caches)."""
    jnp = wm.jnp
    rng = np.random.default_rng(2)
    jc = wm.jed.init_dec_caches(wm.jcfg, B, DEC_SLOTS, jnp.float32)
    _, jc = wm.jed.prefill_encdec(wm.jp, wm.jcfg, jnp.asarray(wm.frames),
                                  jc)
    tc = wm.api.init_caches(B, DEC_SLOTS)
    _, tc = encdec.prefill_encdec(wm.p, wm.cfg, torch.tensor(wm.frames),
                                  tc)
    lens = np.zeros(B, np.int32)
    pairs = []
    for step in range(STEPS):
        tokens = rng.integers(0, wm.cfg.vocab_size, (B, 1)).astype(np.int32)
        if request.param == "scalar":
            jb = {"tokens": jnp.asarray(tokens), "cache_len": step}
            tb = {"tokens": torch.tensor(tokens), "cache_len": step}
        else:               # row 1 off at steps 2-3, row 2 at 5
            active = np.array([True, step not in (2, 3), step != 5])
            jb = {"tokens": jnp.asarray(tokens),
                  "cache_len": jnp.asarray(lens),
                  "active": jnp.asarray(active)}
            tb = {"tokens": torch.tensor(tokens),
                  "cache_len": torch.tensor(lens),
                  "active": torch.tensor(active)}
            lens = lens + active
        lj, jc = wm.japi.decode_fn(wm.jp, jc, jb)
        lt, tc = wm.api.decode_fn(wm.p, tc, tb)
        pairs.append((np.asarray(lj), lt.numpy()))
    return pairs, jc, tc


def test_decode_logits_match_jax(decoded):
    pairs, _, _ = decoded
    for want, got in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_decode_caches_match_jax(wm, decoded):
    _, jc, tc = decoded
    for i, layer in enumerate(tc["self"]):
        for name in ("k", "v", "pos"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(jc["self"][name][i]),
                                       **TOL)
    for name in ("cross_k", "cross_v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    T = wm.cfg.encoder_seq
    assert torch.equal(tc["cross_pos"], torch.arange(T, dtype=torch.int32))
    assert torch.equal(tc["cross_len"],
                       torch.full((B,), T - 1, dtype=torch.int32))


@pytest.mark.parametrize("S", [1, 5])
def test_cross_attention_matches_jax(wm, S):
    from repro.models.attention import cross_attention as jax_cross
    from repro_torch.models.attention import cross_attention

    rng = np.random.default_rng(3)
    hd = wm.cfg.resolved_head_dim()
    K, T = wm.cfg.num_kv_heads, wm.cfg.encoder_seq
    x = rng.standard_normal((B, S, wm.cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, K, hd)).astype(np.float32)
            for _ in range(2))
    layer = {n: a[0] for n, a in wm.jp["decoder"]["cross_attn"].items()}
    want = jax_cross(layer, wm.jcfg, *(wm.jnp.asarray(a) for a in (x, k, v)))
    got = cross_attention(wm.p.decoder[0].cross_attn, wm.cfg,
                          *(torch.tensor(a) for a in (x, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stub_audio_frontend_shape_and_dtype():
    gen = torch.Generator().manual_seed(0)
    for cfg, dtype in ((get_config(ARCH), torch.bfloat16),
                       (get_config(ARCH).reduced(), torch.float32)):
        x = stub_audio_frontend(gen, cfg, 2, 40)
        assert x.shape == (2, 40, cfg.d_model) and x.dtype == dtype
        assert 0.01 < x.float().std().item() < 0.03


def test_build_model_runs_on_the_card_by_default():
    cfg = get_config(ARCH)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg)
    api = build_model(cfg, device="cpu")
    assert api.device.type == "cpu" and api.init_paged_caches is None


def test_continuous_engine_refuses_whisper(wm):
    from repro.runtime.config import EngineConfig as JaxEngineConfig
    from repro.runtime.engine import ContinuousEngine as JaxEngine
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ContinuousEngine

    with pytest.raises(ValueError) as want:
        JaxEngine(wm.japi, wm.jp, config=JaxEngineConfig(
            hbm_budget=1 << 30, max_batch=2, max_context=32))
    with pytest.raises(ValueError) as got:
        ContinuousEngine(wm.api, wm.p, device="cpu", config=EngineConfig(
            hbm_budget=1 << 30, max_batch=2, max_context=32))
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# on the card: the kernels at whisper-tiny's full-width shapes
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


CARD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: bf16 against the plain version in fp32 on the same bf16 values: the
#: output's rounding reads ~2e-3; padding keys of a partial tile given
#: weight exp(0) would read ~1.5e-2 on the 1500-key rows
BF16_NORMWISE = 5e-3


def close_on_card(got, plain, *args):
    """``got`` against ``plain(*args)`` at ``CARD_TOL``; in bf16 also
    normwise against ``plain`` evaluated in fp32 on the same values."""
    want = plain(*args)
    torch.cuda.synchronize()
    tol = CARD_TOL[got.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if got.dtype == torch.bfloat16:
        ref = plain(*(a.float() if a.is_floating_point() else a
                      for a in args))
        assert ((got.float() - ref).norm() / ref.norm()).item() \
            <= BF16_NORMWISE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoder_flash_attention_on_the_card(cuda, dtype):
    """B=8, H=K=6, D=64, S=T=1500, non-causal: both tiles partial."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(8, 6, 1500, 64, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    got = flash_attention(q, k, v, causal=False)
    close_on_card(got, lambda *a: flash_attention_plain(*a, causal=False),
                  q, k, v)
    assert torch.equal(got, flash_attention(q, k, v, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", [(1500, 1499), (448, 100)],
                         ids=["cross", "self"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decoder_decode_attention_on_the_card(cuda, dtype, T, lens):
    """The cross shape (T=1500, every slot valid; 94 tiles, the last
    partial) and the self shape (448 slots, cache_len 100); each row
    alone equals its row in the batch of 8."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)

    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(8, 6, 64, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(8, T, 6, 64, generator=gen, device=cuda).to(dtype)
            .transpose(1, 2) for _ in range(2))
    pos = torch.arange(T, dtype=torch.int32, device=cuda)
    cache_len = torch.full((8,), lens, dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, pos, cache_len)
    close_on_card(got, decode_attention_plain, q, k, v, pos, cache_len)
    for b in (0, 7):
        one = decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], pos,
                               cache_len[b:b + 1])
        assert torch.equal(one[0], got[b])
