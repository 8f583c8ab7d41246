"""The port's flash attention against the JAX kernel and model attention.

Seeded numpy inputs go through the JAX Pallas kernel ``flash_attention``
(interpret mode), its oracle (``ref.py``) and the port's wrapper, which
on CPU tensors runs the plain PyTorch version beside the CUDA kernel.
The sweep is the JAX suite's (``tests/test_kernels.py``): GQA causal,
MHA, MQA with a sliding window and non-causal cross attention with T >
S, plus the full-width head_dim 80.  ``attend_bshd`` (the models'
``(B, S, H, D)`` layout) is held to the JAX model's ``attend`` with
``causal_mask``, and the port's ``attend`` / ``causal_mask`` to the
JAX ones.  Tolerances are the JAX suite's: fp32 2e-5, bf16 2e-2.  The
``cuda``-marked cases hold the CUDA kernel against its plain version on
the card and skip without one.
"""

import pytest

torch = pytest.importorskip("torch")

import types  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.kernels.flash_attention import (  # noqa: E402
    attend_bshd, flash_attention, flash_attention_plain, launches)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SWEEP = [
    # B, H, K, S, T, D, block_q, block_k, causal, window
    (1, 4, 2, 32, 32, 16, 8, 8, True, 0),       # GQA causal
    (2, 2, 2, 16, 16, 32, 16, 16, True, 0),     # MHA
    (1, 4, 1, 32, 32, 16, 8, 16, True, 8),      # sliding window (MQA)
    (1, 2, 2, 16, 32, 16, 8, 8, False, 0),      # cross attention T > S
    (1, 4, 4, 32, 32, 80, 16, 16, True, 0),     # full-width head_dim
]


@pytest.fixture(scope="module")
def jx():
    """The JAX kernel, oracle and model attention (imported here, so that
    the card's machine, which has no JAX, still collects the ``cuda``
    cases)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import ops
    from repro.models import attention

    return types.SimpleNamespace(jnp=jnp, op=ops.flash_attention_op,
                                 ref=ops.flash_attention_ref,
                                 attend=attention.attend,
                                 causal_mask=attention.causal_mask)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(seed, B, H, K, S, T, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, K, T, D)).astype(np.float32),
            rng.standard_normal((B, K, T, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,T,D,bq,bk,causal,window", SWEEP)
def test_flash_matches_jax_kernel_and_ref(jx, dtype, B, H, K, S, T, D, bq,
                                          bk, causal, window):
    arrays = _inputs(0, B, H, K, S, T, D)
    jq, jk, jv = (jx.jnp.asarray(a).astype(dtype) for a in arrays)
    tq, tk, tv = (torch.tensor(a).to(TORCH_DT[dtype]) for a in arrays)
    before = dict(launches)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert launches == before              # CPU tensors: plain version
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, H, S, D)
    got = got.float().numpy()
    ker = jx.op(jq, jk, jv, causal=causal, window=window, block_q=bq,
                block_k=bk, interpret=True)
    ref = jx.ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(ker, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("window", [0, 8])
def test_attend_bshd_matches_model_attention(jx, window):
    """The models' layout: the adapter against the JAX model's attend()
    with causal_mask, and the port's attend/causal_mask against both."""
    from repro_torch.models.attention import attend, causal_mask

    B, S, H, K, D = 2, 32, 4, 2, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    ref = np.asarray(jx.attend(*(jx.jnp.asarray(a) for a in (q, k, v)),
                               jx.causal_mask(S, S, 0, window)))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = attend_bshd(tq, tk, tv, causal=True, window=window)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), ref, **TOL["float32"])
    mask = causal_mask(S, S, 0, window)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jx.causal_mask(S, S, 0, window)))
    np.testing.assert_allclose(attend(tq, tk, tv, mask).numpy(), ref,
                               **TOL["float32"])


# rows with no valid key: S >= T + window (from row T + window - 1 on),
# causal or not; the JAX kernel gives the mean of V over all T keys
EMPTY = dict(B=1, H=2, K=2, S=32, T=8, D=16, window=4)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_rows_with_no_valid_key_match_jax(jx, causal):
    """The plain version (what the CUDA kernels are held to) against the
    JAX kernel in interpret mode: rows from T + window - 1 on are
    mean(V) over all T keys, the rows above them ordinary attention."""
    c = EMPTY
    arrays = _inputs(7, c["B"], c["H"], c["K"], c["S"], c["T"], c["D"])
    got = flash_attention_plain(*(torch.tensor(a) for a in arrays),
                                causal, c["window"]).numpy()
    ker = jx.op(*(jx.jnp.asarray(a) for a in arrays), causal=causal,
                window=c["window"], block_q=8, block_k=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ker), **TOL["float32"])
    first = c["T"] + c["window"] - 1
    mean = arrays[2].mean(axis=2, keepdims=True)       # (B, K, 1, D)
    np.testing.assert_allclose(got[:, :, first:],
                               np.broadcast_to(mean, got[:, :, first:].shape),
                               **TOL["float32"])
    assert np.abs(got[:, :, first - 1] - mean[:, :, 0]).max() > 1e-2


def test_wrapper_rejects_bad_arguments():
    q, k, v = (torch.tensor(a) for a in _inputs(2, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError):                 # H not a multiple of K
        flash_attention(q, k, v)
    q, k, v = (torch.tensor(a) for a in _inputs(2, 1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError):                 # another head dim
        flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# --------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,T,D,causal,window", [
    (1, 4, 2, 32, 32, 16, True, 0), (2, 2, 2, 100, 100, 32, True, 0),
    (1, 4, 1, 130, 130, 16, True, 40), (1, 2, 2, 70, 150, 16, False, 0),
    (2, 8, 8, 256, 256, 80, True, 0), (1, 8, 2, 300, 300, 120, True, 64),
    (1, 2, 2, 64, 64, 128, False, 16),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, H, K, S, T, D, causal,
                                    window):
    tq, tk, tv = (torch.tensor(a).to(cuda, TORCH_DT[dtype])
                  for a in _inputs(3, B, H, K, S, T, D))
    before = launches["flash_attention"]
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    want = flash_attention_plain(tq, tk, tv, causal, window)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_takes_the_models_layout(cuda):
    """attend_bshd passes strided views: the output comes back in the
    (B, S, H, D) layout, contiguous, equal to the plain version."""
    B, S, H, K, D = 2, 96, 4, 2, 80
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda)
               for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    got = attend_bshd(q, k, v, causal=True, window=0)
    assert got.shape == (B, S, H, D) and got.is_contiguous()
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, want, **TOL["float32"])


def _card_inputs(device, dtype, seed, B, H, K, S, T, D):
    return tuple(torch.tensor(a).to(device, TORCH_DT[dtype])
                 for a in _inputs(seed, B, H, K, S, T, D))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_rows_with_no_valid_key(cuda, dtype, causal):
    """Rows from T + window - 1 on have no valid key: both kernels give
    the plain version's mean of V over all T keys (padding keys of the
    last tile never enter the denominator, skipped tiles are no
    excuse)."""
    c = EMPTY
    q, k, v = _card_inputs(cuda, dtype, 7, c["B"], c["H"], c["K"], c["S"],
                           c["T"], c["D"])
    got = flash_attention(q, k, v, causal=causal, window=c["window"])
    want = flash_attention_plain(q, k, v, causal, c["window"])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    first = c["T"] + c["window"] - 1
    mean = v.float().mean(dim=2, keepdim=True).expand(-1, -1, c["S"] - first,
                                                      -1)
    torch.testing.assert_close(got[:, :, first:].float(), mean, **TOL[dtype])


# bf16 on the tensor cores: every head dim the models use (D padded to a
# multiple of 16 in shared memory), S and T off the 64-row / 64-key tiles,
# GQA groups 1, 4 and 8, causal, windowed and cross attention with T > S
BF16_SWEEP = [
    # B, H, K, S, T, D, causal, window
    (1, 2, 2, 77, 77, 16, True, 0),
    (2, 4, 1, 130, 130, 32, True, 0),
    (1, 8, 2, 200, 200, 64, True, 50),
    (2, 8, 8, 257, 257, 80, True, 0),
    (1, 8, 1, 65, 191, 80, False, 0),
    (1, 16, 2, 300, 300, 120, True, 64),
    (1, 4, 4, 129, 129, 128, False, 100),
    (1, 8, 1, 63, 1000, 128, False, 0),
    (1, 32, 8, 1000, 1000, 80, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,S,T,D,causal,window", BF16_SWEEP)
def test_flash_bf16_kernel_sweep(cuda, B, H, K, S, T, D, causal, window):
    q, k, v = _card_inputs(cuda, "bfloat16", 5, B, H, K, S, T, D)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,S,T,D,causal,window", [
    (1, 8, 2, 200, 70, 80, True, 50),        # rows 119.. empty
    (2, 4, 4, 150, 20, 120, False, 33),      # rows 52.., cross, skipped tiles
    (1, 4, 1, 100, 1, 64, True, 3),          # a single key
    (1, 2, 2, 70, 0, 16, False, 5),          # no key at all: zeros
])
def test_flash_kernel_rows_with_no_valid_key_off_the_tile(
        cuda, B, H, K, S, T, D, causal, window):
    for dtype in ("float32", "bfloat16"):
        q, k, v = _card_inputs(cuda, dtype, 8, B, H, K, S, T, D)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_flash_bf16_kernel_takes_the_models_layout(cuda):
    """The models' strided (B, S, H, D) views through attend_bshd, in
    bf16 with GQA and a head dim off the 16-element mma depth."""
    B, S, H, K, D = 2, 333, 8, 2, 120
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda).to(torch.bfloat16)
               for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    for window in (0, 100):
        got = attend_bshd(q, k, v, causal=True, window=window)
        assert got.shape == (B, S, H, D) and got.is_contiguous()
        want = flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True,
            window).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL["bfloat16"])


@pytest.mark.cuda
def test_flash_bf16_kernel_is_deterministic(cuda):
    """A fixed summation order: two launches are bit-identical, and an
    operand that is not 16-byte aligned (the element-wise load path)
    gives the same result as the aligned one."""
    B, H, K, S, D = 1, 8, 2, 300, 80
    q, k, v = _card_inputs(cuda, "bfloat16", 6, B, H, K, S, S, D)
    got = flash_attention(q, k, v, causal=True, window=0)
    again = flash_attention(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    # the same values at an offset of one element: strides stay, bases
    # lose their 16-byte alignment
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    q_off = buf[1:].view(q.shape).copy_(q)
    odd = flash_attention(q_off, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert torch.equal(odd, got)
