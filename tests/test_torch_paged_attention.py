"""The port's paged-attention functions against the JAX kernels.

Seeded numpy inputs go through the JAX Pallas kernels (interpret mode),
their numpy oracles (``ref.py``) and the port's wrappers, which on CPU
tensors run the plain PyTorch versions beside the CUDA kernels.  Cases
cover GQA, a sliding window, block sizes 1 / 16 / non-power-of-two,
ragged lengths (0 and a full row included) and table entries pointing at
the scratch row.  Tolerances are the JAX suite's
(``tests/test_paged_kernels.py``): fp32 2e-5, bf16 2e-2; the append is
exact.  The ``cuda``-marked cases hold each CUDA kernel against its plain
version on the card, and show that the decode kernel's bits do not depend
on the table's width, the batch or the launch; they skip without one.
"""

import pytest

torch = pytest.importorskip("torch")

import types  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.kernels.paged_attention import (  # noqa: E402
    launches, paged_append, paged_append_plain, paged_decode_attention,
    paged_decode_attention_plain)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

DECODE_CASES = [
    # B, H, K, D, bs, bpr, window
    (2, 4, 2, 16, 16, 4, 0),       # GQA, block 16
    (3, 2, 2, 32, 1, 8, 0),        # block_size 1 (one token per block)
    (2, 4, 1, 16, 5, 7, 0),        # non-power-of-two block (MQA)
    (3, 4, 2, 16, 8, 4, 12),       # sliding window
    (4, 4, 4, 80, 16, 3, 0),       # MHA at the full-width head_dim 80
]


@pytest.fixture(scope="module")
def jx():
    """The JAX kernels and oracles (imported here, so that the card's
    machine, which has no JAX, still collects the ``cuda`` cases)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.paged_attention import paged_attention, ref

    return types.SimpleNamespace(
        jnp=jnp, decode=paged_attention.paged_decode_attention,
        append=paged_attention.paged_append,
        decode_ref=ref.paged_decode_attention_ref,
        append_ref=ref.paged_append_ref)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _decode_inputs(seed, B, H, K, D, bs, bpr):
    """Pools, q, scrambled tables (one prefix-shared block, entries past
    cache_len on the scratch row) and ragged lengths incl. 0 and full."""
    rng = np.random.default_rng(seed)
    nb = 2 * B * bpr
    k_pool = rng.standard_normal((nb + 1, bs, K, D)).astype(np.float32)
    v_pool = rng.standard_normal((nb + 1, bs, K, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tables = rng.permutation(nb)[:B * bpr].reshape(B, bpr).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    lens = rng.integers(0, bpr * bs, B).astype(np.int32)
    lens[0], lens[-1] = 0, bpr * bs - 1
    for b in range(B):
        tables[b, lens[b] // bs + 1:] = nb          # unallocated: scratch
    return q, k_pool, v_pool, tables, lens


def _cast(jx, arrays, dtype):
    return ([jx.jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.tensor(a).to(TORCH_DT[dtype]) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,D,bs,bpr,window", DECODE_CASES)
def test_paged_decode_matches_jax_kernel_and_ref(jx, dtype, B, H, K, D,
                                                 bs, bpr, window):
    q, kp, vp, tables, lens = _decode_inputs(0, B, H, K, D, bs, bpr)
    (jq, jk, jv), (tq, tk, tv) = _cast(jx, [q, kp, vp], dtype)
    before = dict(launches)
    got = paged_decode_attention(tq, tk, tv, torch.tensor(tables),
                                 torch.tensor(lens), window=window)
    assert launches == before              # CPU tensors: plain version
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, H, D)
    got = got.float().numpy()
    ker = jx.decode(jq, jk, jv, tables, lens, window=window,
                    interpret=True)
    ref = jx.decode_ref(jq, jk, jv, tables, lens, window)
    np.testing.assert_allclose(got, np.asarray(ker, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               **TOL[dtype])


def _append_inputs(seed, B, C, K, D, bs, bpr):
    rng = np.random.default_rng(seed)
    nb = B * bpr + 2
    k_pool = rng.standard_normal((nb + 1, bs, K, D)).astype(np.float32)
    v_pool = rng.standard_normal((nb + 1, bs, K, D)).astype(np.float32)
    k_new = rng.standard_normal((B, C, K, D)).astype(np.float32)
    v_new = rng.standard_normal((B, C, K, D)).astype(np.float32)
    tables = rng.permutation(nb)[:B * bpr].reshape(B, bpr).astype(np.int32)
    lens = rng.integers(0, bpr * bs - C, B).astype(np.int32)
    n_valid = rng.integers(0, C + 1, B).astype(np.int32)
    n_valid[0] = C                                  # one full chunk
    return k_pool, v_pool, k_new, v_new, tables, lens, n_valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,K,D,bs,bpr", [
    (3, 1, 2, 16, 4, 6),           # the decode write (C = 1)
    (3, 5, 2, 16, 4, 6),           # a ragged prefill chunk
    (2, 3, 4, 80, 16, 3),          # full-width head_dim
])
def test_paged_append_matches_jax_kernel_exactly(jx, dtype, B, C, K, D,
                                                 bs, bpr):
    kp, vp, kn, vn, tables, lens, n_valid = _append_inputs(
        1, B, C, K, D, bs, bpr)
    (jkp, jvp, jkn, jvn), (tkp, tvp, tkn, tvn) = _cast(
        jx, [kp, vp, kn, vn], dtype)
    out_k, out_v = paged_append(tkp, tvp, tkn, tvn, torch.tensor(tables),
                                torch.tensor(lens), torch.tensor(n_valid))
    assert out_k is tkp and out_v is tvp            # updated in place
    ker_k, ker_v = jx.append(jkp, jvp, jkn, jvn, tables, lens, n_valid,
                             interpret=True)
    # every row, the scratch row included, is bit-identical
    np.testing.assert_array_equal(tkp.float().numpy(),
                                  np.asarray(ker_k, np.float32))
    np.testing.assert_array_equal(tvp.float().numpy(),
                                  np.asarray(ker_v, np.float32))
    # the oracle writes no scratch row: compare the real blocks
    ref_k, ref_v = jx.append_ref(jkp, jvp, jkn, jvn, tables, lens,
                                 n_valid)
    np.testing.assert_array_equal(tkp.float().numpy()[:-1],
                                  np.asarray(ref_k, np.float32)[:-1])
    np.testing.assert_array_equal(tvp.float().numpy()[:-1],
                                  np.asarray(ref_v, np.float32)[:-1])


def test_wrappers_reject_bad_shapes():
    q, kp, vp, tables, lens = _decode_inputs(2, 2, 4, 2, 16, 4, 3)
    tq, tk = torch.tensor(q), torch.tensor(kp)
    with pytest.raises(ValueError):
        paged_decode_attention(tq[:, :3], tk, tk, torch.tensor(tables),
                               torch.tensor(lens))
    with pytest.raises(ValueError):
        paged_append(tk, tk, torch.zeros(2, 1, 2, 8), torch.zeros(2, 1, 2, 8),
                     torch.tensor(tables), torch.tensor(lens),
                     torch.ones(2, dtype=torch.int32))


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,D,bs,bpr,window", DECODE_CASES + [
    (8, 32, 32, 80, 16, 10, 0),    # the full-width main path
    (8, 32, 8, 80, 16, 10, 0),     # GQA at full width
    (8, 32, 32, 80, 16, 256, 0),   # a long context, T = 4096
    (8, 32, 8, 120, 16, 512, 4096),  # h2o-danube widths, T = 8192
])
def test_paged_decode_kernel_matches_plain(cuda, dtype, B, H, K, D, bs,
                                           bpr, window):
    arrays = _decode_inputs(3, B, H, K, D, bs, bpr)
    q, kp, vp = (torch.tensor(a).to(cuda, TORCH_DT[dtype])
                 for a in arrays[:3])
    tables, lens = (torch.tensor(a).to(cuda) for a in arrays[3:])
    before = launches["paged_decode_attention"]
    got = paged_decode_attention(q, kp, vp, tables, lens, window=window)
    want = paged_decode_attention_plain(q, kp, vp, tables, lens, window)
    torch.cuda.synchronize()
    assert launches["paged_decode_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,window", [(32, 0), (32, 37), (8, 37)])
def test_paged_decode_kernel_bits_independent_of_width_batch_launch(
        cuda, dtype, K, window):
    """The kernel splits a row's table over blocks and merges the splits
    in a fixed order, so the same rows give the same bits through a table
    of 10 blocks and of 256 (entries past cache_len on other blocks), one
    row alone and in a batch of 8, and on a second launch."""
    B, H, D, bs, bpr, wide = 8, 32, 80, 16, 10, 256
    q, kp, vp, tables, lens = _decode_inputs(5, B, H, K, D, bs, bpr)
    rng = np.random.default_rng(6)
    nb = kp.shape[0] - 1
    extra = rng.integers(0, nb + 1, (B, wide - bpr)).astype(np.int32)
    q, kp, vp = (torch.tensor(a).to(cuda, TORCH_DT[dtype])
                 for a in (q, kp, vp))
    narrow = torch.tensor(tables, device=cuda)
    broad = torch.tensor(np.concatenate([tables, extra], 1), device=cuda)
    tl = torch.tensor(lens, device=cuda)
    got = paged_decode_attention(q, kp, vp, narrow, tl, window=window)
    torch.testing.assert_close(
        got.float(), paged_decode_attention_plain(q, kp, vp, narrow, tl,
                                                  window).float(),
        **TOL[dtype])
    assert torch.equal(got, paged_decode_attention(q, kp, vp, broad, tl,
                                                   window=window))
    assert torch.equal(got, paged_decode_attention(q, kp, vp, narrow, tl,
                                                   window=window))
    for b in (0, 3, B - 1):
        one = paged_decode_attention(q[b:b + 1], kp, vp, narrow[b:b + 1],
                                     tl[b:b + 1], window=window)
        assert torch.equal(one[0], got[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,K,D,bs,bpr", [
    (8, 1, 32, 80, 16, 10), (3, 5, 2, 16, 4, 6)])
def test_paged_append_kernel_matches_plain(cuda, dtype, B, C, K, D, bs,
                                           bpr):
    arrays = _append_inputs(4, B, C, K, D, bs, bpr)
    kp, vp, kn, vn = (torch.tensor(a).to(cuda, TORCH_DT[dtype])
                      for a in arrays[:4])
    tables, lens, n_valid = (torch.tensor(a).to(cuda) for a in arrays[4:])
    k2, v2 = kp.clone(), vp.clone()
    before = launches["paged_append"]
    paged_append(kp, vp, kn, vn, tables, lens, n_valid)
    paged_append_plain(k2, v2, kn, vn, tables, lens, n_valid)
    torch.cuda.synchronize()
    assert launches["paged_append"] == before + 1
    assert torch.equal(kp, k2) and torch.equal(vp, v2)
