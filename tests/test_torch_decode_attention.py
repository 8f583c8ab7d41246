"""The port's dense decode attention against the JAX kernel.

Seeded numpy inputs go through the JAX Pallas kernel ``decode_attention``
(interpret mode), its oracle (``ref.py``) and the port's wrapper, which
on CPU tensors runs the plain PyTorch version beside the CUDA kernel.
The sweep is the JAX suite's (``tests/test_kernels.py``): GQA, MHA, MQA
with a sliding window, the first token, per-row lengths and ring-buffer
slot order, plus the full-width head_dim 80.  The port receives K/V as
the model holds them — ``(B, T, K, D)`` storage seen through a
``(B, K, T, D)`` view.  Tolerances are the JAX suite's: fp32 2e-5, bf16
2e-2.  The ``cuda``-marked cases hold the CUDA kernel against its plain
version and against the paged kernel on the card, and show that its bits
do not depend on the cache width, the batch or the launch; they skip
without a card.
"""

import pytest

torch = pytest.importorskip("torch")

import types  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain, launches)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SWEEP = [
    # B, H, K, T, D, block_k, window, cache_len
    (1, 4, 2, 64, 16, 16, 0, 40),
    (2, 2, 2, 128, 32, 64, 0, 100),
    (1, 4, 1, 64, 16, 16, 16, 50),     # sliding window (MQA)
    (1, 2, 2, 64, 16, 32, 0, 0),       # first token
    (2, 4, 4, 48, 80, 16, 0, 30),      # full-width head_dim
]


@pytest.fixture(scope="module")
def jx():
    """The JAX kernel and oracle (imported here, so that the card's
    machine, which has no JAX, still collects the ``cuda`` cases)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention import ops

    return types.SimpleNamespace(jnp=jnp, op=ops.decode_attention_op,
                                 ref=ops.decode_attention_ref)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(seed, B, H, K, T, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, K, T, D)).astype(np.float32)
    v = rng.standard_normal((B, K, T, D)).astype(np.float32)
    return q, k, v


def _port(arr, dtype, device="cpu"):
    """(B, K, T, D) numpy -> a (B, K, T, D) view of (B, T, K, D) storage,
    the model's cache layout."""
    t = torch.tensor(np.ascontiguousarray(arr.transpose(0, 2, 1, 3)))
    return t.to(device, TORCH_DT[dtype]).transpose(1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,T,D,bk,window,cache_len", SWEEP)
def test_decode_matches_jax_kernel_and_ref(jx, dtype, B, H, K, T, D, bk,
                                           window, cache_len):
    q, k, v = _inputs(0, B, H, K, T, D)
    pos = np.where(np.arange(T) <= cache_len, np.arange(T), -1) \
        .astype(np.int32)
    jq, jk, jv = (jx.jnp.asarray(a).astype(dtype) for a in (q, k, v))
    before = dict(launches)
    got = decode_attention(torch.tensor(q).to(TORCH_DT[dtype]),
                           _port(k, dtype), _port(v, dtype),
                           torch.tensor(pos), cache_len, window=window)
    assert launches == before              # CPU tensors: plain version
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, H, D)
    got = got.float().numpy()
    ker = jx.op(jq, jk, jv, pos, cache_len, window=window, block_k=bk,
                interpret=True)
    ref = jx.ref(jq, jk, jv, pos, cache_len, window=window)
    np.testing.assert_allclose(got, np.asarray(ker, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("window", [0, 16])
def test_per_row_lengths(jx, window):
    """Vector cache_len (B,): every row masks at its own length, and
    equals a scalar-length call on that row alone."""
    B, H, K, T, D = 4, 4, 2, 64, 16
    q, k, v = _inputs(1, B, H, K, T, D)
    pos = np.arange(T, dtype=np.int32)
    lens = np.array([0, 7, 33, 63], np.int32)
    tq, tk, tv = torch.tensor(q), _port(k, "float32"), _port(v, "float32")
    got = decode_attention(tq, tk, tv, torch.tensor(pos),
                           torch.tensor(lens), window=window)
    ker = jx.op(*(jx.jnp.asarray(a) for a in (q, k, v)), pos, lens,
                window=window, block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ker), **TOL["float32"])
    for b in range(B):
        one = decode_attention(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1],
                               torch.tensor(pos), int(lens[b]),
                               window=window)
        torch.testing.assert_close(one[0], got[b], rtol=0, atol=0)


def test_ring_positions(jx):
    """Ring-buffer slot order (positions permuted) must not matter."""
    B, H, K, T, D = 1, 2, 2, 32, 16
    q, k, v = _inputs(2, B, H, K, T, D)
    pos = np.random.default_rng(3).permutation(T).astype(np.int32)
    got = decode_attention(torch.tensor(q), _port(k, "float32"),
                           _port(v, "float32"), torch.tensor(pos), 31,
                           window=8)
    ker = jx.op(*(jx.jnp.asarray(a) for a in (q, k, v)), pos, 31,
                window=8, block_k=8, interpret=True)
    ref = jx.ref(*(jx.jnp.asarray(a) for a in (q, k, v)), pos, 31,
                 window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ker),
                               **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **TOL["float32"])


def test_wrapper_rejects_bad_arguments():
    q, k, v = _inputs(4, 2, 4, 2, 16, 16)
    tq, tk = torch.tensor(q), torch.tensor(k)
    pos = torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError):                 # H not a multiple of K
        decode_attention(tq[:, :3], tk, tk, pos, 3)
    with pytest.raises(ValueError):                 # pos of another T
        decode_attention(tq, tk, tk, pos[:8], 3)
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(tq.to("meta"), tk.to("meta"), tk.to("meta"),
                         pos.to("meta"), 3)


def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    """The build hashes every csrc header a source includes (the decode
    kernels share csrc/decode_tile.cuh), so a header edit rebuilds."""
    from repro_torch.kernels import _build

    real = {name: _build.library_path(name) for name in _build.SIGNATURES}
    assert len(set(real.values())) == len(real)
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "tile.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "tile.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "inner.cuh").write_text("// v2\n")     # nested header
    second = _build.library_path("k")
    (tmp_path / "tile.cuh").write_text('#include "inner.cuh"\n')
    third = _build.library_path("k")
    assert len({first, second, third}) == 3
    assert first.name.startswith("libk-") and first.parent == _build.BUILD_DIR


# --------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version and the paged one
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,T,D,window,tile", [
    (1, 4, 2, 64, 16, 0, 16), (2, 2, 2, 128, 32, 0, 64),
    (1, 4, 1, 64, 16, 16, 16), (3, 4, 4, 50, 80, 0, 16),   # T % tile != 0
    (8, 32, 32, 160, 80, 0, 16),                           # main path
    (2, 32, 8, 256, 120, 100, 16),                         # GQA + window
])
def test_decode_kernel_matches_plain(cuda, dtype, B, H, K, T, D, window,
                                     tile):
    q, k, v = _inputs(5, B, H, K, T, D)
    lens = np.random.default_rng(6).integers(0, T, B).astype(np.int32)
    lens[0] = T - 1
    tq = torch.tensor(q).to(cuda, TORCH_DT[dtype])
    tk, tv = _port(k, dtype, cuda), _port(v, dtype, cuda)
    pos = torch.arange(T, dtype=torch.int32, device=cuda)
    tl = torch.tensor(lens, device=cuda)
    before = launches["decode_attention"]
    got = decode_attention(tq, tk, tv, pos, tl, window=window, tile=tile)
    want = decode_attention_plain(tq, tk, tv, pos, tl, window)
    torch.cuda.synchronize()
    assert launches["decode_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_decode_kernel_ring_positions(cuda):
    B, H, K, T, D = 2, 4, 2, 48, 32
    q, k, v = _inputs(7, B, H, K, T, D)
    pos = np.random.default_rng(8).permutation(T).astype(np.int32)
    pos[:5] = -1                                    # empty slots
    args = (torch.tensor(q, device=cuda), _port(k, "float32", cuda),
            _port(v, "float32", cuda), torch.tensor(pos, device=cuda), 40)
    got = decode_attention(*args, window=12, tile=8)
    torch.testing.assert_close(got, decode_attention_plain(*args, 12),
                               **TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_bit_identical_to_paged(cuda, dtype):
    """tile = block size and pos = arange: the dense kernel walks the
    paged kernel's tiles with its code (csrc/decode_tile.cuh)."""
    from repro_torch.kernels.paged_attention import paged_decode_attention

    B, H, K, D, bs, bpr = 8, 32, 32, 80, 16, 10
    T = bs * bpr
    q, k, v = _inputs(9, B, H, K, T, D)
    lens = np.random.default_rng(10).integers(0, T, B).astype(np.int32)
    lens[0], lens[1] = 0, T - 1
    tq = torch.tensor(q).to(cuda, TORCH_DT[dtype])
    tk, tv = _port(k, dtype, cuda), _port(v, dtype, cuda)
    tl = torch.tensor(lens, device=cuda)
    tables = torch.randperm(B * bpr, device=cuda).reshape(B, bpr).int()
    pools = []
    for c in (tk, tv):                      # (B, T, K, D) -> block pool
        pool = torch.zeros(B * bpr + 1, bs, K, D, dtype=c.dtype,
                           device=cuda)
        pool[tables.long().reshape(-1)] = c.transpose(1, 2).reshape(
            B * bpr, bs, K, D)
        pools.append(pool)
    pos = torch.arange(T, dtype=torch.int32, device=cuda)
    for window in (0, 37):
        dense = decode_attention(tq, tk, tv, pos, tl, window=window,
                                 tile=bs)
        paged = paged_decode_attention(tq, *pools, tables, tl,
                                       window=window)
        torch.cuda.synchronize()
        assert torch.equal(dense, paged), window


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,window", [(8, 0), (8, 37), (2, 37)])
def test_decode_kernel_bits_independent_of_width_batch_launch(cuda, dtype,
                                                              K, window):
    """The kernel splits a row's slots over blocks and merges the splits
    in a fixed order, so the same rows give the same bits over a cache of
    160 slots and of 4096 (empty past cache_len, as the round engine's
    per-round widths give), one row alone and in a batch of 8, and on a
    second launch."""
    B, H, D, T, wide = 8, 8, 80, 160, 4096
    q, k, v = _inputs(11, B, H, K, wide, D)
    lens = np.random.default_rng(12).integers(0, T, B).astype(np.int32)
    lens[0], lens[1] = 0, T - 1
    tq = torch.tensor(q).to(cuda, TORCH_DT[dtype])
    tl = torch.tensor(lens, device=cuda)
    caches = {}
    for n in (T, wide):
        caches[n] = (_port(k[:, :, :n], dtype, cuda),
                     _port(v[:, :, :n], dtype, cuda),
                     torch.arange(n, dtype=torch.int32, device=cuda))
    got = decode_attention(tq, *caches[T], tl, window=window)
    torch.testing.assert_close(
        got.float(), decode_attention_plain(tq, *caches[T], tl, window)
        .float(), **TOL[dtype])
    assert torch.equal(got, decode_attention(tq, *caches[wide], tl,
                                             window=window))
    assert torch.equal(got, decode_attention(tq, *caches[T], tl,
                                             window=window))
    kn, vn, pos = caches[T]
    for b in (0, 1, 5):
        one = decode_attention(tq[b:b + 1], kn[b:b + 1], vn[b:b + 1], pos,
                               tl[b:b + 1], window=window)
        assert torch.equal(one[0], got[b]), b
