"""The CUDA decode kernels, built for the CPU, against their plain versions.

``csrc/decode_attention.cu`` and ``csrc/paged_decode_attention.cu`` (with
their shared ``decode_tile.cuh``) are compiled by g++ against a CPU
stand-in of the CUDA runtime (``tests/cuda_emu``: one thread per CUDA
thread) and called through their C interface with CPU tensors, as the
wrappers call them on the card.  So the kernels' indexing, masking,
split over positions and fixed-order merges are checked here without a
card: against the plain PyTorch versions at the port's tolerances (fp32
2e-5, bf16 2e-2; the stand-in's ``expf`` is the C library's, not the
card's), and bit for bit against themselves over a wider cache or table,
one row alone, a second launch, and dense against paged at tile = block
size.  Output and scratch start as NaN, so a value the kernels never
write, or scratch a merge reads before any block wrote it, shows.  The
speed, and whatever only nvcc checks, is the card's business
(``chip_smoke.py``, the ``cuda``-marked tests).
"""

import ctypes

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import cuda_emu  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._args import KERNEL_DTYPES, aligned16  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention_plain)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
NAMES = ("decode_attention", "paged_decode_attention")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The two libraries, built once per test process."""
    if not cuda_emu.available():
        pytest.skip("needs g++")
    libs = cuda_emu.build(NAMES, tmp_path_factory.mktemp("cuda_emu"))
    for name, lib in libs.items():
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return libs


def _scratch(B, H, D, n_split):
    n = B * H * n_split * (D + 2) if n_split > 1 else 0
    return torch.full((n,), float("nan"))


def dense(emu, q, k, v, pos, lens, window=0, tile=16):
    """The dense kernel's C entry point, called as the wrapper calls it."""
    B, H, D = q.shape
    K, T = k.shape[1], k.shape[2]
    n_split = emu["decode_attention"].decode_splits(
        D, H // K, KERNEL_DTYPES[q.dtype], -(-T // tile))
    out = torch.full_like(q, float("nan"))
    scratch = _scratch(B, H, D, n_split)
    counters = torch.zeros(B * H, dtype=torch.int32)
    rc = emu["decode_attention"].decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        counters.data_ptr(), B, H, K, D, T, tile, *k.stride()[:3], window,
        float(np.float32(1 / np.sqrt(D))), KERNEL_DTYPES[q.dtype],
        aligned16((q, k, v), D, *k.stride()[:3]), None)
    assert rc == 0
    assert not counters.any()              # left as found, for the next
    return out


def paged(emu, q, kp, vp, tables, lens, window=0):
    B, H, D = q.shape
    _, bs, K, _ = kp.shape
    bpr = tables.shape[1]
    lib = emu["paged_decode_attention"]
    n_split = lib.decode_splits(D, H // K, KERNEL_DTYPES[q.dtype], bpr)
    out = torch.full_like(q, float("nan"))
    scratch = _scratch(B, H, D, n_split)
    counters = torch.zeros(B * H, dtype=torch.int32)
    rc = lib.paged_decode_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        counters.data_ptr(), B, H, K, D, bs, bpr, window,
        float(np.float32(1 / np.sqrt(D))), KERNEL_DTYPES[q.dtype],
        aligned16((q, kp, vp), D), None)
    assert rc == 0
    assert not counters.any()
    return out


def _cache(rng, B, H, K, T, D, dtype):
    """q and a (B, T, K, D) cache seen as (B, K, T, D)."""
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=dtype)
    k, v = (torch.tensor(rng.standard_normal((B, T, K, D)), dtype=dtype)
            .transpose(1, 2) for _ in range(2))
    return q, k, v


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,K,T,D,window,tile", [
    (2, 4, 2, 64, 16, 0, 16),       # one split
    (2, 2, 2, 128, 32, 0, 4),       # MHA, two splits
    (1, 4, 1, 64, 16, 16, 2),       # MQA, sliding window
    (3, 4, 4, 50, 80, 0, 2),        # T % split != 0
    (2, 8, 2, 96, 120, 20, 2),      # GQA 4 heads a block, D = 120
    (2, 12, 1, 40, 24, 0, 1),       # 12 heads: two blocks of 8
    (1, 2, 2, 40, 200, 0, 4),       # D = 200: two vectors a lane
])
def test_dense_kernel_matches_plain(emu, dtype, B, H, K, T, D, window,
                                    tile):
    rng = np.random.default_rng(T + D)
    q, k, v = _cache(rng, B, H, K, T, D, dtype)
    lens = torch.tensor(rng.integers(0, T, B), dtype=torch.int32)
    lens[0] = T - 1
    pos = torch.arange(T, dtype=torch.int32)
    _close(dense(emu, q, k, v, pos, lens, window, tile),
           decode_attention_plain(q, k, v, pos, lens, window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_kernel_ring_and_unaligned(emu, dtype):
    """Permuted positions with empty slots; a cache off 16-byte alignment
    (element loads) gives the aligned cache's bits."""
    rng = np.random.default_rng(1)
    q, k, v = _cache(rng, 2, 4, 2, 48, 32, dtype)
    pos = torch.tensor(rng.permutation(48), dtype=torch.int32)
    pos[:5] = -1
    lens = torch.tensor([40, 40], dtype=torch.int32)
    _close(dense(emu, q, k, v, pos, lens, 12, 2),
           decode_attention_plain(q, k, v, pos, lens, 12), dtype)
    q, k, v = _cache(rng, 2, 4, 2, 40, 16, dtype)
    off = torch.empty(k.numel() + 1, dtype=dtype)[1:].view(2, 40, 2, 16)
    off = off.transpose(1, 2)
    off.copy_(k)
    lens = torch.tensor([39, 20], dtype=torch.int32)
    pos = torch.arange(40, dtype=torch.int32)
    assert aligned16((q, off, v), 16, *off.stride()[:3]) == 0
    assert torch.equal(dense(emu, q, off, v, pos, lens, 0, 2),
                       dense(emu, q, k, v, pos, lens, 0, 2))


def _pool(c, tables, bs):
    """A (B, K, T, D) cache laid into a block pool through ``tables``."""
    B, K, T, D = c.shape
    pool = torch.zeros(tables.numel() + 1, bs, K, D, dtype=c.dtype)
    pool[tables.long().reshape(-1)] = c.transpose(1, 2).reshape(-1, bs, K,
                                                                 D)
    return pool


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 7])
def test_bits_independent_of_width_batch_launch_and_layout(emu, dtype,
                                                           window):
    """Dense at tile = bs equals paged; the same rows over a wider cache
    or table, one row alone and a second launch give the same bits."""
    rng = np.random.default_rng(2 + window)
    B, H, K, D, bs, bpr = 8, 4, 2, 16, 2, 10
    T = bs * bpr
    q, k, v = _cache(rng, B, H, K, T, D, dtype)
    lens = torch.tensor(rng.integers(0, T, B), dtype=torch.int32)
    lens[0], lens[1] = 0, T - 1
    pos = torch.arange(T, dtype=torch.int32)
    got = dense(emu, q, k, v, pos, lens, window, bs)
    _close(got, decode_attention_plain(q, k, v, pos, lens, window), dtype)
    assert torch.equal(got, dense(emu, q, k, v, pos, lens, window, bs))
    wide = 4 * T + 3
    kw, vw = (torch.cat([c, torch.tensor(rng.standard_normal(
        (B, K, wide - T, D)), dtype=dtype)], 2) for c in (k, v))
    assert torch.equal(got, dense(emu, q, kw, vw, torch.arange(
        wide, dtype=torch.int32), lens, window, bs))
    one = dense(emu, q[3:4].contiguous(), k[3:4], v[3:4], pos,
                lens[3:4].contiguous(), window, bs)
    assert torch.equal(one[0], got[3])
    tables = torch.tensor(rng.permutation(B * bpr).reshape(B, bpr),
                          dtype=torch.int32)
    kp, vp = _pool(k, tables, bs), _pool(v, tables, bs)
    assert torch.equal(got, paged(emu, q, kp, vp, tables, lens, window))
    longer = torch.cat([tables, torch.full((B, 4 * bpr + 1), B * bpr,
                                           dtype=torch.int32)], 1)
    assert torch.equal(got, paged(emu, q, kp, vp, longer, lens, window))
    one = paged(emu, q[5:6].contiguous(), kp, vp, tables[5:6].contiguous(),
                lens[5:6].contiguous(), window)
    assert torch.equal(one[0], got[5])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,K,D,bs,bpr,window", [
    (2, 4, 2, 16, 16, 4, 0),        # GQA, block 16
    (3, 2, 2, 32, 1, 8, 0),         # one token per block
    (2, 4, 1, 16, 5, 7, 0),         # non-power-of-two block (MQA)
    (3, 4, 2, 16, 8, 4, 12),        # sliding window
    (4, 4, 4, 80, 16, 3, 0),        # MHA at head_dim 80
    (3, 8, 2, 120, 2, 9, 5),        # GQA, D = 120, window, many splits
])
def test_paged_kernel_matches_plain(emu, dtype, B, H, K, D, bs, bpr,
                                    window):
    """Scrambled tables, entries past cache_len on the scratch row,
    ragged lengths with 0 and a full row."""
    rng = np.random.default_rng(bs * bpr + D)
    nb = 2 * B * bpr
    kp, vp = (torch.tensor(rng.standard_normal((nb + 1, bs, K, D)),
                           dtype=dtype) for _ in range(2))
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=dtype)
    tables = rng.permutation(nb)[:B * bpr].reshape(B, bpr).astype(np.int32)
    lens = rng.integers(0, bpr * bs, B).astype(np.int32)
    lens[0], lens[-1] = 0, bpr * bs - 1
    for b in range(B):
        tables[b, lens[b] // bs + 1:] = nb
    tables, lens = torch.tensor(tables), torch.tensor(lens)
    _close(paged(emu, q, kp, vp, tables, lens, window),
           paged_decode_attention_plain(q, kp, vp, tables, lens, window),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_stale_length_clipped_to_table(emu, dtype):
    """An idle row's stale cache_len == bpr * bs reads no block past its
    table."""
    rng = np.random.default_rng(3)
    q, k, v = _cache(rng, 2, 4, 2, 32, 16, dtype)
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    kp, vp = _pool(k, tables, 8), _pool(v, tables, 8)
    lens = torch.tensor([32, 31], dtype=torch.int32)
    _close(paged(emu, q, kp, vp, tables, lens),
           paged_decode_attention_plain(q, kp, vp, tables, lens), dtype)
