"""The CUDA ``branch_matmul`` kernel, built for the CPU, against its plain
version, at the MoE path's ragged shapes.

``csrc/branch_matmul.cu`` is compiled by g++ against the CPU stand-in of
the CUDA runtime (``tests/cuda_emu``: one thread per CUDA thread, the
kernel's inline-PTX ``cp.async`` copies landing only at their wait) and
called through its C interface with CPU tensors, as the wrapper calls it
on the card.  So the tiling, the copy ring, the ragged edges (M under
one tile, K and N off the tile and off 4, element copies) and both
block tiles (64 x 64 where the grid gives every SM four blocks, else
32 x 64; the stand-in reports 132 SMs) are checked without a card:
against ``branch_matmul_plain`` at the repository's kernel tolerances
(fp32 2e-5, bf16 2e-2), and bit for bit against itself — a rerun, the
same rows at a larger capacity (more rows in every group) and groups
run among many groups (the other block tile).  The output starts as
NaN, so an element never written shows.  Speed, and whatever only nvcc
checks, is the card's business (``chip_smoke.py``, the ``cuda``-marked
tests).
"""

import ctypes
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))

import cuda_emu  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._args import KERNEL_DTYPES  # noqa: E402
from repro_torch.kernels.branch_matmul import branch_matmul_plain  # noqa: E402

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not cuda_emu.available():
        pytest.skip("needs g++")
    out = cuda_emu.build(("branch_matmul",),
                         tmp_path_factory.mktemp("cuda_emu"))["branch_matmul"]
    out.branch_matmul.argtypes = _build.SIGNATURES["branch_matmul"]
    out.branch_matmul.restype = ctypes.c_int
    return out


def run(lib, x, w):
    """The kernel's C entry point, called as the wrapper calls it, with
    the output started as NaN."""
    G, M, K = x.shape
    N = w.shape[2]
    out = torch.full((G, M, N), float("nan"), dtype=x.dtype)
    rc = lib.branch_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(), G, M,
                           K, N, KERNEL_DTYPES[x.dtype], None)
    assert rc == 0
    return out


def _operands(seed, G, M, K, N, dtype):
    """Outputs of std 0.5 (under 4, where a bf16 ulp is below 2e-2)."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((G, M, K), dtype=np.float32))
    w = torch.tensor(rng.standard_normal((G, K, N), dtype=np.float32)
                     / np.float32(2 * np.sqrt(K)))
    return x.to(dtype), w.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,K,N", [
    (3, 8, 64, 96),          # a decode step: M under one tile, vectors
    (4, 5, 37, 22),          # K and N off the tile and off 4: elements
    (2, 70, 130, 68),        # rows over two tiles, ragged K and N tiles
    (600, 3, 20, 12),        # G over the grid's 4 blocks an SM: 64 x 64
])
def test_kernel_matches_plain(lib, dtype, G, M, K, N):
    x, w = _operands(G + M + K + N, G, M, K, N, dtype)
    got = run(lib, x, w)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               branch_matmul_plain(x, w).float(),
                               **TOL[dtype])
    if G > 4 * 132:       # 64 x 64 tiles; three groups alone take 32 x 64
        assert torch.equal(run(lib, x[:3], w[:3]), got[:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 64, 96), (5, 37, 22)])
def test_rows_bit_identical_across_capacity(lib, dtype, M, K, N):
    """A row's output is one FMA chain over ascending k: the same bits on
    a rerun and at a larger capacity (37 more rows a group, which also
    moves the row among other rows of its tile).  Across the two block
    tiles: ``test_kernel_matches_plain``'s 600-group case."""
    G = 3
    x, w = _operands(M * K, G, M, K, N, dtype)
    got = run(lib, x, w)
    assert torch.equal(got, run(lib, x, w))
    extra, _ = _operands(1, G, 37, K, N, dtype)
    wider = run(lib, torch.cat([extra[:, :3], x, extra[:, 3:]], 1), w)
    assert torch.equal(wider[:, 3:3 + M], got)
