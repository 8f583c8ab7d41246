"""The CUDA ``branch_matmul`` kernel, built for the CPU, against its plain
version, at the MoE path's ragged shapes.

``csrc/branch_matmul.cu`` is compiled by g++ against the CPU stand-in of
the CUDA runtime (``tests/cuda_emu``: one thread per CUDA thread, the
kernel's inline-PTX ``cp.async`` copies landing only at their wait,
``ldmatrix`` and ``mma.sync`` as warp exchanges, launches over 48 KB of
shared memory refused without the kernel's opt-in) and called through
its C interface with CPU tensors, as the wrapper calls it on the card.
So the tiling, the copy ring, the tensor-core fragments, the ragged
edges (M under one tile, K and N off the tile and off 4 or 8, element
copies), the per-group row counts and every block tile (fp32: 64 x 64
where the grid gives every SM four blocks, else 32 x 64, the stand-in
reporting 132 SMs; bf16: 16, 64 or 128 rows by M) are checked without a
card: against ``branch_matmul_plain`` at the repository's kernel
tolerances (fp32 2e-5, bf16 2e-2), and bit for bit against itself — a
rerun, the same rows at a larger capacity (more rows in every group, on
another bf16 tile), groups run among many groups (the other fp32 tile)
and the launch without counts.  The output starts as NaN, so an element
never written shows.  Speed, and whatever only nvcc checks, is the
card's business (``chip_smoke.py``, the ``cuda``-marked tests).
"""

import ctypes
import os
import shutil
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
# the bf16 launch without its shared-memory opt-in
NO_OPT_IN = ("""  cudaError_t err = cudaFuncSetAttribute(
      branch_matmul_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kBytes);""", "  cudaError_t err = cudaSuccess;")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{"branch_matmul": the kernel, "no_opt_in": it without the opt-in},
    built in parallel."""
    if not cuda_emu.available():
        pytest.skip("needs g++")
    src = tmp_path_factory.mktemp("csrc")
    shutil.copy(cuda_emu.CSRC / "branch_matmul.cu", src)
    text = (src / "branch_matmul.cu").read_text()
    assert text.count(NO_OPT_IN[0]) == 1, "the opt-in moved"
    (src / "no_opt_in.cu").write_text(text.replace(*NO_OPT_IN))
    out = cuda_emu.build(("branch_matmul", "no_opt_in"),
                         tmp_path_factory.mktemp("cuda_emu"), src)
    for lib in out.values():
        lib.branch_matmul.argtypes = _build.SIGNATURES["branch_matmul"]
        lib.branch_matmul.restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def lib(libs):
    return libs["branch_matmul"]


def run(lib, x, w, counts=None):
    """The kernel's C entry point, called as the wrapper calls it, with
    the output started as NaN."""
    G, M, K = x.shape
    N = w.shape[2]
    out = torch.full((G, M, N), float("nan"), dtype=x.dtype)
    rc = lib.branch_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                           None if counts is None else counts.data_ptr(),
                           G, M, K, N, KERNEL_DTYPES[x.dtype], None)
    assert rc == 0
    return out


def bits(t):
    """The raw bits of a float tensor (so -0 differs from 0)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,counts", [
    (8, 64, 96, (0, 5, 8)),            # decode: the 16-row bf16 tile
    (70, 40, 68, (0, 37, 70)),         # a count in mid-tile; 64-row tile
    (520, 24, 16, (3, 0, 140)),        # the 128-row tile, most rows idle
])
def test_counts_rows_below_equal_and_past_zero(lib, dtype, M, K, N, counts):
    """A count of 0, one in mid-tile and one of M: against the plain
    version with the same counts; rows below each count bit-identical to
    the launch without counts, rows past it exact zeros."""
    G = len(counts)
    x, w = _operands(M + K, G, M, K, N, dtype)
    c = torch.tensor(counts, dtype=torch.int32)
    got = run(lib, x, w, c)
    torch.testing.assert_close(got.float(),
                               branch_matmul_plain(x, w, c).float(),
                               **TOL[dtype])
    full = run(lib, x, w)
    for g, n in enumerate(counts):
        assert torch.equal(bits(got[g, :n]), bits(full[g, :n]))
        assert not bits(got[g, n:]).any()


def test_one_row_same_bits_on_every_bf16_tile(lib):
    """The same rows through the decode tile (capacity 8), the 64-row tile
    (capacity 100) and the 128-row tile (capacity 600, counts 8): one
    sequence of m16n8k16 steps over ascending k, whatever the tile."""
    G, K, N = 2, 40, 24
    x, w = _operands(14, G, 8, K, N, torch.bfloat16)
    got = run(lib, x, w)
    counts = torch.full((G,), 8, dtype=torch.int32)
    for cap in (100, 600):
        rest, _ = _operands(cap, G, cap - 8, K, N, torch.bfloat16)
        wide = torch.cat([x, rest], 1)
        assert torch.equal(bits(run(lib, wide, w)[:, :8] if cap == 100
                                else run(lib, wide, w, counts)[:, :8]),
                           bits(got))


def test_launch_past_48kb_without_the_opt_in_is_refused(libs):
    """The bf16 tiles take over 48 KB of shared memory: without the
    kernel's opt-in the launch is refused and never runs (the stand-in
    refuses it as the card does)."""
    x, w = _operands(15, 2, 8, 32, 16, torch.bfloat16)
    out = torch.full((2, 8, 16), float("nan"), dtype=torch.bfloat16)
    rc = libs["no_opt_in"].branch_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), None, 2, 8, 32, 16,
        KERNEL_DTYPES[torch.bfloat16], None)
    assert rc != 0 and out.isnan().all()
    torch.testing.assert_close(run(libs["branch_matmul"], x, w).float(),
                               branch_matmul_plain(x, w).float(),
                               **TOL[torch.bfloat16])
