"""The CUDA ``ssd_scan`` and ``paged_append`` kernels, built for the CPU,
against their plain versions.

``csrc/ssd_scan.cu`` and ``csrc/paged_append.cu`` are compiled by g++
against the CPU stand-in of the CUDA runtime (``tests/cuda_emu``: one
thread per CUDA thread, cp.async copies landing only at their wait) and
called through their C interface with CPU tensors, as the wrappers call
them on the card.  So the scan's chunk split — the chunk states, the
pass carrying them across the chunks, the scores per group, the chunk
outputs through the cp.async ring — and the append's targets are
checked without a card:
the scan against ``ssd_scan_plain`` and the sequential ``ssd_scan_ref``
at rtol = atol = 2e-4 (the JAX suite's SSD tolerance; the stand-in's
``expf`` is the C library's, not the card's) on odd chunks, L = S,
groups, ragged tiles and strided operands, and bit for bit against
itself (a rerun, one batch row alone, a prefix of whole chunks, and the
design's variants: one or three ring stages, 32-row query tiles,
16-column d_state slices); y and the scratch
start as NaN, so an element never written, or scratch read before it is
written, shows.  The append's pools must equal ``paged_append_plain``'s
bit for bit.  The speed, and whatever only nvcc checks, is the card's
business (``chip_smoke.py``, the ``cuda``-marked tests).
"""

import ctypes
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import cuda_emu  # noqa: E402
from benchmarks import torch_kernel_variants as tkv  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._args import KERNEL_DTYPES, aligned16  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_append_plain)
from repro_torch.kernels.ssd_scan import (ssd_scan_plain,  # noqa: E402
                                          ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: E402
    scratch_floats)

TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ("ssd_scan", "paged_append")
# the bench's patches of the design: one ring stage, 32-row query tiles
# and 16-column d_state slices at once; and a ring of three stages
VARIANTS = {
    "ssd_scan_v1": sum((tkv.SSD_VARIANTS[label] for label in (
        "one ring stage", "query tile 32", "N slice 16")), ()),
    "ssd_scan_v3": tkv.SSD_VARIANTS["three ring stages"],
}


def _bind(libs):
    for name, lib in libs.items():
        entry = "ssd_scan" if name in VARIANTS else name
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return libs


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The shipped libraries and the scan's variants, built once per
    test process."""
    if not cuda_emu.available():
        pytest.skip("needs g++")
    patched = tmp_path_factory.mktemp("variant_src")
    for name, patches in VARIANTS.items():
        (patched / f"{name}.cu").write_text(tkv.patched("ssd_scan", patches))
    libs = _bind(cuda_emu.build(NAMES, tmp_path_factory.mktemp("cuda_emu")))
    libs.update(_bind(cuda_emu.build(
        tuple(VARIANTS), tmp_path_factory.mktemp("cuda_emu_variants"),
        sources=patched)))
    return libs


def scan(lib, x, dt, A, B, C, L):
    """The scan's C entry point, called as the wrapper calls it, with y
    and the scratch started as NaN."""
    b, S, H, P = x.shape
    G, N = B.shape[2:]
    nan = float("nan")
    y = torch.full((b, S, H, P), nan)
    cs, st, cb = (torch.full((n,), nan)
                  for n in scratch_floats(lib, b, S, H, G, P, N, L))
    rc = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), cs.data_ptr(), st.data_ptr(),
        cb.data_ptr(), b, S, H, P, G, N, L, *x.stride()[:3],
        *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        aligned16((x, B, C), *x.stride()[:3], *B.stride()[:3],
                  *C.stride()[:3], P, N), None)
    assert rc == 0
    return y


def _inputs(seed, b, S, H, G, P, N, strided=False):
    """The JAX suite's distributions; strided: x, B and C sliced out of
    one projection-like buffer and dt out of a wider one, as
    ``mamba_block`` hands them to the kernel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H * P), dtype=np.float32)
    Bm = rng.standard_normal((b, S, G * N), dtype=np.float32)
    Cm = rng.standard_normal((b, S, G * N), dtype=np.float32)
    dt = rng.uniform(0.01, 0.2, (b, S, 2 * H)).astype(np.float32)
    A = torch.tensor(-rng.uniform(0.5, 2.0, H).astype(np.float32))
    if strided:
        buf = torch.tensor(np.concatenate([x, Bm, Cm], -1))
        x, Bm, Cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
        dt = torch.tensor(dt)[..., :H]
    else:
        x, Bm, Cm = (torch.tensor(t) for t in (x, Bm, Cm))
        dt = torch.tensor(dt[..., :H].copy())
    return (x.reshape(b, S, H, P), dt, A, Bm.reshape(b, S, G, N),
            Cm.reshape(b, S, G, N))


SCAN_CASES = [                       # b, S, H, G, P, N, L, strided
    (1, 48, 4, 2, 8, 8, 16, False),      # G < H, three chunks
    (1, 45, 3, 1, 8, 4, 15, False),      # odd L
    (1, 100, 2, 2, 8, 8, 100, True),     # L = S (the DAG exporter's rule)
    (1, 130, 2, 1, 72, 36, 65, False),   # ragged query, head-dim, N tiles
    (2, 24, 2, 1, 6, 5, 8, True),        # off 16 bytes: element copies
    (1, 128, 1, 1, 64, 128, 64, False),  # mamba2-370m's P and N
    (1, 44, 1, 1, 8, 4, 4, False),       # 11 chunks: the pass in batches
]


@pytest.mark.parametrize("b,S,H,G,P,N,L,strided", SCAN_CASES)
def test_scan_kernel_matches_plain_and_ref(emu, b, S, H, G, P, N, L,
                                           strided):
    args = _inputs(S + N, b, S, H, G, P, N, strided)
    assert strided == (not args[0].is_contiguous())
    got = scan(emu["ssd_scan"], *args, L)
    torch.testing.assert_close(got, ssd_scan_plain(*args, L), **TOL)
    torch.testing.assert_close(got, ssd_scan_ref(*args)[0], **TOL)


@pytest.mark.parametrize("b,S,H,G,P,N,L,strided", [
    (2, 48, 2, 1, 8, 8, 16, False),
    (2, 130, 1, 1, 72, 72, 65, True),     # ragged tiles, two N slices
])
def test_scan_bits_rerun_row_prefix_and_variants(emu, b, S, H, G, P, N, L,
                                                 strided):
    """A rerun, one batch row alone, the first k chunks alone and the
    variants of the design give the same bits."""
    args = _inputs(7, b, S, H, G, P, N, strided)
    lib = emu["ssd_scan"]
    got = scan(lib, *args, L)
    assert torch.equal(got, scan(lib, *args, L))
    x, dt, A, Bm, Cm = args
    one = scan(lib, x[1:], dt[1:], A, Bm[1:], Cm[1:], L)
    assert torch.equal(one[0], got[1])
    k = S // L // 2 * L or L
    prefix = scan(lib, x[:, :k], dt[:, :k], A, Bm[:, :k], Cm[:, :k], L)
    assert torch.equal(prefix, got[:, :k])
    for name in VARIANTS:
        assert torch.equal(scan(emu[name], *args, L), got), name


def append(lib, k_pool, v_pool, k_new, v_new, tables, lens, n_valid):
    """The append's C entry point, called as the wrapper calls it."""
    nb1, bs, K, D = k_pool.shape
    B, C = k_new.shape[:2]
    rc = lib.paged_append(
        k_pool.data_ptr(), v_pool.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), tables.data_ptr(), lens.data_ptr(),
        n_valid.data_ptr(), B, C, K * D, bs, tables.shape[1], nb1 - 1,
        KERNEL_DTYPES[k_pool.dtype], None)
    assert rc == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,K,D,bs,bpr,n_valid", [
    (4, 1, 4, 8, 4, 5, [1, 1, 0, 1]),        # decode: an idle row
    (3, 5, 2, 8, 4, 4, [5, 2, 0]),           # ragged chunks, a row idle
    (3, 4, 2, 16, 3, 6, [0, 4, 1]),          # the last invalid is row 2's
    (2, 3, 3, 3, 2, 5, [3, 1]),              # K * D odd
])
def test_append_kernel_matches_plain_bit_for_bit(emu, dtype, B, C, K, D, bs,
                                                 bpr, n_valid):
    rng = np.random.default_rng(B * C + D)
    nb = B * bpr + 2
    pools = [torch.tensor(rng.standard_normal((nb + 1, bs, K, D)),
                          dtype=dtype) for _ in range(2)]
    new = [torch.tensor(rng.standard_normal((B, C, K, D)), dtype=dtype)
           for _ in range(2)]
    tables = torch.tensor(rng.permutation(nb)[:B * bpr].reshape(B, bpr),
                          dtype=torch.int32)
    lens = torch.tensor(rng.integers(0, bpr * bs - C + 1, B),
                        dtype=torch.int32)
    n_valid = torch.tensor(n_valid, dtype=torch.int32)
    want = [p.clone() for p in pools]
    paged_append_plain(*want, *new, tables, lens, n_valid)
    append(emu["paged_append"], *pools, *new, tables, lens, n_valid)
    assert torch.equal(pools[0], want[0]) and torch.equal(pools[1], want[1])
