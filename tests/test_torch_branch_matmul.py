"""The port's ``branch_matmul`` against the JAX kernel and its reference.

Seeded numpy operands go through the JAX Pallas kernel in interpret mode
(``branch_matmul_ref`` beside it) and through the port's wrapper, which
takes its plain PyTorch version for CPU tensors.  Weights are scaled so
that results have a standard deviation of 0.5.  Tolerances: fp32 2e-5
(two fp32 sums in different orders), bf16 2e-2 (two sums may round to
adjacent bf16 values; below 4, where these results stay, an ulp is at
most 1.6e-2).  The ``cuda`` cases hold the CUDA kernel against the plain
version on the card; JAX is imported only inside fixtures, so the file
collects on the card's machine, which has no JAX.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.branch_matmul import (  # noqa: E402
    branch_matmul, branch_matmul_op, branch_matmul_plain,
    grouped_branch_matmul, launches, parallel_branches)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [(2, 8, 16, 8), (3, 16, 32, 16)]          # (G, M, K, N)
RAGGED_M = (5, 8, 3)                                # branch rows, K=16, N=8


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.branch_matmul.branch_matmul import branch_matmul as k
    from repro.kernels.branch_matmul.ops import parallel_branches as pb
    from repro.kernels.branch_matmul.ref import branch_matmul_ref

    return SimpleNamespace(jnp=jnp, kernel=k, parallel_branches=pb,
                           ref=branch_matmul_ref)


def _operands(seed, G, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, M, K), dtype=np.float32)
    w = rng.standard_normal((G, K, N), dtype=np.float32) \
        / np.float32(2 * np.sqrt(K))
    return x, w


def _np(a):
    return np.asarray(a.astype("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel_interpret(jx, shape, dtype):
    x, w = _operands(0, *shape)
    jt = getattr(jx.jnp, dtype)
    want = jx.kernel(jx.jnp.asarray(x, jt), jx.jnp.asarray(w, jt),
                     block_m=8, block_n=8, block_k=16, interpret=True)
    tt = getattr(torch, dtype)
    got = branch_matmul(torch.tensor(x).to(tt), torch.tensor(w).to(tt))
    assert got.dtype == tt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_reference(jx, dtype):
    x, w = _operands(1, 4, 24, 40, 12)
    jt = getattr(jx.jnp, dtype)
    want = jx.ref(jx.jnp.asarray(x, jt), jx.jnp.asarray(w, jt))
    tt = getattr(torch, dtype)
    got = branch_matmul_plain(torch.tensor(x).to(tt), torch.tensor(w).to(tt))
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_parallel_branches_match_jax(jx, dtype):
    """Branches of unequal M: zero-padded to the largest, results cut
    back; the JAX version pads K and N to its blocks as well."""
    rng = np.random.default_rng(2)
    K, N = 16, 8
    xs = [rng.standard_normal((m, K), dtype=np.float32) for m in RAGGED_M]
    ws = [rng.standard_normal((K, N), dtype=np.float32)
          / np.float32(2 * np.sqrt(K)) for _ in RAGGED_M]
    jt, tt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    want = jx.parallel_branches([jx.jnp.asarray(a, jt) for a in xs],
                                [jx.jnp.asarray(a, jt) for a in ws],
                                interpret=True)
    got = parallel_branches([torch.tensor(a).to(tt) for a in xs],
                            [torch.tensor(a).to(tt) for a in ws])
    assert [tuple(o.shape) for o in got] == [(m, N) for m in RAGGED_M]
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.float().numpy(), _np(w_), rtol=0,
                                   atol=TOL[dtype])


def test_op_and_grouped_entry_points_agree_on_cpu(monkeypatch):
    mod = importlib.import_module(
        "repro_torch.kernels.branch_matmul.branch_matmul")

    def no_build(name):
        raise AssertionError(f"CPU tensors must not build {name}")

    monkeypatch.setattr(mod, "load", no_build)
    before = dict(launches)
    x, w = (torch.tensor(a) for a in _operands(3, 3, 8, 16, 8))
    torch.testing.assert_close(branch_matmul_op(x, w),
                               branch_matmul_plain(x, w), rtol=0, atol=0)
    outs = grouped_branch_matmul(list(x), list(w))
    for i, o in enumerate(outs):
        torch.testing.assert_close(o, x[i] @ w[i], rtol=2e-5, atol=2e-5)
    assert launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w = (torch.tensor(a) for a in _operands(4, 2, 8, 16, 8))
    with pytest.raises(ValueError, match="expected"):
        branch_matmul(x, w[:, :8])
    with pytest.raises(ValueError, match="expected"):
        branch_matmul(x[0], w[0])
    with pytest.raises(ValueError, match="no kernel"):
        branch_matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="one K and N"):
        parallel_branches([x[0], x[1]], [w[0], w[1][:, :4]])
    with pytest.raises(ValueError, match="inputs"):
        parallel_branches([], [])



def test_outputs_skip_the_nan_fill_and_restore_it():
    """Kernel outputs are allocated without deterministic mode's NaN fill
    (the kernel writes every element); the setting is restored after,
    also when the allocation raises."""
    from repro_torch.kernels._args import unfilled

    flag = torch.utils.deterministic.fill_uninitialized_memory
    with unfilled():
        assert torch.utils.deterministic.fill_uninitialized_memory is False
    assert torch.utils.deterministic.fill_uninitialized_memory == flag
    with pytest.raises(RuntimeError):
        with unfilled():
            raise RuntimeError("allocation failed")
    assert torch.utils.deterministic.fill_uninitialized_memory == flag

# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.device import deterministic

    deterministic()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 512, 2560, 240), (6, 512, 80, 2560),
                                   (3, 77, 33, 19), (2, 1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_the_card(card, shape, dtype):
    x, w = _operands(5, *shape)
    tt = getattr(torch, dtype)
    x, w = (torch.tensor(a, device=card).to(tt) for a in (x, w))
    before = launches["branch_matmul"]
    got = branch_matmul(x, w)
    again = branch_matmul(x, w)
    want = branch_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert launches["branch_matmul"] == before + 2
    assert got.dtype == tt and torch.equal(got, again)   # fixed K order
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_ragged_branches_on_the_card(card):
    rng = np.random.default_rng(6)
    xs = [torch.tensor(rng.standard_normal((m, 80), dtype=np.float32),
                       device=card) for m in (300, 512, 129)]
    ws = [torch.tensor(rng.standard_normal((80, 96), dtype=np.float32)
                       / np.float32(np.sqrt(80)), device=card) for _ in xs]
    for o, x, w in zip(grouped_branch_matmul(xs, ws), xs, ws):
        torch.testing.assert_close(o, x @ w, rtol=0, atol=2e-5)


# around both block tiles the kernel picks: 32 x 64 (few tiles) and 64 x 64
# (four blocks an SM or more: 6x513x33x2561 and 4x640x19x1920); K and N off
# the multiple of 4 take the 4-byte copies
EDGE_SHAPES = [(2, 31, 15, 63), (2, 33, 17, 65), (3, 64, 16, 128),
               (1, 95, 48, 129), (2, 1, 2561, 7), (6, 513, 33, 2561),
               (4, 640, 19, 1920), (3, 257, 129, 1023)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_around_tile_edges(card, shape, dtype):
    x, w = _operands(7, *shape)
    tt = getattr(torch, dtype)
    x, w = (torch.tensor(a, device=card).to(tt) for a in (x, w))
    got = branch_matmul(x, w)
    want = branch_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert got.dtype == tt and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("site", [(6, 512, 2560, 240), (6, 512, 80, 2560)],
                         ids=["qkv", "out"])
def test_fp32_kernel_bit_identical_to_bmm(card, site):
    """One FMA chain per output, ascending k from 0: at the planner's two
    sites the kernel equals cuBLAS bmm bit for bit (deterministic mode,
    TF32 off), which the planner's fused-vs-plain check leans on."""
    x, w = (torch.tensor(a, device=card) for a in _operands(8, *site))
    got = branch_matmul(x, w)
    want = torch.bmm(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unaligned_operands_take_the_same_chain(card, dtype):
    """A base off the 16-byte boundary takes the element-wise copies and
    gives the aligned launch's result bit for bit."""
    tt = getattr(torch, dtype)
    x, w = (torch.tensor(a, device=card).to(tt)
            for a in _operands(9, 3, 200, 96, 160))
    buf = torch.empty(x.numel() + 1, dtype=tt, device=card)
    x_off = buf[1:].view(x.shape).copy_(x)
    got = branch_matmul(x, w)
    odd = branch_matmul(x_off, w)
    torch.cuda.synchronize()
    assert torch.equal(got, odd)
