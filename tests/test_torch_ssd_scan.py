"""The port's SSD scan against the JAX kernel and the models' SSD.

Seeded numpy inputs (the JAX suite's distributions: x, B, C standard
normal, dt uniform in [0.01, 0.2], A uniform in [-2, -0.5]) go through
the JAX Pallas kernel ``ssd_scan_op`` (interpret mode), its oracle
``ssd_scan_kernel_ref`` (pre-chunked layout) and the port's wrapper,
which on CPU tensors runs the plain version (``ssd_chunked`` from a zero
state).  The sweep is the JAX suite's (``tests/test_kernels.py``); the
port's ``ssd_chunked`` (with and without an initial state) and
``ssd_scan_ref`` are held to the JAX model's.  Tolerance: rtol = atol =
2e-4, the JAX suite's for the SSD scan (other summation orders of the
within-chunk cumsum and products).  The ``cuda``-marked cases hold the
CUDA kernel against its plain version and the sequential oracle on the
card — odd chunk lengths, groups broadcast by stride, strided inputs
sliced out of one projection as ``mamba_block`` passes them — and skip
without one.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.ssd_scan import (launches, ssd_chunked,  # noqa: E402
                                          ssd_scan, ssd_scan_op,
                                          ssd_scan_plain, ssd_scan_ref)

TOL = dict(rtol=2e-4, atol=2e-4)

SWEEP = [                            # b, S, H, G, P, N, chunk
    (1, 32, 2, 1, 8, 4, 8),
    (2, 64, 4, 2, 16, 8, 16),
    (1, 16, 2, 2, 8, 8, 4),
]


@pytest.fixture(scope="module")
def jx():
    """The JAX kernel, its oracle and the models' SSD (imported here, so
    the card's machine, which has no JAX, still collects the ``cuda``
    cases)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd_scan import ops
    from repro.models import ssm

    return types.SimpleNamespace(jnp=jnp, op=ops.ssd_scan_op,
                                 kernel_ref=ops.ssd_scan_kernel_ref,
                                 chunked=ssm.ssd_chunked,
                                 ref=ssm.ssd_scan_ref)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(seed, b, S, H, G, P, N):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((b, S, H, P)).astype(f32),
            rng.uniform(0.01, 0.2, (b, S, H)).astype(f32),
            -rng.uniform(0.5, 2.0, (H,)).astype(f32),
            rng.standard_normal((b, S, G, N)).astype(f32),
            rng.standard_normal((b, S, G, N)).astype(f32))


def _torch(arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


def _to_kernel_layout(jnp, a, chunk, feat=True):
    """(b, S, H[, F]) -> the Pallas kernel's (b, H, C, L[, F])."""
    b, S, H = a.shape[:3]
    a = jnp.asarray(a)
    if feat:
        return a.transpose(0, 2, 1, 3).reshape(b, H, S // chunk, chunk,
                                               a.shape[3])
    return a.transpose(0, 2, 1).reshape(b, H, S // chunk, chunk)


@pytest.mark.parametrize("b,S,H,G,P,N,chunk", SWEEP)
def test_plain_matches_jax_kernel_and_ref(jx, b, S, H, G, P, N, chunk):
    arrays = _inputs(0, b, S, H, G, P, N)
    before = dict(launches)
    got = ssd_scan_op(*_torch(arrays), chunk=chunk)
    assert launches == before                  # CPU tensors: plain version
    assert got.shape == (b, S, H, P) and got.dtype == torch.float32
    want = jx.op(*(jx.jnp.asarray(a) for a in arrays), chunk=chunk,
                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the kernel oracle, in the kernel's pre-chunked layout, heads
    # broadcast from the groups as the JAX op does
    x, dt, A, B, C = arrays
    rep = H // G
    Bh, Ch = (np.repeat(t, rep, axis=2) for t in (B, C))
    kern = jx.kernel_ref(_to_kernel_layout(jx.jnp, x, chunk),
                         _to_kernel_layout(jx.jnp, dt, chunk, feat=False),
                         _to_kernel_layout(jx.jnp, Bh, chunk),
                         _to_kernel_layout(jx.jnp, Ch, chunk),
                         jx.jnp.asarray(A))
    kern = np.asarray(kern).reshape(b, H, S, P).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), kern, **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(jx, with_state):
    b, S, H, G, P, N, chunk = 2, 64, 4, 2, 16, 8, 16
    arrays = _inputs(1, b, S, H, G, P, N)
    h0 = (np.random.default_rng(2).standard_normal((b, H, P, N))
          .astype(np.float32) if with_state else None)
    got_y, got_h = ssd_chunked(*_torch(arrays), chunk=chunk,
                               initial_state=None if h0 is None
                               else torch.tensor(h0))
    want_y, want_h = jx.chunked(*(jx.jnp.asarray(a) for a in arrays),
                                chunk=chunk, initial_state=h0)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    # the sequential oracles agree too, final state included
    ref_y, ref_h = ssd_scan_ref(*_torch(arrays), initial_state=None
                                if h0 is None else torch.tensor(h0))
    jy, jh = jx.ref(*(jx.jnp.asarray(a) for a in arrays), initial_state=h0)
    np.testing.assert_allclose(ref_y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ref_h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(got_y.numpy(), ref_y.numpy(), **TOL)


def _strided(arrays, device="cpu"):
    """x, B and C as slices of one (b, S, H*P + 2*G*N) buffer and dt as a
    slice of another, the way mamba_block splits its projection: no
    operand is contiguous."""
    x, dt, A, B, C = arrays
    b, S, H, P = x.shape
    G, N = B.shape[2:]
    buf = torch.tensor(np.concatenate(
        [x.reshape(b, S, -1), B.reshape(b, S, -1), C.reshape(b, S, -1)],
        axis=-1), device=device)
    xs, Bs, Cs = torch.split(buf, [H * P, G * N, G * N], dim=-1)
    dts = torch.tensor(np.concatenate([dt, dt], axis=-1),
                       device=device)[..., :H]
    return (xs.reshape(b, S, H, P), dts, torch.tensor(A, device=device),
            Bs.reshape(b, S, G, N), Cs.reshape(b, S, G, N))


@pytest.mark.parametrize("b,S,H,G,P,N,chunk", [
    (1, 100, 4, 2, 8, 8, 100),      # odd L = S (the DAG exporter's rule)
    (2, 45, 6, 3, 8, 4, 15),        # odd L, three groups
])
def test_odd_chunk_and_groups_through_the_wrapper(b, S, H, G, P, N, chunk):
    arrays = _inputs(3, b, S, H, G, P, N)
    ops = _strided(arrays)
    assert not ops[0].is_contiguous() and not ops[3].is_contiguous()
    got = ssd_scan_op(*ops, chunk=chunk)
    want, _ = ssd_scan_ref(*_torch(arrays))
    torch.testing.assert_close(got, want, **TOL)
    # the chunk length changes the summation order, not the function
    torch.testing.assert_close(got, ssd_scan_op(*ops, chunk=S // chunk
                                                if chunk != S else 5), **TOL)


def test_wrapper_checks_and_takes_the_plain_path_only_on_cpu(monkeypatch):
    import importlib

    mod = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    def no_build(name):
        raise AssertionError(f"CPU tensors must not build {name}")

    monkeypatch.setattr(mod, "load", no_build)
    arrays = _torch(_inputs(4, 1, 16, 2, 1, 8, 4))
    before = dict(launches)
    assert torch.equal(ssd_scan(*arrays, chunk=8),
                       ssd_scan_plain(*arrays, chunk=8))
    assert launches == before
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssd_scan(*arrays, chunk=5)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssd_chunked(*arrays, chunk=5)
    x, dt, A, B, C = arrays
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd_scan(x, dt[:, :8], A, B, C, chunk=8)
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan(*(t.to("meta") for t in arrays), chunk=8)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

CARD_CASES = SWEEP + [
    (1, 100, 4, 2, 8, 8, 100),      # odd L, G < H
    (1, 512, 4, 1, 64, 128, 256),   # mamba2-370m's P, N and chunk
    (2, 320, 8, 1, 64, 16, 64),     # jamba's d_state
    (1, 130, 2, 1, 40, 128, 65),    # ragged tiles in every direction
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,S,H,G,P,N,chunk", CARD_CASES)
def test_kernel_matches_plain_and_ref_on_the_card(cuda, b, S, H, G, P, N,
                                                  chunk):
    arrays = _inputs(5, b, S, H, G, P, N)
    ops = _strided(arrays, cuda)
    n = launches["ssd_scan"]
    got = ssd_scan_op(*ops, chunk=chunk)
    torch.cuda.synchronize()
    assert launches["ssd_scan"] == n + 1
    assert got.is_contiguous() and got.shape == (b, S, H, P)
    plain = ssd_scan_plain(*_torch(arrays, cuda), chunk=chunk)
    ref, _ = ssd_scan_ref(*_torch(arrays, cuda))
    torch.testing.assert_close(got, plain, **TOL)
    torch.testing.assert_close(got, ref, **TOL)
    assert torch.equal(got, ssd_scan_op(*ops, chunk=chunk))   # no atomics


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    arrays = _torch(_inputs(6, 1, 16, 2, 1, 8, 4), cuda)
    x, dt, A, B, C = arrays
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x.bfloat16(), dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="unit stride"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B,
                 C, chunk=8)
    with pytest.raises(ValueError, match="d_state"):
        big = torch.zeros(1, 16, 1, 256, device=cuda)
        ssd_scan(x, dt, A, big, big, chunk=8)
